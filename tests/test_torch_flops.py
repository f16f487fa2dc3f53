"""The port's FLOP counting and MFU (``utils/flops.py``) against the JAX
package's ``utils/flops.py``: the analytic estimators give the same
counts for the same configs; ``torch_flops`` (FlopCounterMode over the
plain fp32 path on the meta device) agrees with the analytic count
within 25% at the JAX test's SwinIR config (the bound of
``tests/test_round3_misc.py::TestFlops``) and with XLA's count of the
JAX MS_ResUNet within 5% (the two counters' conventions differ: XLA
also counts the elementwise work, BatchNorm, ReLU and the residual
adds, which FlopCounterMode leaves out, and yet the port's count came
3.3% above XLA's at 64 x 64, so the two count some convolutions, such as
the transposed ones, differently); the Evaluator's ``flops`` / ``mfu``
on the CPU."""

import dataclasses

import pytest
import torch

torch.set_num_threads(1)


def _jax_configs():
    from tpu_superresolution_tpu.core.config import (
        DATConfig,
        HATConfig,
        SwinIRConfig,
    )

    return [
        ("swinir-default", SwinIRConfig(scale=4), (64, 64)),
        ("swinir-x2-odd", SwinIRConfig(scale=2, embed_dim=60, depths=(6, 6), num_heads=(6, 6)),
         (125, 93)),
        ("swinir-chain", SwinIRConfig(scale=4, fused_reconstruct=False), (48, 48)),
        ("swinir-x3", SwinIRConfig(scale=3), (40, 40)),
        ("swinir-direct", SwinIRConfig(scale=4, upsampler="pixelshuffledirect"), (32, 40)),
        ("swinir-nearest", SwinIRConfig(scale=4, upsampler="nearest+conv"), (32, 32)),
        ("swinir-denoise-3conv", SwinIRConfig(scale=1, upsampler="", resi_connection="3conv"),
         (32, 32)),
        ("hat-default", HATConfig(scale=4), (64, 64)),
        ("hat-chain-x2", HATConfig(scale=2, fused_reconstruct=False), (35, 35)),
        ("hat-ws8", HATConfig(scale=4, window_size=8), (64, 64)),
        ("dat-default", DATConfig(scale=4), (64, 64)),
        ("dat-direct", DATConfig(scale=2, upsampler="pixelshuffledirect"), (50, 70)),
        ("dat-chain", DATConfig(scale=4, fused_reconstruct=False), (32, 64)),
    ]


_CASES = _jax_configs()


@pytest.mark.parametrize("jcfg,hw", [c[1:] for c in _CASES], ids=[c[0] for c in _CASES])
def test_analytic_counts_equal_jax(jcfg, hw):
    from tpu_superresolution_tpu.utils.flops import model_flops as jax_flops
    from tpu_superresolution_torch.core.config import config_from_dict
    from tpu_superresolution_torch.utils.flops import model_flops

    cfg = config_from_dict(jcfg.to_dict())
    assert model_flops(cfg, *hw) == jax_flops(jcfg, *hw)


def _swinir_test_config():
    """The JAX test's config (tests/test_round3_misc.py::TestFlops)."""
    from tpu_superresolution_torch.core.config import SwinIRConfig

    return SwinIRConfig(scale=2, img_size=16, window_size=4, embed_dim=32, depths=(2, 2),
                        num_heads=(4, 4), upsampler="pixelshuffle", fused_reconstruct=False,
                        drop_path_rate=0.0)


def test_torch_flops_within_25pct_of_analytic():
    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.utils.flops import swinir_flops, torch_flops

    cfg = _swinir_test_config()
    counted = torch_flops(build_model(cfg), (1, 16, 16, 3))
    analytic = swinir_flops(cfg, 16, 16)
    assert counted > 0
    assert abs(analytic - counted) / counted < 0.25


@pytest.mark.parametrize("family", ["swinir", "hat", "dat"])
def test_torch_flops_scales_with_batch_and_allocates_nothing(family):
    """The count is linear in the batch, runs on the meta device (a
    model whose parameters are on the meta device counts too) and
    leaves the model it was given untouched."""
    from tpu_superresolution_torch.core.config import (
        DATConfig,
        HATConfig,
        build_model,
    )
    from tpu_superresolution_torch.utils.flops import torch_flops

    cfg = {"swinir": _swinir_test_config(),
           "hat": HATConfig(embed_dim=24, depths=(2,), num_heads=(2,), squeeze_factor=6,
                            scale=2),
           "dat": DATConfig(embed_dim=32, depths=(2,), num_heads=(2,), split_size=(4, 8),
                            num_feat=16, scale=2)}[family]
    with torch.device("meta"):
        model = build_model(cfg)
    one = torch_flops(model, (1, 16, 16, 3))
    assert one > 0 and torch_flops(model, (3, 16, 16, 3)) == 3 * one
    assert all(p.is_meta for p in model.parameters())


def test_torch_flops_matches_xla_for_msresunet():
    """MS_ResUNet x4 (the published geometry) on a 64 x 64 pre-upscaled
    input: FlopCounterMode's count of the port within 5% of XLA's cost
    analysis of the JAX model (the module docstring says why they
    differ)."""
    import jax
    import jax.numpy as jnp

    from tpu_superresolution_tpu.core.config import MSResUNetConfig as JaxConfig
    from tpu_superresolution_tpu.core.config import build_model as jax_build
    from tpu_superresolution_tpu.utils.flops import xla_flops
    from tpu_superresolution_torch.core.config import MSResUNetConfig, build_model
    from tpu_superresolution_torch.utils.flops import torch_flops

    jmodel = jax_build(JaxConfig(scale=4))
    x = jnp.zeros((1, 64, 64, 1), jnp.float32)
    variables = jax.eval_shape(lambda a: jmodel.init(jax.random.key(0), a, train=False), x)
    xla = xla_flops(lambda v, a: jmodel.apply(v, a, train=False), variables, x)
    with torch.device("meta"):
        model = build_model(MSResUNetConfig(scale=4))
    counted = torch_flops(model, (1, 64, 64, 1))
    assert abs(counted - xla) <= 0.05 * xla


def test_peak_and_mfu():
    from tpu_superresolution_torch.utils.flops import PEAK_BF16_FLOPS, mfu

    assert PEAK_BF16_FLOPS == 989.4e12
    assert mfu(PEAK_BF16_FLOPS, 1.0) == pytest.approx(1.0)
    assert mfu(1e12, 2.0, peak=1e12) == pytest.approx(0.5)


@pytest.mark.parametrize("name", ["ms_resunet", "unet2d"])
def test_model_flops_raises_for_the_conv_families(name):
    from tpu_superresolution_torch.core.config import MSResUNetConfig, UNet2DConfig
    from tpu_superresolution_torch.utils.flops import model_flops

    cfg = MSResUNetConfig() if name == "ms_resunet" else UNet2DConfig()
    with pytest.raises(ValueError, match="torch_flops"):
        model_flops(cfg, 64, 64)


def _evaluator(model, tile=None):
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.evaluate.runner import Evaluator

    ecfg = EvalConfig(batch_size=2, tile_size=tile, tile_overlap=4, max_tile_batch=4)
    return Evaluator(model, 4, "native_lr", ecfg, log=lambda m: None)


@pytest.mark.parametrize("tile", [None, 12])
def test_evaluator_counts_the_steady_batches(tile):
    """``Evaluator._add_mfu`` (run by ``Evaluator.run`` on a GPU): the
    count of the whole forward pipeline (tiling included) for each
    steady batch shape times its batches, over the steady seconds."""
    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model
    from tpu_superresolution_torch.evaluate.tiling import tiled_forward
    from tpu_superresolution_torch.utils.flops import PEAK_BF16_FLOPS, torch_flops

    model = build_model(SwinIRConfig(embed_dim=24, depths=(2,), num_heads=(2,)))
    ev = _evaluator(model, tile)
    results = {}
    ev._add_mfu(results, {(2, 20, 20, 3): 3, (1, 16, 16, 3): 2}, 0.5)

    def direct(m, x):
        return m(x) if tile is None else tiled_forward(m, x, 4, tile, 4, max_tile_batch=4)

    want = (3 * torch_flops(model, (2, 20, 20, 3), direct)
            + 2 * torch_flops(model, (1, 16, 16, 3), direct))
    assert results["flops"] == want
    assert results["mfu"] == pytest.approx(want / 0.5 / PEAK_BF16_FLOPS)
    if tile:  # the tiles, not the whole image, go through the model
        assert want != 3 * torch_flops(model, (2, 20, 20, 3)) + 2 * torch_flops(
            model, (1, 16, 16, 3))


def test_evaluator_says_why_when_the_count_fails():
    """A model the counter cannot rebuild (no config) leaves ``mfu`` out
    and says so in one line."""
    lines = []
    ev = _evaluator(torch.nn.Identity())
    ev = dataclasses.replace(ev, log=lines.append)
    results = {}
    ev._add_mfu(results, {(1, 8, 8, 3): 1}, 1.0)
    assert "mfu" not in results and "flops" not in results
    assert len(lines) == 1 and lines[0].startswith("[mfu] not reported: the FLOP count failed")
