"""DAT x2 / x4 serving in the PyTorch port against the JAX package: the
same weights (seeded, perturbed params and BatchNorm running statistics,
through the port's ``dat_state_dict_from_jax``) and inputs, fp32 on the
CPU (where every port kernel runs its plain version), bound 3e-5 max
abs.  The oracles are the JAX module chain (its fused switches "off")
and the JAX fully fused forward (rect, shifted rect, channel and tail
kernels "on", interpret mode).  Embed 32, depths (2, 2), heads (2, 2),
split (4, 8): group 1's j = 0 block is shifted.  Also the config
inference and a reference-format .pth through the CLIs (DAT training is
``tests/test_torch_dat_train.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import TOL, jax_forward, port_forward

torch.set_num_threads(1)


@pytest.fixture
def jax_switches():
    """Set the JAX package's DAT kernel switches; restored afterwards."""
    from tpu_superresolution_tpu.ops.pallas import fused_channel_attn as fc
    from tpu_superresolution_tpu.ops.pallas import fused_datb_tail as ft
    from tpu_superresolution_tpu.ops.pallas import fused_rect_attn as fr

    old = ft.FUSED_TAIL, fr.FUSED_RECT, fr.FUSED_RECT_SHIFTED, fc.FUSED_CHAN

    def set_all(value):
        ft.FUSED_TAIL = fr.FUSED_RECT = fr.FUSED_RECT_SHIFTED = fc.FUSED_CHAN = value

    set_all("off")
    yield set_all
    ft.FUSED_TAIL, fr.FUSED_RECT, fr.FUSED_RECT_SHIFTED, fc.FUSED_CHAN = old


def small_dat_config(**kw):
    from tpu_superresolution_tpu.core.config import DATConfig

    base = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 2), split_size=(4, 8), num_feat=16,
                scale=2, upsampler="pixelshuffledirect", fused_reconstruct=False,
                drop_path_rate=0.0)
    base.update(kw)
    return DATConfig(**base)


def _random_leaf(path, shape, rng):
    names = [str(getattr(p, "key", p)) for p in path]
    n = rng.standard_normal(shape).astype(np.float32)
    if names[0] == "batch_stats":
        return 0.3 * n if names[-1] == "mean" else (0.5 + rng.random(shape)).astype(np.float32)
    if names[-1] == "kernel":  # variance-preserving
        return n / np.sqrt(np.prod(shape[:-1]))
    if names[-1] in ("scale", "temperature"):
        return 1.0 + 0.3 * n
    return 0.05 * n


def perturbed_jax_dat(cfg, seed=0):
    """The JAX DAT for `cfg` and seeded random variables (params and
    batch_stats) of the tree `init` builds, as numpy leaves."""
    from tpu_superresolution_tpu.core.config import build_model

    model = build_model(cfg)
    x = jax.ShapeDtypeStruct((1, 16, 32, cfg.in_channels), jnp.float32)
    shapes = jax.eval_shape(lambda x: model.init(jax.random.key(0), x, train=False), x)
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: _random_leaf(p, s.shape, rng), shapes)
    return model, jax.tree_util.tree_map(np.asarray, variables)


def port_dat(cfg, variables, impl="auto"):
    from tpu_superresolution_torch.core.config import build_model, config_from_dict
    from tpu_superresolution_torch.interop import dat_state_dict_from_jax

    model = build_model(config_from_dict(cfg.to_dict()), impl=impl)
    sd = dat_state_dict_from_jax(variables)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                          strict=True)
    return model


_CASES = [
    (dict(), "x2 direct"),
    (dict(scale=4, upsampler="pixelshuffle"), "x4 chain"),
    (dict(scale=4, upsampler="pixelshuffle", fused_reconstruct=True), "x4 composed"),
]


@pytest.mark.parametrize("overrides,label", _CASES, ids=[c[1] for c in _CASES])
def test_dat_matches_jax_module_chain_and_fused(overrides, label, jax_switches):
    """The port against the JAX module chain and the JAX fully fused
    forward (nine Pallas calls more: K9 x2 with the shifted block's two,
    K14 x2, K10 x4) on [2, 16, 32]."""
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    cfg = small_dat_config(**overrides)
    model, variables = perturbed_jax_dat(cfg)
    x = np.random.default_rng(1).random((2, 16, 32, 3), dtype=np.float32)
    chain = jax_forward(model, variables, x)
    n_chain = str(jax.make_jaxpr(lambda v, x: model.apply(v, x, train=False))(
        variables, x)).count("pallas_call")
    jax_switches("on")
    fused = jax_forward(model, variables, x)
    n_fused = str(jax.make_jaxpr(lambda v, x: model.apply(v, x, train=False))(
        variables, x)).count("pallas_call")
    assert n_fused - n_chain == 9
    reset_counters()
    got = port_forward(port_dat(cfg, variables), x)
    assert not any(read_counters().values())
    s = cfg.scale
    assert got.shape == chain.shape == fused.shape == (2, 16 * s, 32 * s, 3)
    assert np.isfinite(got).all()
    assert np.abs(got - chain).max() <= TOL
    assert np.abs(got - fused).max() <= TOL


@pytest.mark.parametrize("overrides,hw", [(dict(), (20, 28)),
                                          (dict(scale=4, upsampler="pixelshuffle"), (13, 19))],
                         ids=["x2-20x28", "x4-13x19"])
def test_dat_non_multiple_size_matches_module_chain(overrides, hw, jax_switches):
    """Sizes that are not multiples of the split: q, k, v zero-padded
    after the projection, pad tokens real keys, the shift mask built at
    the padded size (dat_arch.py:376-385); the plain impl equals auto."""
    cfg = small_dat_config(**overrides)
    model, variables = perturbed_jax_dat(cfg, seed=2)
    x = np.random.default_rng(3).random((1, *hw, 3), dtype=np.float32)
    want = jax_forward(model, variables, x)
    got = port_forward(port_dat(cfg, variables), x)
    assert got.shape == want.shape == (1, hw[0] * cfg.scale, hw[1] * cfg.scale, 3)
    assert np.abs(got - want).max() <= TOL
    plain = port_forward(port_dat(cfg, variables, impl="plain"), x)
    np.testing.assert_array_equal(plain, got)


def test_dat_shift_rule_and_block_types():
    """Spatial blocks at even j, channel blocks at odd j; shifted: group
    i even at j = 2, 6; i odd at j = 0, 4 (the JAX package's DATB)."""
    from tpu_superresolution_torch.core.config import DATConfig, build_model

    model = build_model(DATConfig(embed_dim=32, depths=(6, 6), num_heads=(2, 2),
                                  split_size=(4, 8)))
    kinds = [[(b.spatial, b.shifted) for b in layer.blocks] for layer in model.layers]
    assert kinds[0] == [(True, False), (False, False), (True, True), (False, False),
                        (True, False), (False, False)]
    assert kinds[1] == [(True, True), (False, False), (True, False), (False, False),
                        (True, True), (False, False)]


def test_dat_bridge_equals_export_dat_and_infers_the_config(tmp_path):
    """dat_state_dict_from_jax equals the JAX package's export_dat key for
    key; infer_dat_config on it equals the JAX package's; a reference
    .pth with DAT's buffers (rpe_biases, relative_position_index,
    attn_mask_0/1) loads strict through the upscale loader and matches
    the JAX module chain; without a GPU the loader raises unless asked
    for the CPU."""
    from tpu_superresolution_tpu.core.config import build_model as jax_build
    from tpu_superresolution_tpu.interop.torch_convert import infer_dat_config as jax_infer
    from tpu_superresolution_tpu.interop.torch_export import export_dat
    from tpu_superresolution_torch.cli.upscale import load_any_checkpoint
    from tpu_superresolution_torch.interop import dat_state_dict_from_jax, infer_dat_config

    cfg = small_dat_config(scale=4, upsampler="pixelshuffle", split_size=(8, 16),
                           fused_reconstruct=True)
    jmodel, variables = perturbed_jax_dat(cfg, seed=4)
    ours = dat_state_dict_from_jax(variables)
    ref = export_dat(variables)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    inferred = infer_dat_config(ours, 4)
    assert inferred.to_dict() == jax_infer(ref, 4).to_dict()
    assert inferred.split_size == (8, 16) and inferred.num_heads == (2, 2)

    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ours.items()}
    for blk in ("layers.0.blocks.0", "layers.1.blocks.0"):
        for idx, (hsp, wsp) in enumerate(((8, 16), (16, 8))):
            sd[f"{blk}.attn.attns.{idx}.rpe_biases"] = torch.zeros((2 * hsp - 1) * (2 * wsp - 1), 2)
            sd[f"{blk}.attn.attns.{idx}.relative_position_index"] = torch.zeros(128, 128,
                                                                               dtype=torch.int64)
    sd["layers.1.blocks.0.attn.attn_mask_0"] = torch.zeros(8, 128, 128)
    sd["layers.1.blocks.0.attn.attn_mask_1"] = torch.zeros(8, 128, 128)
    path = str(tmp_path / "dat_x4.pth")
    torch.save({"params": sd}, path)
    mcfg, model = load_any_checkpoint(path, "dat", 4, exact=True, device=torch.device("cpu"))
    assert mcfg.name == "dat" and not mcfg.fused_reconstruct
    x = np.random.default_rng(5).random((1, 16, 16, 3), dtype=np.float32)
    want = jax_forward(jax_build(dataclasses.replace(cfg, fused_reconstruct=False)), variables, x)
    assert np.abs(port_forward(model, x) - want).max() <= TOL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_any_checkpoint(path, "dat", 4)


def test_dat_serve_and_upscale_cli_on_cpu(tmp_path):
    """upscale --model dat and the serve service on a tiny .pth with
    --device cpu (whole image and tiled); without --device the entry
    points raise on a machine with no GPU."""
    from PIL import Image

    from tpu_superresolution_torch.cli.serve import SRService
    from tpu_superresolution_torch.cli.upscale import main as upscale_main
    from tpu_superresolution_torch.core.config import DATConfig, build_model

    model = build_model(DATConfig(embed_dim=32, depths=(2,), num_heads=(2,), split_size=(4, 8),
                                  num_feat=16))
    model.reset_parameters(torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "dat.pth")
    torch.save({"params": model.state_dict()}, ckpt)
    img = (np.random.default_rng(6).random((18, 22, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    outs = upscale_main(["--image", str(tmp_path / "a.png"), "--ckpt", ckpt, "--model", "dat",
                         "--scale", "X4", "--device", "cpu", "--tile", "16", "--tile_overlap",
                         "4"])
    with Image.open(outs[0]) as im:
        assert im.size == (88, 72)
    buf = (tmp_path / "a.png").read_bytes()
    svc = SRService(ckpt, "dat", "X4", None, -1, 16, 8, device="cpu")
    png, meta = svc.serve(buf)
    assert meta["out_shape"] == [72, 88] and meta["tile"] == 0
    png, meta = svc.serve(buf, tile=16, overlap=4)
    assert meta["tile"] == 16 and png[:4] == b"\x89PNG"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            upscale_main(["--image", str(tmp_path / "a.png"), "--ckpt", ckpt, "--model", "dat",
                          "--scale", "X4"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SRService(ckpt, "dat", "X4", None, -1, 16, 8)
