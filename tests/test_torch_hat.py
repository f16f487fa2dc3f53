"""HAT x4 serving in the PyTorch port against the JAX package: same
weights (through the port's HAT weight bridge) and inputs, fp32 on the
CPU (where every port kernel runs its plain version), bound 3e-5 max
abs.  The oracles are the JAX module path and the JAX block kernels in
interpret mode (K6 at ws 7, K1 with `extra` at ws 8); the checkpoint
path, config inference, the OCAB gather and the configs besides."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import (
    TOL,
    jax_forward,
    perturbed_jax_swinir,
    port_forward,
    port_from_jax,
)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def small_hat_config(**kw):
    """A JAX HATConfig at test size (embed 24, depths (2, 2), ws 7); the
    conv branch weighted 0.3 so that `extra` moves the output."""
    from tpu_superresolution_tpu.core.config import HATConfig

    base = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window_size=7, num_feat=16,
                squeeze_factor=6, conv_scale=0.3, attention_impl="jnp",
                gelu_approximate=False, fused_reconstruct=False, scale=4)
    base.update(kw)
    return HATConfig(**base)


_HAT_CASES = [
    # ws 7, exact: erf GELU, chain reconstruction, input not a multiple of 7
    (dict(), (13, 16)),
    # hat_fast's window through the module path
    (dict(window_size=8), (12, 17)),
    # the JAX block kernels in interpret mode: K6 (ws 7) and K1 + extra (ws 8)
    (dict(attention_impl="fused", gelu_approximate=True), (14, 15)),
    (dict(attention_impl="fused", window_size=8), (16, 16)),
    # serving settings: composed reconstruction + tanh GELU
    (dict(fused_reconstruct=True, gelu_approximate=True), (15, 14)),
]


@pytest.mark.parametrize("overrides,hw", _HAT_CASES,
                         ids=["exact-ws7", "ws8", "jax-K6", "jax-K1-extra", "composed-tanh"])
def test_hat_matches_jax(overrides, hw):
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    cfg = small_hat_config(**overrides)
    model, variables = perturbed_jax_swinir(cfg, (14, 14))
    x = np.random.default_rng(3).random((2, hw[0], hw[1], 3), dtype=np.float32)
    want = jax_forward(model, variables, x)
    reset_counters()
    got = port_forward(port_from_jax(cfg, variables), x)
    assert not any(read_counters().values())
    assert got.shape == want.shape == (2, 4 * hw[0], 4 * hw[1], 3)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL


def test_hat_bridge_equals_export_hat_and_infers_the_config(tmp_path):
    """hat_state_dict_from_jax equals the JAX package's export_hat key for
    key; infer_hat_config on it equals the JAX package's; a reference
    .pth with HAT's index buffers loads through the upscale loader, and
    --exact there matches the JAX model at erf GELU and chain
    reconstruction."""
    from tpu_superresolution_tpu.interop.torch_convert import infer_hat_config as jax_infer
    from tpu_superresolution_tpu.interop.torch_export import export_hat
    from tpu_superresolution_torch.cli.upscale import load_any_checkpoint
    from tpu_superresolution_torch.interop import hat_state_dict_from_jax, infer_hat_config

    cfg = small_hat_config(gelu_approximate=True, fused_reconstruct=True)
    _, variables = perturbed_jax_swinir(cfg, (14, 14))
    ours = hat_state_dict_from_jax(variables)
    ref = export_hat(variables)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
    inferred = infer_hat_config(ours, 4)
    assert inferred.to_dict() == jax_infer(ref, 4).to_dict()
    # the overlap ratio comes back as ows / ws - 1 = 3/7, which gives the same ows
    assert (inferred.window_size, inferred.squeeze_factor) == (7, 6)
    assert int(inferred.overlap_ratio * 7) + 7 == int(cfg.overlap_ratio * 7) + 7 == 10

    sd = {k: _t(v) for k, v in ours.items()}
    sd["relative_position_index_SA"] = torch.zeros(49, 49, dtype=torch.int64)
    sd["relative_position_index_OCA"] = torch.zeros(49, 100, dtype=torch.int64)
    path = str(tmp_path / "hat_x4.pth")
    torch.save({"params_ema": sd}, path)
    mcfg, model = load_any_checkpoint(path, "hat", 4, exact=True, device=torch.device("cpu"))
    assert mcfg.name == "hat" and not mcfg.gelu_approximate and not mcfg.fused_reconstruct
    # a checkpoint does not carry conv_scale: the reference's 0.01
    assert mcfg.conv_scale == 0.01
    exact_cfg = dataclasses.replace(cfg, gelu_approximate=False, fused_reconstruct=False,
                                    conv_scale=0.01)
    jmodel, _ = perturbed_jax_swinir(exact_cfg, (14, 14))
    x = np.random.default_rng(4).random((1, 10, 11, 3), dtype=np.float32)
    want = jax_forward(jmodel, variables, x)
    assert np.abs(port_forward(model, x) - want).max() <= TOL
    if not torch.cuda.is_available():  # no GPU and no --device cpu: the loader raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_any_checkpoint(path, "hat", 4)


def test_overlap_windows_and_oca_index_match_jax():
    """The overlapping k/v gather, at an odd ows - ws (7 -> 10) and an
    even one (8 -> 12), and OCAB's relative-position index."""
    from tpu_superresolution_tpu.models.hat import _overlap_windows
    from tpu_superresolution_tpu.ops.window import relative_position_index_oca as jax_rpi
    from tpu_superresolution_torch.ops.window import overlap_windows, relative_position_index_oca

    rng = np.random.default_rng(5)
    for ws, ows, h, w in ((7, 10, 14, 21), (8, 12, 16, 24), (4, 6, 8, 8)):
        x = rng.standard_normal((2, h, w, 5)).astype(np.float32)
        got = overlap_windows(_t(x), ws, ows).numpy()
        want = np.asarray(_overlap_windows(jnp.asarray(x), ws, ows))
        assert got.shape == (2 * (h // ws) * (w // ws), ows * ows, 5)
        np.testing.assert_array_equal(got, want.reshape(got.shape))
        np.testing.assert_array_equal(relative_position_index_oca(ws, ows), jax_rpi(ws, ows))


def test_hat_config_dicts_round_trip_between_packages():
    from tpu_superresolution_tpu.core.config import HATConfig as JaxHAT
    from tpu_superresolution_tpu.core.config import HATFastConfig as JaxHATFast
    from tpu_superresolution_tpu.core.config import config_from_dict as jax_from_dict
    from tpu_superresolution_torch.core.config import (
        HATConfig,
        HATFastConfig,
        build_model,
        config_from_dict,
    )

    assert HATConfig().to_dict() == JaxHAT().to_dict()
    assert HATFastConfig().to_dict() == JaxHATFast().to_dict()
    for jcfg in (small_hat_config(depths=(2, 4)), JaxHATFast(embed_dim=48)):
        tcfg = config_from_dict(jcfg.to_dict())
        assert tcfg.to_dict() == jcfg.to_dict()
        assert jax_from_dict(tcfg.to_dict()) == jcfg
    assert build_model(HATFastConfig(embed_dim=24, depths=(2,), num_heads=(2,),
                                     squeeze_factor=6)).config.window_size == 8


def test_hat_state_dict_keys_and_seeded_init():
    from tpu_superresolution_torch.core.config import HATConfig, build_model

    cfg = HATConfig(embed_dim=24, depths=(2,), num_heads=(2,), squeeze_factor=6, num_feat=16)
    a, b = build_model(cfg), build_model(cfg)
    sd = a.state_dict()
    for k in ("conv_first.weight", "patch_embed.norm.weight",
              "layers.0.residual_group.blocks.1.attn.relative_position_bias_table",
              "layers.0.residual_group.blocks.0.conv_block.cab.3.attention.3.bias",
              "layers.0.residual_group.overlap_attn.relative_position_bias_table",
              "layers.0.residual_group.overlap_attn.mlp.fc2.weight", "layers.0.conv.weight",
              "conv_after_body.weight", "conv_before_upsample.0.weight", "upsample.2.weight",
              "conv_last.bias"):
        assert k in sd, k
    assert sd["layers.0.residual_group.overlap_attn.relative_position_bias_table"].shape == (
        (7 + 10 - 1) ** 2, 2)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    table = a.layers[0].residual_group.overlap_attn.relative_position_bias_table
    assert 0 < float(table.detach().std()) < 0.05  # trunc-normal(0.02), not zeros


def test_hat_refuses_training_mode():
    """Training mode runs (stochastic depth, the OCAB's fused route
    through K8's wrapper) and gives every parameter a gradient, and
    eval() goes back to serving's path: no K8, the same output as before
    training mode, no kernel on the CPU.  (The name predates HAT
    training.)"""
    from tpu_superresolution_torch.core.config import HATConfig, build_model
    from tpu_superresolution_torch.kernels import fused_ocab, read_counters, reset_counters

    model = build_model(HATConfig(embed_dim=24, depths=(2,), num_heads=(2,), squeeze_factor=6))
    x = torch.rand(1, 7, 7, 3)
    with torch.no_grad():
        served = model(x)
    calls = []
    real = fused_ocab.ocab_core_plain
    reset_counters()
    try:
        fused_ocab.ocab_core_plain = lambda *a: calls.append(1) or real(*a)
        model.train()
        model(x, generator=torch.Generator().manual_seed(0)).mean().backward()
        assert calls == [1]  # one OCAB, through K8's wrapper
        assert all(p.grad is not None for p in model.parameters())
        model.eval()
        with torch.no_grad():
            again = model(x)
        assert calls == [1]  # serving keeps the module path
    finally:
        fused_ocab.ocab_core_plain = real
    assert torch.equal(again, served)
    assert not any(read_counters().values())


@pytest.mark.parametrize("impl", ["jnp", "fused"])
def test_hat_ws16_matches_jax(impl):
    """HAT at upstream HAT-SRx4's window 16 (embed 24, depths (2, 2)):
    every HAB takes the K7 route and every CAB K12's function, against
    the JAX module path (jnp) and its fused path (K1 at ws 16 in
    interpret mode), on an input whose sides are not multiples of 16."""
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.fused_block import block_route

    cfg = small_hat_config(window_size=16, attention_impl=impl, gelu_approximate=impl == "fused")
    model, variables = perturbed_jax_swinir(cfg, (16, 16))
    x = np.random.default_rng(8).random((1, 20, 37, 3), dtype=np.float32)
    want = jax_forward(model, variables, x)
    port = port_from_jax(cfg, variables)
    assert block_route(16, 24, 2, 96) == "window_attention"
    assert port.layers[0].residual_group.overlap_attn.overlap_win_size == 24
    reset_counters()
    got = port_forward(port, x)
    assert not any(read_counters().values())
    assert got.shape == want.shape == (1, 80, 148, 3)
    assert np.abs(got - want).max() <= TOL


def _ws16_reference_pth(tmp_path):
    """A reference-format HAT .pth at window 16 (with hat_arch.py's index
    buffers), from the port's seeded random weights."""
    from tpu_superresolution_torch.core.config import HATConfig, build_model

    cfg = HATConfig(embed_dim=24, depths=(2,), num_heads=(2,), window_size=16, squeeze_factor=6,
                    num_feat=16, mlp_ratio=2.0)
    model = build_model(cfg)
    model.reset_parameters(torch.Generator().manual_seed(9))
    sd = dict(model.state_dict())
    sd["relative_position_index_SA"] = torch.zeros(256, 256, dtype=torch.int64)
    sd["relative_position_index_OCA"] = torch.zeros(256, 576, dtype=torch.int64)
    path = str(tmp_path / "hat_ws16_x4.pth")
    torch.save({"params_ema": sd}, path)
    return cfg, model, path


def test_hat_ws16_checkpoint_infers_the_config_and_upscales_on_cpu(tmp_path):
    """infer_hat_config reads window 16, ows 24 and mlp_ratio 2 from a
    ws-16 reference .pth; the upscale CLI serves it with --device cpu,
    whole image and tiled, and matches the model it came from."""
    from PIL import Image

    from tpu_superresolution_torch.cli.upscale import load_any_checkpoint
    from tpu_superresolution_torch.cli.upscale import main as upscale_main

    cfg, model, path = _ws16_reference_pth(tmp_path)
    mcfg, loaded = load_any_checkpoint(path, "hat", 4, exact=True, device=torch.device("cpu"))
    assert (mcfg.window_size, mcfg.embed_dim, mcfg.mlp_ratio) == (16, 24, 2.0)
    assert int(mcfg.overlap_ratio * 16) + 16 == 24
    x = torch.rand(1, 18, 22, 3, generator=torch.Generator().manual_seed(10))
    ref = build_exact(cfg)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert (loaded(x) - ref(x)).abs().max() <= TOL
    img = (np.random.default_rng(11).random((18, 22, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    for extra in ([], ["--tile", "16", "--tile_overlap", "4"]):
        outs = upscale_main(["--image", str(tmp_path / "a.png"), "--ckpt", path, "--model",
                             "hat", "--scale", "X4", "--device", "cpu"] + extra)
        with Image.open(outs[0]) as im:
            assert im.size == (88, 72)


def build_exact(cfg):
    from tpu_superresolution_torch.core.config import build_model

    return build_model(dataclasses.replace(cfg, gelu_approximate=False, fused_reconstruct=False,
                                           conv_scale=0.01))


def test_hat_ws16_training_runs_on_cpu_and_names_the_k8_item():
    """At window 16 HAT trains on the CPU (the K7 route and K12 are
    differentiable), and K8's window envelope, which the OCAB's training
    route meets on CUDA, refuses ws 16 naming the ROADMAP item."""
    from tpu_superresolution_torch.core.config import HATConfig, build_model
    from tpu_superresolution_torch.kernels.fused_ocab import OcabWeights, check_ocab_args

    model = build_model(HATConfig(embed_dim=24, depths=(2,), num_heads=(2,), window_size=16,
                                  squeeze_factor=6))
    model.train()
    model(torch.rand(1, 16, 16, 3), generator=torch.Generator().manual_seed(0)).mean().backward()
    assert all(p.grad is not None for p in model.parameters())
    ocab = model.layers[0].residual_group.overlap_attn
    weights = OcabWeights(
        wproj=ocab.proj.weight, bproj=ocab.proj.bias, g2=ocab.norm2.weight, b2=ocab.norm2.bias,
        wfc1=ocab.mlp.fc1.weight, bfc1=ocab.mlp.fc1.bias, wfc2=ocab.mlp.fc2.weight,
        bfc2=ocab.mlp.fc2.bias, num_heads=2)
    with pytest.raises(ValueError, match="K8 and the block backward at ws 16, for HAT-SRx4 "
                                         "training"):
        check_ocab_args((4, 256, 24), (4, 576, 24), (4, 256, 24), weights, (2, 256, 576))
