"""Whole-SwinIR parity: the PyTorch port against the JAX package, same
weights (through the port's weight bridge), same input, fp32 on the CPU
(where every port kernel runs its plain version), bound 3e-5 max abs."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.util_torchport import (
    TOL,
    jax_forward,
    perturbed_jax_swinir,
    port_forward,
    port_from_jax,
    small_swinir_config,
)

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "overrides,hw",
    [
        # exact reference chain, erf GELU, window-multiple input
        (dict(), (16, 16)),
        # serving settings: composed reconstruction + tanh GELU, reflect pad
        (dict(fused_reconstruct=True, gelu_approximate=True), (20, 19)),
        (dict(upsampler="pixelshuffledirect", resi_connection="3conv"), (16, 24)),
        (dict(upsampler="nearest+conv"), (16, 16)),
        (dict(upsampler="", scale=1), (17, 16)),
        (dict(scale=3, fused_reconstruct=True), (16, 16)),
        # the JAX fused-block Pallas kernel (interpret mode) as the oracle
        (dict(attention_impl="fused", gelu_approximate=True), (16, 16)),
    ],
    ids=["exact", "fused-tanh-reflect", "direct-3conv", "nearest-conv", "denoise",
         "x3-fused", "jax-fused-block"],
)
def test_swinir_matches_jax(overrides, hw):
    cfg = small_swinir_config(**overrides)
    model, variables = perturbed_jax_swinir(cfg, hw)
    x = np.random.default_rng(1).random((2, hw[0], hw[1], 3), dtype=np.float32)
    want = jax_forward(model, variables, x)
    got = port_forward(port_from_jax(cfg, variables), x)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL


def test_bridge_equals_export_swinir_and_loads_strict():
    from tpu_superresolution_tpu.interop.torch_export import export_swinir
    from tpu_superresolution_torch.interop import swinir_state_dict_from_jax

    for cfg in (small_swinir_config(ape=True, img_size=16),
                small_swinir_config(resi_connection="3conv", upsampler="nearest+conv")):
        _, variables = perturbed_jax_swinir(cfg)
        ours = swinir_state_dict_from_jax(variables)
        ref = export_swinir(variables)
        assert sorted(ours) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
        port_from_jax(cfg, variables)  # strict load


def test_config_dicts_round_trip_between_packages():
    from tpu_superresolution_tpu.core.config import config_from_dict as jax_from_dict
    from tpu_superresolution_torch.core.config import SwinIRConfig, config_from_dict

    jcfg = small_swinir_config(upsampler="pixelshuffledirect", depths=(2, 4))
    tcfg = config_from_dict(jcfg.to_dict())
    assert tcfg.to_dict() == jcfg.to_dict()
    assert jax_from_dict(tcfg.to_dict()) == jcfg
    # defaults are SwinIR-M x4, as in the JAX package
    from tpu_superresolution_tpu.core.config import SwinIRConfig as JaxSwinIRConfig

    assert SwinIRConfig().to_dict() == JaxSwinIRConfig().to_dict()


def test_state_dict_keys_match_reference_layout():
    """Keys are the reference torch names; the shape-derived reference
    buffers are not part of the state dict."""
    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model

    sd = build_model(SwinIRConfig(embed_dim=24, depths=(2,), num_heads=(2,))).state_dict()
    for k in ("conv_first.weight", "patch_embed.norm.weight",
              "layers.0.residual_group.blocks.1.attn.relative_position_bias_table",
              "layers.0.residual_group.blocks.0.mlp.fc2.bias", "layers.0.conv.weight",
              "conv_after_body.weight", "conv_before_upsample.0.weight",
              "upsample.0.weight", "upsample.2.weight", "conv_last.bias"):
        assert k in sd, k
    assert not any(k.endswith(("relative_position_index", "attn_mask", "mean")) for k in sd)


def test_seeded_init_is_reproducible():
    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model

    cfg = SwinIRConfig(embed_dim=24, depths=(2,), num_heads=(2,))
    a, b = build_model(cfg), build_model(cfg)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    x = torch.rand(1, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(a(x), b(x))


def test_plain_impl_equals_auto_on_cpu():
    """impl="plain" and impl="auto" are the same computation on CPU
    tensors (auto dispatches to the plain versions there)."""
    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model

    cfg = SwinIRConfig(embed_dim=24, depths=(2,), num_heads=(2,))
    auto = build_model(cfg)
    plain = build_model(dataclasses.replace(cfg), impl="plain")
    plain.load_state_dict(auto.state_dict())
    x = torch.rand(1, 16, 24, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(auto(x), plain(x))
    with pytest.raises(ValueError):
        build_model(cfg, impl="fast")
