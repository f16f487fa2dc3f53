"""``interop.export`` of every family on the CPU against the JAX
package's own export: the same seeded weights (through the port's
weight bridges) and the same numpy input go through

- the port's exported and loaded ``.pt2`` program (the plain path),
  held to the eager port within 1e-5;
- the JAX package's exported and loaded StableHLO program
  (``tpu_superresolution_tpu.interop.export``), held to the port's
  loaded program within 3e-5 (fp32).

One case a family: SwinIR at ws 7 (the block kernel's K6 on the card),
SwinIR at ws 16 (the K7 route), HAT at ws 4 / ows 6 (as
``tests/test_parity_hat.py`` builds it), HAT at ws 16 / ows 24 (K7 and
K8w16 on the card), DAT (split (4, 8): the K9 / K14 / K10 fronts and
tails and the module chain on the card), MS_ResUNet and UNet2D (their
pre-upscaled single-channel input)."""

import numpy as np
import pytest
import torch

from tests.util_torchport import TOL, perturbed_jax_swinir, port_from_jax, small_swinir_config

torch.set_num_threads(2)

EAGER_TOL = 1e-5  # the loaded program against the eager port


def _hat_config(**kw):
    from tpu_superresolution_tpu.core.config import HATConfig

    base = dict(embed_dim=24, depths=(2, 2), num_heads=(4, 4), window_size=4,
                overlap_ratio=0.5, compress_ratio=3, squeeze_factor=6, conv_scale=0.3,
                num_feat=16, attention_impl="jnp", gelu_approximate=False,
                fused_reconstruct=False, scale=2)
    base.update(kw)
    return HATConfig(**base)


def _swin_family(cfg, hw):
    model, variables = perturbed_jax_swinir(cfg, hw)
    return model, variables, port_from_jax(cfg, variables)


def _dat():
    from tests.test_torch_dat import perturbed_jax_dat, port_dat, small_dat_config

    cfg = small_dat_config()
    model, variables = perturbed_jax_dat(cfg)
    return model, variables, port_dat(cfg, variables).eval()


def _msresunet():
    from tests.test_torch_msresunet import _jax_msresunet, _port

    cfg, model, variables = _jax_msresunet((1, 1, 1, 1), seed=2, hw=(24, 20))
    return model, variables, _port(cfg, variables).eval()


def _unet2d():
    from tests.test_torch_unet2d import _pair

    _, model, variables, port = _pair(0)
    return model, variables, port.eval()


# family -> (a function making (JAX model, variables, port model), input shape)
FAMILIES = {
    "swinir-ws7": (lambda: _swin_family(small_swinir_config(window_size=7), (14, 14)),
                   (1, 15, 20, 3)),
    "swinir-k7-ws16": (lambda: _swin_family(small_swinir_config(window_size=16), (16, 16)),
                       (1, 18, 24, 3)),
    "hat-ws4": (lambda: _swin_family(_hat_config(), (16, 16)), (1, 16, 16, 3)),
    "hat-ws16": (lambda: _swin_family(_hat_config(window_size=16, num_heads=(2, 2), scale=4,
                                                  fused_reconstruct=True), (16, 16)),
                 (1, 20, 18, 3)),
    "dat": (_dat, (1, 16, 24, 3)),
    "msresunet": (_msresunet, (1, 24, 20, 1)),
    "unet2d": (_unet2d, (2, 24, 16, 1)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_exported_program_matches_eager_and_the_jax_export(family):
    from tpu_superresolution_tpu.interop import export as jax_export
    from tpu_superresolution_torch.interop.export import export_model, load_exported

    build, shape = FAMILIES[family]
    jmodel, variables, port = build()
    x = np.random.default_rng(11).random(shape, dtype=np.float32)
    program = load_exported(export_model(port, shape))
    with torch.no_grad():
        got = program(torch.from_numpy(x)).numpy()
        eager = port(torch.from_numpy(x)).numpy()
    jax_program = jax_export.load_exported(jax_export.export_model(jmodel, variables, shape))
    want = np.asarray(jax_program(x), np.float32)
    assert got.shape == eager.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - eager).max() <= EAGER_TOL
    assert np.abs(got - want).max() <= TOL
