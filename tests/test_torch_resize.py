"""The port's PIL-parity resize (``ops/resize.py``) and the bicubic
pre-upscale against the JAX package's functions and against PIL on the
same numpy inputs, in fp32: max abs <= 3e-5."""

import numpy as np
import pytest
import torch
from PIL import Image

from tests.util_torchport import TOL

torch.set_num_threads(1)

CASES = [
    ((64, 64), (128, 128)),  # x2 up
    ((50, 70), (200, 280)),  # x4 up, non-square
    ((128, 128), (64, 64)),  # x2 down (the antialias path)
    ((200, 120), (50, 30)),  # x4 down
    ((37, 53), (91, 113)),  # odd, fractional
]


def _pil_resize(arr01, out_w, out_h, method):
    im = Image.fromarray(arr01.astype(np.float32), mode="F")
    resample = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}[method]
    return np.asarray(im.resize((out_w, out_h), resample=resample), dtype=np.float32)


def _both(name, x, *args, **kw):
    """(port, JAX) results of the function `name` of ops/resize.py on x."""
    import jax.numpy as jnp

    from tpu_superresolution_tpu.ops import resize as jr
    from tpu_superresolution_torch.ops import resize as tr

    got = getattr(tr, name)(torch.from_numpy(x), *args, **kw).numpy()
    want = np.asarray(getattr(jr, name)(jnp.asarray(x), *args, **kw), np.float32)
    return got, want


@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("in_hw,out_hw", CASES)
def test_resize_matches_jax(method, antialias, in_hw, out_hw, rng):
    x = rng.random((2, *in_hw, 3), dtype=np.float32)
    got, want = _both(f"resize_{method}", x, *out_hw, antialias=antialias)
    assert got.shape == (2, *out_hw, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("in_hw,out_hw", CASES)
def test_resize_matches_pil(method, in_hw, out_hw, rng):
    from tpu_superresolution_torch.ops.resize import resize

    img = rng.random(in_hw, dtype=np.float32)
    got = resize(torch.from_numpy(img[..., None]), *out_hw, method)[..., 0].numpy()
    ref = _pil_resize(img, out_hw[1], out_hw[0], method)
    assert np.abs(got - ref).max() <= TOL


@pytest.mark.parametrize("scale", [2, 4])
def test_upscale_and_degrade_match_jax(scale, rng):
    lr = rng.random((2, 25, 31, 1), dtype=np.float32)
    got, want = _both("upscale_lr_to_hr", lr, scale)
    assert got.shape == (2, 25 * scale, 31 * scale, 1)
    assert np.abs(got - want).max() <= TOL
    hr = rng.random((3, 64, 48, 3), dtype=np.float32)
    got, want = _both("degrade_hr_to_lr", hr, scale)
    assert got.shape == (3, 64 // scale, 48 // scale, 3)
    assert np.abs(got - want).max() <= TOL


def test_pre_upscale_batch_matches_jax(rng):
    import jax.numpy as jnp

    from tpu_superresolution_tpu.data.transforms import pre_upscale_batch as jax_pre
    from tpu_superresolution_torch.data.transforms import pre_upscale_batch

    lr = rng.random((2, 20, 28, 3), dtype=np.float32)
    got = pre_upscale_batch(torch.from_numpy(lr), 4).numpy()
    assert got.shape == (2, 80, 112, 3)
    assert np.abs(got - np.asarray(jax_pre(jnp.asarray(lr), 4))).max() <= TOL


def test_identity_dtype_and_batch_rules(rng):
    from tpu_superresolution_torch.ops.resize import _resize_matrix, resize_bicubic

    img = torch.from_numpy(rng.random((3, 32, 32, 2), dtype=np.float32))
    assert torch.equal(resize_bicubic(img, 32, 32), img)  # no resize: the input back
    # a floating input comes back in its dtype, computed in fp32
    half = resize_bicubic(img.to(torch.bfloat16), 64, 48)
    assert half.dtype == torch.bfloat16
    full = resize_bicubic(img.to(torch.bfloat16).float(), 64, 48)
    assert torch.equal(half, full.to(torch.bfloat16))
    # an integer input comes back fp32
    u8 = resize_bicubic((img * 255).to(torch.uint8), 64, 48)
    assert u8.dtype == torch.float32
    # batched multichannel == per image, per channel
    out = resize_bicubic(img, 80, 72)
    for b in range(3):
        for c in range(2):
            single = resize_bicubic(img[b, :, :, c : c + 1], 80, 72)[..., 0]
            assert torch.allclose(out[b, :, :, c], single, rtol=0, atol=1e-6)
    # the weight cache holds numpy, row-stochastic
    w = _resize_matrix(32, 80, "bicubic", True)
    assert isinstance(w, np.ndarray) and np.allclose(w.sum(1), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="expected"):
        resize_bicubic(img[0, :, :, 0], 4, 4)
