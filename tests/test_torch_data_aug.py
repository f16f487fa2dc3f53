"""The port's paired augmentation against the JAX package's
(``data/transforms.py``) on the same numpy inputs, the random draws
handed to both (the port draws from a ``torch.Generator``, the JAX
package from ``jax.random``; each random function has an ``_at`` form):

- the pre-upscale crop at the same offsets and the flips at the same
  coin flips: exact;
- the gaussian blur at one sigma: within 1e-6; the paired blur at the
  same per-image decisions: within 1e-6;
- normalize / denormalize: exact; ``dataset_mean_std``: within 1e-6
  relative;
- the whole pre-upscale train batch (upscale -> crop -> flips -> blur)
  with the draws the port's generator made, replayed on the JAX side:
  within 3e-5 (the resize's fp32 products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_fakedata import make_deeprock_dataset

torch.set_num_threads(2)


def _pair(rng, b=3, h=20, w=18, c=1):
    return (rng.random((b, h, w, c), dtype=np.float32), rng.random((b, h, w, c), dtype=np.float32))


def test_crop_and_flips_at_the_same_draws_are_exact(rng):
    from tpu_superresolution_tpu.data.transforms import _crop_one
    from tpu_superresolution_torch.data.transforms import crop_at, flip_at

    lr, hr = _pair(rng)
    tops, lefts = [0, 5, 9], [3, 0, 7]
    a, b = crop_at(torch.from_numpy(lr), torch.from_numpy(hr), tops, lefts, 11, 10)
    for i, (t, l) in enumerate(zip(tops, lefts)):
        np.testing.assert_array_equal(a[i].numpy(), np.asarray(_crop_one(lr[i], t, l, 11, 10)))
        np.testing.assert_array_equal(b[i].numpy(), np.asarray(_crop_one(hr[i], t, l, 11, 10)))
    do_h, do_v = [True, False, True], [False, True, True]
    got = flip_at(torch.from_numpy(lr), do_h, do_v).numpy()
    dh = np.asarray(do_h).reshape(-1, 1, 1, 1)
    want = np.where(np.asarray(do_v).reshape(-1, 1, 1, 1),
                    np.where(dh, lr[:, :, ::-1], lr)[:, ::-1], np.where(dh, lr[:, :, ::-1], lr))
    np.testing.assert_array_equal(got, want)


def test_random_crop_covering_patch_draws_nothing(rng):
    from tpu_superresolution_torch.data.transforms import paired_random_crop

    lr, hr = _pair(rng)
    g = torch.Generator().manual_seed(0)
    a, b = paired_random_crop(torch.from_numpy(lr), torch.from_numpy(hr), 64, g)
    assert torch.equal(a, torch.from_numpy(lr)) and torch.equal(b, torch.from_numpy(hr))
    assert torch.equal(g.get_state(), torch.Generator().manual_seed(0).get_state())
    a, b = paired_random_crop(torch.from_numpy(lr), torch.from_numpy(hr), 8, g)
    assert a.shape == b.shape == (3, 8, 8, 1)


@pytest.mark.parametrize("sigma", [0.1, 0.7, 2.0])
@pytest.mark.parametrize("c", [1, 3])
def test_gaussian_blur_matches_jax(rng, sigma, c):
    from tpu_superresolution_tpu.data.transforms import gaussian_blur as jax_blur
    from tpu_superresolution_torch.data.transforms import gaussian_blur

    x = rng.random((2, 13, 17, c), dtype=np.float32)
    want = np.asarray(jax_blur(jnp.asarray(x), jnp.float32(sigma)))
    got = gaussian_blur(torch.from_numpy(x), sigma).numpy()
    assert got.shape == x.shape
    assert np.abs(got - want).max() <= 1e-6


def test_paired_blur_at_the_same_decisions(rng):
    from tpu_superresolution_tpu.data.transforms import gaussian_blur as jax_blur
    from tpu_superresolution_torch.data.transforms import paired_blur_at, paired_random_blur

    lr, hr = _pair(rng, b=4)
    do, sigma = [True, False, False, True], 1.3
    a, b = paired_blur_at(torch.from_numpy(lr), torch.from_numpy(hr), do, sigma)
    m = np.asarray(do).reshape(-1, 1, 1, 1)
    for got, x in ((a, lr), (b, hr)):  # the JAX paired_random_blur's where
        want = np.where(m, np.asarray(jax_blur(jnp.asarray(x), jnp.float32(sigma))), x)
        assert np.abs(got.numpy() - want).max() <= 1e-6
    # the random form: one sigma for the batch, p = 0.5 per image, the
    # same decision for both members, reproducible from the generator
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    r1 = paired_random_blur(torch.from_numpy(lr), torch.from_numpy(hr), g1)
    r2 = paired_random_blur(torch.from_numpy(lr), torch.from_numpy(hr), g2)
    assert torch.equal(r1[0], r2[0]) and torch.equal(r1[1], r2[1])
    changed_lr = [not torch.equal(r1[0][i], torch.from_numpy(lr[i])) for i in range(4)]
    changed_hr = [not torch.equal(r1[1][i], torch.from_numpy(hr[i])) for i in range(4)]
    assert changed_lr == changed_hr


def test_normalize_and_dataset_stats(tmp_path, rng):
    from tpu_superresolution_tpu.data import Loader as JaxLoader
    from tpu_superresolution_tpu.data import PairedIndex as JaxIndex
    from tpu_superresolution_tpu.data.transforms import dataset_mean_std as jax_stats
    from tpu_superresolution_tpu.data.transforms import normalize as jax_norm
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.loader import Loader
    from tpu_superresolution_torch.data.transforms import dataset_mean_std, denormalize, normalize

    x = rng.random((2, 5, 6, 1), dtype=np.float32)
    got = normalize(torch.from_numpy(x), 0.45161797, 0.20893379).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_norm(jnp.asarray(x), 0.45161797,
                                                           0.20893379)))
    back = denormalize(torch.from_numpy(got), 0.45161797, 0.20893379).numpy()
    assert np.abs(back - x).max() <= 1e-6
    root = make_deeprock_dataset(tmp_path, splits=("train",), n_per_split=5, hr_size=32,
                                 scale="X4")
    ours = dataset_mean_std(Loader(PairedIndex(str(root), "train", "X4"), 2, num_threads=2,
                                   use_native="never"))
    theirs = jax_stats(JaxLoader(JaxIndex(str(root), "train", "X4"), 2, use_native="never"))
    assert ours[0] == pytest.approx(theirs[0], rel=1e-6)
    assert ours[1] == pytest.approx(theirs[1], rel=1e-6)


def test_preupscale_train_batch_matches_jax_at_the_same_draws(rng):
    """The port's whole pre-upscale batch, its draws replayed: the crop
    offsets, flips, blur decisions and sigma the generator gives in the
    order the port draws them, applied by the JAX package's functions."""
    from tpu_superresolution_tpu.data.transforms import (
        _crop_one,
        gaussian_blur as jax_blur,
        pre_upscale_batch as jax_up,
    )
    from tpu_superresolution_torch.data.transforms import make_train_batch_preupscale

    b, s, patch = 3, 4, 24
    lr = rng.random((b, 8, 9, 1), dtype=np.float32)
    hr = rng.random((b, 32, 36, 1), dtype=np.float32)
    got = make_train_batch_preupscale(torch.from_numpy(lr), torch.from_numpy(hr), s, patch,
                                      True, torch.Generator().manual_seed(11), True)
    g = torch.Generator().manual_seed(11)
    tops = torch.randint(0, 32 - patch + 1, (b,), generator=g).tolist()
    lefts = torch.randint(0, 36 - patch + 1, (b,), generator=g).tolist()
    do_h = (torch.rand(b, generator=g) < 0.5).tolist()
    do_v = (torch.rand(b, generator=g) < 0.5).tolist()
    do_b = (torch.rand(b, generator=g) < 0.5).tolist()
    sigma = 0.1 + 1.9 * float(torch.rand((), generator=g))

    up = np.asarray(jax_up(jnp.asarray(lr), s))
    for x, out in ((up, got[0]), (hr, got[1])):
        want = np.stack([np.asarray(_crop_one(x[i], t, l, patch, patch))
                         for i, (t, l) in enumerate(zip(tops, lefts))])
        want = np.where(np.asarray(do_h).reshape(-1, 1, 1, 1), want[:, :, ::-1], want)
        want = np.where(np.asarray(do_v).reshape(-1, 1, 1, 1), want[:, ::-1], want)
        blurred = np.asarray(jax_blur(jnp.asarray(want), jnp.float32(sigma)))
        want = np.where(np.asarray(do_b).reshape(-1, 1, 1, 1), blurred, want)
        assert out.shape == (b, patch, patch, 1)
        assert np.abs(out.numpy() - want).max() <= 3e-5
