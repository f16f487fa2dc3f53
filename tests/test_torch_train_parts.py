"""The training building blocks of the port against the JAX package's,
on the same numpy inputs (fp32, CPU): metrics and losses at 3e-5, the
LR schedules at every step (rtol 1e-5: the JAX ones compute in fp32,
the port's in Python floats), the native-LR crop and flips at
fixed offsets / decisions (exact), the dataset index and the threaded
loader (the same batches, exactly), and stochastic depth's sampling."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_fakedata import make_deeprock_dataset
from tests.util_torchport import TOL

torch.set_num_threads(1)


def _pair(seed, shape=(3, 24, 20, 3)):
    rng = np.random.default_rng(seed)
    pred = (rng.random(shape, dtype=np.float32) * 1.2 - 0.1).astype(np.float32)
    target = rng.random(shape, dtype=np.float32)
    return pred, target


@pytest.mark.parametrize("fn", ["batch_psnr", "psnr", "ssim", "ssim_per_image"])
def test_metrics_match_jax(fn):
    from tpu_superresolution_tpu.ops import metrics as jm
    from tpu_superresolution_torch.ops import metrics as tm

    pred, target = _pair(len(fn))
    kw = {}
    if fn == "ssim_per_image":
        fn, kw = "ssim", dict(size_average=False)
    want = np.asarray(getattr(jm, fn)(jnp.asarray(pred), jnp.asarray(target), **kw))
    got = getattr(tm, fn)(torch.from_numpy(pred), torch.from_numpy(target), **kw).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("name", ["l1", "mse", "l1_ssim"])
def test_losses_match_jax(name):
    from tpu_superresolution_tpu.train import losses as jl
    from tpu_superresolution_torch.train import losses as tl

    pred, target = _pair(7)
    for get in ("get_loss", "get_loss_per_sample"):
        want = np.asarray(getattr(jl, get)(name)(jnp.asarray(pred), jnp.asarray(target)))
        got = getattr(tl, get)(name)(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL, get
    with pytest.raises(ValueError):
        tl.get_loss("huber")


@pytest.mark.parametrize("name", ["none", "onecycle", "exponential", "cosine"])
def test_schedules_match_jax_at_every_step(name):
    from tpu_superresolution_tpu.train.schedules import build_schedule as jax_schedule
    from tpu_superresolution_torch.train.schedules import build_schedule

    epochs, spe = 4, 5
    want = jax_schedule(name, 2e-4, epochs, spe, 2e-6)
    got = build_schedule(name, 2e-4, epochs, spe, 2e-6)
    for step in range(epochs * spe + 3):
        w = float(want(jnp.asarray(step))) if callable(want) else want
        np.testing.assert_allclose(got(step), w, rtol=1e-5, err_msg=f"step {step}")


def test_native_crop_and_flips_match_jax():
    import jax

    from tpu_superresolution_tpu.data.transforms import _crop_one
    from tpu_superresolution_torch.data.transforms import (
        crop_native_at,
        flip_at,
        make_train_batch_native,
    )

    rng = np.random.default_rng(3)
    s, p = 4, 8
    lr = rng.random((3, 12, 14, 3), dtype=np.float32)
    hr = rng.random((3, 48, 56, 3), dtype=np.float32)
    tops, lefts = [0, 4, 2], [6, 1, 0]
    lr_c, hr_c = crop_native_at(torch.from_numpy(lr), torch.from_numpy(hr), tops, lefts, p, s)
    crop = lambda x, ph: jax.vmap(lambda im, t, l: _crop_one(im, t, l, ph, ph))
    want_lr = crop(lr, p)(jnp.asarray(lr), jnp.asarray(tops), jnp.asarray(lefts))
    want_hr = crop(hr, p * s)(jnp.asarray(hr), jnp.asarray(tops) * s, jnp.asarray(lefts) * s)
    np.testing.assert_array_equal(lr_c.numpy(), np.asarray(want_lr))
    np.testing.assert_array_equal(hr_c.numpy(), np.asarray(want_hr))

    do_h, do_v = [True, False, True], [False, True, True]
    got = flip_at(lr_c, do_h, do_v).numpy()
    x = np.asarray(want_lr)
    dh = np.asarray(do_h).reshape(-1, 1, 1, 1)
    dv = np.asarray(do_v).reshape(-1, 1, 1, 1)
    want = np.where(dh, x[:, :, ::-1], x)  # the JAX package's paired_random_flips
    want = np.where(dv, want[:, ::-1], want)
    np.testing.assert_array_equal(got, want)

    # random crops stay scale-aligned and reproducible from the generator
    a = make_train_batch_native(torch.from_numpy(lr), torch.from_numpy(hr), s, p, True,
                                torch.Generator().manual_seed(5))
    b = make_train_batch_native(torch.from_numpy(lr), torch.from_numpy(hr), s, p, True,
                                torch.Generator().manual_seed(5))
    assert a[0].shape == (3, p, p, 3) and a[1].shape == (3, p * s, p * s, 3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_index_and_loader_give_the_jax_batches(tmp_path):
    from tpu_superresolution_tpu.data.index import PairedIndex as JaxIndex
    from tpu_superresolution_tpu.data.loader import Loader as JaxLoader
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.loader import Loader

    root = make_deeprock_dataset(tmp_path, splits=("train",), n_per_split=7, hr_size=32,
                                 scale="X4")
    idx, jidx = PairedIndex(str(root), "train", "X4"), JaxIndex(str(root), "train", "X4")
    assert idx.pairs == jidx.pairs and len(idx) == 7
    kw = dict(batch_size=3, shuffle=True, drop_last=True, grayscale=False, channels=3, seed=4,
              num_threads=2, host_crop_hr=16, host_crop_scale=4)
    ours, theirs = Loader(idx, use_native="never", **kw), JaxLoader(jidx, use_native="never", **kw)
    assert len(ours) == len(theirs) == 2
    for _ in range(2):  # two epochs: the shuffle and crops follow the epoch
        for (a_lr, a_hr), (b_lr, b_hr) in zip(ours, theirs, strict=True):
            assert a_lr.shape == (3, 4, 4, 3) and a_hr.shape == (3, 16, 16, 3)
            np.testing.assert_array_equal(a_lr, b_lr)
            np.testing.assert_array_equal(a_hr, b_hr)


def test_stochastic_depth_sampling_and_train_eval():
    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model
    from tpu_superresolution_torch.models.blocks import drop_path_scales

    rates = [0.0, 0.25, 0.5]
    s = drop_path_scales(rates, 4000, torch.Generator().manual_seed(0))
    assert s.shape == (3, 4000, 2)
    assert torch.equal(s[0], torch.ones(4000, 2))
    for r, blk in zip(rates[1:], s[1:]):
        kept = blk[blk != 0]
        torch.testing.assert_close(kept, torch.full_like(kept, 1.0 / (1 - r)))
        assert abs(float((blk == 0).float().mean()) - r) < 0.03

    cfg = SwinIRConfig(embed_dim=24, depths=(2, 2), num_heads=(2, 2), num_feat=16,
                       drop_path_rate=0.5)
    model = build_model(cfg)
    assert not model.training  # built in eval mode, as JAX's train=False default
    np.testing.assert_allclose(model.drop_path_rates(), np.linspace(0, 0.5, 4), rtol=1e-6)
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.train()
        a = model(x, generator=torch.Generator().manual_seed(2))
        b = model(x, generator=torch.Generator().manual_seed(2))
        c = model(x, generator=torch.Generator().manual_seed(3))
        model.eval()
        e1, e2 = model(x), model(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(e1, e2) and not torch.equal(a, e1)
    assert model.sample_branch_scales(2, None, x.device) is None  # eval: no drop path
