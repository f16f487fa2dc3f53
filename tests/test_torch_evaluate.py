"""The port's dataset evaluation (``evaluate/baseline.py``,
``evaluate/runner.py``'s ``Evaluator.run`` and ``_save_decision``) on
the CPU against the JAX package on the same synthetic DeepRockSR-layout
set: the baseline to 1e-4 dB / 1e-5 SSIM, an evaluation to 1e-3 dB /
1e-5 SSIM, the PNG triplets' names equal and their pixels equal where
both packages save the same array (a pixel of an image that went through
a float computation may fall one gray level apart where the two fp32
values straddle a rounding boundary)."""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from tests.util_fakedata import make_deeprock_dataset
from tests.util_torchport import perturbed_jax_swinir, port_from_jax, small_swinir_config

torch.set_num_threads(1)

PSNR_TOL, SSIM_TOL = 1e-3, 1e-5


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """X2 and X4 test splits of four 64^2 grayscale images."""
    root = tmp_path_factory.mktemp("evaldata")
    for scale in ("X2", "X4"):
        make_deeprock_dataset(root, splits=("test",), n_per_split=4, hr_size=64, scale=scale,
                              seed=1)
    return str(root)


def _loaders(root, scale, batch, channels=1):
    """The same test split through the port's and the JAX package's loaders."""
    from tpu_superresolution_tpu.data import Loader as JaxLoader
    from tpu_superresolution_tpu.data import PairedIndex as JaxIndex
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.loader import Loader

    kw = dict(grayscale=channels == 1, channels=channels)
    return (Loader(PairedIndex(root, "test", scale), batch, num_threads=2, **kw),
            JaxLoader(JaxIndex(root, "test", scale), batch, **kw))


@pytest.mark.parametrize("scale", ["X2", "X4"])
def test_bicubic_baseline_matches_jax(dataset, scale):
    from tpu_superresolution_tpu.evaluate.baseline import bicubic_baseline as jax_baseline
    from tpu_superresolution_torch.evaluate import bicubic_baseline

    ours_loader, jax_loader = _loaders(dataset, scale, 3)
    got = bicubic_baseline(ours_loader, int(scale[1:]), device="cpu")
    want = jax_baseline(jax_loader, int(scale[1:]))
    assert got["n"] == want["n"] == 4
    assert abs(got["psnr"] - want["psnr"]) <= 1e-4
    assert abs(got["ssim"] - want["ssim"]) <= 1e-5
    assert got["psnr"] > 20.0  # the fake LR is a PIL bicubic downscale of HR


@pytest.mark.parametrize("rules,n", [
    (dict(save_n=3), 5),
    (dict(save_every=2, save_start=1, save_n=0), 6),
    (dict(save_indices=(0, 4), save_every=2, save_n=3), 5),
    (dict(save_n=0), 4),
    (dict(save_every=3, save_start=0, save_n=16), 8),
])
def test_save_decision_matches_jax(rules, n):
    from tpu_superresolution_tpu.core.config import EvalConfig as JaxEvalConfig
    from tpu_superresolution_tpu.evaluate.runner import _save_decision as jax_rule
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.evaluate.runner import _save_decision

    got = [_save_decision(i, EvalConfig(**rules)) for i in range(n)]
    assert got == [jax_rule(i, JaxEvalConfig(**rules)) for i in range(n)]


class _JaxIdentity:
    """A pre-upscale "model" of the JAX package: SR is its input."""

    def apply(self, variables, x, train=False):
        return x


class _JaxHalf:
    """A pre-upscale "model" whose output is half the HR size."""

    def apply(self, variables, x, train=False):
        return x[:, ::2, ::2] * 0.9 + 0.05


class _JaxModel:
    def __init__(self, model, variables):
        self.model, self.variables = model, variables

    def apply(self, variables, x, train=False):
        return self.model.apply(self.variables, x, train=False)


def _run_both(root, scale, ours_model, jax_model, convention, channels, tmp_path, **ecfg):
    """Evaluator.run of both packages over the same split, each saving
    its PNG triplets; returns (ours, jax, ours_dir, jax_dir)."""
    from tpu_superresolution_tpu.core.config import EvalConfig as JaxEvalConfig
    from tpu_superresolution_tpu.evaluate.runner import Evaluator as JaxEvaluator
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.evaluate import Evaluator

    s = int(scale[1:])
    ours_loader, jax_loader = _loaders(root, scale, 2, channels)
    logs = []
    ours = Evaluator(ours_model, s, convention, EvalConfig(**ecfg), log=logs.append,
                     device="cpu").run(ours_loader, save_dir=str(tmp_path / "ours"))
    want = JaxEvaluator(jax_model, {}, s, convention, JaxEvalConfig(**ecfg),
                        log=lambda m: None).run(jax_loader, save_dir=str(tmp_path / "jax"))
    assert logs[0].startswith("[peek]") and logs[-1].startswith("[done] n=4")
    return ours, want, tmp_path / "ours", tmp_path / "jax"


def _check_results(ours, want):
    assert ours["n"] == want["n"] == 4
    assert abs(ours["psnr"] - want["psnr"]) <= PSNR_TOL
    assert abs(ours["ssim"] - want["ssim"]) <= SSIM_TOL
    assert set(ours) == {"psnr", "ssim", "n", "wall_s", "compile_s", "mpix_per_s"}
    assert ours["mpix_per_s"] > 0 and ours["wall_s"] >= ours["compile_s"] > 0


def _check_pngs(ours_dir, jax_dir, exact=()):
    """The same file names; pixels equal in the `exact` kinds (lr / hr /
    sr), at most one gray level apart in the others."""
    names = sorted(p.name for p in Path(ours_dir).iterdir())
    assert names == sorted(p.name for p in Path(jax_dir).iterdir())
    assert names == [f"idx_{i:06d}_{k}.png" for i in range(2) for k in ("hr", "lr", "sr")]
    for name in names:
        a = np.asarray(Image.open(Path(ours_dir) / name), np.int16)
        b = np.asarray(Image.open(Path(jax_dir) / name), np.int16)
        assert a.shape == b.shape, name
        if name[-6:-4] in exact:
            assert np.array_equal(a, b), name
        else:
            assert np.abs(a - b).max() <= 1, name


@pytest.mark.parametrize("ecfg", [
    dict(save_n=2),
    dict(save_n=2, tile_size=24, tile_overlap=8),
    dict(save_n=2, self_ensemble=True),
    dict(save_n=2, tile_size=24, tile_overlap=8, max_tile_batch=3, self_ensemble=True),
], ids=["whole", "tiled", "tta", "tiled-tta"])
def test_run_identity_pre_upscale_matches_jax(dataset, ecfg, tmp_path):
    """SR = the bicubic pre-upscale: the evaluation equals the baseline,
    the LR and HR PNGs are the loaded arrays."""
    from tpu_superresolution_tpu.evaluate.baseline import bicubic_baseline as jax_baseline

    ours, want, od, jd = _run_both(dataset, "X2", lambda x: x, _JaxIdentity(), "pre_upscale",
                                   1, tmp_path, **ecfg)
    _check_results(ours, want)
    base = jax_baseline(_loaders(dataset, "X2", 2)[1], 2)
    assert abs(ours["psnr"] - base["psnr"]) <= PSNR_TOL
    _check_pngs(od, jd, exact=("lr", "hr"))


@pytest.fixture(scope="module")
def swinir():
    """A small SwinIR x4 (embed 24, depths (2, 2)) with seeded weights in
    both packages."""
    cfg = small_swinir_config()
    jmodel, variables = perturbed_jax_swinir(cfg, seed=3)
    return _JaxModel(jmodel, variables), port_from_jax(cfg, variables)


@pytest.mark.parametrize("ecfg", [
    dict(save_n=2),
    dict(save_indices=(0, 1), tile_size=12, tile_overlap=4, max_tile_batch=3),
    dict(save_every=1, save_n=0, self_ensemble=True),
], ids=["whole", "tiled", "tta"])
def test_run_swinir_matches_jax(dataset, swinir, ecfg, tmp_path):
    jax_model, model = swinir
    ours, want, od, jd = _run_both(dataset, "X4", model, jax_model, "native_lr", 3, tmp_path,
                                   **ecfg)
    _check_results(ours, want)
    if "save_every" in ecfg:  # every index saved: keep the first two for the check
        for d in (od, jd):
            for p in Path(d).iterdir():
                if not p.name.startswith(("idx_000000", "idx_000001")):
                    p.unlink()
    _check_pngs(od, jd, exact=("hr",))


def test_run_realigns_other_output_sizes(dataset, tmp_path):
    """An output of another size than HR is realigned bilinearly (no
    antialias) before the metrics; the SR PNG keeps the model's size."""
    ours, want, od, jd = _run_both(dataset, "X2", lambda x: x[:, ::2, ::2] * 0.9 + 0.05,
                                   _JaxHalf(), "pre_upscale", 1, tmp_path, save_n=2)
    _check_results(ours, want)
    _check_pngs(od, jd, exact=("lr", "hr"))
    with Image.open(od / "idx_000000_sr.png") as im:
        assert im.size == (32, 32)


def test_run_raises_on_non_finite(dataset):
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.evaluate import Evaluator

    def bad(x):
        y = x.clone()
        y[:, :4] = float("nan")
        return y

    ev = Evaluator(bad, 2, "pre_upscale", EvalConfig(), log=lambda m: None, device="cpu")
    with pytest.raises(RuntimeError, match=r"Non-finite predictions: share=0\.0625, "
                                           r"finite_min=.*finite_max="):
        ev.run(_loaders(dataset, "X2", 2)[0])


def test_run_needs_a_device_or_the_gpu(dataset):
    """Without a device, ``run`` takes the GPU and raises where there is none."""
    from tpu_superresolution_torch.cli.common import NO_CUDA
    from tpu_superresolution_torch.evaluate import Evaluator

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Evaluator(lambda x: x, 2).run(_loaders(dataset, "X2", 2)[0])
    assert "no CUDA device" in NO_CUDA


def test_mpix_per_s_counts_the_steady_window(monkeypatch):
    """``mpix_per_s`` holds only the batches after each shape's first:
    their output pixels over the wall time less the first batches'
    iterations (a clock that only the model's calls advance: 10 s for a
    first call, 1 s for the others)."""
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.evaluate import Evaluator
    from tpu_superresolution_torch.evaluate import runner

    now = [0.0]
    monkeypatch.setattr(runner.time, "perf_counter", lambda: now[0])
    seen = set()

    def model(x):
        now[0] += 1.0 if x.shape in seen else 10.0
        seen.add(x.shape)
        return x

    rng = np.random.default_rng(0)
    batch = lambda b: (rng.random((b, 8, 8, 1), dtype=np.float32),
                       rng.random((b, 16, 16, 1), dtype=np.float32))
    loader = [batch(2), batch(2), batch(2), batch(1)]  # the last batch is a new shape
    res = Evaluator(model, 2, "pre_upscale", EvalConfig(save_n=0), log=lambda m: None,
                    device="cpu").run(loader)
    assert (res["n"], res["wall_s"], res["compile_s"]) == (7, 22.0, 20.0)
    assert res["mpix_per_s"] == pytest.approx(2 * 2 * 16 * 16 / 1e6 / 2.0)

    now[0] = 0.0
    seen.clear()
    res = Evaluator(model, 2, "pre_upscale", EvalConfig(save_n=0), log=lambda m: None,
                    device="cpu").run([batch(2)])
    assert (res["wall_s"], res["compile_s"], res["mpix_per_s"]) == (10.0, 10.0, 0.0)
