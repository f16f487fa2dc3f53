"""The port's compare, mat_eval and export_torch CLIs on ``--device cpu``
against the JAX package's CLIs on the same data and the same weights
(bridged with ``interop/jax_bridge.py``):

- compare: a reference SwinIR .pth against another (the JAX CLI reads
  them too): each model's printed PSNR / SSIM within 0.01 dB / 1e-4 of
  the JAX CLI's (the lines print 2 and 4 decimals), the panel files of
  the same names and sizes, their pixels within 1 of 255 (fp32 sums in
  another order, then the uint8 rounding);
- mat_eval: a SwinIR x4 on classic .mat volumes (``scipy.io.savemat``),
  the JAX CLI on an Orbax checkpoint of the weights, the port on a
  checkpoint of its own format with the same weights: the baseline and
  result lines within 0.01 dB / 1e-4, whole slices and tiled;
- export_torch: the port's checkpoint written as {'params': state_dict}
  equals the JAX CLI's export of the Orbax checkpoint of the same
  weights, key for key and bit for bit (SwinIR; DAT with its BatchNorm
  statistics; its ``num_batches_tracked`` counters are torch's 0-d
  tensors, where the JAX exporter writes [1]), and loads back with ``strict=True`` through
  ``load_any_checkpoint``; a reference .pth and UNet2D are refused."""

import re
import types

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_dat import perturbed_jax_dat, small_dat_config
from tests.util_fakedata import make_deeprock_dataset
from tests.util_torchport import perturbed_jax_swinir, small_swinir_config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_extra")
    make_deeprock_dataset(root / "data", n_per_split=3, hr_size=64, scale="X4", seed=5)
    return root


def _results(out):
    """{label: (psnr, ssim)} of compare's [result] lines."""
    return {m[0]: (float(m[1]), float(m[2])) for m in re.findall(
        r"\[result\] (\S+): PSNR ([-\d.]+) dB \| SSIM ([-\d.]+)", out)}


def test_compare_matches_jax_cli(root, tmp_path, capsys):
    from PIL import Image

    from tpu_superresolution_tpu.cli.compare import main as jax_main
    from tpu_superresolution_tpu.interop.torch_export import save_torch_checkpoint
    from tpu_superresolution_torch.cli.compare import main

    _, va = perturbed_jax_swinir(small_swinir_config(), seed=6)
    _, vb = perturbed_jax_swinir(small_swinir_config(depths=(2,), num_heads=(2,)), seed=7)
    a = save_torch_checkpoint("swinir", va, str(tmp_path / "a.pth"))
    b = save_torch_checkpoint("swinir", vb, str(tmp_path / "b.pth"))
    args = ["--data_root", str(root / "data"), "--scale", "X4", "--ckpt_a", a, "--ckpt_b", b,
            "--model_a", "swinir", "--model_b", "swinir", "--name_a", "wide", "--name_b",
            "narrow", "--indices", "0,2"]
    stats = main(args + ["--out_dir", str(tmp_path / "ours"), "--device", "cpu"])
    ours = _results(capsys.readouterr().out)
    jax_main(args + ["--out_dir", str(tmp_path / "jax")])
    want = _results(capsys.readouterr().out)
    assert sorted(ours) == sorted(want) == ["narrow", "wide"]
    for label, (p, s) in want.items():
        assert abs(ours[label][0] - p) <= 0.01 and abs(ours[label][1] - s) <= 1e-4, label
        assert len(stats[label]["psnr"]) == 2
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 2 and all(n.startswith("wide_vs_narrow_x4_") for n in names)
    for n in names:
        got = np.asarray(Image.open(tmp_path / "ours" / n), np.int32)
        ref = np.asarray(Image.open(tmp_path / "jax" / n), np.int32)
        assert got.shape == ref.shape == (16 + 64, 5 * 64 + 4 * 8, 3)
        assert np.abs(got - ref).max() <= 1


def _orbax(path, cfg, variables):
    """An Orbax checkpoint of the JAX package's train CLI layout holding
    `variables` (the JAX package's ``save_checkpoint``)."""
    from tpu_superresolution_tpu.train.checkpoint import save_checkpoint

    variables = jax.tree.map(lambda a: np.asarray(a, np.float32), variables)
    state = types.SimpleNamespace(
        params=variables["params"], batch_stats=variables.get("batch_stats") or {},
        opt_state={}, step=np.int32(0), ema_params=None)
    save_checkpoint(str(path), state, cfg, extra={"epoch": 1})
    return str(path)


def _port_ckpt(path, cfg, variables):
    """The same weights as a checkpoint of the port's train CLI."""
    from tpu_superresolution_torch.core.config import build_model, config_from_dict
    from tpu_superresolution_torch.interop import (
        dat_state_dict_from_jax,
        swinir_state_dict_from_jax,
    )

    bridge = dat_state_dict_from_jax if cfg.name == "dat" else swinir_state_dict_from_jax
    pcfg = config_from_dict(cfg.to_dict())
    model = build_model(pcfg)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in bridge(variables).items()}, strict=True)
    torch.save({"params": model.state_dict(), "ema": None, "optimizer": {}, "step": 3,
                "config": pcfg.to_dict(), "extra": {"epoch": 1, "ema_decay": 0.0}}, path)
    return str(path)


@pytest.fixture(scope="module")
def mats(tmp_path_factory):
    from scipy.io import savemat

    tmp = tmp_path_factory.mktemp("mats")
    rng = np.random.default_rng(8)
    hr = (rng.random((5, 32, 32)) * 1000).astype(np.float32)
    savemat(tmp / "hr.mat", {"vol": hr})
    savemat(tmp / "lr.mat", {"vol": hr[:, ::4, ::4].copy()})
    return tmp


def _mat_lines(out):
    base = re.search(r"\[baseline\] Bicubic PSNR: ([-\d.]+) dB \| SSIM: ([-\d.]+)", out)
    res = re.search(r"\[result\] PSNR ([-\d.]+) dB \| SSIM ([-\d.]+)", out)
    return tuple(float(v) for v in base.groups() + res.groups())


@pytest.mark.parametrize("tile", [[], ["--tile", "6", "--tile_overlap", "2"]],
                         ids=["whole", "tiled"])
def test_mat_eval_matches_jax_cli(mats, tmp_path, capsys, tile):
    from tpu_superresolution_tpu.cli.mat_eval import main as jax_main
    from tpu_superresolution_torch.cli.mat_eval import main

    cfg = small_swinir_config(in_channels=1, out_channels=1, depths=(2,), num_heads=(2,))
    _, variables = perturbed_jax_swinir(cfg, seed=9)
    common = ["--hr_mat", str(mats / "hr.mat"), "--lr_mat", str(mats / "lr.mat"),
              "--batch_size", "2", "--limit_pairs", "4", "--scale", "X4"] + tile
    ours = main(common + ["--ckpt", _port_ckpt(tmp_path / "m.pth", cfg, variables),
                          "--device", "cpu"])
    got = _mat_lines(capsys.readouterr().out)
    want_res = jax_main(common + ["--ckpt", _orbax(tmp_path / "orbax", cfg, variables)])
    want = _mat_lines(capsys.readouterr().out)
    assert ours["n"] == want_res["n"] == 4
    assert abs(ours["psnr"] - want_res["psnr"]) <= 0.01
    assert abs(ours["ssim"] - want_res["ssim"]) <= 1e-4
    for g, w, tol in zip(got, want, (0.01, 1e-4, 0.01, 1e-4)):
        assert abs(g - w) <= tol + 1e-9, (got, want)


@pytest.mark.parametrize("family", ["swinir", "dat"])
def test_export_torch_matches_jax_cli(tmp_path, capsys, family):
    from tpu_superresolution_tpu.cli.export_torch import main as jax_main
    from tpu_superresolution_torch.cli.export_torch import main
    from tpu_superresolution_torch.cli.upscale import load_any_checkpoint

    if family == "dat":
        cfg = small_dat_config(depths=(2,), num_heads=(2,))
        _, variables = perturbed_jax_dat(cfg, seed=10)
    else:
        cfg = small_swinir_config()
        _, variables = perturbed_jax_swinir(cfg, seed=10)
    ours = main(["--ckpt", _port_ckpt(tmp_path / "m.pth", cfg, variables),
                 "--out", str(tmp_path / "ours.pt")])
    assert "[export]" in capsys.readouterr().out
    jax_main(["--ckpt", _orbax(tmp_path / "orbax", cfg, variables),
              "--out", str(tmp_path / "jax.pt")])
    got = torch.load(ours, weights_only=True)
    want = torch.load(tmp_path / "jax.pt", weights_only=True)
    assert list(got) == list(want) == ["params"]
    assert sorted(got["params"]) == sorted(want["params"])
    for k, v in want["params"].items():
        g = got["params"][k]
        if k.endswith("num_batches_tracked"):
            # torch's 0-d counter; the JAX exporter's np.ascontiguousarray
            # makes it [1]
            assert g.shape == () and v.shape == (1,) and int(g) == int(v) == 0, k
            continue
        assert g.shape == v.shape and torch.equal(g.to(v.dtype), v), k
    if family == "dat":
        assert any(k.endswith("running_var") for k in got["params"])
    mcfg, model = load_any_checkpoint(ours, family, cfg.scale, device="cpu")
    assert mcfg.name == family
    sd = model.state_dict()
    for k, v in got["params"].items():
        assert torch.equal(sd[k], v), k


def test_export_torch_refusals(tmp_path):
    from tpu_superresolution_torch.cli.export_torch import main
    from tpu_superresolution_torch.core.config import UNet2DConfig, build_model

    ref = tmp_path / "ref.pth"
    torch.save({"params": {"conv_first.weight": torch.zeros(1)}}, ref)
    with pytest.raises(SystemExit, match="already is the reference format"):
        main(["--ckpt", str(ref), "--out", str(tmp_path / "o.pt")])
    cfg = UNet2DConfig(base_channels=4, depth=1)
    unet = tmp_path / "unet.pth"
    torch.save({"params": build_model(cfg).state_dict(), "config": cfg.to_dict()}, unet)
    with pytest.raises(SystemExit, match="no reference checkpoint format"):
        main(["--ckpt", str(unet), "--out", str(tmp_path / "o.pt")])


def test_new_clis_run_on_the_gpu_by_default(root, monkeypatch, tmp_path):
    """compare and mat_eval, like every CLI of the port, run on the GPU
    unless ``--device cpu``: without one they raise."""
    from tpu_superresolution_torch.cli.compare import main as compare
    from tpu_superresolution_torch.cli.mat_eval import main as mat_eval

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compare(["--data_root", str(root / "data"), "--scale", "X4", "--ckpt_a", "a.pth",
                 "--ckpt_b", "b.pth"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mat_eval(["--hr_mat", "h.mat", "--lr_mat", "l.mat", "--ckpt", "m.pth"])
