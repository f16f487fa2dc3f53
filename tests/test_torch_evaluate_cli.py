"""The port's evaluate CLI on the CPU: a reference-format .pth against
the JAX package's evaluate CLI on the same file (<= 1e-3 dB, with
--report_json and the PNG triplets), a fine-tune checkpoint with an EMA
(auto EMA, --no-ema), and what it refuses: --ema on a reference .pth or
on a checkpoint without an EMA, --dp outside a torchrun launch of as
many ranks (tests/test_torch_dp_cli.py runs the launch), a UNet2D
reference .pth (UNet2D has no reference format), Orbax directories, and
the GPU where there is none."""

import json

import pytest
import torch

from tests.util_fakedata import make_deeprock_dataset
from tests.util_torchport import perturbed_jax_swinir, small_swinir_config

torch.set_num_threads(1)

FT_TINY = ["--embed_dim", "24", "--depths", "2,2", "--num_heads", "2,2", "--lr_patch", "16",
           "--batch_size", "2", "--workers", "2", "--seed", "3"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("evalcli")
    make_deeprock_dataset(root / "data", n_per_split=4, hr_size=64, scale="X4", seed=2)
    return root


@pytest.fixture(scope="module")
def ref_pth(data):
    """A small SwinIR x4 with seeded weights, written by the JAX
    package's exporter as a reference-format .pth."""
    from tpu_superresolution_tpu.interop.torch_export import save_torch_checkpoint

    _, variables = perturbed_jax_swinir(small_swinir_config(), seed=4)
    return save_torch_checkpoint("swinir", variables, str(data / "ref_x4.pth"))


@pytest.fixture()
def jax_dat_switches():
    """The JAX evaluate CLI pins DAT's implementation switches (module
    globals) on a .pth; put them back for the tests that follow."""
    from tpu_superresolution_tpu.models import dat as dm
    from tpu_superresolution_tpu.ops.pallas import fused_channel_attn as fc
    from tpu_superresolution_tpu.ops.pallas import fused_datb_tail as ft
    from tpu_superresolution_tpu.ops.pallas import fused_rect_attn as fr

    old = dm.CHAN_ATTN_IMPL, ft.FUSED_TAIL, fr.FUSED_RECT, fr.FUSED_RECT_SHIFTED, fc.FUSED_CHAN
    yield
    dm.CHAN_ATTN_IMPL, ft.FUSED_TAIL, fr.FUSED_RECT, fr.FUSED_RECT_SHIFTED, fc.FUSED_CHAN = old


def _common(data, tag):
    return ["--data_root", str(data / "data"), "--scale", "X4", "--batch_size", "2",
            "--workers", "2", "--save_dir", str(data / f"preds_{tag}")]


def test_reference_pth_matches_jax_cli(data, ref_pth, jax_dat_switches, capsys):
    from tpu_superresolution_tpu.cli.evaluate import main as jax_main
    from tpu_superresolution_torch.cli.evaluate import main

    args = ["--model", "swinir", "--ckpt", ref_pth, "--save_n", "2", "--tile", "12",
            "--tile_overlap", "4"]
    ours = main(args + _common(data, "ours") + ["--device", "cpu", "--report_json",
                                                str(data / "ours.json")])
    out = capsys.readouterr().out
    want = jax_main(args + _common(data, "jax") + ["--report_json", str(data / "jax.json")])
    capsys.readouterr()
    for line in ("[device] cpu", "reference checkpoint, model=swinir (exact=True)",
                 "[data] test samples: 4 | steps: 2", "[baseline] Bicubic PSNR:", "[peek]",
                 "[done] n=4", "[result] PSNR", "[report] result json"):
        assert line in out, line
    assert ours["n"] == want["n"] == 4
    assert abs(ours["psnr"] - want["psnr"]) <= 1e-3
    assert abs(ours["ssim"] - want["ssim"]) <= 1e-5
    report = json.loads((data / "ours.json").read_text())
    assert report.keys() == json.loads((data / "jax.json").read_text()).keys()
    assert report["psnr"] == ours["psnr"] and report["n"] == 4.0
    names = sorted(p.name for p in (data / "preds_ours").iterdir())
    assert names == sorted(p.name for p in (data / "preds_jax").iterdir())
    assert names == [f"idx_{i:06d}_{k}.png" for i in range(2) for k in ("hr", "lr", "sr")]


@pytest.fixture(scope="module")
def finetuned(data):
    """cli.finetune for one epoch with an EMA (decay 0.5, a large
    learning rate so that the EMA and the parameters differ)."""
    from tpu_superresolution_torch.cli.finetune import main

    workdir = data / "ft"
    main(["--data_root", str(data / "data"), "--scale", "X4", "--epochs", "1", "--lr", "1e-2",
          "--workdir", str(workdir), "--device", "cpu", "--ema_decay", "0.5"] + FT_TINY)
    return str(workdir / "best_X4.pth")


def _direct(ckpt, data, ema):
    """Evaluator.run on the checkpoint's config with the expected weights."""
    from tpu_superresolution_torch.core.config import EvalConfig, build_model
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.loader import Loader
    from tpu_superresolution_torch.evaluate import Evaluator
    from tpu_superresolution_torch.train.checkpoint import (
        load_ema_params,
        load_weights_only,
        model_config_from_checkpoint,
    )

    cfg = model_config_from_checkpoint(ckpt)
    params, _ = load_weights_only(ckpt)
    if ema:
        params = dict(params, **load_ema_params(ckpt))
    model = build_model(cfg)
    model.load_state_dict(params, strict=True)
    loader = Loader(PairedIndex(str(data / "data"), "test", "X4"), 2, grayscale=False,
                    channels=3, num_threads=2)
    return Evaluator(model.eval(), 4, "native_lr", EvalConfig(batch_size=2), log=lambda m: None,
                     device="cpu").run(loader)


def test_finetune_checkpoint_auto_ema_and_no_ema(data, finetuned, capsys):
    from tpu_superresolution_torch.cli.evaluate import main

    base = ["--ckpt", finetuned, "--save_n", "0", "--no_baseline", "--device", "cpu"]
    auto = main(base + _common(data, "ft"))
    out = capsys.readouterr().out
    assert "ema_decay=0.5" in out and "using EMA weights" in out
    raw = main(base + _common(data, "ft") + ["--no-ema"])
    assert "using EMA weights" not in capsys.readouterr().out
    want_ema, want_raw = _direct(finetuned, data, True), _direct(finetuned, data, False)
    assert auto["psnr"] == pytest.approx(want_ema["psnr"], abs=1e-9)
    assert raw["psnr"] == pytest.approx(want_raw["psnr"], abs=1e-9)
    assert abs(auto["psnr"] - raw["psnr"]) > 1e-4  # the EMA is another weight set


@pytest.mark.parametrize("case,match", [
    ("ema_on_reference", "--ema applies to the port's own checkpoints"),
    ("ema_missing", "no EMA in"),
    pytest.param("dp", "torchrun --nproc_per_node 2", id="dp-Queue 1 item 5"),
    ("cnn", "no reference checkpoint format"),
    ("orbax", "does not read.*tpu_superresolution_tpu.cli.export_torch"),
])
def test_refusals(data, ref_pth, tmp_path, case, match):
    from tpu_superresolution_torch.cli.evaluate import main
    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model

    common = _common(data, "refused") + ["--device", "cpu", "--no_baseline"]
    if case == "ema_missing":  # a port checkpoint of a run without an EMA
        cfg = SwinIRConfig(embed_dim=24, depths=(2,), num_heads=(2,))
        path = tmp_path / "no_ema.pth"
        torch.save({"params": build_model(cfg).state_dict(), "ema": None, "step": 0,
                    "config": cfg.to_dict(), "extra": {"ema_decay": 0.0}}, path)
        argv = ["--ckpt", str(path), "--ema"]
    else:
        argv = {"ema_on_reference": ["--model", "swinir", "--ckpt", ref_pth, "--ema"],
                "dp": ["--model", "swinir", "--ckpt", ref_pth, "--tile", "12", "--dp", "2"],
                "cnn": ["--model", "unet2d", "--ckpt", ref_pth],
                "orbax": ["--model", "swinir", "--ckpt", str(tmp_path)]}[case]
    with pytest.raises(SystemExit, match=match):
        main(argv + common)


def test_gpu_by_default(data, ref_pth, monkeypatch):
    """Without --device the CLI takes the GPU and raises where there is none."""
    from tpu_superresolution_torch.cli.common import NO_CUDA
    from tpu_superresolution_torch.cli.evaluate import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device") as info:
            main(["--model", "swinir", "--ckpt", ref_pth] + _common(data, "gpu") + device)
        assert str(info.value) == NO_CUDA
