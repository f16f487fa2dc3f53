"""The port's fine-tune entry point on the CPU: a one-epoch run of
``cli.finetune`` on a synthetic DeepRockSR-layout set (bests, report,
finite loss), its checkpoint loaded by ``upscale`` and resumed by the
engine, and the entry points' device rule: the GPU unless the caller
asks for the CPU, an error without one."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from tests.util_fakedata import make_deeprock_dataset

torch.set_num_threads(1)

TINY = ["--embed_dim", "24", "--depths", "2,2", "--num_heads", "2,2", "--lr_patch", "16",
        "--batch_size", "2", "--workers", "2", "--seed", "3"]


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    from tpu_superresolution_torch.cli.finetune import main

    tmp = tmp_path_factory.mktemp("finetune")
    root = make_deeprock_dataset(tmp / "data", splits=("train", "valid"), n_per_split=4,
                                 hr_size=64, scale="X4")
    workdir = tmp / "run"
    trainer, state = main(["--data_root", str(root), "--scale", "X4", "--epochs", "1",
                           "--workdir", str(workdir), "--device", "cpu", "--ema_decay", "0.5"]
                          + TINY)
    return root, workdir, trainer, state


def test_finetune_cli_writes_bests_and_report(finetuned):
    _, workdir, trainer, state = finetuned
    assert state.step == 2  # 4 pairs, batch 2, drop_last
    for name in ("best_X4.pth", "bestpsnr_X4.pth", "run_X4.json"):
        assert (workdir / name).exists(), name
    report = json.loads((workdir / "run_X4.json").read_text())
    assert len(report["history"]["train"]) == 1
    assert np.isfinite(report["history"]["train"][0]) and np.isfinite(report["best_val_loss"])
    assert report["model_config"]["embed_dim"] == 24
    assert report["train_config"]["loss"] == "l1" and report["data_config"]["lr_patch"] == 16
    assert np.isfinite(trainer.best_val_psnr)


def test_finetune_checkpoint_upscales_and_resumes(finetuned, tmp_path):
    from tpu_superresolution_torch.cli.upscale import main as upscale
    from tpu_superresolution_torch.core.config import TrainConfig
    from tpu_superresolution_torch.train.checkpoint import (
        load_checkpoint,
        load_weights_only,
        model_config_from_checkpoint,
    )
    from tpu_superresolution_torch.train.engine import build_optimizer, create_train_state

    _, workdir, _, state = finetuned
    ckpt = str(workdir / "best_X4.pth")
    src = tmp_path / "in.png"
    Image.fromarray((np.random.default_rng(0).random((20, 24, 3)) * 255).astype(np.uint8)).save(src)
    out = tmp_path / "out.png"
    assert upscale(["--image", str(src), "--ckpt", ckpt, "--scale", "X4", "--out", str(out),
                    "--device", "cpu"]) == [str(out)]
    with Image.open(out) as im:
        assert im.size == (96, 80)

    params, extra = load_weights_only(ckpt)
    assert extra["epoch"] == 1 and "best_val_loss" in extra
    cfg = model_config_from_checkpoint(ckpt)
    from tpu_superresolution_torch.core.config import build_model

    model = build_model(cfg)
    model.load_state_dict(params, strict=True)
    for k, v in state.model.state_dict().items():
        assert torch.equal(params[k], v), k
    opt, sched = build_optimizer(TrainConfig(), 2, model)
    resumed = create_train_state(model, opt, sched, ema_decay=0.5)
    load_checkpoint(ckpt, resumed)
    assert resumed.step == state.step
    assert all(torch.equal(resumed.ema[k], state.ema[k]) for k in state.ema)
    assert len(resumed.optimizer.state) == len(state.optimizer.state)

    bad = tmp_path / "bad.pth"
    payload = torch.load(ckpt, weights_only=True)
    payload["params"]["conv_first.weight"] = torch.zeros(5, 3, 3, 3)
    torch.save(payload, bad)
    with pytest.raises(ValueError, match="conv_first.weight"):
        load_weights_only(str(bad))


def test_entry_points_raise_without_a_gpu(finetuned, monkeypatch, tmp_path):
    """Without --device the entry points take the GPU; where there is
    none they raise instead of running on the CPU."""
    from tpu_superresolution_torch.cli import finetune, serve, upscale
    from tpu_superresolution_torch.cli.common import NO_CUDA

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, workdir, _, _ = finetuned
    ckpt = str(workdir / "best_X4.pth")
    src = tmp_path / "in.png"
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(src)
    calls = [
        lambda: finetune.main(["--data_root", str(root), "--scale", "X4", "--epochs", "1",
                               "--workdir", str(tmp_path)] + TINY),
        lambda: upscale.main(["--image", str(src), "--ckpt", ckpt, "--scale", "X4"]),
        lambda: serve.main(["--ckpt", ckpt, "--scale", "X4", "--port", "0"]),
        lambda: serve.SRService(ckpt, "swinir", "X4", None, -1, 16, 2),
        lambda: upscale.main(["--image", str(src), "--ckpt", ckpt, "--scale", "X4",
                              "--device", "cuda"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert "--device cpu" in NO_CUDA


def test_finetune_refuses_what_is_not_ported(finetuned, tmp_path):
    from tpu_superresolution_torch.cli.finetune import main

    root = str(finetuned[0])
    base = ["--data_root", root, "--scale", "X4", "--epochs", "1", "--workdir", str(tmp_path),
            "--device", "cpu"] + TINY
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node 2"):
        main(base + ["--dp", "2"])  # outside a launch of two ranks
    with pytest.raises(SystemExit, match="Orbax.*tpu_superresolution_tpu.cli.export_torch"):
        main(base + ["--weights", str(tmp_path / "orbax_dir")])
