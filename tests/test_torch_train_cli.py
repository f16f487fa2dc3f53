"""The port's ``train`` entry point on the CPU: ``--model hat`` for one
epoch on a synthetic DeepRockSR-layout set (checkpoints, run report,
finite loss; at window 16 as well), its checkpoint resumed by
``--resume`` and loaded by ``upscale``; the flags not ported yet, and the
transformer overrides given to a CNN family, exit with a message;
without a GPU and without ``--device cpu`` it raises."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from tests.util_fakedata import make_deeprock_dataset

torch.set_num_threads(1)

# HAT at its default squeeze factor 30 needs C >= 30
TINY = ["--model", "hat", "--embed_dim", "30", "--t_depths", "2,2", "--t_heads", "2,2",
        "--patch_size", "14", "--batch_size", "2", "--workers", "2", "--seed", "3",
        "--loss", "l1", "--epochs", "1"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from tpu_superresolution_torch.cli.train import main

    tmp = tmp_path_factory.mktemp("train")
    root = make_deeprock_dataset(tmp / "data", splits=("train", "valid"), n_per_split=4,
                                 hr_size=64, scale="X4")
    workdir = tmp / "run"
    trainer, state = main(["--data_root", str(root), "--scale", "X4", "--workdir", str(workdir),
                           "--device", "cpu", "--ema_decay", "0.5"] + TINY)
    return root, workdir, trainer, state


def test_train_cli_hat_writes_checkpoints_and_report(trained):
    _, workdir, trainer, state = trained
    assert state.step == 2  # 4 pairs, batch 2
    assert state.model.config.name == "hat" and state.model.config.embed_dim == 30
    for name in ("best_X4.pth", "bestpsnr_X4.pth", "run_X4.json"):
        assert (workdir / name).exists(), name
    report = json.loads((workdir / "run_X4.json").read_text())
    assert report["model_config"]["__model__"] == "hat"
    assert report["model_config"]["depths"] == [2, 2]
    assert report["data_config"]["convention"] == "native_lr"
    assert report["data_config"]["lr_patch"] == 14 and report["data_config"]["do_flips"]
    assert report["train_config"]["loss"] == "l1" and report["train_config"]["lr"] == 1e-4
    assert np.isfinite(report["history"]["train"][0]) and np.isfinite(trainer.best_val_psnr)


def test_train_cli_resumes_a_hat_run(trained, tmp_path):
    """--resume restores the weights, optimizer state, step and EMA of a
    HAT checkpoint and trains on from there; --finetune takes the
    weights only."""
    from tpu_superresolution_torch.cli.train import main
    from tpu_superresolution_torch.train.checkpoint import model_config_from_checkpoint

    root, workdir, _, state = trained
    ckpt = str(workdir / "best_X4.pth")
    assert model_config_from_checkpoint(ckpt).to_dict() == state.model.config.to_dict()
    base = ["--data_root", str(root), "--scale", "X4", "--device", "cpu", "--ema_decay", "0.5",
            "--resume", ckpt] + TINY
    _, resumed = main(base + ["--workdir", str(tmp_path / "resumed")])
    assert resumed.step == state.step + 2
    _, tuned = main(base + ["--workdir", str(tmp_path / "tuned"), "--finetune"])
    assert tuned.step == 2


def test_train_cli_checkpoint_upscales_as_hat(trained, tmp_path):
    from tpu_superresolution_torch.cli.upscale import main as upscale

    _, workdir, _, _ = trained
    src = tmp_path / "in.png"
    Image.fromarray((np.random.default_rng(0).random((15, 17, 3)) * 255).astype(np.uint8)).save(src)
    out = tmp_path / "out.png"
    assert upscale(["--image", str(src), "--ckpt", str(workdir / "best_X4.pth"), "--model", "hat",
                    "--scale", "X4", "--out", str(out), "--device", "cpu"]) == [str(out)]
    with Image.open(out) as im:
        assert im.size == (68, 60)


def test_train_cli_trains_hat_at_window_16(trained, tmp_path):
    """``train --model hat --window_size 16`` (upstream HAT-SRx4's window)
    takes its steps on the CPU: the HABs on the K7 route, the OCABs on
    the fused route (K8 takes ws 16), a finite loss and validation
    PSNR."""
    from tpu_superresolution_torch.cli.train import main

    trainer, state = main(["--data_root", str(trained[0]), "--scale", "X4", "--workdir",
                           str(tmp_path), "--device", "cpu"] + TINY
                          + ["--window_size", "16", "--patch_size", "16"])
    assert state.step == 2 and state.model.config.window_size == 16
    assert all(layer.residual_group.overlap_attn.takes_k8() for layer in state.model.layers)
    assert np.isfinite(trainer.history["train"][0]) and np.isfinite(trainer.best_val_psnr)


@pytest.mark.parametrize("model", ["ms_resunet", "unet2d"])
def test_train_cli_refuses_the_cnn_families(trained, tmp_path, model):
    """The CNN families train (tests/test_torch_cnn_cli.py); they refuse
    the transformer overrides, here TINY's HAT sizes."""
    from tpu_superresolution_torch.cli.train import main

    with pytest.raises(SystemExit, match="transformer-only"):
        main(["--data_root", str(trained[0]), "--scale", "X4", "--workdir", str(tmp_path),
              "--device", "cpu"] + TINY + ["--model", model])


@pytest.mark.parametrize("flags,match", [
    pytest.param(["--dp", "2"], "torchrun --nproc_per_node 2", id="flags0-multi-GPU")])
def test_train_cli_refuses_flags_not_ported(trained, tmp_path, flags, match):
    """--dp 2 outside a torchrun launch of two ranks exits, naming the
    launch (the dp path itself: tests/test_torch_dp_cli.py)."""
    from tpu_superresolution_torch.cli.train import main

    with pytest.raises(SystemExit, match=match):
        main(["--data_root", str(trained[0]), "--scale", "X4", "--workdir", str(tmp_path),
              "--device", "cpu"] + TINY + flags)


def test_train_cli_raises_without_a_gpu(trained, monkeypatch, tmp_path):
    from tpu_superresolution_torch.cli.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--data_root", str(trained[0]), "--scale", "X4", "--workdir", str(tmp_path)]
             + TINY)


def test_train_cli_mlp_ratio_builds_hat_srx4():
    """``--mlp_ratio`` resizes the MLP: upstream HAT-SRx4's flags give its
    config (window 16, embed 180, depths and heads 6x6, mlp 2); without
    it the JAX CLI's mlp 4 (hidden 720).  The ws-16 training kernels take
    the blocks and OCABs of both; a family without the field refuses
    it."""
    from tpu_superresolution_torch.cli.train import build_argparser, model_config_from_args
    from tpu_superresolution_torch.kernels.fused_block import k5w16_ok
    from tpu_superresolution_torch.kernels.fused_ocab import ocab_ok

    flags = ["--data_root", "d", "--scale", "X4", "--model", "hat", "--window_size", "16",
             "--embed_dim", "180", "--t_depths", "6,6,6,6,6,6", "--t_heads", "6,6,6,6,6,6"]
    default = model_config_from_args(build_argparser().parse_args(flags))
    cfg = model_config_from_args(build_argparser().parse_args(flags + ["--mlp_ratio", "2"]))
    assert default.mlp_ratio == 4.0 and cfg.mlp_ratio == 2.0
    hidden = int(cfg.embed_dim * cfg.mlp_ratio)
    assert k5w16_ok(cfg.window_size, cfg.embed_dim, 6, hidden)
    assert ocab_ok(16, 24, cfg.embed_dim, 6, hidden)
    assert k5w16_ok(16, 180, 6, int(180 * default.mlp_ratio))
    assert ocab_ok(16, 24, 180, 6, int(180 * default.mlp_ratio))
    with pytest.raises(SystemExit, match="mlp_ratio"):
        model_config_from_args(build_argparser().parse_args(
            ["--data_root", "d", "--scale", "X4", "--model", "dat", "--mlp_ratio", "2"]))
