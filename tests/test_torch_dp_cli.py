"""``--dp`` on the port's CLIs and the port's entry module, on the CPU:

- ``train --dp 2 --device cpu`` under ``torchrun --nproc_per_node 2``
  (gloo) on a tiny generated dataset, one epoch with a ragged train and
  a ragged val batch: one set of checkpoints, by rank 0, that loads;
  the ``[dp]`` line once;
- ``--dp 2`` outside such a launch exits naming torchrun, for
  ``train``, ``finetune``, ``evaluate`` and ``upscale``;
  ``evaluate --dp 2`` without ``--tile`` exits, as the JAX CLI;
- ``entry.entry()`` on the CPU to a [1, 256, 256, 3] output;
  ``entry.dryrun_multichip(2)``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.util_fakedata import make_deeprock_dataset

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
# a SwinIR x4 small enough for two CPU ranks: batch 4 of 8^2 LR crops
TINY = ["--model", "swinir", "--embed_dim", "12", "--t_depths", "1", "--t_heads", "2",
        "--window_size", "4", "--patch_size", "8", "--batch_size", "4", "--workers", "1",
        "--loss", "l1", "--epochs", "1", "--seed", "3"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """5 images a split: the train epoch's second batch holds 1 image
    (padded to 2 with a weight-0 wrap), validation runs batches of 2, 2
    and 1 (the last whole on every rank)."""
    root = tmp_path_factory.mktemp("dpcli")
    make_deeprock_dataset(root / "data", n_per_split=5, hr_size=32, scale="X4", seed=6)
    return root


def test_train_under_torchrun(data):
    from tpu_superresolution_torch.train.checkpoint import read_checkpoint

    workdir = data / "run"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "tpu_superresolution_torch.cli.train", "--data_root", str(data / "data"),
         "--scale", "X4", "--workdir", str(workdir), "--device", "cpu", "--dp", "2"] + TINY,
        capture_output=True, text=True, timeout=240, env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout
    assert out.count("[dp] data-parallel over 2 devices (gloo") == 1, out
    assert out.count("[ckpt] saved best_X4") == 1, out
    names = sorted(p.name for p in workdir.iterdir())
    assert names == ["best_X4.pth", "bestpsnr_X4.pth", "loss_curve_X4.png", "run_X4.json"] or \
        names == ["best_X4.pth", "bestpsnr_X4.pth", "run_X4.json"], names
    saved = read_checkpoint(str(workdir / "best_X4.pth"))
    assert saved["step"] == 2 and saved["config"]["embed_dim"] == 12


def _train(data, tmp_path):
    from tpu_superresolution_torch.cli.train import main

    return lambda dp: main(["--data_root", str(data / "data"), "--scale", "X4", "--workdir",
                            str(tmp_path), "--device", "cpu", "--dp", dp] + TINY)


def _finetune(data, tmp_path):
    from tpu_superresolution_torch.cli.finetune import main

    return lambda dp: main(["--data_root", str(data / "data"), "--scale", "X4", "--epochs", "1",
                            "--workdir", str(tmp_path), "--device", "cpu", "--dp", dp])


def _evaluate(data, tmp_path):
    from tpu_superresolution_torch.cli.evaluate import main

    return lambda dp: main(["--data_root", str(data / "data"), "--scale", "X4", "--model",
                            "swinir", "--ckpt", str(tmp_path / "m.pth"), "--tile", "8",
                            "--device", "cpu", "--dp", dp])


def _upscale(data, tmp_path):
    from tpu_superresolution_torch.cli.upscale import main

    return lambda dp: main(["--image", str(tmp_path / "a.png"), "--ckpt", str(tmp_path / "m.pth"),
                            "--scale", "X4", "--device", "cpu", "--dp", dp])


@pytest.mark.parametrize("cli", [_train, _finetune, _evaluate, _upscale],
                         ids=["train", "finetune", "evaluate", "upscale"])
def test_dp_outside_torchrun_exits(data, tmp_path, monkeypatch, cli):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match=r"torchrun --nproc_per_node 2 .*\(this launch has 1\)"):
        cli(data, tmp_path)("2")
    assert not torch.distributed.is_initialized()


def test_evaluate_dp_needs_tiles(data, tmp_path):
    from tpu_superresolution_torch.cli.evaluate import main

    with pytest.raises(SystemExit, match="--dp requires --tile"):
        main(["--data_root", str(data / "data"), "--scale", "X4", "--model", "swinir",
              "--ckpt", str(tmp_path / "m.pth"), "--device", "cpu", "--dp", "2"])


def test_entry_runs_on_the_cpu():
    from tpu_superresolution_torch.entry import entry

    fn, args = entry("cpu")
    out = fn(*args)
    assert tuple(out.shape) == (1, 256, 256, 3) and bool(torch.isfinite(out).all())


def test_dryrun_multichip(capsys):
    from tpu_superresolution_torch.entry import dryrun_multichip

    dryrun_multichip(2, timeout_s=240)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[dryrun_multichip] 2 ranks (gloo, CPU) OK") and "(1, 64, 64, 3)" in line
