"""Which weights the port's CLIs load from a checkpoint of its own train
CLI that kept an EMA: the raw parameters for ``upscale`` / ``serve``
(``load_for_inference``), ``compare`` and ``mat_eval`` (its ``--ema``
off by default), as the JAX CLIs load ``restored["params"]``; the EMA
for ``evaluate``, whose JAX CLI picks it by default.  The checkpoint's
EMA is its parameters + 1, so every output tells the two apart."""

import numpy as np
import pytest
import torch

from tests.util_fakedata import make_deeprock_dataset

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """(root, checkpoint path, raw model, EMA model): a small SwinIR x4
    saved as the train CLI saves, with ema = params + 1 and ema_decay
    0.999."""
    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model

    root = tmp_path_factory.mktemp("ema_default")
    make_deeprock_dataset(root / "data", n_per_split=2, hr_size=32, scale="X4", seed=4)
    cfg = SwinIRConfig(embed_dim=12, depths=(1,), num_heads=(2,), window_size=4, num_feat=8,
                       drop_path_rate=0.0)
    raw = build_model(cfg)
    raw.reset_parameters(torch.Generator().manual_seed(0))
    ema = {k: p.detach() + 1.0 for k, p in raw.named_parameters()}
    path = root / "best_X4.pth"
    torch.save({"params": raw.state_dict(), "ema": ema, "optimizer": {}, "step": 3,
                "config": cfg.to_dict(), "extra": {"epoch": 1, "ema_decay": 0.999}}, path)
    ema_model = build_model(cfg)
    ema_model.load_state_dict(dict(raw.state_dict(), **ema))
    return root, str(path), raw.eval(), ema_model.eval()


def _forward(model, lr):
    with torch.no_grad():
        return model(torch.from_numpy(lr)).numpy()


def test_load_for_inference_takes_the_raw_parameters(ckpt, capsys):
    from tpu_superresolution_torch.cli.upscale import load_for_inference

    _, path, raw, ema = ckpt
    _, model, _, _, _ = load_for_inference(path, "swinir", "X4", None, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, raw.state_dict()[k]), k
    out = capsys.readouterr().out
    assert "EMA" not in out and "--no-ema" not in out


def test_upscale_writes_the_raw_model_output(ckpt, tmp_path):
    from PIL import Image

    from tpu_superresolution_torch.cli.upscale import main
    from tpu_superresolution_torch.data.decode import decode_image

    root, path, raw, ema = ckpt
    src = sorted((root / "data").rglob("*x4.png"))[0]
    out = tmp_path / "sr.png"
    main(["--image", str(src), "--ckpt", path, "--scale", "X4", "--out", str(out),
          "--device", "cpu"])
    lr = decode_image(src, grayscale=False, channels=3)[None]
    want = np.clip(_forward(raw, lr)[0], 0, 1) * 255.0 + 0.5
    got = np.asarray(Image.open(out), np.float64)
    assert np.abs(got - want.astype(np.uint8)).max() == 0
    other = (np.clip(_forward(ema, lr)[0], 0, 1) * 255.0 + 0.5).astype(np.uint8)
    assert np.abs(got - other).max() > 0


def test_compare_takes_the_raw_parameters(ckpt, tmp_path):
    from tpu_superresolution_torch.cli.compare import main
    from tpu_superresolution_torch.data.decode import decode_image
    from tpu_superresolution_torch.data.index import PairedIndex

    root, path, raw, _ = ckpt
    stats = main(["--data_root", str(root / "data"), "--scale", "X4", "--ckpt_a", path,
                  "--ckpt_b", path, "--name_a", "a", "--name_b", "b", "--indices", "0",
                  "--out_dir", str(tmp_path), "--device", "cpu"])
    lr_path, _ = PairedIndex(str(root / "data"), "test", "X4").pairs[0]
    want = _forward(raw, decode_image(lr_path, grayscale=False, channels=3)[None])[0]
    for label in ("a", "b"):
        assert np.abs(stats[label]["sr"][0] - want).max() <= 1e-6, label


def _mats(root):
    from scipy.io import savemat

    hr = (np.random.default_rng(3).random((2, 16, 16)) * 1000).astype(np.float32)
    savemat(root / "hr.mat", {"vol": hr})
    savemat(root / "lr.mat", {"vol": hr[:, ::4, ::4].copy()})


@pytest.mark.parametrize("flag", [[], ["--ema"]], ids=["default_raw", "ema_flag"])
def test_mat_eval_takes_the_raw_parameters_unless_asked(ckpt, tmp_path, flag):
    from tpu_superresolution_torch.cli.mat_eval import main
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.data.mrccm import mat_volume_pairs
    from tpu_superresolution_torch.evaluate.runner import Evaluator

    _, path, raw, ema = ckpt
    _mats(tmp_path)
    got = main(["--hr_mat", str(tmp_path / "hr.mat"), "--lr_mat", str(tmp_path / "lr.mat"),
                "--ckpt", path, "--batch_size", "2", "--device", "cpu"] + flag)
    lr, hr = mat_volume_pairs(str(tmp_path / "lr.mat"), str(tmp_path / "hr.mat"), None)
    want = {}
    for name, model in (("raw", raw), ("ema", ema)):
        ev = Evaluator(model, 4, "native_lr", EvalConfig(batch_size=2), log=lambda m: None,
                       device="cpu")
        want[name] = ev.run([(lr, hr)])["psnr"]
    assert abs(want["raw"] - want["ema"]) > 1e-3
    assert got["psnr"] == pytest.approx(want["ema" if flag else "raw"], abs=1e-9)


def test_evaluate_takes_the_ema_by_default(ckpt, capsys):
    from tpu_superresolution_torch.cli.evaluate import main
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.loader import Loader
    from tpu_superresolution_torch.evaluate.runner import Evaluator

    root, path, raw, ema = ckpt
    got = main(["--data_root", str(root / "data"), "--scale", "X4", "--ckpt", path,
                "--batch_size", "2", "--workers", "1", "--no_baseline", "--save_n", "0",
                "--device", "cpu"])
    assert "using the EMA weights" in capsys.readouterr().out
    loader = Loader(PairedIndex(str(root / "data"), "test", "X4"), 2, grayscale=False,
                    channels=3, num_threads=1)
    want = {}
    for name, model in (("raw", raw), ("ema", ema)):
        ev = Evaluator(model, 4, "native_lr", EvalConfig(batch_size=2), log=lambda m: None,
                       device="cpu")
        want[name] = ev.run(loader)["psnr"]
    assert abs(want["raw"] - want["ema"]) > 1e-3
    assert got["psnr"] == pytest.approx(want["ema"], abs=1e-9)
