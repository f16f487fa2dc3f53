"""The port's entry points with the CNN families on the CPU: ``train``
with no ``--model`` (MS_ResUNet at full width, the pre-upscale
convention) on a tiny DeepRockSR-layout set for two epochs with
``--do_blur --normalize --cache_decoded`` (the second epoch decodes
nothing), then ``evaluate``, ``upscale`` and the serve service with no
``--model`` on its checkpoint; ``--model unet2d --residual``; the
transformer-only flags refused for the CNNs; a UNet2D reference
checkpoint refused (there is no reference format); a pre-upscale train
step against the JAX package's augmentation + step on the same draws."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from tests.util_fakedata import make_deeprock_dataset

torch.set_num_threads(2)

TINY = ["--scale", "X4", "--device", "cpu", "--batch_size", "2", "--patch_size", "24",
        "--workers", "2", "--seed", "3"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from tpu_superresolution_torch.cli.train import main

    tmp = tmp_path_factory.mktemp("cnn")
    root = make_deeprock_dataset(tmp / "data", n_per_split=4, hr_size=32, scale="X4")
    workdir = tmp / "run"
    trainer, state = main(["--data_root", str(root), "--workdir", str(workdir), "--epochs", "2",
                           "--do_blur", "--normalize", "--cache_decoded"] + TINY)
    return root, workdir, trainer, state


def test_train_defaults_to_msresunet_with_the_data_flags(trained):
    from tpu_superresolution_torch.data import native_decode

    _, workdir, trainer, state = trained
    assert state.model.config.name == "ms_resunet" and state.step == 4
    report = json.loads((workdir / "run_X4.json").read_text())
    dcfg = report["data_config"]
    assert dcfg["convention"] == "pre_upscale" and dcfg["patch_size"] == 24
    assert dcfg["do_blur"] and dcfg["norm_mean"] is not None and dcfg["norm_std"] > 0
    assert all(np.isfinite(trainer.history["train"])) and np.isfinite(trainer.best_val_psnr)
    if native_decode.available():  # epoch 2 comes from the decoded-image cache
        assert trainer.history["native_decodes"] == [4, 0]
    bn = state.model.bn1
    assert float(bn.running_var.min()) != 1.0  # train mode updated the running statistics


def test_evaluate_upscale_and_serve_load_it_with_no_model_flag(trained, tmp_path):
    from tpu_superresolution_torch.cli.evaluate import main as evaluate
    from tpu_superresolution_torch.cli.serve import SRService
    from tpu_superresolution_torch.cli.upscale import main as upscale

    root, workdir, _, _ = trained
    ckpt = str(workdir / "best_X4.pth")
    res = evaluate(["--data_root", str(root), "--scale", "X4", "--ckpt", ckpt, "--device", "cpu",
                    "--save_n", "1", "--save_dir", str(tmp_path / "preds")])
    assert res["n"] == 4 and np.isfinite(res["psnr"])
    assert (tmp_path / "preds" / "idx_000000_sr.png").exists()
    src = tmp_path / "in.png"
    Image.fromarray((np.random.default_rng(0).random((9, 11)) * 255).astype(np.uint8)).save(src)
    out = tmp_path / "out.png"
    assert upscale(["--image", str(src), "--ckpt", ckpt, "--scale", "X4", "--out", str(out),
                    "--device", "cpu"]) == [str(out)]
    with Image.open(out) as im:
        assert im.size == (44, 36)
    svc = SRService(ckpt, "ms_resunet", "X4", None, -1, 16, 2, device="cpu")
    assert svc.mcfg.name == "ms_resunet" and svc.convention == "pre_upscale"
    with pytest.raises(SystemExit, match="X4"):
        upscale(["--image", str(src), "--ckpt", ckpt, "--scale", "X2", "--device", "cpu"])


def test_unet2d_residual_trains_and_upscales(trained, tmp_path):
    from tpu_superresolution_torch.cli.train import main
    from tpu_superresolution_torch.cli.upscale import main as upscale

    root = trained[0]
    trainer, state = main(["--data_root", str(root), "--workdir", str(tmp_path), "--epochs", "1",
                           "--model", "unet2d", "--base_channels", "8", "--depth", "2",
                           "--residual"] + TINY)
    cfg = state.model.config
    assert (cfg.name, cfg.base_channels, cfg.depth, cfg.residual) == ("unet2d", 8, 2, True)
    assert np.isfinite(trainer.history["train"][0])
    src = tmp_path / "in.png"
    Image.fromarray((np.random.default_rng(1).random((8, 12)) * 255).astype(np.uint8)).save(src)
    out = tmp_path / "out.png"
    upscale(["--image", str(src), "--ckpt", str(tmp_path / "best_X4.pth"), "--model", "unet2d",
             "--scale", "X4", "--out", str(out), "--device", "cpu"])
    with Image.open(out) as im:
        assert im.size == (48, 32)


@pytest.mark.parametrize("flag", [["--embed_dim", "32"], ["--t_depths", "2"], ["--t_heads", "2"],
                                  ["--window_size", "8"], ["--mlp_ratio", "2"]])
@pytest.mark.parametrize("model", ["ms_resunet", "unet2d"])
def test_transformer_flags_refused_for_the_cnns(trained, tmp_path, flag, model):
    from tpu_superresolution_torch.cli.train import main

    with pytest.raises(SystemExit, match="transformer-only"):
        main(["--data_root", str(trained[0]), "--workdir", str(tmp_path), "--model", model]
             + TINY + flag)


def test_unet2d_reference_checkpoint_refused(tmp_path):
    from tpu_superresolution_torch.cli.upscale import load_any_checkpoint
    from tpu_superresolution_torch.core.config import UNet2DConfig, build_model

    path = tmp_path / "u.pth"
    torch.save({"params": build_model(UNet2DConfig(base_channels=4, depth=2)).state_dict()},
               path)
    with pytest.raises(SystemExit, match="no reference checkpoint format"):
        load_any_checkpoint(str(path), "unet2d", 4, device=torch.device("cpu"))


def test_preupscale_step_matches_jax(rng):
    """One engine step of a small UNet2D, normalized, without crops or
    flips (patch None: the pre-upscale only), against the JAX package's
    ``make_train_step`` from the same weights: the loss within 1e-5
    relative, the updated weights within 0.1 lr (Adam's first step is
    lr * g / (|g| + eps): near-zero gradient entries move by a share of
    lr that fp32 rounding of g decides)."""
    import jax

    from tests.test_torch_unet2d import _pair
    from tpu_superresolution_tpu.core.config import TrainConfig as JaxTrainConfig
    from tpu_superresolution_tpu.train.engine import build_optimizer as jax_opt
    from tpu_superresolution_tpu.train.engine import create_train_state as jax_state
    from tpu_superresolution_tpu.train.engine import make_train_step as jax_step
    from tpu_superresolution_torch.core.config import TrainConfig
    from tpu_superresolution_torch.interop import unet2d_state_dict_from_jax
    from tpu_superresolution_torch.train.engine import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    _, jmodel, variables, port = _pair(5, residual=True)
    lr = rng.random((2, 4, 6, 1), dtype=np.float32)
    hr = rng.random((2, 16, 24, 1), dtype=np.float32)
    norm = (0.45, 0.2)
    tx = jax_opt(JaxTrainConfig(lr=1e-3, scheduler="none"), 1, variables["params"])
    js = jax_state(jmodel, variables["params"], variables["batch_stats"], tx)
    js, jm = jax_step(jmodel, "mse", "pre_upscale", 4, None, False, norm=norm)(
        js, lr, hr, jax.random.key(0))
    opt, sched = build_optimizer(TrainConfig(lr=1e-3, scheduler="none"), 1, port)
    st = create_train_state(port, opt, sched)
    m = make_train_step("mse", "pre_upscale", 4, None, False, norm=norm)(st, lr, hr)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5 * float(jm["loss"])
    want = unet2d_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, js.params),
                                       "batch_stats": js.batch_stats})
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert np.abs(v.numpy() - want[k]).max() <= 1e-4, k
