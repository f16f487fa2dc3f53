"""The port's chrome-trace recorder (``utils/trace.py``) against the JAX
package's, and ``--trace`` on the port's train and finetune CLIs
(``--device cpu``), as ``tests/test_trace.py`` checks the JAX ones."""

import json
import time

import pytest
import torch

from tests.util_fakedata import make_deeprock_dataset

torch.set_num_threads(1)


def _record(rec):
    """The same calls on either package's recorder."""
    with rec.span("epoch 1", track="train", loss=0.5, skipme=None):
        time.sleep(0.002)
    rec.complete("val 1", rec.elapsed_s, 0.25, track="val", psnr=30.0)
    rec.counter("train_loss", 0.5)
    rec.counter("val_psnr", 31.0, ts_us=12.0)
    rec.instant("ckpt", track="train", path="best_X2")
    with rec.span("epoch 2", track="train"):
        pass


def _structure(doc):
    """Everything but the measured times."""
    evs = [{k: v for k, v in e.items() if k not in ("ts", "dur")} for e in doc["traceEvents"]]
    return {"displayTimeUnit": doc["displayTimeUnit"], "events": evs}


def test_recorder_writes_the_jax_structure(tmp_path):
    from tpu_superresolution_tpu.utils.trace import TraceRecorder as JaxRecorder
    from tpu_superresolution_torch.utils.trace import TraceRecorder

    docs = []
    for cls, name in ((TraceRecorder, "port.json"), (JaxRecorder, "jax.json")):
        rec = cls()
        _record(rec)
        rec.save(str(tmp_path / name))
        docs.append(json.loads((tmp_path / name).read_text()))
    assert _structure(docs[0]) == _structure(docs[1])
    assert [e["ph"] for e in docs[0]["traceEvents"]] == [e["ph"] for e in docs[1]["traceEvents"]]


def test_recorder_times_and_tracks(tmp_path):
    from tpu_superresolution_torch.utils.trace import TraceRecorder

    rec = TraceRecorder()
    _record(rec)
    rec.save(str(tmp_path / "t.json"))
    evs = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    meta = {e["args"]["name"]: e["tid"] for e in evs if e["ph"] == "M"}
    assert set(meta) == {"train", "val", "main"}  # the counters' events take "main"
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert spans["epoch 1"]["dur"] >= 2_000  # us
    assert spans["epoch 1"]["args"] == {"loss": 0.5}  # None args dropped
    assert spans["val 1"]["dur"] == pytest.approx(250_000)
    assert spans["epoch 1"]["tid"] == spans["epoch 2"]["tid"] == meta["train"]
    assert spans["val 1"]["tid"] == meta["val"]
    assert next(e for e in evs if e["ph"] == "C" and "val_psnr" in e["args"])["ts"] == 12.0
    assert all(e["dur"] >= 0 for e in spans.values())


def _events(path):
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    spans = [e for e in evs if e["ph"] == "X"]
    counters = {k for e in evs if e["ph"] == "C" for k in e["args"]}
    tracks = {e["tid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    return spans, counters, tracks


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace")
    make_deeprock_dataset(root / "x2", hr_size=48, scale="X2", n_per_split=4)
    make_deeprock_dataset(root / "x4", hr_size=64, scale="X4", n_per_split=4, seed=1)
    return root


def test_train_cli_trace_flag(data, tmp_path, capsys):
    """The JAX test's run (tests/test_trace.py::test_train_cli_trace_flag)
    on the port: UNet2D base 4, depth 1, two epochs."""
    from tpu_superresolution_torch.cli.train import main

    trace = tmp_path / "timeline.json"
    main(["--data_root", str(data / "x2"), "--scale", "X2", "--model", "unet2d",
          "--base_channels", "4", "--depth", "1", "--epochs", "2", "--batch_size", "4",
          "--patch_size", "32", "--lr", "1e-3", "--workdir", str(tmp_path), "--workers", "2",
          "--trace", str(trace), "--device", "cpu"])
    assert f"[trace] saved chrome-trace timeline to {trace}" in capsys.readouterr().out
    spans, counters, tracks = _events(trace)
    assert {e["name"] for e in spans} == {"epoch 1", "epoch 2", "val 1", "val 2"}
    ep1 = next(e for e in spans if e["name"] == "epoch 1")
    assert set(ep1["args"]) == {"loss", "data_s_per_batch", "step_s_per_batch"}
    val1 = next(e for e in spans if e["name"] == "val 1")
    assert set(val1["args"]) == {"loss", "psnr", "ssim"}
    assert tracks[ep1["tid"]] == "train" and tracks[val1["tid"]] == "val"
    assert counters == {"train_loss", "val_psnr"}
    assert all(e["dur"] >= 0 for e in spans)


def test_finetune_cli_trace_flag(data, tmp_path, capsys):
    from tpu_superresolution_torch.cli.finetune import main

    trace = tmp_path / "ft.json"
    main(["--data_root", str(data / "x4"), "--scale", "X4", "--epochs", "1", "--embed_dim",
          "24", "--depths", "2", "--num_heads", "2", "--lr_patch", "8", "--batch_size", "2",
          "--workers", "2", "--workdir", str(tmp_path), "--trace", str(trace),
          "--device", "cpu"])
    assert "[trace] saved chrome-trace timeline" in capsys.readouterr().out
    spans, counters, _ = _events(trace)
    assert {e["name"] for e in spans} == {"epoch 1", "val 1"}
    assert counters == {"train_loss", "val_psnr"}
