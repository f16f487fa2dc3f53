"""The port's native C++ PNG decoder (``data/native_decode.py`` over
``native/decoder.cpp``, built into the port's own build directory)
against PIL (the port's ``decode_image``) and the JAX package's
``decode_image``, within 1e-6 (2e-6 for RGB -> luma, whose weights the
two compute in another order): 8- and 16-bit gray, RGB, RGBA, gray ->
3 channels; the build into a fresh directory by three processes at once
under the lock; the loader's decoder choice ("auto", "never", "always"),
its PIL fallback on a file of another size, and the decoded-image cache
(uint16, the counter still in the second epoch)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.util_fakedata import make_deeprock_dataset

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def nd():
    from tpu_superresolution_torch.data import native_decode

    if not native_decode.available():
        pytest.skip(f"native decoder unavailable here: {native_decode.unavailable_reason()}")
    return native_decode


def _images(tmp_path):
    rng = np.random.default_rng(0)
    g8 = (rng.random((20, 24)) * 255).astype(np.uint8)
    g16 = (rng.random((20, 24)) * 65535).astype(np.uint16)
    rgb = (rng.random((20, 24, 3)) * 255).astype(np.uint8)
    rgba = (rng.random((20, 24, 4)) * 255).astype(np.uint8)
    paths = {}
    for name, arr in (("g8", g8), ("g16", g16), ("rgb", rgb), ("rgba", rgba)):
        paths[name] = tmp_path / f"{name}.png"  # modes L, I;16, RGB, RGBA
        Image.fromarray(arr).save(paths[name])
    return paths


@pytest.mark.parametrize("name,grayscale,channels,tol", [
    ("g8", True, 1, 1e-6), ("g16", True, 1, 1e-6), ("rgb", False, 3, 1e-6),
    ("rgb", True, 1, 2e-6), ("rgba", False, 3, 1e-6), ("rgba", True, 1, 2e-6),
    ("g8", False, 3, 1e-6), ("g16", False, 3, 1e-6)])
def test_native_matches_pil_and_jax(nd, tmp_path, name, grayscale, channels, tol):
    from tpu_superresolution_tpu.data.decode import decode_image as jax_decode
    from tpu_superresolution_torch.data.decode import decode_image

    path = _images(tmp_path)[name]
    assert nd.probe(path)[:2] == (20, 24)
    got = nd.decode_batch_native([path, path], 20, 24, grayscale, channels)
    assert got.shape == (2, 20, 24, channels)
    for want in (decode_image(path, grayscale, channels), jax_decode(path, grayscale, channels)):
        assert np.abs(got[1] - want).max() <= tol


def test_errors_name_the_file(nd, tmp_path):
    paths = _images(tmp_path)
    with pytest.raises(IOError, match="nope.png"):
        nd.decode_batch_native([tmp_path / "nope.png"], 8, 8)
    with pytest.raises(IOError, match="g8.png"):  # another size
        nd.decode_batch_native([paths["g8"]], 21, 24)


def test_three_processes_build_one_library_under_the_lock(nd, tmp_path):
    code = ("import sys; from pathlib import Path; "
            "from tpu_superresolution_torch.data import native_decode as n; "
            "print(n.build(Path(sys.argv[1])))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "build")], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-400:] for o in outs]
    built = {o[0].strip() for o in outs}
    assert built == {str(nd.library_path(tmp_path / "build"))}
    files = sorted(f.name for f in (tmp_path / "build").iterdir())
    assert files == sorted([Path(built.pop()).name, "native.lock"])  # no temporaries left


def test_loader_decoder_choice_and_fallback(nd, tmp_path, monkeypatch, capsys):
    from tpu_superresolution_torch.data import native_decode
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.loader import Loader

    root = make_deeprock_dataset(tmp_path, splits=("train",), n_per_split=5, hr_size=32,
                                 scale="X4")
    idx = PairedIndex(str(root), "train", "X4")
    auto = Loader(idx, 2, num_threads=2)
    assert auto.decoder == "native" and "native decoder:" in capsys.readouterr().out
    pil = Loader(idx, 2, num_threads=2, use_native="never")
    assert pil.decoder == "PIL"
    for (a_lr, a_hr), (b_lr, b_hr) in zip(auto, pil, strict=True):
        assert np.abs(a_lr - b_lr).max() <= 1e-6 and np.abs(a_hr - b_hr).max() <= 1e-6
    # a file of another size: that batch goes to PIL, said once
    odd = idx.pairs[0][1]
    Image.fromarray(np.zeros((30, 32), np.uint8)).save(odd)
    lr, hr = next(iter(Loader(idx, 1, num_threads=1)))
    assert hr.shape == (1, 30, 32, 1) and "decoded with PIL" in capsys.readouterr().out
    monkeypatch.setattr(native_decode, "unavailable_reason", lambda: "no g++ here")
    with pytest.raises(RuntimeError, match="no g\\+\\+ here"):
        Loader(idx, 2, use_native="always")
    assert Loader(idx, 2).decoder == "PIL"
    assert "native decoder: unavailable (no g++ here)" in capsys.readouterr().out


def test_decoded_cache_replays_quantized_pixels(nd, tmp_path):
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.loader import Loader

    root = make_deeprock_dataset(tmp_path, splits=("train",), n_per_split=4, hr_size=32,
                                 scale="X4")
    loader = Loader(PairedIndex(str(root), "train", "X4"), 2, num_threads=2, cache_decoded=True)
    nd.decodes.reset()
    first = list(loader)
    assert nd.decodes.count == 4 and nd.decodes.images == 8  # 2 batches x (LR, HR)
    second = list(loader)
    assert nd.decodes.count == 4  # all from the cache
    for (a_lr, a_hr), (b_lr, b_hr) in zip(first, second, strict=True):
        for a, b in ((a_lr, b_lr), (a_hr, b_hr)):
            np.testing.assert_array_equal(
                b, (a * 65535.0 + 0.5).astype(np.uint16).astype(np.float32) / 65535.0)
    full = Loader(PairedIndex(str(root), "train", "X4"), 2, num_threads=2, cache_decoded=True,
                  cache_limit_gb=0.0)  # nothing fits: each epoch decodes
    list(full)
    list(full)
    assert nd.decodes.count == 4 + 8
