"""MRCCM preparation in the PyTorch port against the JAX package's
(``data/mrccm.py``, ``cli/prepare_mrccm.py``) on small classic .mat
volumes: the same files, split counts and pixels (the HR slices exact,
the LR slices that ``--force_4x`` resizes within one 16-bit level: the
two resizes' fp32 products may round a value across a level), the
16-bit PNGs through the native decoder's big-endian path,
``mat_volume_pairs``, ``load_mat_volume``'s key choice and the v7.3
branch's h5py error."""

import builtins

import numpy as np
import pytest
from PIL import Image
from scipy.io import savemat


@pytest.fixture(scope="module")
def mats(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mats")
    rng = np.random.default_rng(0)
    lr = rng.random((12, 10, 9)) * 3000.0  # CT-like range; force_4x resizes 10x9 -> 8x8
    hr1 = rng.random((12, 32, 32)) * 1000.0 + 50.0
    hr2 = rng.random((7, 32, 32)).astype(np.float32)
    savemat(tmp / "lr.mat", {"vol": lr, "small": np.zeros(3)})
    savemat(tmp / "hr1.mat", {"vol": hr1})
    savemat(tmp / "hr2.mat", {"vol": hr2})
    return tmp


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.png"))


def test_prepare_matches_jax(mats, tmp_path):
    from tpu_superresolution_tpu.cli.prepare_mrccm import main as jax_main
    from tpu_superresolution_torch.cli.prepare_mrccm import main

    argv = ["--lr_mat", str(mats / "lr.mat"), "--hr", f"ILS1={mats / 'hr1.mat'}",
            "--hr", f"ILS2={mats / 'hr2.mat'}", "--scale", "X4", "--force_4x"]
    ours = main(argv + ["--out_root", str(tmp_path / "ours")])
    theirs = jax_main(argv + ["--out_root", str(tmp_path / "jax")])
    assert ours == theirs == {"train": 16, "valid": 2, "test": 1}
    files = _tree(tmp_path / "ours")
    assert files == _tree(tmp_path / "jax") and len(files) == 2 * 19
    for rel in files:
        with Image.open(tmp_path / "ours" / rel) as a, Image.open(tmp_path / "jax" / rel) as b:
            x, y = np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64)
        assert x.shape == y.shape
        assert np.abs(x - y).max() <= (1 if "_LR_" in rel else 0), rel
    assert "shuffled2D/shuffled2D_test_LR_default_X4/ILS1_00009x4.png" in files
    with pytest.raises(SystemExit, match="NAME=path"):
        main(["--lr_mat", "a.mat", "--hr", "b.mat", "--out_root", str(tmp_path / "x")])


def test_prepared_set_decodes_natively_as_with_pil(mats, tmp_path):
    from tpu_superresolution_torch.data import native_decode
    from tpu_superresolution_torch.data.decode import decode_image
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.mrccm import prepare_mrccm

    if not native_decode.available():
        pytest.skip(f"native decoder unavailable: {native_decode.unavailable_reason()}")
    counts = prepare_mrccm(mats / "lr.mat", {"ILS1": str(mats / "hr1.mat")}, tmp_path,
                           force_4x=True, limit_slices=5)
    assert counts == {"train": 5, "valid": 0, "test": 0}
    idx = PairedIndex(str(tmp_path), "train", "X4")
    assert native_decode.probe(idx[0][1]) == (32, 32, 1, 16)
    got = native_decode.decode_batch_native([p[1] for p in idx.pairs], 32, 32)
    want = np.stack([decode_image(p[1]) for p in idx.pairs])
    assert np.abs(got - want).max() <= 1e-6


def test_mat_volume_pairs_and_loading(mats, monkeypatch):
    from tpu_superresolution_tpu.data.mrccm import mat_volume_pairs as jax_pairs
    from tpu_superresolution_torch.data import mrccm

    lr, hr = mrccm.mat_volume_pairs(mats / "lr.mat", mats / "hr2.mat", limit_pairs=4)
    jlr, jhr = jax_pairs(mats / "lr.mat", mats / "hr2.mat", limit_pairs=4)
    assert lr.shape == (4, 10, 9, 1) and hr.shape == (4, 32, 32, 1)
    np.testing.assert_array_equal(lr, jlr)
    np.testing.assert_array_equal(hr, jhr)
    assert 0.0 <= lr.min() and lr.max() <= 1.0
    assert mrccm.load_mat_volume(mats / "lr.mat", key="small").shape == (1, 1, 3)
    assert np.all(mrccm.normalize_volume(np.full((2, 3, 3), 7.0)) == 0)

    # a v7.3 file is HDF5: scipy refuses it, and without h5py the error names it
    def refuse(path):
        raise NotImplementedError("Please use HDF reader for matlab v7.3 files")

    real_import = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *a, **k)

    monkeypatch.setattr("scipy.io.loadmat", refuse)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="needs h5py"):
        mrccm.load_mat_volume(mats / "lr.mat")
