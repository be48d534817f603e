"""The port's native IO bindings (``afford_motion_torch/native``) against
the JAX package's (``afford_motion_tpu/native``) and ``np.load``, on the
zoo of ``tests/test_native_io.py``: the v2 header, npz (stored and
compressed members), Fortran order, object arrays and a missing file; and
the port's own build of ``native/am_io.cpp``, which lands in the ignored
``build/`` and leaves the tracked ``native/build/libam_io.so`` as it was."""
import hashlib
from pathlib import Path

import numpy as np
import pytest

from afford_motion_tpu import native as jax_nio
from afford_motion_torch import native as nio

REPO = Path(__file__).resolve().parents[1]
TRACKED = REPO / "native" / "build" / "libam_io.so"


def _sha(path):
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def tracked_before():
    return _sha(TRACKED)


@pytest.fixture
def zoo(tmp_path):
    from numpy.lib import format as npf

    rng = np.random.default_rng(0)
    cases = [((196, 263), np.float32), ((8192, 3), np.float16), ((100,), np.int16),
             ((3, 4, 5, 6), np.float64), ((7,), np.int64), ((2, 2), np.uint8),
             ((0, 5), np.float32), ((), np.float32)]
    out = []
    for i, (shape, dt) in enumerate(cases):
        a = (rng.normal(size=shape) * 100).astype(dt)
        np.save(tmp_path / f"{i}.npy", a)
        out.append(tmp_path / f"{i}.npy")
    with open(tmp_path / "v2.npy", "wb") as f:
        npf.write_array(f, np.arange(10, dtype=np.int32), version=(2, 0))
    np.save(tmp_path / "fortran.npy", np.asfortranarray(np.arange(12.0).reshape(3, 4)))
    np.savez(tmp_path / "z.npz", points=rng.normal(size=(128, 3)).astype(np.float32),
             idx=rng.integers(0, 100, size=(5,)).astype(np.int16), mask=np.arange(10) > 4)
    np.savez_compressed(tmp_path / "c.npz", x=np.ones(100))
    return out + [tmp_path / "v2.npy", tmp_path / "fortran.npy"], tmp_path


def test_builds_into_the_ignored_directory(tracked_before):
    assert nio.available()
    lib = nio.library_path()
    assert lib.exists() and lib.parent == REPO / "build" / "native"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert _sha(TRACKED) == tracked_before


def test_reads_equal_the_jax_package_and_np_load(zoo):
    files, root = zoo
    for path in files:
        want = np.load(path)
        for got in (nio.load(str(path)), nio.load_npy(path), jax_nio.load(str(path))):
            assert got.dtype == want.dtype and got.shape == want.shape, path.name
            np.testing.assert_array_equal(got, want, err_msg=path.name)
    many = nio.batch_load_npy([str(p) for p in files])
    for path, got in zip(files, many):
        np.testing.assert_array_equal(got, np.load(path), err_msg=path.name)
    same = [str(files[0])] * 5
    stacked = nio.stack_load_npy(same)
    assert stacked.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(stacked, jax_nio.stack_load_npy(same))
    for name in ("z.npz", "c.npz"):
        want, got, ref = np.load(root / name), nio.load(str(root / name)), jax_nio.load(
            str(root / name))
        assert sorted(got.files) == sorted(want.files) == sorted(ref.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{name} {k}")
    with pytest.raises(KeyError):
        nio.load(str(root / "z.npz"))["nope"]


def test_fallbacks_raise_as_numpy_does(zoo):
    _, root = zoo
    with pytest.raises(FileNotFoundError):
        nio.load(str(root / "missing.npy"))
    with pytest.raises(FileNotFoundError):
        nio.load(str(root / "missing.npz"))
    np.save(root / "o.npy", np.array([{"a": 1}], dtype=object), allow_pickle=True)
    assert nio.load(str(root / "o.npy"), allow_pickle=True)[0]["a"] == 1
    with pytest.raises(ValueError):
        nio.load(str(root / "o.npy"))
    with pytest.raises(ValueError):  # mixed shapes: the error np.stack raises
        nio.stack_load_npy([str(root / "0.npy"), str(root / "1.npy")])


def test_rebuild_into_another_directory_leaves_the_tracked_library(tmp_path, monkeypatch,
                                                                   tracked_before):
    monkeypatch.setattr(nio, "BUILD_DIR", tmp_path / "native")
    out = nio.build()
    assert out.parent == tmp_path / "native" and out.stat().st_size > 0
    assert not list((tmp_path / "native").glob("*.tmp"))
    assert _sha(TRACKED) == tracked_before


def test_am_native_0_reads_through_np_load(tmp_path, monkeypatch):
    """A fresh process state with ``AM_NATIVE=0``: no library, same arrays."""
    monkeypatch.setenv("AM_NATIVE", "0")
    monkeypatch.setattr(nio, "_lib", None)
    monkeypatch.setattr(nio, "_tried", False)
    assert not nio.available()
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.save(tmp_path / "a.npy", a)
    np.testing.assert_array_equal(nio.load(str(tmp_path / "a.npy")), a)
    np.testing.assert_array_equal(nio.stack_load_npy([str(tmp_path / "a.npy")] * 2),
                                  np.stack([a, a]))
