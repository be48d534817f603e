"""ctypes bindings to the native IO core ``native/am_io.cpp``: ``.npy``
headers parsed in C++, payloads pread into caller-owned numpy buffers, and
whole batches fanned across a C++ thread pool with the GIL released (ctypes
releases it for the call's duration). ``stack_load_npy`` preads every file's
payload straight into the rows of one contiguous batch array, so the
collate happens inside the read.

The library is compiled with ``g++`` from ``native/am_io.cpp`` at first use,
into ``build/native/`` at the root of the checkout (listed in
``.gitignore``); its name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library never loaded. Every entry point
falls back to ``np.load`` when the compiler or the build is missing, when
``AM_NATIVE=0``, and for files the fast path does not cover (compressed npz
members, object arrays, Fortran order). The first load logs which route the
process took.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..utils.io import get_logger

logger = get_logger()

_REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _REPO_ROOT / "native" / "am_io.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library for the current source and flags lives (built or
    not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libam_io_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/am_io.cpp`` unless the library for it exists; a
    process-private temporary name is renamed into place, so processes that
    build at once never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, c++ or $CXX) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed on {SOURCE.name} with exit code "
                               f"{proc.returncode}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    signatures = {
        "am_npy_header": [ctypes.c_char_p, ctypes.c_char_p, i64p, i32p, i32p, i64p, i64p],
        "am_pread_file": [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p],
        "am_batch_pread": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), i64p, i64p,
                           ctypes.POINTER(ctypes.c_void_p), ctypes.c_int],
        "am_batch_header": [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), ctypes.c_char_p,
                            i64p, i32p, i32p, i64p, i64p, ctypes.c_int],
        "am_npy_header_at": [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, i64p, i32p,
                             i32p, i64p, i64p],
        "am_npz_index": [ctypes.c_char_p, ctypes.c_char_p, i64p, ctypes.c_int],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        if os.environ.get("AM_NATIVE", "1") == "0":
            logger.info("native IO: off (AM_NATIVE=0); reading through np.load")
        else:
            try:
                path = build()
                _lib = _bind(ctypes.CDLL(str(path)))
                logger.info(f"native IO: {path.relative_to(_REPO_ROOT)} "
                            f"(built from {SOURCE.relative_to(_REPO_ROOT)})")
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                logger.warning(f"native IO: unavailable ({e}); reading through np.load")
        _tried = True
        return _lib


def available() -> bool:
    return _load_lib() is not None


def _default_threads(n: int) -> int:
    # reads are I/O-bound, not CPU-bound: keep a minimum of 4 in flight
    return max(1, min(n, max(4, (os.cpu_count() or 1) * 2), 16))


def _header(lib, path: str, base: int = 0):
    """-> (dtype, shape, data_offset), or None where the fast path cannot
    serve the file."""
    descr = ctypes.create_string_buffer(16)
    shape = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int32()
    fortran = ctypes.c_int32()
    off = ctypes.c_int64()
    nbytes = ctypes.c_int64()
    rc = lib.am_npy_header_at(
        path.encode(), base, descr, shape, ctypes.byref(ndim),
        ctypes.byref(fortran), ctypes.byref(off), ctypes.byref(nbytes))
    if rc != 0 or fortran.value:
        return None
    try:
        dt = np.dtype(descr.value.decode())
    except TypeError:
        return None
    if dt.hasobject:
        return None
    shp = tuple(shape[i] for i in range(ndim.value))
    if int(np.prod(shp, dtype=np.int64)) * dt.itemsize > nbytes.value:
        return None
    return dt, shp, off.value


def _pread(lib, path: str, h) -> Optional[np.ndarray]:
    dt, shp, off = h
    out = np.empty(shp, dtype=dt)
    rc = lib.am_pread_file(path.encode(), off, out.nbytes, out.ctypes.data_as(ctypes.c_void_p))
    return out if rc == 0 else None


def load_npy(path: str | os.PathLike) -> np.ndarray:
    """``np.load`` of one ``.npy`` file through the native reader."""
    path = os.fspath(path)
    lib = _load_lib()
    if lib is None or not path.endswith(".npy"):
        return np.load(path)
    h = _header(lib, path)
    out = None if h is None else _pread(lib, path, h)
    return np.load(path) if out is None else out


class NpzView:
    """Lazy ``.npz`` mapping over the native reader: a member is read only
    when it is accessed (``np.load``'s NpzFile semantics without the
    zipfile parse, so ``npz['dist']`` reads one member)."""

    def __init__(self, path: str, members):
        self._path = path
        self._members = members  # name (no .npy suffix) -> npy base offset

    @property
    def files(self):
        return list(self._members)

    def keys(self):
        return self._members.keys()

    def __contains__(self, name):
        return name in self._members

    def __iter__(self):
        return iter(self._members)

    def __len__(self):
        return len(self._members)

    def __getitem__(self, name) -> np.ndarray:
        lib = _load_lib()
        h = _header(lib, self._path, self._members[name])
        out = None if h is None else _pread(lib, self._path, h)
        return np.load(self._path)[name] if out is None else out

    def get(self, name, default=None):
        return self[name] if name in self._members else default

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self):
        pass


def load_npz(path: str | os.PathLike):
    """``np.load`` of a ``.npz`` through the native zip index (``np.load``
    for compressed members and files it cannot parse)."""
    path = os.fspath(path)
    lib = _load_lib()
    if lib is None:
        return np.load(path)
    max_n = 256
    names = ctypes.create_string_buffer(80 * max_n)
    offs = (ctypes.c_int64 * max_n)()
    n = lib.am_npz_index(path.encode(), names, offs, max_n)
    if n <= 0:
        return np.load(path)
    members = {}
    for i in range(n):
        raw = names.raw[80 * i: 80 * (i + 1)].split(b"\0", 1)[0].decode()
        if offs[i] < 0:  # a compressed member: numpy reads the whole file
            return np.load(path)
        members[raw[:-4] if raw.endswith(".npy") else raw] = offs[i]
    return NpzView(path, members)


def load(path, **kwargs):
    """Drop-in ``np.load``: ``.npy`` and ``.npz`` paths take the native
    route, everything else (``allow_pickle``, ``mmap_mode``, file objects)
    goes straight to numpy."""
    if kwargs or not isinstance(path, (str, os.PathLike)):
        return np.load(path, **kwargs)
    p = os.fspath(path)
    if p.endswith(".npz"):
        return load_npz(p)
    if not p.endswith(".npy"):
        return np.load(p)
    return load_npy(p)


def batch_load_npy(paths: Sequence[str], nthreads: int = 0) -> List[np.ndarray]:
    """Read many ``.npy`` files in one parallel native call (GIL released)."""
    paths = [os.fspath(p) for p in paths]
    lib = _load_lib()
    if lib is None or not paths:
        return [np.load(p) for p in paths]
    nthreads = nthreads or _default_threads(len(paths))
    hs = _batch_headers(lib, paths, nthreads)
    if hs is None:
        return [np.load(p) for p in paths]
    outs = [np.empty(shp, dtype=dt) for dt, shp, _ in hs]
    rc = _batch_pread(lib, paths, [h[2] for h in hs], [o.nbytes for o in outs],
                      [o.ctypes.data for o in outs], nthreads)
    return [np.load(p) for p in paths] if rc != 0 else outs


def stack_load_npy(paths: Sequence[str], nthreads: int = 0) -> np.ndarray:
    """Read N same-shape ``.npy`` files straight into one (N, *shape) array:
    the parallel reads are the collate (no per-item intermediates)."""
    paths = [os.fspath(p) for p in paths]
    lib = _load_lib()
    if lib is None or not paths:
        return np.stack([np.load(p) for p in paths])
    n = len(paths)
    nthreads = nthreads or _default_threads(n)
    hs = _batch_headers(lib, paths, nthreads)
    if hs is None or len({(h[0], h[1]) for h in hs}) != 1:
        return np.stack([np.load(p) for p in paths])
    dt, shp, _ = hs[0]
    out = np.empty((n,) + shp, dtype=dt)
    row = out.nbytes // n
    rc = _batch_pread(lib, paths, [h[2] for h in hs], [row] * n,
                      [out.ctypes.data + i * row for i in range(n)], nthreads)
    return np.stack([np.load(p) for p in paths]) if rc != 0 else out


def _batch_headers(lib, paths: List[str], nthreads: int):
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    descrs = ctypes.create_string_buffer(16 * n)
    shapes = (ctypes.c_int64 * (8 * n))()
    ndims = (ctypes.c_int32 * n)()
    fortrans = (ctypes.c_int32 * n)()
    offs = (ctypes.c_int64 * n)()
    nbytes = (ctypes.c_int64 * n)()
    rc = lib.am_batch_header(n, c_paths, descrs, shapes, ndims, fortrans, offs, nbytes,
                             nthreads)
    if rc != 0:
        return None
    out = []
    for i in range(n):
        if fortrans[i]:
            return None
        raw = descrs.raw[16 * i: 16 * (i + 1)].split(b"\0", 1)[0]
        try:
            dt = np.dtype(raw.decode())
        except TypeError:
            return None
        if dt.hasobject:
            return None
        shp = tuple(shapes[8 * i + d] for d in range(ndims[i]))
        if int(np.prod(shp, dtype=np.int64)) * dt.itemsize > nbytes[i]:
            return None
        out.append((dt, shp, offs[i]))
    return out


def _batch_pread(lib, paths, offsets, sizes, addresses, nthreads) -> int:
    """``addresses``: integer addresses of buffers the caller keeps alive
    for the call."""
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_offs = (ctypes.c_int64 * n)(*offsets)
    c_sizes = (ctypes.c_int64 * n)(*[int(s) for s in sizes])
    c_ptrs = (ctypes.c_void_p * n)(*addresses)
    return lib.am_batch_pread(n, c_paths, c_offs, c_sizes, c_ptrs, nthreads)
