"""Build the hand-written Hopper kernels in ``afford_motion_torch/csrc`` and
bind them with ctypes.

The ``.cu`` files are compiled with nvcc, at first use (one nvcc process per
source, all started together, then one link), into one shared library with
a plain C interface in ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``). The library's name carries a hash of
the sources and flags, so an edited kernel is rebuilt and a stale library
is never loaded. ``-fmad=false`` keeps nvcc from contracting ``a*b+c`` into
an FMA anywhere; the distance kernels also spell their rounding out with
``__fmul_rn``/``__fadd_rn``, because their picks must be bit-equal to the
plain PyTorch versions, and the attention kernel asks for its FMAs with
``fmaf``.

Every C entry point launches on the stream it is given, returns the
``cudaError_t`` of ``cudaGetLastError()`` right after the launch, and
allocates nothing; :func:`check` turns a non-zero code into an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = ("fps.cu", "knn.cu", "gather.cu", "scatter.cu", "banded_knn.cu", "banded_gather.cu",
           "banded_scatter.cu", "nn1.cu", "attention.cu")
HEADERS = ("ordered_scatter.cuh",)  # included by the sources; part of the library's hash
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the card the launch configurations are chosen for (an H100 SXM): its
# streaming multiprocessors, and the dynamic shared memory a block may take
# (227 KB) less 1 KB for a kernel's static shared memory
SMS = 132
SMEM_BYTES = 232448 - 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (xyz, b, n, m, out, stream)
    "amt_fps": [_P, _I, _I, _I, _P, _P],
    # (xyz, b, n, m, field, out, stream)
    "amt_fps_streamed": [_P, _I, _I, _I, _P, _P, _P],
    # (support, query, b, n, m, ssorted, sorder, scodes, qorder, qcodes, stream)
    "amt_knn_order": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # (query, qorder, qcodes, ssorted, sorder, scodes, b, m, n, k, threads, split, part_keys,
    #  idx, dist, stream)
    "amt_knn_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # (x, idx, b, n, c, m, k, elem_bytes, mode, wide, span, out, stream)
    "amt_gather_rows": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # (g, idx, b, n, c, mk, elem_bytes, passes, wide, budget, scratch, out, stream)
    "amt_scatter_add_rows": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # (query, support, starts, starts_stride, b, m, n, s, k, queries, groups, idx, dist,
    #  flushes, stream)
    "amt_knn_banded": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # (x, idx, starts, starts_stride, b, n, c, m, k, s, elem_bytes, parts, staged, out, stream)
    "amt_gather_banded": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # (g, idx, starts, starts_stride, b, n, c, m, k, s, elem_bytes, passes, wide, budget, scratch,
    #  out, stream)
    "amt_scatter_banded": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # (points, verts, l, o, h, scratch, d2, idx, visits, stream)
    "amt_nn1": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    # (q, k, v, mask, b, lq, lk, heads, hd, scale, elem_bytes, out, lse, stream)
    "amt_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P, _P, _P],
    # the same with a launch configuration before the stream
    "amt_attention_config": [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P, _P,
                             _I, _P],
    # (q, k, v, o, dout, lse, mask, b, lq, lk, heads, hd, scale, elem_bytes, scratch, dq, dk,
    #  dv, stream)
    "amt_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                          _P, _P, _P, _P, _P],
}
# entry points that return something other than a CUDA error code:
# {name: (argtypes, restype)}
_SIZES = {
    # (b, lq, lk, heads, elem_bytes) -> bytes of amt_attention_bwd's scratch
    "amt_attention_bwd_scratch": ([_I, _I, _I, _I, _I], ctypes.c_longlong),
    # (b, n, mk) -> int32 entries of amt_scatter_add_rows' and amt_scatter_banded's scratch
    "amt_scatter_scratch": ([_I, _I, _I], ctypes.c_longlong),
    # (l, o, h) -> bytes of amt_nn1's scratch
    "amt_nn1_scratch": ([_I, _I, _I], ctypes.c_longlong),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "on a machine with the CUDA toolkit"
    )


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libamt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for them exists. The
    compiler's output (ptxas registers / shared memory per kernel) is kept
    beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, obj in zip(SOURCES, objects)]
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(name, proc.returncode, log)
                  for name, proc, log in zip(SOURCES, procs, logs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("\n".join(
                f"nvcc failed on {name} with exit code {rc}:\n{log}" for name, rc, log in failed))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link with exit code {link.returncode}:\n"
                               f"{link.stdout}{link.stderr}")
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, out)
    finally:
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, (argtypes, restype) in _SIZES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            lib.amt_error_string.argtypes = [ctypes.c_int]
            lib.amt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        msg = library().amt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {t.device}")
