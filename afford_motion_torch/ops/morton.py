"""Morton (Z-order) spatial ordering for point clouds (numpy-only copy of
``afford_motion_tpu/ops/morton.py``).

Storing scene clouds in Morton order makes kNN neighbourhoods index-local:
most of a point's nearest neighbours lie within a few hundred rows of it.
The banded kernels (``ops/cuda/banded.py``) rest on that locality: the
windowed kNN measures distances against a window of support rows around
each 128-query tile instead of all N points, and the neighbourhood gather
and scatter-add take the same windows.

The order is a pure relabeling of the points: models are permutation-
equivariant over the cloud (per-point conditioning rides along), so sorted
and unsorted data are interchangeable; only the banded path requires sorted
input.
"""
from __future__ import annotations

import numpy as np


def morton_codes(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """(N, 3) float -> (N,) uint64 interleaved-bit Z-order codes."""
    p = np.asarray(points, dtype=np.float64)
    lo = p.min(axis=0)
    extent = np.ptp(p, axis=0) + 1e-9
    q = ((p - lo) / extent * ((1 << bits) - 1)).astype(np.uint64)
    code = np.zeros(len(p), dtype=np.uint64)
    for b in range(bits):
        for a in range(3):
            code |= ((q[:, a] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + a)
    return code


def morton_order(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """Permutation that sorts points into Morton order (stable)."""
    return np.argsort(morton_codes(points, bits), kind="stable")


def sort_contact_npz(npz_path: str, out_path: str | None = None,
                     curve: str = "morton") -> bool:
    """Rewrite a contacts ``.npz`` (points (N,C), dist (N,J), optional
    mask) with rows in ``curve`` order of the xyz columns. Returns True if
    rewritten. Idempotent (sorting sorted data is a no-op permutation)."""
    data = dict(np.load(npz_path))
    if "points" not in data:
        return False
    from .curves import curve_order

    order = curve_order(np.asarray(data["points"])[:, :3], curve)
    for key, v in data.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == len(order):
            data[key] = v[order]
    np.savez(out_path or npz_path, **data)
    return True
