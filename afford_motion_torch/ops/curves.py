"""Space-filling-curve orderings for point clouds, Morton (Z-order) and
Hilbert (numpy-only copy of ``afford_motion_tpu/ops/curves.py``).

Both make kNN neighbourhoods index-local, so the banded kernels
(``ops/cuda/banded.py``) can restrict distance, gather and scatter work to a
window of rows around each query tile. Hilbert improves on Morton's
locality: consecutive codes are always spatially adjacent cells, where
Morton has long jumps at octant boundaries. Sorting is a pure relabeling
either way: models are permutation-equivariant over the cloud, so sorted and
unsorted data are interchangeable; only the banded path requires a
locality-preserving order (``python -m afford_motion_torch.prepare sort``).
"""
from __future__ import annotations

import numpy as np

from .morton import morton_codes, morton_order

CURVES = ("morton", "hilbert")


def hilbert_codes(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """(N, 3) float -> (N,) uint64 Hilbert-curve codes.

    Quantizes to a 2^bits grid per axis (same normalization as
    ``morton_codes``), then applies Skilling's transpose algorithm
    ("Programming the Hilbert curve", AIP CP707, 2004) vectorized over
    rows, and interleaves the transposed bits into one index.
    """
    p = np.asarray(points, dtype=np.float64)
    lo = p.min(axis=0)
    extent = np.ptp(p, axis=0) + 1e-9
    q = ((p - lo) / extent * ((1 << bits) - 1)).astype(np.uint64)
    return hilbert_from_ints(q, bits)


def hilbert_from_ints(grid: np.ndarray, bits: int) -> np.ndarray:
    """(N, 3) uint grid coords in [0, 2^bits) -> (N,) uint64 Hilbert index.

    Exhaustively verified bijective with unit-step adjacency between
    consecutive indices (the defining Hilbert property) at bits<=3 in
    tests/test_curves.py.
    """
    X = np.array(grid, dtype=np.uint64, copy=True)
    n = 3
    M = np.uint64(1) << np.uint64(bits - 1)

    # inverse undo excess work
    Q = M
    while Q > np.uint64(1):
        P = Q - np.uint64(1)
        for i in range(n):
            mask = (X[:, i] & Q) != 0
            X[mask, 0] ^= P
            t = (X[:, 0] ^ X[:, i]) & P
            nm = ~mask
            X[nm, 0] ^= t[nm]
            X[nm, i] ^= t[nm]
        Q >>= np.uint64(1)

    # Gray encode
    for i in range(1, n):
        X[:, i] ^= X[:, i - 1]
    t = np.zeros(len(X), dtype=np.uint64)
    Q = M
    while Q > np.uint64(1):
        mask = (X[:, n - 1] & Q) != 0
        t[mask] ^= Q - np.uint64(1)
        Q >>= np.uint64(1)
    for i in range(n):
        X[:, i] ^= t

    # interleave transposed bits (X[0] most significant at each level)
    code = np.zeros(len(X), dtype=np.uint64)
    for b in range(bits):
        for i in range(n):
            code |= ((X[:, i] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                n * b + (n - 1 - i)
            )
    return code


def curve_codes(points: np.ndarray, curve: str, bits: int = 10) -> np.ndarray:
    if curve == "morton":
        return morton_codes(points, bits)
    if curve == "hilbert":
        return hilbert_codes(points, bits)
    raise ValueError(f"unknown curve {curve!r} (choose from {CURVES})")


def curve_order(points: np.ndarray, curve: str, bits: int = 10) -> np.ndarray:
    """Permutation sorting points along the curve (stable)."""
    if curve == "morton":
        return morton_order(points, bits)
    return np.argsort(curve_codes(points, curve, bits), kind="stable")


def matching_curves(points: np.ndarray, bits: int = 10) -> tuple:
    """All supported curves the rows are monotone under (checked on
    full-precision points). What the banded kernels actually require is
    monotonicity under SOME locality curve per item — degenerate clouds
    (constant/duplicated coordinates) can be monotone under both."""
    matches = []
    for curve in CURVES:
        codes = curve_codes(points, curve, bits)
        if bool(np.all(codes[:-1] <= codes[1:])):
            matches.append(curve)
    return tuple(matches)


def detect_curve(points: np.ndarray, bits: int = 10) -> str | None:
    """First matching curve in CURVES order, or None (see
    ``matching_curves`` for the multi-match form)."""
    matches = matching_curves(points, bits)
    return matches[0] if matches else None
