"""Kernel #7 of the port, the banded ordered scatter-add, the gather's
backward (``csrc/banded_scatter.cu`` with ``ordered_scatter.cuh``): the
kernels of one call of ``launch_scatter`` (count, scan, place, lists, sums
and the scratch's fill).

Counts as ``chip_smoke.py`` counts them: the gradient rows (B, M, K, C) read
once, the indices (B, M, K) int32 read once, the output (B, N, C) written
once, the window starts read once; one addition an input element, at the
float32 rate (the sums accumulate in float32)."""
MODULE = "afford_motion_torch.ops.cuda.banded"
FUNCTION = "launch_scatter"


def counts(args, kwargs):
    """(bytes, operations, the arithmetic's dtype name) of one call
    ``launch_scatter(g, idx, starts, stride, n, s, passes, wide, budget)``."""
    g, idx, starts, n = args[0], args[1], args[2], int(args[4])
    b, m, k, c = g.shape
    e = g.element_size()
    nbytes = b * (m * k * c * e + m * k * 4 + n * c * e) + starts.numel() * 4
    return float(nbytes), float(b * m * k * c), "float32"
