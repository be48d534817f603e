"""Kernel #6 of the port, the banded (windowed) neighbourhood gather
(``csrc/banded_gather.cu``): one kernel a call of ``launch_gather``.

Counts as ``chip_smoke.py`` counts them: the source rows ``x`` (B, N, C)
read once, the indices (B, M, K) int32 read once, the output (B, M, K, C)
written once, the window starts read once; no arithmetic."""
MODULE = "afford_motion_torch.ops.cuda.banded"
FUNCTION = "launch_gather"


def counts(args, kwargs):
    """(bytes, operations, the inputs' dtype name) of one call
    ``launch_gather(x, idx, starts, stride, s, parts, staged)``."""
    x, idx, starts = args[0], args[1], args[2]
    b, n, c = x.shape
    _, m, k = idx.shape
    e = x.element_size()
    nbytes = b * (n * c * e + m * k * 4 + m * k * c * e) + starts.numel() * 4
    return float(nbytes), 0.0, str(x.dtype).replace("torch.", "")
