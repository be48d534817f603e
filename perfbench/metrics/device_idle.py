"""Device: the share of the traced segment in which no operation ran on the
card (the union of the trace's kernels, copies and fills), in %."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
