"""Kernels: the port's kernels that ``perfbench/roofline`` counts, over the
traced segment, in %: the sum over their launches of the least time the
card could take (bytes at the memory's rate or operations at the inputs'
peak, whichever is larger), over the sum of the same launches' device time
from the trace. Nothing is read where no such kernel ran, or where a launch's
device time could not be found in the trace."""


def read(run):
    roof = (run.get("trace") or {}).get("roofline")
    if not roof or roof["calls"] == 0 or roof["timed_calls"] != roof["calls"]:
        return None
    return 100.0 * roof["bound_s"] / roof["device_s"]
