"""Device time by program layer: each device operation of the kernel segment
put down to the program's span (``afford_motion_torch/utils/trace.py``)
whose profiler range, ``am.<span>``, launched it.

For each device operation:

1. its launch on the host is found by correlation id;
2. a launch inside an ``am.`` range of its own thread (the loop's) goes to
   the innermost such range;
3. a launch inside an autograd node (autograd's thread) goes through the
   node's ``sequence_nr`` and forward thread to the forward operation that
   made the node (the last forward operation of that thread to carry the
   number), and from there to the innermost ``am.`` range that holds it;
4. anything else is ``unattributed``.

The events come as :class:`HostEvent` and :class:`DeviceOp`
(:func:`from_kineto` turns a profiler's events into them), so that the rule
can be tested on an event list built by hand.

No run calls it yet: a traced run would have to switch the program's tracer
on before the loop is built (``runners/train_loop.py``) and hand the kernel
segment's events here (``harness/trace.py``'s ``stop_kernels``)."""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

PREFIX = "am."
UNATTRIBUTED = "unattributed"
LAUNCHES = ("LaunchKernel", "cudaMemsetAsync", "cudaMemcpyAsync", "cuLaunch")


class HostEvent(NamedTuple):
    name: str
    thread: int
    start_ns: int
    end_ns: int
    sequence_nr: int = -1  # the forward op's; -1 where autograd numbered none
    fwd_thread: int = 0  # an autograd node's forward thread; 0 elsewhere
    correlation: int = 0  # a launch's, which its device operation carries


class DeviceOp(NamedTuple):
    name: str
    correlation: int
    duration_ns: int


def from_kineto(device, host) -> Tuple[List[DeviceOp], List[HostEvent]]:
    """The profiler's device operations and host events as plain records.
    A range's copy on the device's timeline (its time there, under the
    launching thread's id) is left out: only the host's ranges say what the
    host was doing."""
    ops = [DeviceOp(e.name(), e.correlation_id(), e.duration_ns()) for e in device]
    events = [HostEvent(e.name(), e.start_thread_id(), e.start_ns(),
                        e.start_ns() + e.duration_ns(), e.sequence_nr(), e.fwd_thread_id(),
                        e.correlation_id()) for e in host
              if not (e.name().startswith(PREFIX) and "CPU" not in str(e.device_type()))]
    return ops, events


class _Innermost:
    """The innermost of a thread's nested ranges that holds a time."""

    def __init__(self, ranges: Iterable[Tuple[int, int, object]]):
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.ranges]
        # each range's enclosing range: ranges of one thread nest
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (s, e, _) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t: int) -> Optional[object]:
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.ranges[j][1] < t:
            j = self.parent[j]  # climb out of ranges that ended before t
        return self.ranges[j][2] if j >= 0 else None


def _per_thread(items) -> Dict[int, _Innermost]:
    by: Dict[int, list] = {}
    for thread, rng in items:
        by.setdefault(thread, []).append(rng)
    return {t: _Innermost(r) for t, r in by.items()}


def device_seconds(ops: List[DeviceOp], events: List[HostEvent]) -> Dict[str, float]:
    """Seconds of device time per span name (``unattributed`` included);
    a span of the segment that launched nothing reads 0."""
    spans = _per_thread((e.thread, (e.start_ns, e.end_ns, e.name[len(PREFIX):]))
                        for e in events if e.name.startswith(PREFIX))
    nodes = _per_thread((e.thread, (e.start_ns, e.end_ns, (e.sequence_nr, e.fwd_thread)))
                        for e in events if e.fwd_thread > 0 and e.sequence_nr >= 0)
    # an op records the number the next autograd node will take, so the ops
    # before the one that makes node n (no-grad ones too) share its n: the
    # last to start with that number is the one, or an op inside it
    forward: Dict[Tuple[int, int], int] = {}
    launch: Dict[int, Tuple[int, int]] = {}
    for e in events:
        if e.fwd_thread <= 0 and e.sequence_nr >= 0:
            key = (e.sequence_nr, e.thread)
            forward[key] = max(forward.get(key, e.start_ns), e.start_ns)
        if any(w in e.name for w in LAUNCHES):
            launch[e.correlation] = (e.thread, e.start_ns)

    def span_at(thread: int, t: int) -> Optional[str]:
        inner = spans.get(thread)
        return inner.at(t) if inner is not None else None

    # every span of the segment, those that launched nothing at 0
    out: Dict[str, float] = {e.name[len(PREFIX):]: 0.0 for e in events
                             if e.name.startswith(PREFIX)}
    for op in ops:
        if op.name.startswith(PREFIX):
            continue  # a range drawn on the device's timeline, not an operation
        name = None
        where = launch.get(op.correlation)
        if where is not None:
            thread, t = where
            name = span_at(thread, t)
            if name is None and thread in nodes:
                node = nodes[thread].at(t)
                if node is not None:
                    seq, fwd_thread = node
                    at = forward.get((seq, fwd_thread))
                    if at is not None:
                        name = span_at(fwd_thread, at)
        key = name or UNATTRIBUTED
        out[key] = out.get(key, 0.0) + op.duration_ns * 1e-9
    return out
