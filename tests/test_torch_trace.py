"""The port's tracer (``afford_motion_torch/utils/trace.py``) on the CPU: off
it records nothing and hands out one shared null context; on, spans nest,
keep their identifiers across the producer and loop threads and enclose the
profiler's ``am.`` range of the same name. And the benchmark's reducer of
device time by program span (``perfbench/harness/program_layers.py``) on a
hand-built event list."""
import threading

import numpy as np
import pytest
import torch

from afford_motion_torch.parallel.mesh import DevicePrefetcher
from afford_motion_torch.utils import trace
from perfbench.harness.program_layers import (
    UNATTRIBUTED,
    DeviceOp,
    HostEvent,
    device_seconds,
    from_kineto,
)


@pytest.fixture
def tracer():
    """The tracer switched on, empty, and off again afterwards."""
    trace.take()
    trace.totals()
    trace.enable()
    yield trace
    trace.disable()
    trace.take()
    trace.totals()


def test_off_records_nothing_and_shares_one_null_context():
    trace.disable()
    trace.take()
    trace.totals()
    first, second = trace.span("a"), trace.span("b", step=3)
    assert first is second
    with first:
        with trace.span("c", megabatch=1):
            trace.count("n", 5)
    assert not trace.enabled()
    assert trace.take() == []
    assert trace.totals() == {"seconds": {}, "counts": {}}


def test_spans_nest_with_their_parents_and_count(tracer):
    with trace.span("outer", step=7):
        with trace.span("inner"):
            trace.count("n")
            trace.count("n", 2)
    inner, outer = trace.take()
    assert (inner.name, inner.parent, inner.ids) == ("inner", "outer", {})
    assert (outer.name, outer.parent, outer.ids) == ("outer", None, {"step": 7})
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.thread == outer.thread == threading.get_ident()
    totals = trace.totals()
    assert totals["counts"] == {"n": 3}
    assert set(totals["seconds"]) == {"outer", "inner"}
    assert totals["seconds"]["outer"] >= totals["seconds"]["inner"] >= 0
    assert trace.take() == [] and trace.totals() == {"seconds": {}, "counts": {}}


def test_ids_join_the_producer_and_the_loop_across_threads(tracer):
    """The producer thread's ``producer: prepare`` / ``upload`` of megabatch
    m (numbered from ``first``), a child span inside the preparation, and
    the loop thread's wait for m: one identifier, two threads."""

    def prepare(i):
        with trace.span("store: draw batch"):
            return {"x": np.full((4,), i, np.float32)}

    pf = DevicePrefetcher(lambda: iter(range(5)), prepare, "cpu", first=10)
    got = []
    for m in range(10, 16):
        with trace.span("loop: wait", megabatch=m):
            item = next(iter(pf), None)
        if item is None:
            break
        got.append(int(item["x"][0]))
    pf.close()
    assert got == list(range(5))
    records = trace.take()
    by = {}
    for r in records:
        by.setdefault(r.name, []).append(r)
    prepared = [r.ids["megabatch"] for r in by["producer: prepare"]]
    assert prepared[:5] == list(range(10, 15))  # the sixth looked for the stream's end
    assert [r.ids["megabatch"] for r in by["producer: upload"]] == list(range(10, 15))
    assert [r.ids["megabatch"] for r in by["loop: wait"]] == list(range(10, 16))
    assert all(r.parent == "producer: prepare" for r in by["store: draw batch"])
    producer = {r.thread for r in by["producer: prepare"] + by["store: draw batch"]}
    assert producer == {pf._thread.ident} != {threading.get_ident()}
    assert {r.thread for r in by["loop: wait"]} == {threading.get_ident()}
    # megabatch m's upload ends before the loop's wait for m does
    ends = {r.ids["megabatch"]: r.end_ns for r in by["producer: upload"]}
    assert all(ends[r.ids["megabatch"]] <= r.end_ns for r in by["loop: wait"][:5])
    counts = trace.totals()["counts"]
    assert counts["producer: bytes uploaded"] == 5 * 4 * 4
    assert 1 <= counts.get("loop: empty-queue waits", 0) <= 6


def test_a_span_encloses_its_profiler_range_on_one_clock(tracer):
    """Under a CPU ``torch.profiler`` the span is also the range
    ``am.<name>``, and the two agree to within a millisecond: the span's
    ``time.time_ns()`` is the clock the profiler stamps its events with."""
    from torch.profiler import ProfilerActivity, profile

    lin = torch.nn.Linear(16, 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("clock"):
            lin(torch.randn(8, 16)).sum().backward()
    (record,) = trace.take()
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name() == "am.clock"]
    assert len(ranges) == 1
    start, end = ranges[0].start_ns(), ranges[0].start_ns() + ranges[0].duration_ns()
    assert record.start_ns <= start and end <= record.end_ns
    assert start - record.start_ns < 1e6 and record.end_ns - end < 1e6


def test_a_thread_the_profiler_does_not_record_enters_no_range(tracer):
    """The profiler records the thread that started it: a span of another
    thread (the producer's while the loop profiles) is recorded and enters
    no ``am.`` range, so no range outlives the session it began in."""
    from torch.profiler import ProfilerActivity, profile

    def producer():
        with trace.span("producer: prepare", megabatch=0):
            torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("loop: step", step=0):
            worker = threading.Thread(target=producer)
            worker.start()
            worker.join()
    assert sorted(r.name for r in trace.take()) == ["loop: step", "producer: prepare"]
    assert [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(trace.PREFIX)] == ["am.loop: step"]


def test_a_span_opened_before_the_profiler_enters_no_range(tracer):
    """A span open when a session starts is recorded whole and enters no
    range; the spans begun inside the session do."""
    from torch.profiler import ProfilerActivity, profile

    with trace.span("loop: wait", megabatch=2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("loop: step", step=8):
                torch.ones(4).sum()
    inner, outer = trace.take()
    assert (inner.name, inner.parent, outer.name) == ("loop: step", "loop: wait", "loop: wait")
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(trace.PREFIX)] == ["am.loop: step"]


def test_without_ranges_a_span_records_and_the_profiler_sees_none(tracer):
    """``enable(ranges=False)``: the span is recorded, the profiler's trace
    holds no ``am.`` range, and ``enable()`` brings the ranges back."""
    from torch.profiler import ProfilerActivity, profile

    trace.enable(ranges=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("quiet"):
            torch.ones(4).sum()
    assert [r.name for r in trace.take()] == ["quiet"]
    assert not [e for e in prof.profiler.kineto_results.events()
                if e.name().startswith(trace.PREFIX)]
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("loud"):
            torch.ones(4).sum()
    assert [r.name for r in trace.take()] == ["loud"]
    assert [e.name() for e in prof.profiler.kineto_results.events()
            if e.name().startswith(trace.PREFIX)] == ["am.loud"]


def test_end_ranges_ends_the_range_and_the_span_goes_on(tracer):
    """A profiler that stops inside an open span: ``end_ranges`` ends the
    span's range in that session; the span itself records to its end."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with trace.span("straddle"):
        torch.ones(4).sum()
        trace.end_ranges()
        prof.stop()
        torch.ones(4).sum()
    (record,) = trace.take()
    (rng,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "am.straddle"]
    assert record.start_ns <= rng.start_ns() and rng.start_ns() + rng.duration_ns() <= (
        record.end_ns)


# --------------------------------------------------------------- the reducer
# the loop's thread 1 and autograd's thread 2; times in ns
LOOP, AUTOGRAD = 1, 2
EVENTS = [
    # a no-grad op before the model carries the number of the next node to be made
    HostEvent("am.step: assemble", LOOP, 10, 50),
    HostEvent("aten::index_select", LOOP, 20, 30, sequence_nr=41),
    HostEvent("am.model: denoiser", LOOP, 100, 200),
    HostEvent("am.step: loss", LOOP, 90, 300),
    HostEvent("aten::addmm", LOOP, 110, 130, sequence_nr=41),
    HostEvent("cudaLaunchKernel", LOOP, 120, 125, correlation=1),  # forward, in the denoiser
    HostEvent("cudaLaunchKernel", LOOP, 250, 255, correlation=2),  # forward, in the loss
    HostEvent("am.step: backward", LOOP, 400, 600),
    HostEvent("autograd::engine::evaluate_function: AddmmBackward0", AUTOGRAD, 450, 480,
              sequence_nr=41, fwd_thread=LOOP),
    HostEvent("AddmmBackward0", AUTOGRAD, 451, 479, sequence_nr=41, fwd_thread=LOOP),
    HostEvent("cudaLaunchKernel", AUTOGRAD, 460, 462, correlation=3),  # its backward
    HostEvent("cudaLaunchKernel", AUTOGRAD, 700, 702, correlation=4),  # in no node
    HostEvent("cudaMemcpyAsync", 3, 800, 805, correlation=5),  # another thread, no range
]
OPS = [DeviceOp("sm90_gemm_fwd", 1, 1000), DeviceOp("elementwise_kernel", 2, 300),
       DeviceOp("sm90_gemm_bwd", 3, 2000), DeviceOp("reduce_kernel", 4, 50),
       DeviceOp("Memcpy HtoD", 5, 70), DeviceOp("fill_kernel", 99, 5)]


def test_a_forward_kernel_goes_to_the_innermost_range_that_launched_it():
    seconds = device_seconds(OPS[:2], EVENTS)
    assert seconds["model: denoiser"] == pytest.approx(1000e-9)
    assert seconds["step: loss"] == pytest.approx(300e-9)
    assert seconds["step: backward"] == 0.0  # a range that launched nothing reads 0


def test_a_backward_kernel_goes_to_its_forward_range_through_sequence_nr():
    """Through the node's number to the op that made the node (the
    ``addmm`` in the denoiser), not to the earlier no-grad op in the
    assembly that carries the same number."""
    seconds = device_seconds(OPS[2:3], EVENTS)
    assert seconds["model: denoiser"] == pytest.approx(2000e-9)
    assert seconds["step: assemble"] == 0.0 and UNATTRIBUTED not in seconds


def test_an_orphan_kernel_is_unattributed():
    seconds = device_seconds(OPS, EVENTS)
    # outside any node, on a thread without ranges, and with no launch at all
    assert seconds[UNATTRIBUTED] == pytest.approx((50 + 70 + 5) * 1e-9)
    assert seconds["model: denoiser"] == pytest.approx(3000e-9)
    assert sum(seconds.values()) == pytest.approx(sum(op.duration_ns for op in OPS) * 1e-9)


class _Event:
    """A profiler event as ``from_kineto`` reads it."""

    def __init__(self, name, device, thread, start, end, seq=-1, fwd=0, corr=0):
        self._v = (name, device, thread, start, end, seq, fwd, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_thread_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4] - self._v[3]

    def sequence_nr(self):
        return self._v[5]

    def fwd_thread_id(self):
        return self._v[6]

    def correlation_id(self):
        return self._v[7]


def test_a_ranges_copy_on_the_device_timeline_names_nothing():
    """The profiler also draws each range where the device ran its work,
    under the launching thread's id and later than the host's range: a
    launch of the model that falls in that copy still goes to the model."""
    cpu, cuda = "DeviceType.CPU", "DeviceType.CUDA"
    host = [_Event("am.step: assemble", cpu, LOOP, 10, 50),
            _Event("am.model: denoiser", cpu, LOOP, 100, 200),
            _Event("am.step: assemble", cuda, LOOP, 110, 160),  # the device's copy
            _Event("cudaLaunchKernel", cpu, LOOP, 120, 125, corr=1)]
    ops, events = from_kineto([_Event("sm90_gemm", cuda, 7, 300, 400, corr=1)], host)
    assert [e.name for e in events].count("am.step: assemble") == 1
    assert device_seconds(ops, events) == pytest.approx(
        {"step: assemble": 0.0, "model: denoiser": 100e-9})
