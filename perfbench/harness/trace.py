"""The traced segment of a run: ``torch.profiler`` over a fixed number of
steps, the launches of the port's kernels that ``perfbench/roofline``
names (observed from the benchmark's side: their counts recorded and each
call marked by a profiler range), and the reduction of the trace to the
device's busy time, the time by kernel class, the longest idle gaps by what
the host was doing, and each observed launch's device time."""
from __future__ import annotations

import bisect
import contextlib
import importlib
import re
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import peaks

# the port's kernels (csrc/*.cu), by name (tools/profile_train_step.py's list)
PORT_KERNELS = re.compile(
    r"(?<![a-z0-9_])(attention_bf16|attention_bwd_bf16|attention_bwd_f32|attention_f32|count|fps|"
    r"fps_streamed|gather_banded|gather_rows|knn_banded|knn_merge|knn_scan|lists|nn1_scan|"
    r"nn1_sort|order|place|scan|sums)_kernel(?![a-z0-9_])")
# the other kernel classes, by a word of the kernel's name; the first that
# matches takes it (tools/profile_train_step.py's classes, memory copies added)
KERNEL_CLASSES = (
    ("GEMMs", ("gemm", "cutlass", "xmma", "nvjet", "sm90_", "sm80_", "cublas")),
    ("softmax", ("softmax",)),
    ("norms", ("layer_norm", "batch_norm", "welford")),
    ("optimizer", ("adam", "multi_tensor")),
    ("reductions", ("reduce",)),
    ("memory copies", ("memcpy", "memset")),
    ("copies and casts", ("copy", "cat", "index", "gather", "scatter", "fill")),
    ("elementwise", ("elementwise",)),
)
TOP = 10
GAPS_NAMED = 200  # the longest gaps looked up in the host's trace
LAUNCHES = ("LaunchKernel", "cudaMemsetAsync", "cudaMemcpyAsync", "cuLaunch")


def kernel_class(name: str) -> str:
    low = name.lower()
    if PORT_KERNELS.search(low):
        return "the port's kernels"
    return next((c for c, words in KERNEL_CLASSES if any(w in low for w in words)), "other")


def _is_device(e) -> bool:
    """A kernel, copy or fill on the card; not a profiler range drawn on the
    card's timeline."""
    return ("CUDA" in str(e.device_type()).upper() and not e.is_user_annotation()
            and not e.name().startswith("perfbench.") and e.duration_ns() > 0)


class Tracer:
    """Two traced segments of the loop, each bounded by device synchronizes:

    - the device segment, under ``torch.profiler`` with the CUDA activity
      alone (no host operation recorded, so that the host runs near its
      untraced pace): the card's busy time, its time by kernel class, and
      its longest idle gaps named by the benchmark's host spans (``span``,
      on the host's clock, which the trace shares) that held their middle;
    - the kernel segment, with the host's operations too: each launch that
      ``perfbench/roofline`` names is counted and marked by a profiler
      range, and its device time is that of the kernels launched inside the
      range."""

    def __init__(self, roofline_files: List[Path], load_module):
        self.calls: List[Tuple[str, float, float, str]] = []
        self.observing = self.spanning = False
        self.spans: List[Tuple[str, int, int]] = []
        self._restore = []
        for path in roofline_files:
            spec = load_module(path)
            module = importlib.import_module(spec.MODULE)
            original = getattr(module, spec.FUNCTION)
            setattr(module, spec.FUNCTION, self._observe(path.stem, spec, original))
            self._restore.append((module, spec.FUNCTION, original))
        self.window_s = 0.0
        self.device = self.roofline = None

    def _observe(self, name: str, spec, original):
        def launch(*args, **kwargs):
            if not self.observing:
                return original(*args, **kwargs)
            nbytes, flops, dtype = spec.counts(args, kwargs)
            i = len(self.calls)
            self.calls.append((name, nbytes, flops, dtype))
            with torch.profiler.record_function(f"perfbench.roofline.{name}#{i}"):
                return original(*args, **kwargs)

        return launch

    def wrap(self, obj, attr: str, name: str) -> None:
        """Time every call of ``obj.attr`` as the host span ``name`` while
        the device segment runs."""
        original = getattr(obj, attr)

        def call(*args, **kwargs):
            with self.span(name):
                return original(*args, **kwargs)

        setattr(obj, attr, call)
        self._restore.append((obj, attr, original))

    def restore(self) -> None:
        for obj, attr, original in reversed(self._restore):
            setattr(obj, attr, original)
        self._restore = []

    def span(self, name: str):
        return _Span(self, name) if self.spanning else contextlib.nullcontext()

    def start_device(self, device) -> None:
        from torch.profiler import ProfilerActivity, profile

        _sync(device)
        self._prof = profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                                         else ProfilerActivity.CPU])
        self._prof.start()
        self.spanning = True
        self._t0 = time.monotonic()

    def stop_device(self, device) -> None:
        _sync(device)
        self.window_s = time.monotonic() - self._t0
        self.spanning = False
        self._prof.stop()
        self.device = [(e.name(), e.start_ns(), e.duration_ns())
                       for e in self._prof.profiler.kineto_results.events() if _is_device(e)]
        self._prof = None

    def start_kernels(self, device) -> None:
        from torch.profiler import ProfilerActivity, profile

        _sync(device)
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self.observing = True

    def stop_kernels(self, device) -> None:
        _sync(device)
        self.observing = False
        self._prof.stop()
        events = list(self._prof.profiler.kineto_results.events())
        self.roofline = self._roofline([e for e in events if _is_device(e)],
                                       [e for e in events if not _is_device(e)])
        self._prof = None

    def reduce(self) -> Dict[str, Any]:
        busy_ns, gaps = _union([(s, s + d) for _, s, d in self.device])
        by_class: Dict[str, float] = {}
        for name, _, d in self.device:
            c = kernel_class(name)
            by_class[c] = by_class.get(c, 0.0) + d * 1e-9
        device_ops = sorted(([c, v] for c, v in by_class.items()), key=lambda r: -r[1])[:TOP]
        return {
            "busy_s": busy_ns * 1e-9,
            "window_s": self.window_s,
            "device_s": sum(by_class.values()),
            "launches": len(self.device),
            "breakdown": {"device_ops": device_ops, "idle_gaps": _name_gaps(gaps, self.spans)},
            "roofline": self.roofline,
        }

    def _roofline(self, device, host) -> Optional[Dict[str, float]]:
        """Each observed call's device time: the kernels whose launch on the
        host lies inside the call's profiler range on the same thread."""
        if not self.calls:
            return None
        ranges: Dict[int, List[Tuple[int, int, int]]] = {}
        for e in host:
            name = e.name()
            if name.startswith("perfbench.roofline."):
                i = int(name.rsplit("#", 1)[1])
                ranges.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.start_ns() + e.duration_ns(), i))
        for r in ranges.values():
            r.sort()
        starts = {t: [s for s, _, _ in r] for t, r in ranges.items()}
        launch_of = {}
        for e in host:
            if any(w in e.name() for w in LAUNCHES):
                launch_of[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        seconds = [0.0] * len(self.calls)
        for e in device:
            where = launch_of.get(e.correlation_id())
            if where is None or where[0] not in ranges:
                continue
            t, at = where
            j = bisect.bisect_right(starts[t], at) - 1
            # the innermost range that holds the launch: ranges of one thread nest
            while j >= 0:
                s, end, i = ranges[t][j]
                if s <= at <= end:
                    seconds[i] += e.duration_ns() * 1e-9
                    break
                j -= 1
        bound = sum(peaks.bound_s(b, f, peaks.FLOP_PER_S[d]) for _, b, f, d in self.calls)
        return {"bound_s": bound, "device_s": sum(seconds), "calls": len(self.calls),
                "timed_calls": sum(1 for v in seconds if v > 0)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Span:
    """A host span on the clock the trace shares (ns since the epoch)."""

    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        self.tracer.spans.append((self.name, self.t0, time.time_ns()))
        return False




def _union(intervals) -> Tuple[int, List[Tuple[int, int]]]:
    """(ns in which any device operation ran, the idle gaps between them)."""
    spans = sorted(intervals)
    busy, gaps = 0, []
    cur_s = cur_e = None
    for s, e in spans:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def _name_gaps(gaps, spans) -> List[List[Any]]:
    """The longest idle gaps summed by what the loop's thread was doing at
    their middle: the innermost host span there."""
    spans = sorted(spans, key=lambda sp: sp[1])
    starts = [s for _, s, _ in spans]
    out: Dict[str, float] = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]:
        mid = (a + b) // 2
        j = bisect.bisect_right(starts, mid) - 1
        best = None
        for k in range(j, max(-1, j - 64), -1):
            name, s, e = spans[k]
            if e >= mid and (best is None or e - s < best[2] - best[1]):
                best = (name, s, e)
        name = best[0] if best else "loop (outside the step and the wait)"
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return sorted(([n, v] for n, v in out.items()), key=lambda r: -r[1])[:TOP]
