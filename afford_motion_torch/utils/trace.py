"""The port's spans and counters, on the clock ``torch.profiler`` stamps its
events with (``time.time_ns()``, ns since the Unix epoch).

Off by default. Off, :func:`span` returns one shared null context and
:func:`count` returns at once: a span costs one test of a module flag. On
(:func:`enable`; the train entry's ``task.train.trace``), a span records
``(name, thread, start_ns, end_ns, parent, ids)`` in memory, the parent
being the enclosing span of the same thread and ``ids`` the ``step`` or
``megabatch`` the span works on, so that a megabatch's preparation, its
upload, the loop's wait for it and the steps that take it can be joined.
While a ``torch.profiler`` session records the calling thread, the span is
also a ``record_function`` range named ``am.<name>`` (:data:`PREFIX`), so
the program's layers appear by name in every trace and a device operation
can be put down to the span that launched it. ``enable(ranges=False)``
keeps the records and enters no range: a profiler session then sees the
program's host work as it is with the tracer off.

A caller that stops a profiler session inside open spans calls
:func:`end_ranges` first.

Readers: :func:`take` returns the records and clears them (a benchmark's
window); :func:`totals` returns each name's seconds and each counter since
its last call (the loop's log line). The producer thread and the loop thread
record at once; the records are kept under one lock, the newest
:data:`MAX_RECORDS` of them.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

PREFIX = "am."
MAX_RECORDS = 1 << 18  # the newest records a long run keeps

_NULL = contextlib.nullcontext()
_on = False
_ranges = True  # enter a profiler range while a session records the thread
_lock = threading.Lock()
_local = threading.local()
_records: "collections.deque[Record]" = collections.deque(maxlen=MAX_RECORDS)
_span_ns: Dict[str, int] = {}
_counts: Dict[str, int] = {}


class Record(NamedTuple):
    name: str
    thread: int
    start_ns: int
    end_ns: int
    parent: Optional[str]
    ids: Dict[str, int]


class _Span:
    __slots__ = ("name", "ids", "parent", "range", "t0")

    def __init__(self, name: str, ids: Dict[str, int]):
        self.name, self.ids = name, ids

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.t0 = time.time_ns()
        self.range = None
        if _ranges and torch.autograd._profiler_enabled():  # this thread is being profiled
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        t1 = time.time_ns()
        _local.stack.pop()
        record = Record(self.name, threading.get_ident(), self.t0, t1, self.parent, self.ids)
        with _lock:
            _records.append(record)
            _span_ns[self.name] = _span_ns.get(self.name, 0) + t1 - self.t0
        return False


def end_ranges() -> None:
    """End the profiler ranges of this thread's open spans now, innermost
    first; the spans go on recording. For a caller that stops a
    ``torch.profiler`` session inside open spans: a range must end in the
    session it began in."""
    for sp in reversed(getattr(_local, "stack", None) or []):
        if sp.range is not None:
            sp.range.__exit__(None, None, None)
            sp.range = None


def span(name: str, step: Optional[int] = None, megabatch: Optional[int] = None):
    """A context manager that records ``name`` while it is open (nothing when
    the tracer is off). ``step`` / ``megabatch``: the identifier of the work."""
    if not _on:
        return _NULL
    ids = {}
    if step is not None:
        ids["step"] = int(step)
    if megabatch is not None:
        ids["megabatch"] = int(megabatch)
    return _Span(name, ids)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing when the tracer is off)."""
    if not _on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + int(n)


def enable(ranges: bool = True) -> None:
    """Switch the tracer on; ``ranges=False``: record, but enter no
    profiler range."""
    global _on, _ranges
    _on, _ranges = True, bool(ranges)


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def take() -> List[Record]:
    """The span records since the last call, oldest first; clears them."""
    with _lock:
        out = list(_records)
        _records.clear()
    return out


def totals() -> Dict[str, Dict[str, Any]]:
    """``{"seconds": {span: s}, "counts": {counter: n}}`` since the last
    call; resets both. Nested spans each count their whole time."""
    with _lock:
        out = {"seconds": {k: v * 1e-9 for k, v in _span_ns.items()}, "counts": dict(_counts)}
        _span_ns.clear()
        _counts.clear()
    return out
