"""The port's producer thread (``afford_motion_torch/parallel/mesh.py``
``DevicePrefetcher``) on the CPU: it keeps the stream's order, hands a
producer's exception to the consumer, and closes without hanging, also
while it waits on a full queue or inside an endless stream."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from afford_motion_torch.parallel.mesh import DevicePrefetcher


def _prepare(i):
    return {"i": np.array([i], np.int64), "x": np.full((2, 3), i, np.float32)}


def test_keeps_the_order_under_a_short_switch_interval():
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pf = DevicePrefetcher(lambda: iter(range(300)), _prepare, "cpu")
        got = [(int(b["i"][0]), b["x"]) for b in pf]
        pf.close()
    finally:
        sys.setswitchinterval(saved)
    assert [i for i, _ in got] == list(range(300))
    assert all(isinstance(x, torch.Tensor) and torch.equal(x, torch.full((2, 3), float(i)))
               for i, x in got)
    assert not pf._thread.is_alive()


@pytest.mark.parametrize("where", ["stream", "prepare"])
def test_reraises_the_producers_error(where):
    def stream():
        yield from range(3)
        if where == "stream":
            raise ValueError("broken stream")
        yield 3

    def prepare(i):
        if where == "prepare" and i == 3:
            raise ValueError("broken prepare")
        return _prepare(i)

    pf = DevicePrefetcher(stream, prepare, "cpu")
    seen = []
    with pytest.raises(ValueError, match=f"broken {where}"):
        for b in pf:
            seen.append(int(b["i"][0]))
    pf.close()
    assert seen == [0, 1, 2] and not pf._thread.is_alive()


def test_close_does_not_hang_on_a_full_queue_or_an_endless_stream():
    drawn = []

    def endless():
        i = 0
        while True:
            drawn.append(i)
            yield i
            i += 1

    pf = DevicePrefetcher(endless, _prepare, "cpu")
    it = iter(pf)
    assert int(next(it)["i"][0]) == 0
    deadline = time.monotonic() + 5
    while len(drawn) < 2 + DevicePrefetcher.DEPTH and time.monotonic() < deadline:  # full
        time.sleep(0.01)
    t0 = time.monotonic()
    pf.close()
    assert time.monotonic() - t0 < 5 and not pf._thread.is_alive()
    n = len(drawn)
    time.sleep(0.05)
    assert len(drawn) == n  # nothing drawn after close


def test_close_before_any_item_is_read():
    gate = threading.Event()

    def slow():
        gate.wait(5)
        yield 0

    pf = DevicePrefetcher(slow, _prepare, "cpu")
    gate.set()
    pf.close()
    assert not pf._thread.is_alive()
