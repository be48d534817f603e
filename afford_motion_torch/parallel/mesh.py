"""Host-to-device pipelining on one device (counterpart of
``DevicePrefetcher`` in ``afford_motion_tpu/parallel/mesh.py``). The device
mesh, its shardings and the corpus sharding wait for the multi-GPU slice."""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator

import numpy as np
import torch

from ..utils.io import get_logger

logger = get_logger()

_END = object()


class DevicePrefetcher:
    """One producer thread that pulls items from ``batch_iter_fn()``, turns
    each into a flat ``{name: numpy array}`` with ``prepare_fn`` (host work:
    loading, drawing, text encoding) and copies it to ``device``, in stream
    order, while the consumer's device work runs.

    On a CUDA device the copy goes from pinned host memory on a side stream
    and the consumer's stream waits for its event before it reads the
    tensors; the producer launches nothing on the consumer's stream. At most
    ``DEPTH`` prepared items wait in the queue. An exception in the producer
    is raised in the consumer; :meth:`close` stops the producer and waits
    for it at most ``JOIN_TIMEOUT_S``."""

    DEPTH = 2
    JOIN_TIMEOUT_S = 120.0

    def __init__(self, batch_iter_fn: Callable[[], Iterable[Any]],
                 prepare_fn: Callable[[Any], Dict[str, np.ndarray]], device):
        self._device = torch.device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=self.DEPTH)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, args=(batch_iter_fn, prepare_fn),
                                        name="device-prefetcher", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless the consumer has closed the prefetcher."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _upload(self, host: Dict[str, np.ndarray], stream):
        arrays = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in host.items()}
        if stream is None:
            return arrays, None
        with torch.cuda.stream(stream):
            out = {k: v.pin_memory().to(self._device, non_blocking=True)
                   for k, v in arrays.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _work(self, batch_iter_fn, prepare_fn) -> None:
        try:
            stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
            for batch in batch_iter_fn():
                if self._stop.is_set():
                    return
                if not self._put(self._upload(prepare_fn(batch), stream)):
                    return
            self._put(_END)
        except BaseException as e:  # handed to the consumer, which raises it
            self._put(e)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            item = self._q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            tensors, event = item
            if event is not None:
                current = torch.cuda.current_stream(self._device)
                current.wait_event(event)
                for t in tensors.values():
                    t.record_stream(current)
            yield tensors

    def close(self) -> None:
        """Stop the producer after the item it is preparing, drop what is
        queued, and wait for the thread (at most ``JOIN_TIMEOUT_S``)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=self.JOIN_TIMEOUT_S)
        if self._thread.is_alive():
            logger.warning("device prefetcher: the producer thread did not stop within "
                           f"{self.JOIN_TIMEOUT_S:.0f} s")
