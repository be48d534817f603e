"""Data parallelism over processes and host-to-device pipelining
(counterpart of ``afford_motion_tpu/parallel/mesh.py``).

The JAX package runs one program over a device mesh: ``create_mesh`` /
``create_mesh_for_batch`` lay the devices on a ``data`` axis, ``shard_batch``
splits a batch's rows over it, ``replicate`` copies the state to every
device, and XLA inserts the gradient all-reduce; every train-mode BatchNorm
then takes its statistics over the global batch. Here one process runs per
card (``torchrun``, i.e. ``python -m torch.distributed.run``) in one process
group:

- :func:`session` sets the group up from ``RANK`` / ``WORLD_SIZE`` and
  tears it down; inside it
  :func:`current` returns the :class:`DataParallel` context (rank, world,
  device, backend). Without a group :func:`current` is None and every
  caller runs its one-device code;
- :meth:`DataParallel.local_rows` gives the rank its rows of a global batch
  (``shard_batch``); :meth:`DataParallel.broadcast_module` copies rank 0's
  parameters and buffers to every rank at start-up (``replicate``);
  :meth:`DataParallel.wrap` is the ``DistributedDataParallel`` module whose
  backward averages the gradients;
- the collectives that move rows move bits: a float rides as the integer of
  its width (8- and 16-bit ones widened to 32 bits), so a sum in which one
  rank holds each value and the others zero returns that value bit for bit.

:class:`DevicePrefetcher` works per rank, unchanged.
"""
from __future__ import annotations

import contextlib
import inspect
import os
import queue
import threading
from datetime import timedelta
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.io import get_logger, set_log_rank

logger = get_logger()

_END = object()

# seconds a collective may wait for the other ranks before the group fails
# (``AM_DDP_TIMEOUT_S``): a rank that died makes the others raise, not hang
DEFAULT_TIMEOUT_S = 600.0

_CURRENT: Optional["DataParallel"] = None

_INT_OF_WIDTH = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def to_bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` as integers that a sum carries exactly: a float viewed as the
    integer of its width, 8- and 16-bit integers (and bool) widened to 32."""
    v = t.contiguous()
    if v.dtype == torch.bool:
        return v.to(torch.int32)
    if v.is_floating_point():
        v = v.view(_INT_OF_WIDTH[v.element_size()])
    return v.to(torch.int32) if v.element_size() < 4 else v


def from_bits(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`to_bits` for a tensor of ``dtype``."""
    if dtype == torch.bool:
        return v.bool()
    if dtype.is_floating_point:
        width = torch.empty((), dtype=dtype).element_size()
        return v.to(_INT_OF_WIDTH[width]).view(dtype)
    return v.to(dtype)


class DataParallel:
    """This process's place in the group: ``rank`` of ``world``, on
    ``device``, over ``backend`` (``nccl`` or ``gloo``). Every rank runs the
    same program on its own rows of each global batch."""

    def __init__(self, rank: int, world: int, device: torch.device, backend: str):
        self.rank, self.world = int(rank), int(world)
        self.device, self.backend = torch.device(device), str(backend)
        # when a list, each collective of this context appends (name, bytes
        # a rank sends): what one step moves, for a timed replay
        self.trace: Optional[List[tuple]] = None

    # ---------------------------------------------------------------- rows
    def local_rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of ``batch_size`` rows, an
        equal share each (``shard_batch``). A batch the world does not
        divide raises: ``torchrun`` fixes the world, so the JAX package's
        rule (the largest device prefix that divides the batch) has no
        counterpart here."""
        if batch_size % self.world:
            raise ValueError(f"the global batch of {batch_size} rows does not split over "
                             f"{self.world} processes: make the batch size a multiple of "
                             "the world size")
        n = batch_size // self.world
        return slice(self.rank * n, (self.rank + 1) * n)

    def chunk(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` independent rows (a test
        batch, a fit): shares may differ by one row, or be empty."""
        return slice(self.rank * n // self.world, (self.rank + 1) * n // self.world)

    # ---------------------------------------------------------- collectives
    def _note(self, name: str, t: torch.Tensor) -> None:
        if self.trace is not None:
            self.trace.append((name, t.numel() * t.element_size()))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        self._note("all_reduce", t)
        dist.all_reduce(t)
        return t

    def all_reduce_autograd(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, through the autograd-aware
        all-reduce: its backward sums the gradients over the ranks too."""
        from torch.distributed.nn.functional import all_reduce

        self._note("all_reduce", t)
        return all_reduce(t)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """(world * b, ...) from every rank's (b, ...) ``t``, in rank order,
        bit for bit: each rank's bits placed in zeros and summed."""
        v = to_bits(t)
        out = v.new_zeros((self.world * v.shape[0],) + tuple(v.shape[1:]))
        out[self.rank * v.shape[0]:(self.rank + 1) * v.shape[0]] = v
        self._note("all_gather", out)
        dist.all_reduce(out)
        return from_bits(out, t.dtype)

    def reduce_scatter_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the sum over the ranks of ``t`` (B, ...), B a
        multiple of the world: rows ``local_rows(B)``. ``t`` holds integer
        bits (:func:`to_bits`), so a row that one rank fills and the others
        leave 0 arrives exactly. NCCL runs ``reduce_scatter_tensor``; gloo,
        whose CUDA tensors it may lack, an all-reduce of which each rank
        keeps its rows (the same bits, ``world`` times the traffic)."""
        rows = self.local_rows(t.shape[0])
        self._note("reduce_scatter", t)
        if self.backend == "nccl":
            out = t.new_empty((rows.stop - rows.start,) + tuple(t.shape[1:]))
            dist.reduce_scatter_tensor(out, t.contiguous())
            return out
        t = t.contiguous().clone()
        dist.all_reduce(t)
        return t[rows]

    def gather_objects(self, obj: Any) -> List[Any]:
        """Every rank's ``obj`` (picklable), in rank order, on every rank."""
        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index or 0])
        else:
            dist.barrier()

    # -------------------------------------------------------------- modules
    @torch.no_grad()
    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Rank 0's parameters and buffers on every rank (``replicate``)."""
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)

    def wrap(self, module: torch.nn.Module) -> torch.nn.Module:
        """``module`` in ``DistributedDataParallel``: the backward averages
        the gradients of the trainable parameters over the ranks. The
        parameters were broadcast already (:meth:`broadcast_module`) and the
        buffers are not broadcast each step: the train-mode ``PointNorm``s
        sync their statistics, so their running statistics agree by
        construction. Every trainable parameter of the shipped models gets a
        gradient, so DDP does not look for unused ones."""
        from torch.nn.parallel import DistributedDataParallel

        kwargs: Dict[str, Any] = {"broadcast_buffers": False}
        if "init_sync" in inspect.signature(DistributedDataParallel.__init__).parameters:
            kwargs["init_sync"] = False
        return DistributedDataParallel(module, device_ids=None, **kwargs)


def current() -> Optional[DataParallel]:
    """The process group's context inside :func:`session`, else None."""
    return _CURRENT


def is_main() -> bool:
    """Whether this process writes the run's files: rank 0, or no group."""
    return _CURRENT is None or _CURRENT.rank == 0


def launched() -> bool:
    """Whether a launcher (``torchrun``) started this process as a rank."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


@contextlib.contextmanager
def session(device, backend: Optional[str] = None, init_method: Optional[str] = None):
    """The process group for the block: rank and world from ``RANK`` /
    ``WORLD_SIZE`` (set by the launcher); the backend ``backend``, else NCCL
    for a CUDA ``device`` and gloo for the CPU; the rendezvous
    ``init_method`` (a ``file://`` path, say), else ``env://`` (the
    launcher's ``MASTER_ADDR`` / ``MASTER_PORT``); every collective bounded
    by ``AM_DDP_TIMEOUT_S`` seconds (default ``DEFAULT_TIMEOUT_S``). Yields
    the :class:`DataParallel` context, which :func:`current` returns inside
    the block; the logger speaks on rank 0 only. Inside an open session it
    yields that one."""
    global _CURRENT
    if _CURRENT is not None:
        yield _CURRENT
        return
    dev = torch.device(device)
    rank, world = int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = float(os.environ.get("AM_DDP_TIMEOUT_S", DEFAULT_TIMEOUT_S))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout))
    _CURRENT = DataParallel(rank, world, dev, backend)
    set_log_rank(rank)
    logger.info(f"data parallel: rank {rank} of {world} on {dev} over {backend}")
    try:
        yield _CURRENT
    finally:
        _CURRENT = None
        set_log_rank(0)
        dist.destroy_process_group()


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
