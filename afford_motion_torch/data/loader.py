"""Host-side batching + prefetch (replaces torch DataLoader usage,
reference: datasets/misc.py:5-13, datasets/*.get_dataloader).

Collation stacks numpy arrays and passes strings/None through as lists —
the same contract as the reference's collate_fn_general. A background
thread keeps ``prefetch`` collated batches ready so host data prep overlaps
device compute (the torch num_workers equivalent for this single-core box).
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def collate_fn_general(batch: List[Dict]) -> Dict[str, Any]:
    """Stack array fields, list-ify everything else
    (reference: datasets/misc.py:5-13)."""
    out: Dict[str, Any] = {}
    for key in batch[0]:
        vals = [d[key] for d in batch]
        stackable = (
            all(isinstance(v, np.ndarray) for v in vals)
            and len({v.shape for v in vals}) == 1
        )
        if stackable:
            out[key] = np.stack(vals)
        elif all(isinstance(v, (bool, np.bool_)) for v in vals):
            out[key] = np.asarray(vals)
        else:
            # ragged / mixed (e.g. info_obj_mask is an array for HUMANISE
            # and None elsewhere): pass through as a list
            out[key] = vals
    return out


class DataLoader:
    """Minimal epoch iterator over a map-style dataset."""

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        collate_fn=collate_fn_general,
        num_workers: int = 0,   # accepted for config compat; prefetch thread instead
        prefetch: int = 2,
        seed: int = 0,
        pin_memory: bool = False,  # ignored (torch compat)
        **_unused,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.prefetch = max(1, prefetch) if num_workers != 0 or prefetch else 0
        # item loads are I/O-bound (np.load / native preads release the GIL),
        # so torch-style num_workers maps onto a thread pool here
        self.num_workers = max(0, int(num_workers))
        self.seed = int(seed)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle control (the DistributedSampler.set_epoch equivalent,
        reference: utils/training.py:122-123)."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self) -> List[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            # pure function of (seed, epoch): a crash-resumed process that
            # jumps straight to epoch e sees the exact permutation the
            # uninterrupted run used (train/loop.py fast-forward; the old
            # stateful-generator scheme made the shuffle depend on how many
            # epochs THIS process had already iterated)
            rng = np.random.default_rng([self.seed, self._epoch])
            rng.shuffle(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        return [order[i: i + self.batch_size] for i in range(0, stop, self.batch_size)]

    def _produce(self, batches: List[np.ndarray], q: "queue.Queue") -> None:
        try:
            for idxs in batches:
                q.put(self.collate_fn([self.dataset[int(i)] for i in idxs]))
            q.put(None)
        except BaseException as e:  # surface worker errors in the consumer
            q.put(e)

    def _make_batch(self, idxs: np.ndarray) -> Dict[str, Any]:
        return self.collate_fn([self.dataset[int(i)] for i in idxs])

    def _iter_pooled(self, batches: List[np.ndarray]) -> Iterator[Dict[str, Any]]:
        """num_workers>1: batches built concurrently, yielded in order, with
        a bounded in-flight window so memory stays proportional to prefetch."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        window = self.num_workers + max(1, self.prefetch)
        ex = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            pending: "deque" = deque()
            it = iter(batches)
            for idxs in batches[: window]:
                pending.append(ex.submit(self._make_batch, idxs))
                next(it)
            while pending:
                batch = pending.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(ex.submit(self._make_batch, nxt))
                yield batch
        finally:
            ex.shutdown(wait=False, cancel_futures=True)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self.iter_batches()

    def iter_batches(self, skip: int = 0) -> Iterator[Dict[str, Any]]:
        """Iterate the current epoch's batches, skipping the first ``skip``
        WITHOUT loading their items (resume fast-forward — the skipped
        batches cost index arithmetic only)."""
        batches = self._batch_indices()[skip:]
        if self.num_workers > 1:
            yield from self._iter_pooled(batches)
            return
        if not self.prefetch:
            for idxs in batches:
                yield self.collate_fn([self.dataset[int(i)] for i in idxs])
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(batches, q), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()
