"""Faults planted in the program's timed path, for the tests that show a
broken run comes out not ``correct`` and for the readings its limits are
set from (``perfbench/tools/calibrate.py``). Each is a context manager that
replaces one call of the program from outside and puts it back; no file of
the program changes.

- ``half_batch``: half of each batch left out, the loss's mean taken over
  the rest (the timestep sampler's weights: 2 on the first half, 0 on the
  other);
- ``neighbours``: a point-path fault, wrong neighbours in one tile of 128
  level-0 queries out of 8 (the banded kernels' tile): each of its queries
  takes the neighbour list of the query 64 rows away in the same tile, in
  the hierarchy the step hands the point encoder (every index stays inside
  the tile's window, which the kernels read);
- ``frozen``: a step that leaves the state unchanged (the optimizer's
  update skipped).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


@contextlib.contextmanager
def _replaced(owner, name: str, value):
    real = getattr(owner, name)
    setattr(owner, name, value(real))
    try:
        yield
    finally:
        setattr(owner, name, real)


def half_batch():
    from afford_motion_torch.diffusion import resample

    def wrap(sample):
        def half(self, generator, batch_size, device, state=None):
            t, w = sample(self, generator, batch_size, device, state)
            keep = torch.arange(batch_size, device=device) < batch_size // 2
            return t, torch.where(keep, w * 2.0, torch.zeros_like(w))
        return half

    return _replaced(resample.UniformSampler, "sample", wrap)


def wrong_neighbours(idx: torch.Tensor, tile: int = 128, share: int = 8) -> torch.Tensor:
    """(B, N, k) neighbour indices with each query of every ``share``-th
    tile of ``tile`` queries given the list of the query ``tile // 2`` rows
    away in its tile."""
    q = torch.arange(idx.shape[1], device=idx.device)
    src = torch.where((q // tile) % share == 0, q ^ (tile // 2), q)
    return idx[:, src]


def neighbours():
    from afford_motion_torch.ops.hierarchy import LevelGeometry
    from afford_motion_torch.train import loop

    def wrap(add_hierarchies):
        def faulty(model, cond):
            out = add_hierarchies(model, cond)
            for key, levels in list(out.items()):
                if (isinstance(levels, list) and levels and isinstance(levels[0], LevelGeometry)
                        and levels[0].knn_idx is not None):
                    first = dataclasses.replace(levels[0],
                                                knn_idx=wrong_neighbours(levels[0].knn_idx))
                    out[key] = [first] + list(levels[1:])
            return out
        return faulty

    return _replaced(loop, "add_hierarchies", wrap)


def frozen():
    return _replaced(torch.optim.AdamW, "step", lambda real: lambda self, closure=None: None)


FAULTS = {"half_batch": half_batch, "neighbours": neighbours, "frozen": frozen}
