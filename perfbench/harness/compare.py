"""The numbers that decide ``correct`` in a training cell: the program's
first steps against the plain reference's, from the same weights and
inputs.

- ``loss_gap``: the largest relative gap of a step's loss over the checked
  steps;
- ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first gradient (the program's read from its
  optimizer's first moment), against the reference's norm of that leaf or
  of the median leaf, whichever is larger;
- ``grad_gap_median``: the median over the leaves of the same gaps, steady
  where a few leaves' gradients are differences of nearly equal terms, whose
  rounding in bfloat16 swings the largest gap from seed to seed;
- ``change_gap``: the same of the parameters' change over the checked
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (their true gradient is nought, as a
  bias that a normalization or a softmax cancels, and Adam moves them by
  its rounding alone);
- ``grad_gap.<group>``: ``grad_gap`` over the leaves of a group the
  workload file names (``leaf_groups``: the prefixes of its leaves), still
  against the median leaf of the whole model: the largest gap where the
  leaves' gradients are not differences of nearly equal terms.

A leaf here is one projection: a packed in-projection counts as its three
(``leaf_parts``), so that the rule above can leave out a key's bias, which
the softmax cancels, apart from the query's and the value's. A cell
compares the numbers its workload file gives a limit. A gap that is not
finite reads ``NOT_FINITE``, above any limit."""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

NOT_FINITE = 1e30
TINY = 1e-30  # a leaf and the median leaf both nought: any gap is a fault
ROUNDING_LEAF = 1e-3  # a leaf under this share of the median leaf's gradient moves by rounding
# torch.nn.MultiheadAttention's packed in-projection: q, k and v stacked on the first axis
PACKED = ("in_proj_weight", "in_proj_bias")


def _finite(v: float) -> float:
    return v if math.isfinite(v) else NOT_FINITE


def leaf_parts(name: str, tensor) -> List[tuple]:
    """(name, tensor) of each projection a parameter holds: a packed
    in-projection as ``<name>.q``, ``<name>.k`` and ``<name>.v``, any other
    parameter as itself."""
    if name.rsplit(".", 1)[-1] in PACKED and tensor.shape[0] % 3 == 0:
        return [(f"{name}.{part}", t) for part, t in zip("qkv", tensor.chunk(3, dim=0))]
    return [(name, tensor)]


def leaf_gaps(program: Dict[str, float], ref: Dict[str, float], keep=None,
              median: float = None) -> List[float]:
    """Each leaf's gap against its reference norm or the median leaf's (of
    the kept leaves, unless ``median`` is given)."""
    names = [n for n in ref if keep is None or keep(n)]
    if set(program) != set(ref):
        return [NOT_FINITE]
    if median is None:
        median = statistics.median(ref[n] for n in names)
    return [_finite(abs(program[n] - ref[n]) / max(ref[n], median, TINY)) for n in names]


def moved_leaves(ref: Dict) -> set:
    """The leaves whose reference gradient is a thousandth of the median
    leaf's or more: the others move by rounding alone."""
    median_grad = statistics.median(ref["grad"].values())
    return {n for n, g in ref["grad"].items() if g >= ROUNDING_LEAF * median_grad}


def numbers(program: Dict, ref: Dict, groups: Dict[str, List[str]] = None) -> Dict[str, float]:
    """The numbers over all leaves, and ``grad_gap.<group>`` over the leaves
    of each group (``groups``: a name and the prefixes of its leaves)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(program["loss"], ref["loss"]))
    moved = moved_leaves(ref)
    grad = leaf_gaps(program["grad"], ref["grad"])
    out = {
        "loss_gap": _finite(loss) if len(program["loss"]) == len(ref["loss"]) else NOT_FINITE,
        "grad_gap": max(grad),
        "grad_gap_median": statistics.median(grad),
        "change_gap": max(leaf_gaps(program["change"], ref["change"], moved.__contains__)),
    }
    median = statistics.median(ref["grad"].values())
    for name, prefixes in (groups or {}).items():
        out[f"grad_gap.{name}"] = max(leaf_gaps(
            program["grad"], ref["grad"], lambda n: n.startswith(tuple(prefixes)), median))
    return out


def checks(program: Dict, ref: Dict, limits: Dict[str, float],
           groups: Dict[str, List[str]] = None) -> Dict[str, Dict[str, float]]:
    """The numbers the cell compares, each with its limit."""
    values = numbers(program, ref, groups)
    return {name: {"value": values[name], "limit": float(limit)}
            for name, limit in limits.items()}


def correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
