"""Train step: model FLOPs utilization over the timed window, in %: the
model FLOPs of the window's steps (``perfbench/flops``) over its seconds and
the card's published bf16 dense peak."""
from perfbench.harness import peaks


def read(run):
    if "steps" not in run:
        return None
    return 100.0 * run["flops_per_step"] * run["steps"] / run["window_s"] / peaks.BF16_FLOP_PER_S
