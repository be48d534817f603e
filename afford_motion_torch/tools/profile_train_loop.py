"""Seconds per step through the train entry in steady state, per data route:

    python -m afford_motion_torch.tools.profile_train_loop [out_dir] [--stage1] [--motionx]

Builds ``chip_smoke.py``'s synthetic HumanML3D tree (192 items, 8192-point
clouds, motions of 40..196 frames) and its sorted, cached, packed copy, then
trains the flagship CMDM ``trans_enc`` (full width, bf16, batch 32, four
steps a megabatch) from the seeded init through ``afford_motion_torch.train``
for ``STEPS`` steps on each route in turn:

- ``plain host``: the ``.npz`` tree; the producer thread loads each
  megabatch's items through the native IO core while the card computes;
- ``banded store``: the prepared tree through the device store;
- ``banded host``: the prepared tree with ``task.train.device_store=off``,
  the producer thread reading the packed store.

With ``--stage1`` it trains stage 1 instead, the CDM-Perceiver of
``scripts/t2m_contact/train_ddp.sh`` (batch 64, one step a megabatch: the
tree's 144 training items hold no four), on the plain tree's host stream
(``stage-1 plain host``) and through the stage-1 store on the prepared tree
(``stage-1 store``).

With ``--motionx`` it trains the scene protocol's two stages on
``chip_smoke.py``'s prepared HUMANISE tree (96 scenes, 66-d motions of
40..196 frames, every other item with a ``pred_contact`` file for the mix,
sorted, cached and packed by ``afford_motion_torch.prepare``):
``scripts/ts2m_contact_motion/train_ddp.sh``'s CMDM (batch 32, the rotation
chain, one step a megabatch: 96 items hold no four batches) through the
``motionx`` store (``motionx store``) and on the packed host route
(``motionx host``), and ``scripts/ts2m_contact/train_ddp.sh``'s
CDM-Perceiver (batch 64) through the ``motionx_contact`` store and on the
host route (``motionx stage-1 store`` / ``host``).

With ``task.train.trace=true`` and a log every 4 steps, it reports s/step
over the windows after the first two (set-up, the first megabatch's load and
the libraries' warm-up left out), the share of that wall time the loop
waited for a batch (the tracer's ``loop: wait`` totals, where the loop
records them), the store's bytes and its cache and
upload time, and the peak device memory. Prints the card's name and power
limit first and writes ``profile_train_loop.txt`` (``--stage1``:
``profile_train_loop_stage1.txt``, ``--motionx``:
``profile_train_loop_motionx.txt``) into ``out_dir`` (default
``build/profile``).
"""
from __future__ import annotations

import argparse
import os
import subprocess
from pathlib import Path

import torch

from .kernel_ab import _smoke

STEPS = 32  # eight megabatches: two to warm up, six measured


def _flagship(smoke, tree: dict, exp) -> list:
    return smoke.base_args(tree) + [
        f"exp_dir={exp}", f"task.train.batch_size={smoke.B}",
        "task.dataset.train_transforms=['RandomEraseLang','RandomEraseContact','NumpyToTensor']"]


def _stage1(smoke, tree: dict, exp) -> list:
    return smoke.stage1_args(tree, exp)


def _motionx(smoke, tree: dict, exp) -> list:
    return smoke.mx_args(tree, exp)


def _motionx_stage1(smoke, tree: dict, exp) -> list:
    return smoke.mx_stage1_args(tree, exp)


def _route(smoke, tree: dict, name: str, steps: int, extra: tuple, args_of) -> str:
    """``args_of(smoke, tree, exp)``: the run's configuration."""
    from .. import train as entry

    exp = smoke.WORK / ("loop_" + name.replace(" ", "_"))
    args = args_of(smoke, tree, exp) + list(extra) + [
        f"task.train.max_steps={steps}", f"task.train.save_every_step={steps}",
        "task.train.log_every_step=4", "task.train.trace=true"]
    summary = entry.main(args)
    windows = summary["logged"][2:]
    seconds = sum(w["seconds"] for w in windows)
    n = sum(w["steps"] for w in windows)
    per = [w["seconds"] / w["steps"] for w in windows]
    # a loop without the tracer's totals (an older checkout) leaves it out
    if all("spans" in w for w in windows):
        wait = sum(w["spans"]["seconds"].get("loop: wait", 0.0) for w in windows)
        waited = f"waiting for a batch {100 * wait / seconds:.1f}% of the loop's wall time"
    else:
        waited = "waiting for a batch: not recorded"
    peak = summary.get("peak_memory_bytes", float("nan")) / 2**30
    line = (f"{name}: {seconds / n:.4f} s/step over steps {windows[0]['step'] - 3}.."
            f"{windows[-1]['step']} (windows of 4 steps: min {min(per):.4f}, max "
            f"{max(per):.4f} s/step), {waited}, peak memory {peak:.2f} GiB")
    if "store" in summary:
        st = summary["store"]
        line += (f"; device store {st['bytes'] / 1e6:.1f} MB, cache and upload "
                 f"{st['seconds']:.3f} s")
    return line


def main(out_dir: str = "build/profile", stage1: bool = False, motionx: bool = False) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train_loop runs only on a CUDA device")
    smoke = _smoke()
    os.chdir(smoke.ROOT)  # the entry reads ./configs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    off = ("task.train.device_store=off",)
    if motionx:
        smoke.shutil.rmtree(smoke.WORK, ignore_errors=True)
        tree, _ = smoke.make_motionx_tree(smoke.launch_counters())
        routes = (("motionx store", tree, (), _motionx), ("motionx host", tree, off, _motionx),
                  ("motionx stage-1 store", tree, (), _motionx_stage1),
                  ("motionx stage-1 host", tree, off, _motionx_stage1))
        what = (f"ts2m_contact_motion batch {smoke.B} and ts2m_contact batch "
                f"{smoke.B_STAGE1} on {smoke.MX_ITEMS} HUMANISE scenes")
    else:
        tree = smoke.make_tree()
        banded = smoke.make_banded_tree(tree)
        if stage1:
            routes = (("stage-1 plain host", tree, (), _stage1),
                      ("stage-1 store", banded, (), _stage1))
            what = f"the CDM-Perceiver, batch {smoke.B_STAGE1}"
        else:
            routes = (("plain host", tree, (), _flagship), ("banded store", banded, (), _flagship),
                      ("banded host", banded, off, _flagship))
            what = f"batch {smoke.B}"
    lines = [card, f"{STEPS} steps a route, {what}, bf16, seed {smoke.SEED}:"]
    for name, t, extra, args_of in routes:
        lines.append("  " + _route(smoke, t, name, STEPS, extra, args_of))
        print(lines[-1], flush=True)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    name = ("profile_train_loop_motionx.txt" if motionx else
            "profile_train_loop_stage1.txt" if stage1 else "profile_train_loop.txt")
    (out / name).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default="build/profile")
    ap.add_argument("--stage1", action="store_true")
    ap.add_argument("--motionx", action="store_true")
    args = ap.parse_args()
    main(args.out_dir, args.stage1, args.motionx)
