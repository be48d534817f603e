"""Seconds per step through the train entry in steady state, per data route:

    python -m afford_motion_torch.tools.profile_train_loop [out_dir]

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

With ``AM_LOOP_TIMING=1`` and a log every megabatch, it reports s/step over
the megabatches after the first two (set-up, the first megabatch's load and
the libraries' warm-up left out), the share of that wall time the loop
waited for a batch (where the loop records it), the store's bytes and its cache and upload time, and the
peak device memory. Prints the card's name and power limit first and writes
``profile_train_loop.txt`` into ``out_dir`` (default ``build/profile``).
"""
from __future__ import annotations

import argparse
import os
import subprocess
from pathlib import Path

import torch

from .kernel_ab import _smoke

STEPS = 32  # eight megabatches: two to warm up, six measured


def _route(smoke, tree: dict, name: str, steps: int, extra: tuple) -> str:
    from .. import train as entry

    args = smoke.base_args(tree) + list(extra) + [
        f"exp_dir={smoke.WORK / ('loop_' + name.replace(' ', '_'))}",
        f"task.train.batch_size={smoke.B}", f"task.train.max_steps={steps}",
        f"task.train.save_every_step={steps}", "task.train.log_every_step=4",
        "task.dataset.train_transforms=['RandomEraseLang','RandomEraseContact','NumpyToTensor']",
    ]
    summary = entry.main(args)
    windows = summary["logged"][2:]
    seconds = sum(w["seconds"] for w in windows)
    n = sum(w["steps"] for w in windows)
    per = [w["seconds"] / w["steps"] for w in windows]
    # a loop without AM_LOOP_TIMING's record (an older checkout) leaves it out
    if all("timing" in w for w in windows):
        wait = sum(w["timing"]["wait_batch"] for w in windows)
        total = sum(sum(w["timing"].values()) for w in windows)
        waited = f"waiting for a batch {100 * wait / total:.1f}% of the loop's wall time"
    else:
        waited = "waiting for a batch: not recorded"
    peak = summary.get("peak_memory_bytes", float("nan")) / 2**30
    line = (f"{name}: {seconds / n:.4f} s/step over steps {windows[0]['step'] - 3}.."
            f"{windows[-1]['step']} (a megabatch of 4: min {min(per):.4f}, max "
            f"{max(per):.4f} s/step), {waited}, peak memory {peak:.2f} GiB")
    if "store" in summary:
        st = summary["store"]
        line += (f"; device store {st['bytes'] / 1e6:.1f} MB, cache and upload "
                 f"{st['seconds']:.3f} s")
    return line


def main(out_dir: str = "build/profile") -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train_loop runs only on a CUDA device")
    smoke = _smoke()
    os.chdir(smoke.ROOT)  # the entry reads ./configs
    os.environ["AM_LOOP_TIMING"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    tree = smoke.make_tree()
    banded = smoke.make_banded_tree(tree)
    lines = [card, f"{STEPS} steps a route, batch {smoke.B}, bf16, seed {smoke.SEED}:"]
    for name, t, extra in (("plain host", tree, ()), ("banded store", banded, ()),
                           ("banded host", banded, ("task.train.device_store=off",))):
        lines.append("  " + _route(smoke, t, name, STEPS, extra))
        print(lines[-1], flush=True)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_train_loop.txt").write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default="build/profile")
    main(ap.parse_args().out_dir)
