"""A/B times of one hand-written kernel at the shapes of one pass of the
training and sampling paths (batch 32, 8192-point clouds), for one or more
checkouts of the repo in turn, on one card:

    python afford_motion_torch/tools/kernel_ab.py --kernel knn|banded_gather \
        [--sweep] [--out DIR] ROOT [ROOT ...]

Each ROOT is the root of a checkout (``.`` for this one; an older commit
unpacked with ``git archive`` into ``build/``); each is measured in its own
process, which imports ``afford_motion_torch`` from that root and builds its
kernels there, so list them in turns (old, new, new, old) to compare two
versions on one card. The shapes (``KNN_CALLS``, ``GATHER_CALLS``), the
timer (``time_ms``: the median, least and largest of 5 blocks of
back-to-back calls by CUDA events) and the bit comparison are those of this
checkout's ``chip_smoke.py``, whatever the root. Per shape: the result held
bit-equal to the plain version, then the kernel's ms per call. ``--sweep``
also times, for the roots whose wrappers expose them, every launch
configuration of the kernel (kNN: threads a block, parts of the cloud;
banded gather: blocks a tile, window staged or not). Prints the card's name
and power limit first; writes everything to ``DIR/kernel_ab.txt`` (default
``build/profile``).
"""
from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import subprocess
import sys
from pathlib import Path


def _smoke():
    """This checkout's ``chip_smoke.py`` as a module (by its path: a root's
    own copy may differ)."""
    path = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _equal(smoke, got, want, what):
    for x, y in zip(got, want):
        if x.dtype != y.dtype or x.shape != y.shape or not smoke.torch.equal(
                smoke.bits(x), smoke.bits(y)):
            raise AssertionError(f"{what}: kernel differs from plain")


def _checked_time(smoke, fn, want, reps):
    """A configuration of the sweep: its time if it equals plain, else why not."""
    try:
        _equal(smoke, fn(), want, "sweep")
    except (AssertionError, RuntimeError, ValueError) as e:
        return [f"FAILED: {e}"]
    return smoke.time_ms(fn, reps)


def _pyramid(cloud, sort_fps):
    """The 8192-point cloud and its FPS levels of 2048, 512, 128 points (the
    FPS indices ascending on a banded pyramid): (levels, FPS indices)."""
    import torch

    from afford_motion_torch.ops.cuda.fps import fps_cuda

    levels, fps = [torch.from_numpy(cloud).to("cuda:0")], [None]
    for n_out in (2048, 512, 128):
        idx = fps_cuda(levels[-1], n_out)
        if sort_fps:
            idx = torch.sort(idx, dim=-1).values
        fps.append(idx)
        levels.append(torch.gather(levels[-1], 1, idx.long()[..., None].expand(-1, -1, 3)))
    return levels, fps


def _knn(smoke, rng, sweep):
    """The packed kNN of one SceneMap hierarchy on an FPS pyramid (a sweep's
    rows time the kernel alone, the curve order made once)."""
    from afford_motion_torch.ops.cuda import knn

    b = smoke.B
    levels, _ = _pyramid(rng.normal(size=(b, smoke.N_POINTS, 3)).astype("float32"), False)
    rows = {}
    for qi, si, k in smoke.KNN_CALLS:
        q, s = levels[qi], levels[si]
        m, n = q.shape[1], s.shape[1]
        want = knn.knn_plain(q, s, k)
        _equal(smoke, knn.knn_cuda(q, s, k), want, f"knn {m}/{n}")
        rows[f"knn q{m} s{n} k{k}"] = smoke.time_ms(lambda: knn.knn_cuda(q, s, k), 5)
        if sweep and hasattr(knn, "launch_config"):
            order = knn.curve_order(q, s)
            rows[f"  curve order q{m} s{n}"] = smoke.time_ms(lambda: knn.curve_order(q, s), 5)
            for threads, split in itertools.product((128, 256, 512, 1024), (1, 2, 4, 8)):
                if n % (split * knn.CHUNK) != 0 or threads > 2 * m:
                    continue
                cfg = (threads, split)
                rows[f"  sweep knn q{m} s{n} k{k} {cfg}"] = _checked_time(
                    smoke, lambda: knn.launch(q, s, k, *cfg, order=order), want, 5)
            rows[f"  policy knn q{m} s{n} k{k}"] = list(knn.launch_config(b, m, n, k))
    return rows


def _banded_gather(smoke, rng, sweep):
    """The banded gathers of one banded SceneMap encoder on a sorted pyramid,
    bf16."""
    import numpy as np
    import torch

    from afford_motion_torch.ops.cuda import banded, build
    from afford_motion_torch.ops.curves import curve_order
    from afford_motion_torch.ops.pointops import knn as knn_exact

    b, w0, dev = smoke.B, 128, torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    cloud = rng.normal(size=(b, smoke.N_POINTS, 3)).astype(np.float32)
    levels, fps = _pyramid(np.stack([c[curve_order(c, "morton")] for c in cloud]), True)
    knn_idx, starts = {}, {}
    for qi, si, k in smoke.KNN_CALLS:
        q, sup = levels[qi], levels[si]
        m, n = q.shape[1], sup.shape[1]
        st = (banded._starts_tensor(m, n, w0, dev) if qi == si
              else banded.adaptive_down_starts(fps[qi], n, w0))
        knn_idx[(qi, si)], starts[(qi, si)] = banded.knn_banded(q, sup, k, st, w0)[0], st
    knn_idx[(3, 3)] = knn_exact(levels[3], levels[3], 16)[0].contiguous()
    starts[(3, 3)] = banded._starts_tensor(128, 128, w0, dev)
    rows = {}
    for (qi, si), c in smoke.GATHER_CALLS:
        idx, st = knn_idx[(qi, si)], starts[(qi, si)]
        n, (m, k) = levels[si].shape[1], idx.shape[1:]
        size = banded._window(m, n, w0)
        x = torch.randn(b, n, c, device=dev, generator=gen).to(torch.bfloat16)
        want = [banded.gather_banded_plain(x, idx, st, size)]
        _equal(smoke, [banded.gather_banded(x, idx, st, w0)], want, f"gather {m}/{n}x{c}")
        rows[f"banded_gather m{m} n{n} c{c} k{k} S{size}"] = smoke.time_ms(
            lambda: banded.gather_banded(x, idx, st, w0), 10)
        if sweep and hasattr(banded, "gather_config"):
            stride = 0 if st.ndim == 1 else st.shape[1]
            for staged in (True, False):
                if staged and size * c * 2 + banded.TQ * k * 4 > build.SMEM_BYTES:
                    continue
                for parts in (1, 2, 4, 8, 16):
                    cfg = (parts, staged)
                    rows[f"  sweep banded_gather m{m} c{c} {cfg}"] = _checked_time(
                        smoke, lambda: [banded.launch_gather(x, idx, st, stride, size, *cfg)],
                        want, 10)
            rows[f"  policy banded_gather m{m} c{c}"] = list(
                banded.gather_config(b, m, c, k, size, 2))
    return rows


KERNELS = {"knn": _knn, "banded_gather": _banded_gather}


def worker(root: str, kernel: str, sweep: bool) -> dict:
    """Measure ``kernel`` of the checkout at ``root``; returns {row label:
    [median, lo, hi]}."""
    smoke = _smoke()
    sys.path.insert(0, root)
    from afford_motion_torch.ops.cuda import build

    assert Path(build.__file__).resolve().is_relative_to(Path(root).resolve())
    build.library()
    return KERNELS[kernel](smoke, smoke.np.random.default_rng(smoke.SEED), sweep)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--kernel", required=True, choices=sorted(KERNELS))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--sass", default="", help="write the SASS of the kernels whose mangled "
                    "name holds this text, from the first root's library, to DIR")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.roots[0], args.kernel, args.sweep)))
        return 0
    if args.sass:
        _write_sass(args.roots[0], args.sass, Path(args.out))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    runs, code, failure = [], 0, ""
    for root in args.roots:
        proc = subprocess.run([sys.executable, __file__, "--worker", "--kernel", args.kernel, root]
                              + ["--sweep"] * args.sweep, capture_output=True, text=True)
        if proc.returncode != 0:
            code = proc.returncode
            failure = f"{root} failed:\n{proc.stdout[-4000:]}{proc.stderr[-8000:]}"
            break
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    text = "\n".join([card] + _table(args.roots, runs, args.kernel)
                     + ([failure] if failure else []))
    print(text)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "kernel_ab.txt").write_text(text + "\n")
    return code


def _write_sass(root: str, pattern: str, out: Path) -> None:
    """``cuobjdump -sass`` of the kernels of ``root``'s built library whose
    name holds ``pattern``, each to ``out/sass_<name>.txt`` with a count of
    its instructions by opcode at the top."""
    import os
    import re
    import shutil

    sys.path.insert(0, root)
    from afford_motion_torch.ops.cuda import build

    lib = build.build()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out.mkdir(parents=True, exist_ok=True)
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if pattern not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", block)
        counts = {}
        for op in ops:
            counts[op.split(".")[0]] = counts.get(op.split(".")[0], 0) + 1
        head = f"{name}: {len(ops)} instructions; " + ", ".join(
            f"{op} {n}" for op, n in sorted(counts.items(), key=lambda kv: -kv[1]))
        (out / f"sass_{name[:120]}.txt").write_text(head + "\n" + block)
        print(head)


def _table(roots, runs, kernel) -> list:
    """One line a shape or configuration, one cell a run, then the kernel's
    sum over the shapes of a pass."""
    lines = [f"run {i}: {root}" for i, root in enumerate(roots[:len(runs)])]
    for label in dict.fromkeys(label for run in runs for label in run):
        cells = []
        for run in runs:
            v = run.get(label)
            cells.append("-" if v is None else (f"{v[0]:.4f} ({v[1]:.4f}-{v[2]:.4f})"
                                                if isinstance(v[0], float) else str(v)))
        lines.append(f"{label}: " + " | ".join(cells))
    sums = [sum(v[0] for label, v in run.items() if label.startswith(kernel + " "))
            for run in runs]
    lines.append(f"{kernel} a pass (sum of medians): " + " | ".join(f"{s:.4f}" for s in sums))
    return lines


if __name__ == "__main__":
    sys.exit(main())
