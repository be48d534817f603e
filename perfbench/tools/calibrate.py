"""The readings that the limits of a cell's ``correct`` are set from, in one
process (the corpus and the kernel library made once):

    python3 perfbench/tools/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--fault-seeds 4 5 6 --faults half_batch neighbours] \
        [--f32-seeds 1 2 3] [--leaves] [--out <file.jsonl>]

For each seed of ``--seeds`` a run of the cell's runner with a window of
one megabatch: the program's numbers against the plain reference. For each
of ``--control-seeds`` besides, the same numbers of the control (the
reference in float8) and of the reference's loss over half of each batch
against the reference. For each of ``--fault-seeds``, a run of the program
with each of ``--faults`` planted in its timed path
(``perfbench/harness/faults.py``). For each of ``--f32-seeds``, a run of
the program in float32, a witness of what the program's bfloat16 alone
moves. ``--leaves`` adds every leaf's norms of both sides to each reading.
One JSON line a reading, on standard output and in ``--out``. Not a
benchmark run: it prints no result line.
"""
import sys
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def diagnose(program, ref) -> dict:
    """The three worst leaves of each leaf number (the change's among the
    leaves it compares) and the median leaf's gap."""
    import statistics

    from perfbench.harness import compare

    out = {}
    moved = compare.moved_leaves(ref)
    for key in ("grad", "change"):
        med = statistics.median(ref[key].values())
        names = [n for n in ref[key] if key == "grad" or n in moved]
        gaps = sorted(((abs(program[key][n] - ref[key][n]) / max(ref[key][n], med), n)
                       for n in names), reverse=True)
        out[f"{key}_worst"] = [[n, g] for g, n in gaps[:3]]
        out[f"{key}_median_leaf_gap"] = statistics.median(g for g, _ in gaps)
    return out


def readings(cell: str, seeds, control_seeds=(), out_path=None, device=None, tweak=None,
             root: Path = ROOT, fault_seeds=(), faults=(), f32_seeds=(), leaves=False):
    """Yields one dict a reading: ``kind`` (``program``, ``program_f32``,
    ``control``, ``half_batch``, ``fault_<name>``), ``seed`` and the
    numbers."""
    import copy

    import torch

    from perfbench.harness import compare, core
    from perfbench.harness import faults as planted
    from perfbench.reference import train as reference

    bench = core.load_json(root / "BENCHMARK.json")
    bench_dir = root / "perfbench"
    c = core.find_cell(bench, cell)
    dirs = core.cache_dirs(root)
    base = {"cell": cell, "config": core.load_json(bench_dir / "configs" / f"{c['config']}.json"),
            "traffic": core.load_json(bench_dir / "traffic" / f"{c['traffic']}.json"),
            "workload": core.load_json(bench_dir / "workloads" / f"{cell}.json"),
            "seconds": 0.0, "trace": False, "cache": dirs["cache"], "root": root,
            "roofline": [], "device": device or torch.device("cuda:0")}
    if tweak is not None:
        tweak(base)
    f32 = copy.deepcopy(base)
    f32["config"]["resolved"].pop("model.dtype", None)
    f32["extra_overrides"] = list(f32.get("extra_overrides", [])) + ["model.dtype=float32"]
    runner = core.load_module(bench_dir / "runners" / f"{base['traffic']['runner']}.py")
    groups = base["workload"].get("leaf_groups")

    def row(kind, seed, side, ref, **extra):
        r = {"kind": kind, **compare.numbers(side, ref, groups), **diagnose(side, ref), **extra}
        if leaves:
            r["leaves"] = {"loss": side["loss"], "grad": side["grad"], "change": side["change"],
                           "ref_loss": ref["loss"], "ref_grad": ref["grad"],
                           "ref_change": ref["change"]}
        return r

    plan = [(s, "program", base, None) for s in seeds]
    plan += [(s, "program", base, None) for s in control_seeds if s not in seeds]
    plan += [(s, f"fault_{name}", base, name) for name in faults for s in fault_seeds]
    plan += [(s, "program_f32", f32, None) for s in f32_seeds]
    for seed, kind, ctx0, fault in plan:
        ctx = dict(ctx0, seed=int(seed), t_start=time.monotonic())
        with planted.FAULTS[fault]() if fault else contextlib.nullcontext():
            run = runner.run(ctx)
        rows = []
        if kind != "program" or seed in seeds:
            rows.append(row(kind, seed, run["program"], run["reference"],
                            samples_per_s=run["samples"] / run["window_s"],
                            setup_s=run["setup_s"]))
        if kind == "program" and seed in control_seeds:
            cfg, params, weights, s, n, G = run["reference_args"]
            dev = base["device"]
            lowp = reference.readings(cfg, params, weights, s, n, G, dev, lowp=True,
                                      cache=run["reference_cache"])
            rows.append(row("control", seed, lowp, run["reference"]))
            half = reference.readings(cfg, params, weights, s, n, G, dev,
                                      rows_used=int(run["batch"]) // 2,
                                      cache=run["reference_cache"])
            rows.append(row("half_batch", seed, half, run["reference"]))
        for r in rows:
            r.update(cell=cell, seed=int(seed))
            line = json.dumps(r)
            print(line if not leaves else json.dumps({k: v for k, v in r.items()
                                                        if k != "leaves"}), flush=True)
            if out_path:
                with open(out_path, "a") as f:
                    f.write(line + "\n")
            yield r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--f32-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--leaves", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for _ in readings(args.workload, args.seeds, args.control_seeds, args.out,
                      fault_seeds=args.fault_seeds, faults=args.faults,
                      f32_seeds=args.f32_seeds, leaves=args.leaves):
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
