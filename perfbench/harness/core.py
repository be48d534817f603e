"""One run of one cell: find the cell's files by the names in
``BENCHMARK.json``, run its traffic's runner, read the cell's metrics with
their readers and print the result.

Lookup by name, so that a later change adds cells and metrics as files:

- ``perfbench/configs/<config>.json``: the configuration as it is run;
- ``perfbench/traffic/<traffic>.json``: the traffic's parameters, whose
  ``runner`` names ``perfbench/runners/<runner>.py`` (``run(ctx) -> dict``);
- ``perfbench/workloads/<cell>.json``: the cell's own settings (the limits
  of the numbers that decide ``correct``);
- ``perfbench/flops/<config>.<runner>.py``: ``flops_per_step(config, traffic)``;
- ``perfbench/roofline/<kernel>.py``: the observed launch and its counts;
- ``perfbench/metrics/<metric>.py``: ``read(run) -> float | None`` for every
  metric, end-to-end and per-layer.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

# top-level module names that must not be loaded when the result is printed:
# JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "afford_motion_tpu")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A file of the benchmark loaded as a module of its own (names may hold
    dots, so they are not import paths)."""
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.stem.replace('.', '_')}",
                                                  path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_cell(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench: Dict[str, Any], cell: str, trace: bool) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced. A metric without ``workloads``
    belongs to every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def forbidden_loaded() -> List[str]:
    """The forbidden top-level module names in ``sys.modules``, compared
    whole (``afford_motion_torch`` is not ``afford_motion_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def cache_dirs(root: Path) -> Dict[str, Path]:
    """The fixed cache folders inside the checkout: the corpus, and the
    build caches any library of the program may use."""
    cache = root / "perfbench" / ".cache"
    return {"cache": cache, "TRITON_CACHE_DIR": cache / "triton",
            "TORCH_EXTENSIONS_DIR": cache / "torch_extensions"}


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: List[str], t_start: float, root: Path, require_device: bool = True,
         tweak=None) -> int:
    """One run; returns the exit code. ``require_device=False`` and
    ``tweak(ctx)`` (which may change the loaded files' contents and the
    cache folder) are for the tests, which drive a run on the CPU at a small
    size."""
    args = parse(argv)
    bench = load_json(root / "BENCHMARK.json")
    bench_dir = root / "perfbench"
    cell = find_cell(bench, args.workload)
    dirs = cache_dirs(root)
    for key in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        os.environ[key] = str(dirs[key])
    # a library that could load JAX by itself is told not to
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    import torch

    chips = int(cell["chips"])
    if require_device and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"perfbench: the cell needs {chips} CUDA device(s); PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    config = load_json(bench_dir / "configs" / f"{cell['config']}.json")
    traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    workload = load_json(bench_dir / "workloads" / f"{cell['name']}.json")
    if (workload["config"], workload["traffic"]) != (cell["config"], cell["traffic"]):
        raise ValueError(f"{cell['name']}: its workload file names another configuration "
                         "or traffic than BENCHMARK.json")
    runner = load_module(bench_dir / "runners" / f"{traffic['runner']}.py")
    flops = load_module(bench_dir / "flops" / f"{cell['config']}.{traffic['runner']}.py")
    device = torch.device("cuda:0") if require_device else torch.device("cpu")
    ctx = {
        "cell": cell["name"], "config": config, "traffic": traffic, "workload": workload,
        "seed": int(args.seed), "seconds": float(args.seconds), "trace": bool(args.trace),
        "device": device, "cache": dirs["cache"], "t_start": t_start, "root": root,
        "roofline": sorted((bench_dir / "roofline").glob("*.py")),
    }
    if tweak is not None:
        tweak(ctx)
    run = runner.run(ctx)
    run["flops_per_step"] = float(flops.flops_per_step(config, traffic))

    metrics = {}
    for m in cell_metrics(bench, cell["name"], bool(args.trace)):
        value = load_module(bench_dir / "metrics" / f"{m['name']}.py").read(run)
        if value is None:
            continue  # nothing to read in this run: the metric is left out
        if not math.isfinite(value):
            raise ValueError(f"metric {m['name']} read {value}")
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}  # every digit

    found = forbidden_loaded()
    if found:
        print(f"perfbench: forbidden modules loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": run["device_name"], "count": chips,
                   "memory_peak_bytes": int(run["peak_bytes"])}
    if args.trace:
        device_info["busy_s"] = run["trace"]["busy_s"]
        device_info["window_s"] = run["trace"]["window_s"]
    result = {"correct": bool(run["correct"]), "attempted": int(run["attempted"]),
              "failed": int(run["failed"]), "metrics": metrics, "device": device_info}
    if args.trace:
        result["breakdown"] = run["trace"]["breakdown"]
    checks = run["checks"]
    result["checks"] = checks  # last: the numbers that decide `correct`, each with its limit
    sys.stdout.flush()
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

