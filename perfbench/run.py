"""The benchmark of ``afford_motion_torch`` on NVIDIA GPUs. From the root of a
checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``. The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``); the numbers
that decide ``correct`` are the last lines of standard error. See
``perfbench/README.md``.
"""
import time

T_START = time.monotonic()  # set-up is counted from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from perfbench.harness import core

    sys.exit(core.main(sys.argv[1:], T_START, ROOT))
