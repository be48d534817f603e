"""Shared set-up of the benchmark's tests: the ``card`` marker (tests that
need an NVIDIA GPU decide inside the test and skip without one) and a run
of a cell on the CPU at a small size."""
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# widths that make a CPU run take seconds; every other key is the cell's own
SMALL = {
    "model=cmdm": ["task.train.batch_size=2", "model.latent_dim=64", "model.time_emb_dim=64",
                     "model.num_heads=4", "model.dim_feedforward=128",
                     "model.contact_model.planes=[16,16,16,32]"],
    "model=cdm": ["task.train.batch_size=2",
                          "model.arch_perceiver.encoder_q_input_channels=64",
                          "model.arch_perceiver.encoder_kv_input_channels=32",
                          "model.arch_perceiver.decoder_q_input_channels=32",
                          "model.arch_perceiver.decoder_kv_input_channels=64",
                          "model.arch_perceiver.encoder_num_heads=4",
                          "model.arch_perceiver.decoder_num_heads=4", "model.time_emb_dim=32"],
}
SMALL_CORPUS = {"items": 16, "points": 2048}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one")


@pytest.fixture(scope="session")
def small_cache(tmp_path_factory):
    return tmp_path_factory.mktemp("perfbench_cache")


@pytest.fixture
def small(small_cache):
    """``tweak(ctx)`` for ``core.main``: the small corpus and widths, the
    program in ``dtype`` (float32 by default, where the reference follows it
    to rounding), the cache in one folder for the whole test run."""

    def make(dtype="float32", extra=()):
        def tweak(ctx):
            ctx["cache"] = small_cache
            ctx["traffic"]["corpus"].update(SMALL_CORPUS)
            model = next(o for o in ctx["config"]["overrides"] if o.startswith("model="))
            overrides = SMALL[model] + [f"model.dtype={dtype}", *extra]
            ctx["extra_overrides"] = overrides
            for o in overrides:
                ctx["config"]["resolved"].pop(o.split("=", 1)[0], None)
        return tweak

    return make


def run_cell(cell, tweak, capsys, root=ROOT, seed=3000000001, trace=0, seconds=1.0):
    """A run of ``cell`` on the CPU: (exit code, the result line, stderr)."""
    from afford_motion_torch.utils.io import get_logger

    from perfbench.harness import core

    for handler in get_logger().handlers:  # the program's log to this test's stderr
        handler.stream = sys.stderr
    rc = core.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                    "--trace", str(trace)], time.monotonic(), root, require_device=False,
                   tweak=tweak)
    out, err = capsys.readouterr()
    lines = [line for line in out.splitlines() if line.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None), err
