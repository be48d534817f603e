"""The control: the reference computed in float8 (the precision below the
configurations' bfloat16) in the program's place, and the planted faults
(half of each batch left out, in the reference and in the program; in the
flagship, wrong neighbours in a share of the point encoder's windows), at
each cell's own size on the card, on three seeds: each fails one of the
cell's numbers at least, while the program's own runs on those seeds pass
them. Needs an NVIDIA GPU (``-m card``); run from
the root of a checkout:

    python -m pytest perfbench/tests/test_perfbench_control.py -m card
"""
import json

import pytest

from .conftest import ROOT

SEEDS = (11, 12, 13)
FAULTS = {"cmdm_enc_h3d.train_store": ("half_batch", "neighbours"),
          "cdm_perceiver_h3d.train_store": ("half_batch",)}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_the_control_and_the_fault_fail_where_the_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from perfbench.tools import calibrate

    limits = json.loads((ROOT / "perfbench" / "workloads" / f"{cell}.json").read_text())[
        "limits"]
    rows = list(calibrate.readings(cell, SEEDS, SEEDS, fault_seeds=SEEDS, faults=FAULTS[cell]))
    assert {r["kind"] for r in rows} == {"program", "control", "half_batch"} | {
        f"fault_{f}" for f in FAULTS[cell]}
    for row in rows:
        failed = [n for n, limit in limits.items() if row[n] > limit]
        if row["kind"] == "program":
            assert not failed, row
        else:
            assert failed, row
