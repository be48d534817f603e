"""``correct`` comes out false when the timed path is broken underneath: a
step that returns the state unchanged (the optimizer's update skipped),
half of each batch left out (the loss's mean over the rest), and, where the
cell has a point hierarchy, wrong neighbours in a share of the point
encoder's windows (``perfbench/harness/faults.py``). Runs skip the look for
a card and drive the rest of a run on the CPU at a small size, with the
program in float32, where a sound run agrees with the reference to
rounding."""
import pytest

from perfbench.harness import faults

from .conftest import run_cell

CELLS = ["cmdm_enc_h3d.train_store", "cdm_perceiver_h3d.train_store"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(cell, small, capsys):
    with faults.frozen():
        rc, result, err = run_cell(cell, small(), capsys)
    assert rc == 0, err[-2000:]
    assert result["correct"] is False
    assert result["checks"]["change_gap"]["value"] > result["checks"]["change_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_batch_left_out_is_not_correct(cell, small, capsys):
    with faults.half_batch():
        rc, result, err = run_cell(cell, small(), capsys)
    assert rc == 0, err[-2000:]
    assert result["correct"] is False, result["checks"]


def test_wrong_neighbours_in_the_point_encoder_are_not_correct(small, capsys):
    with faults.neighbours():
        rc, result, err = run_cell("cmdm_enc_h3d.train_store", small(), capsys)
    assert rc == 0, err[-2000:]
    assert result["correct"] is False, result["checks"]
