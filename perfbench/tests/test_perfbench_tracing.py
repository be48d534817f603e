"""The program's tracer in a run of a cell on the CPU: neither an untraced
nor a traced run switches it on, so every metric reads the program as it
runs with the tracer off."""
import pytest

from .conftest import run_cell


@pytest.mark.parametrize("traced", [0, 1])
def test_a_run_records_no_program_span(traced, small, capsys):
    from afford_motion_torch.utils import trace

    trace.take()
    rc, result, err = run_cell("cdm_perceiver_h3d.train_store", small(), capsys, trace=traced)
    assert rc == 0, err[-2000:]
    assert result["correct"], result["checks"]
    assert not trace.enabled() and trace.take() == []
    assert "trace |" not in err
