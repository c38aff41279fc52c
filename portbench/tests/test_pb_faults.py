"""The harness's whole run on the CPU (its look for a card skipped),
sound and with the timed path broken underneath: `correct` must come out
false for each fault a cell of this system can have (half of a batch
left out; an answer altered where it is produced)."""

import pytest

from portbench.faults import drop_half, shift_positions
from portbench.run import run_cell


@pytest.mark.parametrize("mode", ["se", "pe"])
@pytest.mark.parametrize("fault", [None, drop_half, shift_positions])
def test_fault_fails_the_run(tiny, tmp_path, mode, fault):
    cell = tiny(mode)
    out = run_cell(cell, 2 ** 31 + 12345, 0.1, 0, device="cpu",
                   fault=fault, cache=str(tmp_path))
    assert out["correct"] is (fault is None), out["checks"]
    assert set(out["metrics"]) == {"setup_s", cell.traffic["rate_metric"]}
    assert out["attempted"] > 0
    if fault is drop_half:
        assert out["failed"] > 0
