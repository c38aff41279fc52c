"""One short run of a real cell on the card (marked `card`: it skips
where there is none)."""

import pytest

from portbench import manifest


@pytest.mark.card
def test_ecoli_se100_runs_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from portbench.run import run_cell
    cell = manifest.Bench().cell("ecoli.se100")
    out = run_cell(cell, 77, 2.0, 0)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]["se_reads_per_s"]["value"] > 0
