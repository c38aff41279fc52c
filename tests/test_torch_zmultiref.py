"""The multi-reference genome with an all-N reference (test_torch_corpus
`refs_with_all_n`) in the large index mode: the port's forced-large index
against the JAX package's large mode and against the port's small index,
single-end and paired-end `collect_raw` on the CPU. Tolerance:
byte-identical SAM.

Sorts after every other test_torch_* file and puts jax_enable_x64 back
when it ends, as test_torch_zlarge.py does: the JAX package's large mode
turns the flag on for the process."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from bowtie2_tpu.index.build import build_index_from_refs  # noqa: E402
from test_torch_corpus import (multiref_pairs, multiref_reads,  # noqa: E402
                               refs_with_all_n)
from test_torch_multiref import N_PE, N_SE, run_pe, run_se  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _x64_restored():
    """The JAX package's large mode turns on jax_enable_x64 for the whole
    process: put the flag back as it was for the files this process runs
    after this one (the suite's workers take files in no fixed order)."""
    before = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.fixture(scope="module")
def genome():
    refs = refs_with_all_n()
    large = build_index_from_refs(refs, large=True)
    assert large.fw.occ_cp.dtype == np.int64
    return refs, build_index_from_refs(refs), large


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_multiref_large_matches_jax_and_small(genome, mode):
    refs, small, large = genome
    if mode == "se":
        run, batch = run_se, multiref_reads(refs, N_SE)
    else:
        run, batch = run_pe, multiref_pairs(refs, N_PE)
    got = run(large, batch, False)
    assert got == run(small, batch, False)
    assert got == run(large, batch, True)
