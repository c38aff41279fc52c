"""The sharded index mode in the large row mode (uint32 rows), on the CPU:
tests/test_torch_shardidx.py's K3-K6 cases over forced-large indexes
(`build_index_from_refs(..., large=True)`) against the JAX package's
large mode under shard_map, and the port's forced-large sharded SAM
(single end and paired end) against its forced-large replicated SAM.
Tolerance: exact, byte-identical for SAM.

The JAX package's large mode turns on jax_enable_x64 for the whole
process: the file sorts after the other test_torch_* files, and a module
fixture puts the flag back when it ends (tests/test_torch_zlarge.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from bowtie2_tpu.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu_torch.ops import cases  # noqa: E402
from test_torch_corpus import corpus  # noqa: E402
from test_torch_pe import mk_pairs  # noqa: E402
from test_torch_shardidx import (GENOMES, SEED_IDS, SWEEP_IDS,  # noqa: E402
                                 _port_pe, _port_se, build_halves,
                                 check_case, pmesh, resolve_case,
                                 search_case, seed_case)
from bowtie2_tpu_torch.io.fastx import SeqRecord as PRec  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _x64_restored():
    """Put jax_enable_x64 back as it was for the files this process runs
    after this one."""
    before = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.fixture(scope="module")
def large_halves():
    built = {}

    def get(kind, period=32):
        if (kind, period) not in built:
            h = build_halves(kind, period, large=True)
            assert h["psh"].large and h["prep"].large
            assert h["jrep"].row_dtype == np.uint32
            built[kind, period] = h
        return built[kind, period]
    return get


@pytest.mark.parametrize("shape", range(len(cases.SWEEP_SHAPES)),
                         ids=SWEEP_IDS)
@pytest.mark.parametrize("op", ["sweep", "substring"])
@pytest.mark.parametrize("genome", GENOMES)
def test_large_sharded_searches_match_jax(large_halves, genome, op, shape):
    h = large_halves(genome)
    check_case(h, op, *search_case(h, op, shape))


@pytest.mark.parametrize("shape", range(len(cases.SEED_SHAPES)),
                         ids=SEED_IDS)
@pytest.mark.parametrize("genome", GENOMES)
def test_large_sharded_seed_search_matches_jax(large_halves, genome, shape):
    h = large_halves(genome)
    check_case(h, "seed", *seed_case(h, shape))


@pytest.mark.parametrize("kind", cases.RESOLVE_KINDS)
@pytest.mark.parametrize("period", cases.RESOLVE_PERIODS)
@pytest.mark.parametrize("genome", GENOMES)
def test_large_sharded_sa_resolve_matches_jax(large_halves, genome, period,
                                              kind):
    h = large_halves(genome, period)
    check_case(h, "resolve", *resolve_case(h, period, kind))


def test_forced_large_sharded_sam_matches_replicated():
    """192 corpus reads and 64 pairs over a forced-large index: the port's
    sharded SAM (4 and 8 shards) equals its replicated SAM."""
    g, reads = corpus(192, n_alu=20)
    data = build_index_from_refs([("rep", g)], large=True)
    want = _port_se(data, reads)[:2]
    raw = mk_pairs(data, np.random.default_rng(9), 64, err=0.005)
    pp = [(PRec(name=a, seq=x, qual=q), PRec(name=a, seq=y, qual=q))
          for a, x, y, q in raw]
    pwant = _port_pe(data, pp)
    for S in (4, 8):
        raw_se, lines, plain, al = _port_se(data, reads, shard_mesh=pmesh(S))
        assert al.sidx.fw.large and plain.get("take_sharded", 0) >= 2
        assert (raw_se, lines) == want
        assert _port_pe(data, pp, shard_mesh=pmesh(S)) == pwant
