"""The port's UnpairedAligner (device="cpu": the kernels' plain versions)
vs the JAX package's, end to end: SAM lines byte-identical, and the same
number of reads overridden by each RNG-replay layer (the trajectory layer
swallows its own exceptions, so a fault there would otherwise go silent).

Two corpora (tests/test_torch_corpus.py): one that stays inside the fused
pipeline's DP budget, and a denser one whose batch overflows it and takes
the host phase-by-phase path in both packages."""

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from bowtie2_tpu.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu.io.fastx import SeqRecord as JRec  # noqa: E402
from bowtie2_tpu.pipeline.align import UnpairedAligner as JAligner  # noqa: E402
from bowtie2_tpu.pipeline.policy import make_policy as jpolicy  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord as PRec  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner as PAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy as ppolicy  # noqa: E402
from test_torch_corpus import corpus  # noqa: E402


@pytest.fixture(scope="module")
def fused_corpus():
    g, reads = corpus(400, n_alu=20)
    return build_index_from_refs([("rep", g)]), reads


@pytest.fixture(scope="module")
def dense_corpus():
    g, reads = corpus(400, n_alu=60)
    return build_index_from_refs([("rep", g)]), reads


def _spied(al):
    """Count the reads each replay layer overrides, and host-path runs."""
    seen = {"ee": 0, "host": 0}
    ee, host = al._ee_replay_overrides, al._align_batch_host

    def ee_spy(fb, meta):
        out = ee(fb, meta)
        seen["ee"] += len(out)
        return out

    def host_spy(records, *a, **k):
        if k.get("_merge", True):
            seen["host"] += 1
        return host(records, *a, **k)
    al._ee_replay_overrides = ee_spy
    al._align_batch_host = host_spy
    return seen


def _both(data, reads, local, collect="collect_raw"):
    jal = JAligner(data, jpolicy("sensitive", local=local))
    pal = PAligner(data, ppolicy("sensitive", local=local), device="cpu")
    js, ps = _spied(jal), _spied(pal)
    jout = getattr(jal, collect)(jal.submit(
        [JRec(name=a, seq=s, qual=q) for a, s, q in reads]))
    pout = getattr(pal, collect)(pal.submit(
        [PRec(name=a, seq=s, qual=q) for a, s, q in reads]))
    return (jal, js, jout), (pal, ps, pout)


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_collect_raw_matches_jax(fused_corpus, local):
    data, reads = fused_corpus
    (jal, js, jg), (pal, ps, pg) = _both(data, reads, local)
    assert js["host"] == 0 and ps["host"] == 0    # fused path, no overflow
    assert len(jg) == len(pg) == len(reads)
    for a, b in zip(jg, pg):
        assert a == b
    jt = jal.metrics.counters.get("traj_overridden", 0)
    pt = pal.metrics.counters.get("traj_overridden", 0)
    assert (js["ee"], jt) == (ps["ee"], pt)
    if not local:      # both replay layers engaged on this corpus
        assert ps["ee"] > 0 and pt > 0
    assert (jal.stats.al_one, jal.stats.al_multi, jal.stats.unal) == \
        (pal.stats.al_one, pal.stats.al_multi, pal.stats.unal)
    gapped = sum(1 for g in pg for _f, line in g
                 if b"\tXG:i:0\t" not in line and not _f & 4)
    assert gapped > 0


def test_overflow_batch_takes_host_path(dense_corpus):
    data, reads = dense_corpus
    (jal, js, jg), (pal, ps, pg) = _both(data, reads, False)
    assert js["host"] == 1 and ps["host"] == 1
    for a, b in zip(jg, pg):
        assert a == b
    jt = jal.metrics.counters.get("traj_overridden", 0)
    pt = pal.metrics.counters.get("traj_overridden", 0)
    assert jt == pt > 0


def test_collect_objects_match_jax(fused_corpus):
    data, reads = fused_corpus
    (_jal, _js, jout), (_pal, _ps, pout) = _both(data, reads[:300], False,
                                                 collect="collect")
    assert [r.line() for r in jout] == [r.line() for r in pout]


@pytest.mark.parametrize("overrides", [
    dict(khits=3), dict(seed_mms=1), dict(norc=True),
    dict(no_1mm=True, no_exact=True), dict(xeq=True)],
    ids=["k3", "N1", "norc", "no_upfront", "xeq"])
def test_collect_raw_options_match_jax(fused_corpus, overrides):
    """Option branches of the fused program and the SAM builder: -k,
    -N 1 (seed-half searches), --norc (strand suppression),
    --no-1mm-upfront/--no-exact-upfront and --xeq."""
    data, reads = fused_corpus
    recs = reads[:200]
    jal = JAligner(data, jpolicy("sensitive", **overrides))
    pal = PAligner(data, ppolicy("sensitive", **overrides), device="cpu")
    jg = jal.collect_raw(jal.submit(
        [JRec(name=a, seq=s, qual=q) for a, s, q in recs]))
    pg = pal.collect_raw(pal.submit(
        [PRec(name=a, seq=s, qual=q) for a, s, q in recs]))
    assert len(jg) == len(pg) == len(recs)
    for a, b in zip(jg, pg):
        assert a == b
