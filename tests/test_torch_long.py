"""Long reads (over 8192 bp) in the port against the JAX package, on the
CPU (device="cpu": the kernels' plain versions). Tolerance: exact.

- The band DP's and band walk's plain versions (`_sw_banded_diag_plain`,
  `_backtrace_diag_plain`) against `sw_banded_diag` and `backtrace_diag` on
  every case of `ops/cases.py` `diag_cases` / `bt_diag_cases` (with the
  edges of the kernels' designs: reads of 1-3 codes, an odd problem count,
  600-700 rows, gap runs over 32 steps, G = 0, and walks whose runs meet a
  band edge, row -1 or the step limit): score, row, band column and the
  whole direction words; op bytes and all 7 fields.
- The port's band DP and walk against its rectangle DP and walk, on
  --dpad-bounded problems (tests/test_sw.py does the same for JAX).
- SAM: single-end (`collect` and `collect_raw`, end to end and --local),
  paired-end with one mate over 8192 bp, and the CLI's `align -U` on a
  FASTQ of short and long reads, whose short reads the batch planner
  merges into the long batch. The replay-override counts are equal too
  (the trajectory replay swallows its own exceptions).

The genome is the lambda phage rebuilt from tests/golden/lambda_pe.sam.gz.
A long batch takes the phase-by-phase host path in both packages; the
JAX side runs it once per batch and both of its collect entries format
that one result (the host path is deterministic), which keeps the file's
time down."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from bowtie2_tpu.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu.io.fastx import SeqRecord as JRec  # noqa: E402
from bowtie2_tpu.ops import sw as jsw  # noqa: E402
from bowtie2_tpu.pipeline.align import PairedAligner as JPaired  # noqa: E402
from bowtie2_tpu.pipeline.align import UnpairedAligner as JAligner  # noqa: E402
from bowtie2_tpu.pipeline.policy import make_policy as jpolicy  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord as PRec  # noqa: E402
from bowtie2_tpu_torch.ops import cases  # noqa: E402
from bowtie2_tpu_torch.ops import sw as psw  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner as PAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import PairedAligner as PPaired  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy as ppolicy  # noqa: E402
from test_torch_cli import (PORT_PROCS, _build_both, _codes,  # noqa: E402
                            _fastq, _qual, align_both, start_port_runs)
from test_torch_cli_lambda import GOLDEN_PE, rebuild_lambda  # noqa: E402

DIAG = cases.diag_cases()
BT_NAMES = ([f"bt_{c.name}" for c in DIAG]
            + [c.name for c in cases.bt_diag_random_cases()]
            + [c.name for c in cases.bt_diag_edge_cases()])


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


# ---------------------------------------------------------------------------
# the plain versions against the JAX ops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def diag_results():
    """{case name: (row, lane, dirs)} of the port's plain band DP."""
    out = {}
    for c in DIAG:
        r = psw.sw_banded_diag(_t(c.reads), _t(c.quals), _t(c.lens),
                               _t(c.wins), psw.SWParams(**c.params()),
                               c.band)
        out[c.name] = (r.row.numpy(), r.lane.numpy(), r.dirs.numpy())
    return out


@pytest.mark.parametrize("case", DIAG, ids=[c.name for c in DIAG])
def test_diag_dp_plain_matches_jax(case, diag_results):
    c = case
    j = jsw.sw_banded_diag(_j(c.reads), _j(c.quals), _j(c.lens), _j(c.wins),
                           jsw.SWParams(**c.params()), c.band)
    p = psw.sw_banded_diag(_t(c.reads), _t(c.quals), _t(c.lens), _t(c.wins),
                           psw.SWParams(**c.params()), c.band)
    for f in ("score", "row", "lane", "dirs"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(p, f).numpy(), err_msg=f)
    assert p.dirs.shape == (c.reads.shape[1], c.reads.shape[0],
                            (2 * c.band + 8) // 8)


@pytest.mark.parametrize("name", BT_NAMES)
def test_diag_walk_plain_matches_jax(name, diag_results):
    c = next(b for b in cases.bt_diag_cases(lambda d: diag_results[d.name])
             if b.name == name)
    args = (c.dirs, c.sel, c.rows, c.lanes, c.reads, c.quals, c.wins)
    j = jsw.backtrace_diag(*map(_j, args), jsw.SWParams(**c.params()),
                           c.band)
    p = psw.backtrace_diag(*map(_t, args), psw.SWParams(**c.params()),
                           c.band)
    for f in psw.BTResult._fields:
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(p, f).numpy(), err_msg=f)


def test_band_wrappers_dispatch():
    """CPU tensors take the plain versions (counted); a device without a
    kernel raises; the kernels are never launched here."""
    from bowtie2_tpu_torch.ops import _build
    c = DIAG[0]
    p = psw.SWParams(**c.params())
    _build.reset_counts()
    r = psw.sw_banded_diag(_t(c.reads), _t(c.quals), _t(c.lens), _t(c.wins),
                           p, c.band)
    sel = torch.arange(c.reads.shape[0], dtype=torch.int32)
    psw.backtrace_diag(r.dirs, sel, r.row, r.lane, _t(c.reads),
                       _t(c.quals), _t(c.wins), p, c.band)
    assert dict(_build.PLAIN_CALLS) == {"sw_diag": 1, "bt_diag": 1}
    assert not _build.LAUNCHES
    meta = [torch.zeros(x.shape, dtype=torch.int32, device="meta")
            for x in (c.reads, c.quals, c.lens, c.wins)]
    with pytest.raises(ValueError, match="no kernel"):
        psw.sw_banded_diag(*meta, p, c.band)
    with pytest.raises(ValueError, match="no kernel"):
        psw.backtrace_diag(r.dirs.to("meta"), sel.to("meta"),
                           r.row.to("meta"), r.lane.to("meta"), meta[0],
                           meta[1], meta[3], p, c.band)


def _band_problems(rng, B, L, G):
    """Reads embedded in windows of L + 2G + 1 columns with substitutions,
    at most G net inserted or deleted codes, and Ns."""
    W = L + 2 * G + 1
    reads = rng.integers(0, 4, (B, L)).astype(np.int32)
    wins = rng.integers(0, 4, (B, W)).astype(np.int32)
    for b in range(B):
        seg = reads[b].copy()
        for _ in range(b % 4):
            seg[int(rng.integers(0, L))] = rng.integers(0, 4)
        p = int(rng.integers(15, L - 15))
        n = 1 + b % 3
        if b % 3 == 1:
            seg = np.concatenate([seg[:p], rng.integers(0, 4, n), seg[p:]])
        elif b % 3 == 2:
            seg = np.delete(seg, np.arange(p, p + n))
        seg = seg[:W - G]
        wins[b, G:G + seg.size] = seg
        if b % 6 == 0:
            reads[b, int(rng.integers(0, L))] = 4
    quals = rng.integers(10, 41, (B, L)).astype(np.int32)
    return reads, quals, wins


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_diag_dp_matches_rect(local):
    """The band DP finds the rectangle DP's score at the same rect column
    (row + band column), and its walk the rectangle walk's start, counts
    and score, for --dpad-bounded alignments."""
    rng = np.random.default_rng(29)
    G, L, B = 10, 80, 24
    reads, quals, wins = map(_t, _band_problems(rng, B, L, G))
    lens = torch.full((B,), L, dtype=torch.int32)
    p = psw.SWParams(match_bonus=2 if local else 0, local=local)
    r0 = psw.sw_banded(reads, quals, lens, wins, p, G)
    r1 = psw.sw_banded_diag(reads, quals, lens, wins, p, G)
    np.testing.assert_array_equal(r0.score.numpy(), r1.score.numpy())
    np.testing.assert_array_equal(r0.lane.numpy(),
                                  (r1.row + r1.lane).numpy())
    sel = torch.arange(B, dtype=torch.int32)
    b1 = psw.backtrace_diag(r1.dirs, sel, r1.row, r1.lane, reads, quals,
                            wins, p, G)
    b0 = psw.backtrace(r0.dirs, sel, r0.row, r0.lane, reads, quals, wins,
                       p, G)
    np.testing.assert_array_equal(b1.score_check.numpy(), r0.score.numpy())
    for f in ("read_start", "ref_start_win", "n_mm", "n_go", "n_gc",
              "n_refn"):
        np.testing.assert_array_equal(getattr(b0, f).numpy(),
                                      getattr(b1, f).numpy(), err_msg=f)


# ---------------------------------------------------------------------------
# SAM against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lam():
    """(reference name, genome codes, the index of both packages)."""
    name, genome, _m1, _m2 = rebuild_lambda(GOLDEN_PE, 0)
    g = np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                        np.frombuffer(genome.encode(), np.uint8))
    g = g.astype(np.uint8)
    return name, g, build_index_from_refs([(name, g)])


def _mutate(rng, codes, sub, indels=0):
    codes = codes.astype(np.int8).copy()
    err = rng.random(codes.size) < sub
    codes[err] = (codes[err] + rng.integers(1, 4, int(err.sum()))) % 4
    for _ in range(indels):
        p = int(rng.integers(500, codes.size - 500))
        n = int(rng.integers(1, 4))
        codes = (np.concatenate([codes[:p], rng.integers(0, 4, n), codes[p:]])
                 if rng.random() < 0.5 else np.delete(codes, range(p, p + n)))
    return codes.astype(np.uint8)


def _long_reads(g):
    """tests/test_e2e.py test_long_reads_diag_kernel's recipe (4 reads of
    9-12 kbp at 2 % substitutions, default_rng(17)), then two such reads
    with 1-3-bp indels, the second reverse-complemented, and a random
    read that aligns nowhere."""
    rng = np.random.default_rng(17)
    out = []
    for i in range(6):
        L = int(rng.integers(9000, 12000))
        p = int(rng.integers(0, g.size - L))
        c = _mutate(rng, g[p:p + L], 0.02, indels=0 if i < 4 else 2)
        if i == 5:
            c = (3 - c)[::-1].copy()
        out.append((f"L{i}", c))
    out.append(("Lrand", rng.integers(0, 4, 9500).astype(np.uint8)))
    qrng = np.random.default_rng(18)
    return [(n, c, qrng.integers(20, 41, c.size).astype(np.uint8))
            for n, c in out]


def _host_once(al, attr):
    """Run the JAX aligner's host path once per batch: both of its collect
    entries then format the same result."""
    run = getattr(al, attr)
    memo = {}

    def once(batch, *a, **k):
        key = tuple(id(x) for x in batch)
        if key not in memo:
            memo[key] = run(batch, *a, **k)
        return memo[key]
    setattr(al, attr, once)


def _counts(al, times=1):
    """The reads the trajectory replay overrode and the summary counts,
    divided by the host-path runs behind them."""
    out = dict(vars(al.stats), traj=al.metrics.counters.get(
        "traj_overridden", 0))
    assert all(v % times == 0 for v in out.values())
    return {k: v // times for k, v in out.items()}


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_long_se_sam_matches_jax(lam, local):
    _name, g, data = lam
    reads = _long_reads(g)
    jal = JAligner(data, jpolicy("sensitive", local=local))
    _host_once(jal, "_align_batch_host")
    jrecs = [JRec(name=n, seq=s, qual=q) for n, s, q in reads]
    jh = jal.submit(jrecs)
    jobj, jraw = jal.collect(jh), jal.collect_raw(jh)
    pal = PAligner(data, ppolicy("sensitive", local=local), device="cpu")
    ph = pal.submit([PRec(name=n, seq=s, qual=q) for n, s, q in reads])
    assert ph[0] == "long"
    pobj, praw = pal.collect(ph), pal.collect_raw(ph)
    assert [r.line() for r in pobj] == [r.line() for r in jobj]
    assert praw == jraw
    assert len(praw) == len(reads)
    # six alignments, with the indels in their CIGARs; the random read
    # unaligned
    flags = [grp[0][0] for grp in praw]
    assert [f & 4 for f in flags] == [0] * 6 + [4]
    cigars = [grp[0][1].split(b"\t")[5] for grp in praw[4:6]]
    assert any(b"I" in c or b"D" in c for c in cigars), cigars
    # the port ran its host path twice (collect and collect_raw)
    assert _counts(pal, 2) == _counts(jal)


def test_long_pe_sam_matches_jax(lam):
    """8 pairs, one mate of each over 8192 bp: the long mate first or
    second, the other mate 100 bp from inside the long one's span,
    opposite strand, or random (no mate rescue for long reads)."""
    _name, g, data = lam
    rng = np.random.default_rng(23)
    pairs = []
    for i in range(8):
        L = int(rng.integers(8500, 11000))
        p = int(rng.integers(0, g.size - L))
        long_c = _mutate(rng, g[p:p + L], 0.01)
        q0 = int(rng.integers(0, L - 100))
        short_c = (rng.integers(0, 4, 100).astype(np.uint8) if i % 4 == 3
                   else (3 - _mutate(rng, g[p + q0:p + q0 + 100], 0.01)
                         )[::-1].copy())
        m1, m2 = (long_c, short_c) if i % 2 == 0 else (short_c, long_c)
        pairs.append((f"P{i}", m1, m2))

    def recs(cls):
        return [(cls(name=n, seq=a, qual=np.full(a.size, 33, np.uint8)),
                 cls(name=n, seq=b, qual=np.full(b.size, 31, np.uint8)))
                for n, a, b in pairs]
    jal = JPaired(data, jpolicy("sensitive"))
    jraw = jal.collect_raw(jal.submit(recs(JRec)))
    pal = PPaired(data, ppolicy("sensitive"), device="cpu")
    ph = pal.submit(recs(PRec))
    assert ph[0] == "host"
    praw = pal.collect_raw(ph)
    assert praw == jraw
    assert len(praw) == len(pairs)
    assert sum(1 for grp in praw for f, _ in grp if not f & 4) >= 12
    assert pal.metrics.counters.get("mate_dps", 0) == 0
    assert _counts(pal) == _counts(jal)


@pytest.fixture(scope="module")
def mixed_cli(lam, tmp_path_factory):
    """A FASTQ of 30 reads of 100 bp and 3 of 9-10 kbp, both packages'
    indexes, and the port's `align -U` on it, started at once."""
    name, g, _data = lam
    d = str(tmp_path_factory.mktemp("long_cli"))
    fa = os.path.join(d, "lambda.fa")
    s = _codes(g)
    with open(fa, "w") as f:
        f.write(f">{name}\n" + "\n".join(s[i:i + 70]
                                         for i in range(0, len(s), 70)) + "\n")
    rng = np.random.default_rng(31)
    recs = []
    for i in range(33):
        L = 100 if i < 30 else int(rng.integers(9000, 10000))
        p = int(rng.integers(0, g.size - L))
        c = _mutate(rng, g[p:p + L], 0.01)
        if i % 2:
            c = (3 - c)[::-1].copy()
        recs.append((f"r{i}", _codes(c),
                     _qual(rng.integers(20, 41, c.size))))
    order = rng.permutation(len(recs))
    _fastq(os.path.join(d, "mixed.fq"), [recs[k] for k in order])
    jidx, pidx = _build_both(d, fa)
    inputs = ["-U", os.path.join(d, "mixed.fq")]
    with ThreadPoolExecutor(PORT_PROCS) as pool:
        yield d, jidx, inputs, start_port_runs(pool, d, pidx,
                                               [("mixed", inputs, [])])


def test_cli_mixed_lengths_matches_jax(mixed_cli):
    d, jidx, inputs, port = mixed_cli
    (jsam, _), (psam, _) = align_both(d, "mixed", jidx, port["mixed"],
                                      inputs, [])
    body = [x for x in psam if x[0] != "@"]
    assert len(body) == 33
    assert sum(1 for x in body if not int(x.split("\t")[1]) & 4) >= 30
    assert psam == jsam
