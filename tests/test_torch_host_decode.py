"""The host path's batched CIGAR/MD decode in the port, on the CPU.

- `native.samemit.cigar_md_batch` against `pipeline.backtrace
  .cigar_md_from_packed`, string for string, on op columns of 10-40 kbp
  built here: substitutions, Ns, deletion and insertion runs placed at
  the right end of homopolymers and tandem repeats (so the leftmost-gap
  rule shifts both kinds of run), soft clips and --xeq. One column holds
  over 32,768 ops.
- The SE host path in long mode and the PE host path on a batch that
  overflows the fused DP budget: the SAM is the same with the batched
  decode turned off (every record then takes the per-record decoder),
  and the counters say which decoder ran.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

from bowtie2_tpu_torch.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord  # noqa: E402
from bowtie2_tpu_torch.native import samemit  # noqa: E402
from bowtie2_tpu_torch.ops.sw import OP_D, OP_I, OP_M, OP_NONE  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.backtrace import cigar_md_from_packed  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import PairedAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy  # noqa: E402
from test_torch_corpus import corpus  # noqa: E402


# ---------------------------------------------------------------------------
# the batch entry against the per-record decoder
# ---------------------------------------------------------------------------

def _walk(rng, n_read, sub, p_gap):
    """One alignment of about n_read aligned read codes, built segment by
    segment: random stretches, homopolymers and tandem repeats, with
    deletions and insertions put at a repeat's right end.

    Returns (forward op bytes, aligned read codes, n_gc)."""
    ops, refc, ism, read = [], [], [], []

    def m(c):
        r = c
        if c == 4 or rng.random() < sub:      # mismatch, or a reference N
            r = int(rng.integers(0, 5)) if c == 4 else \
                (c + int(rng.integers(1, 4))) % 4
        ops.append(OP_M)
        refc.append(c)
        ism.append(int(r == c and c < 4))
        read.append(r)

    n_gc = 0
    while len(read) < n_read:
        kind = rng.random()
        if kind < 0.3:
            seg = [int(rng.integers(0, 4))] * int(rng.integers(3, 10))
            unit = 1
        elif kind < 0.55:
            unit = int(rng.integers(2, 5))
            seg = rng.integers(0, 4, unit).tolist() * int(rng.integers(3, 7))
        else:
            unit = 0
            seg = rng.integers(0, 4, int(rng.integers(5, 40))).tolist()
            if rng.random() < 0.05:
                seg[int(rng.integers(0, len(seg)))] = 4
        gap = rng.random() if unit else 1.0
        if gap < p_gap / 2:                       # delete the last unit(s)
            d = unit * int(rng.integers(1, 3))
            for c in seg[:-d]:
                m(c)
            for c in seg[-d:]:
                ops.append(OP_D)
                refc.append(c)
                ism.append(int(rng.integers(0, 2)))
            n_gc += d
        elif gap < p_gap:                         # insert a copy of them
            d = unit * int(rng.integers(1, 3))
            for c in seg:
                m(c)
            for c in seg[-d:]:
                ops.append(OP_I)
                refc.append(int(rng.integers(0, 5)))
                ism.append(int(rng.integers(0, 2)))
                read.append(c)
            n_gc += d
        else:
            for c in seg:
                m(c)
    opb = (np.array(ops) | (np.array(refc) << 2) | (np.array(ism) << 5))
    return opb.astype(np.uint8), np.array(read, np.int8), n_gc


def _columns(seed, n_read, n_cols, clip):
    """n_cols walks in one (S, n_cols) matrix in walk order (read end
    first), OP_NONE past each walk's end, with the read codes around each
    walk's span (soft clips when clip)."""
    rng = np.random.default_rng(seed)
    walks = []
    for _ in range(n_cols):
        opb, aread, n_gc = _walk(rng, int(rng.integers(n_read // 2, n_read)),
                                 sub=0.005, p_gap=0.3)
        lo = int(rng.integers(1, 30)) if clip else 0
        hi = int(rng.integers(1, 30)) if clip else 0
        read = np.concatenate([rng.integers(0, 4, lo), aread,
                               rng.integers(0, 4, hi)]).astype(np.int8)
        walks.append((opb, read, lo, lo + aread.size, n_gc))
    S = max(w[0].size for w in walks) + 8
    Lmax = max(w[1].size for w in walks)
    ops = np.full((S, n_cols), OP_NONE, np.uint8)
    reads = np.full((n_cols, Lmax), 4, np.int8)
    meta = []
    for c, (opb, read, rs, re_, n_gc) in enumerate(walks):
        ops[:opb.size, c] = opb[::-1]
        reads[c, :read.size] = read
        meta.append((rs, re_, read.size, (re_ - rs) + n_gc + 1))
    return ops, reads, np.array(meta, np.int64)


DECODE_CASES = {       # seed, aligned read codes, columns, soft clips, --xeq
    "10k": (1, 10_000, 4, False, False),
    "10k-clip-xeq": (2, 10_000, 4, True, True),
    "25k-clip": (3, 25_000, 3, True, False),
    "40k-xeq": (4, 40_000, 2, False, True),
    "past-32768-ops": (5, 36_000, 2, True, False),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_cigar_md_batch_matches_per_record(case):
    seed, n_read, n_cols, clip, xeq = DECODE_CASES[case]
    ops, reads, meta = _columns(seed, n_read, n_cols, clip)
    rs, re_, L, bound = meta.T
    if case == "past-32768-ops":
        assert ((ops != OP_NONE).sum(axis=0) > 32_768).any()
    cigars, mds = samemit.cigar_md_batch(
        ops, np.arange(n_cols), rs, re_, L, bound, reads, xeq=xeq)
    for c in range(n_cols):
        co, md = cigar_md_from_packed(ops[:bound[c], c], int(rs[c]),
                                      int(re_[c]), int(L[c]),
                                      read=reads[c, :L[c]], xeq=xeq)
        assert cigars[c] == "".join(f"{n}{op}" for op, n in co)
        assert mds[c] == md
    # both left-shift branches had runs to move
    opsk = ops & 3
    assert (opsk == OP_I).any() and (opsk == OP_D).any()
    assert any("I" in c for c in cigars) and any("D" in c for c in cigars)


# ---------------------------------------------------------------------------
# the host paths, with the batched decode on and off
# ---------------------------------------------------------------------------

def _mutate(rng, seq, sub, indel):
    out = []
    for c in seq.tolist():
        u = rng.random()
        if u < indel / 2:
            continue                                     # deletion
        if u < indel:
            out.append(int(rng.integers(0, 4)))          # insertion
        out.append((c + int(rng.integers(1, 4))) % 4
                   if rng.random() < sub else c)
    return np.array(out, np.uint8)


@pytest.fixture(scope="module")
def unique_genome():
    """60 kbp of random codes: no read has a second candidate, so no
    replay group replaces a record the host path emitted."""
    g = np.random.default_rng(3).integers(0, 4, 60_000).astype(np.uint8)
    return g, build_index_from_refs([("uniq", g)])


@pytest.fixture(scope="module")
def rep_genome():
    """test_torch_corpus.py's genome with 60 repeats: a batch of 2 %-error
    pairs overflows the fused DP budget."""
    g, _ = corpus(8, n_alu=60)
    return g, build_index_from_refs([("rep", g)])


def _no_native(monkeypatch):
    """Make the native library fail to import, as where it cannot be
    built: the host paths then decode each record on its own."""
    monkeypatch.setitem(sys.modules, "bowtie2_tpu_torch.native.samemit",
                        None)


def _aligned_edited(lines):
    """Aligned records that carry an edit, i.e. that a decoder ran for."""
    n = 0
    for line in lines:
        f = line.split("\t")
        if int(f[1]) & 4:
            continue
        tags = dict(t.split(":", 1) for t in f[11:])
        if (tags["XM"], tags["XG"], tags["XN"]) != ("i:0", "i:0", "i:0"):
            n += 1
    return n


def _long_run(data, reads):
    al = UnpairedAligner(data, make_policy("sensitive"), device="cpu")
    h = al.submit([SeqRecord(name=n, seq=s, qual=q) for n, s, q in reads])
    assert h[0] == "long"
    return al, [r.line() for r in al.collect(h)]


def test_long_se_host_decode(unique_genome, monkeypatch):
    g, data = unique_genome
    rng = np.random.default_rng(31)
    reads = []
    for i in range(4):
        L = int(rng.integers(8500, 10000))
        p = int(rng.integers(0, g.size - L))
        c = _mutate(rng, g[p:p + L], 0.01, 0.0005)
        if i % 2:
            c = (3 - c)[::-1].copy()
        reads.append((f"L{i}", c, np.full(c.size, 35, np.uint8)))
    al, lines = _long_run(data, reads)
    n = _aligned_edited(lines)
    assert n == len(reads)
    assert any("I" in ln.split("\t")[5] or "D" in ln.split("\t")[5]
               for ln in lines)
    assert al.metrics.counters.get("traj_overridden", 0) == 0
    assert al.metrics.counters.get("host_decode_native", 0) == n
    assert al.metrics.counters.get("host_decode_numpy", 0) == 0
    _no_native(monkeypatch)
    al0, lines0 = _long_run(data, reads)
    assert lines0 == lines
    assert al0.metrics.counters.get("host_decode_native", 0) == 0
    assert al0.metrics.counters.get("host_decode_numpy", 0) == n


def _pairs(g, n, err, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        ins = int(rng.integers(200, 400))
        p = int(rng.integers(0, g.size - ins))
        c1 = _mutate(rng, g[p:p + 100], err, err / 5)
        c2 = (3 - _mutate(rng, g[p + ins - 100:p + ins], err, err / 5)
              )[::-1].copy()
        if i % 16 == 5:                  # a garbage mate: mate rescue
            c2 = rng.integers(0, 4, 100).astype(np.uint8)
        out.append((SeqRecord(name=f"p{i}", seq=c1,
                              qual=np.full(c1.size, 35, np.uint8)),
                    SeqRecord(name=f"p{i}", seq=c2,
                              qual=np.full(c2.size, 35, np.uint8))))
    return out


def _pe_run(data, pairs):
    pa = PairedAligner(data, make_policy("sensitive"), device="cpu")
    f = pa.submit(pairs)
    assert pa._pe_decode(f) is None          # the DP budget overflowed
    lines = [r.line() for r in pa.collect(f)]
    assert pa.metrics.counters.get("host_batches", 0) == 1
    return pa, lines


def test_pe_host_decode(rep_genome, monkeypatch):
    g, data = rep_genome
    pairs = _pairs(g, 256, 0.02)
    pa, lines = _pe_run(data, pairs)
    n = _aligned_edited(lines)
    assert n > 0
    assert pa.metrics.counters.get("host_decode_native", 0) == n
    assert pa.metrics.counters.get("host_decode_numpy", 0) == 0
    _no_native(monkeypatch)
    pa0, lines0 = _pe_run(data, pairs)
    assert lines0 == lines
    assert pa0.metrics.counters.get("host_decode_native", 0) == 0
    assert pa0.metrics.counters.get("host_decode_numpy", 0) == n
