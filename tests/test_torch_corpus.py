"""Shared corpus of the PyTorch port's parity tests, and checks of it.

The genome is scripts/make_repcorpus.py's `make_genome` cut to 200 kbp with
a few Alu-like repeats and tandem arrays; the reads are its `sample_reads`,
and every eighth read in each of three classes is given an indel, Ns or an
odd length by numpy here, so the gapped DP, the N paths and the RNG
trajectory replay all run. Everything comes from numpy seeds: the JAX
package and the port get the same arrays.

Two densities: `n_alu=20` keeps every batch inside the fused pipeline's DP
budget (the fused path); `n_alu=60` overflows it, so the batch takes the
host phase-by-phase path in both packages.
"""

import importlib.util
import os

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repcorpus_module():
    path = os.path.join(_REPO, "scripts", "make_repcorpus.py")
    spec = importlib.util.spec_from_file_location("make_repcorpus", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corpus(n_reads: int = 400, n_alu: int = 20, seed: int = 5):
    """(genome uint8 codes, [(name, codes uint8, quals uint8)])."""
    mrc = repcorpus_module()
    rng = np.random.default_rng(seed)
    g = mrc.make_genome(rng, size=200_000, n_alu=n_alu, tandem_copies=20,
                        n_tandem=3)
    out = []
    for i, (r, q) in enumerate(mrc.sample_reads(rng, g, n_reads)):
        k = i % 8
        if k == 1:                                   # deletion
            p, d = int(rng.integers(30, 70)), int(rng.integers(1, 7))
            r = np.concatenate([r[:p], r[p + d:]])
            q = np.concatenate([q[:p], q[p + d:]])
        elif k == 2:                                 # insertion
            p, d = int(rng.integers(30, 70)), int(rng.integers(1, 7))
            r = np.concatenate([r[:p], rng.integers(0, 4, d).astype(r.dtype),
                                r[p:]])
            q = np.concatenate([q[:p], rng.integers(28, 41, d), q[p:]])
        elif k == 3:                                 # Ns
            r = r.copy()
            r[rng.choice(r.size, int(rng.integers(1, 4)), replace=False)] = 4
        elif k == 4:                                 # odd length
            L = int(rng.integers(41, 99)) | 1
            r, q = r[:L], q[:L]
        out.append((f"r{i}", r.astype(np.uint8), q.astype(np.uint8)))
    return g.astype(np.uint8), out


def n_refs_with_ns(seed: int = 3):
    """Two references with N runs (the rep genome has none): [(name,
    codes)] for build_index_from_refs."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, 3000).astype(np.uint8)
    a[700:760] = 4
    a[1500:1503] = 4
    b = rng.integers(0, 4, 2100).astype(np.uint8)
    b[:25] = 4
    b[2000:] = 4
    return [("chrA", a), ("chrB", b)]


def refs_with_all_n(seed: int = 9):
    """Three references for the multi-reference checks: one entirely N,
    one with leading and trailing N runs (and one inside), one shorter
    than a pair (150 bp)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 4, 8000).astype(np.uint8)
    b[:40] = 4
    b[3000:3100] = 4
    b[-60:] = 4
    return [("allN", np.full(700, 4, np.uint8)), ("chrB", b),
            ("tiny", rng.integers(0, 4, 150).astype(np.uint8))]


def _substitute(rng, codes, rate):
    c = codes.astype(np.int64).copy()
    err = rng.random(c.size) < rate
    c[err] = (np.minimum(c[err], 3) + rng.integers(1, 4, int(err.sum()))) % 4
    return c.astype(np.uint8)


def _revcomp(c):
    return np.where(c < 4, 3 - c, 4)[::-1].astype(np.uint8)


def multiref_reads(refs, n: int, seed: int = 10):
    """[(name, codes, quals)] over refs_with_all_n: 100-bp reads of chrB
    (anywhere, so some cross its N runs and ends), its inner N run's edges
    and the tiny reference (all of it, or the first 60-149 bp), and random
    reads; 1 % substitutions, every other read reverse-complemented."""
    rng = np.random.default_rng(seed)
    b, tiny = refs[1][1], refs[2][1]
    out = []
    for i in range(n):
        kind = i % 5
        if kind == 3:
            c = tiny[:int(rng.integers(60, tiny.size + 1))]
        elif kind == 4:
            c = rng.integers(0, 4, 100).astype(np.uint8)
        else:
            p = int(rng.integers(2950, 3060)) if kind == 2 else \
                int(rng.integers(0, b.size - 100))
            c = b[p:p + 100]
        c = _substitute(rng, c, 0.01)
        if i % 2:
            c = _revcomp(c)
        out.append((f"m{i}", c, rng.integers(25, 41, c.size).astype(
            np.uint8)))
    return out


def multiref_pairs(refs, n: int, seed: int = 11):
    """[(name, mate 1, mate 2, quals 1, quals 2)] over refs_with_all_n:
    FR pairs of 100-bp mates in chrB (inserts 150-500, some across its
    inner N run), pairs with one mate on the tiny reference (mates on
    different references), and pairs with a random mate."""
    rng = np.random.default_rng(seed)
    b, tiny = refs[1][1], refs[2][1]
    out = []
    for i in range(n):
        kind = i % 4
        ins = int(rng.integers(150, 501))
        p = int(rng.integers(2700, 2900)) if kind == 1 else \
            int(rng.integers(0, b.size - ins))
        c1 = b[p:p + 100]
        c2 = _revcomp(b[p + ins - 100:p + ins])
        if kind == 2:
            c2 = _revcomp(tiny[20:120])
        elif kind == 3:
            c2 = rng.integers(0, 4, 100).astype(np.uint8)
        c1, c2 = _substitute(rng, c1, 0.01), _substitute(rng, c2, 0.01)
        out.append((f"q{i}", c1, c2, np.full(100, 35, np.uint8),
                    rng.integers(25, 41, 100).astype(np.uint8)))
    return out


def port_sam(data, kind: str, batch, entries=("collect", "collect_raw"),
             int64_rows=None):
    """The port's SAM (device="cpu") for one batch of numpy records, run in
    a process of its own by the tests that hold it beside the JAX
    package's run: kind "se" (reads (name, codes, quals)) or "pe" (pairs
    (name, codes 1, codes 2, quals 1, quals 2)). Returns {entry: output}
    of one submitted batch (`collect`: record lines, `collect_raw`:
    groups), "path": the kind of batch `submit` returned, and "counters":
    the host-path batches and the reads the trajectory replay overrode.
    With `int64_rows` the aligner's index is put in the int64 row mode
    (`data` built with large=True, whose segment tables are int64), as a
    genome past 2^32 rows would be."""
    import torch
    torch.set_num_threads(1)
    from bowtie2_tpu_torch.index.fmindex import FMIndex
    from bowtie2_tpu_torch.io.fastx import SeqRecord
    from bowtie2_tpu_torch.pipeline.align import UnpairedAligner
    from bowtie2_tpu_torch.pipeline.paired import PairedAligner
    from bowtie2_tpu_torch.pipeline.policy import make_policy
    pol = make_policy("sensitive")
    if kind == "se":
        al = UnpairedAligner(data, pol, device="cpu")
    else:
        al = PairedAligner(data, pol, device="cpu")
    if int64_rows:
        assert al.idx.fw.large
        al.idx = FMIndex.from_host(data, "cpu", int64_rows=True)
    if kind == "se":
        h = al.submit([SeqRecord(name=n, seq=c, qual=q) for n, c, q in batch])
    else:
        h = al.submit([(SeqRecord(name=n, seq=a, qual=qa),
                        SeqRecord(name=n, seq=b, qual=qb))
                       for n, a, b, qa, qb in batch])
    out = {"path": h[0] if isinstance(h, tuple) else type(h).__name__}
    for e in entries:
        out[e] = [r.line() for r in al.collect(h)] if e == "collect" \
            else al.collect_raw(h)
    out["counters"] = {k: al.metrics.counters.get(k, 0)
                       for k in ("host_batches", "traj_overridden")}
    return out


N_LIVE_KINDS = ("zero", "one", "half", "all")


def n_live_of(kind: str, B: int):
    """sw_banded's n_live for a kind: 0 and B // 2 as Python ints, 1 and B
    as 0-d int32 tensors (the fused pipelines' form)."""
    import torch
    n = {"zero": 0, "one": 1, "half": B // 2, "all": B}[kind]
    return torch.tensor(n, dtype=torch.int32) if kind in ("one", "all") \
        else n


def assert_live_region(want, got, lens, n_live, fields):
    """`got` (the port's SWResult at n_live) equals `want` (a full DP's
    result, numpy-convertible fields) where sw_banded's contract specifies
    it: lanes below n_live, their dirs rows below their length; and the
    dead lanes hold sw.DEAD_FILL."""
    from bowtie2_tpu_torch.ops.sw import DEAD_FILL
    n = int(n_live)
    lens = np.asarray(lens)
    for f in fields:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        if f == "dirs":
            rows = np.arange(w.shape[0])[:, None] < lens[None, :n]
            np.testing.assert_array_equal(g[:, :n][rows], w[:, :n][rows],
                                          err_msg=f)
            continue
        np.testing.assert_array_equal(g[:n], w[:n], err_msg=f)
        fill = DEAD_FILL[("score", "row", "lane", "origin").index(f)]
        assert (g[n:] == fill).all(), f


def test_corpus_is_deterministic():
    g1, r1 = corpus(64)
    g2, r2 = corpus(64)
    assert np.array_equal(g1, g2)
    assert all(a[0] == b[0] and np.array_equal(a[1], b[1])
               and np.array_equal(a[2], b[2]) for a, b in zip(r1, r2))


def test_corpus_has_each_read_class():
    g, reads = corpus(64)
    assert g.size == 200_000
    lens = np.array([r[1].size for r in reads])
    assert (lens < 100).any() and (lens > 100).any()     # indels
    assert (lens % 2 == 1).any()                          # odd lengths
    assert any((r[1] == 4).any() for r in reads)          # Ns
    assert all(r[1].size == r[2].size for r in reads)
