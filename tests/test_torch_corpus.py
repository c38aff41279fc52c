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
