"""Genome recipe `chr21sim`: a copy of scripts/make_chr21.py
`make_genome`, frozen here so that later changes to the repository's
scripts cannot move the benchmark. Do not edit: a change here changes
every configuration that names the recipe (and, by the cache's digest,
only those).

Each reference of the configuration's `refs` is one such chromosome at
its length, drawn in turn from the configuration's genome seed. Codes
0..3 (A, C, G, T) and 4 (N), int8.
"""

import numpy as np


def make(rng, refs):
    """[(name, codes)] of the configuration's `refs` ([name, bp] each)."""
    return [(name, chr21sim(rng, int(bp))) for name, bp in refs]


def chr21sim(rng, size):
    """scripts/make_chr21.py make_genome: a chromosome with human-like
    repeat content (Alu-like and L1-like copies, an alpha-satellite-like
    field, telomeric caps, N gaps, GC isochores)."""
    # isochore GC structure: per-100kbp GC in [0.35, 0.55]
    nblk = size // 100_000 + 1
    gc = rng.uniform(0.35, 0.55, nblk)
    g = np.empty(size, dtype=np.int8)
    for b in range(nblk):
        s, e = b * 100_000, min((b + 1) * 100_000, size)
        if s >= e:
            break
        p_gc = gc[b] / 2
        p_at = (1 - gc[b]) / 2
        g[s:e] = rng.choice(4, e - s, p=[p_at, p_gc, p_gc, p_at])

    def plant(consensus, n, div_lo, div_hi, trunc_frac=0.0):
        L = consensus.size
        for _ in range(n):
            pos = int(rng.integers(0, size - L))
            copy = consensus.copy()
            div = rng.uniform(div_lo, div_hi)
            nmut = max(int(div * L), 1)
            mp = rng.choice(L, nmut, replace=False)
            copy[mp] = (copy[mp] + rng.integers(1, 4, nmut)) % 4
            if trunc_frac and rng.random() < trunc_frac:
                cut = int(rng.integers(L // 10, L))   # keep 3' end
                copy = copy[L - cut:]
            if rng.random() < 0.5:                     # strand
                copy = (3 - copy)[::-1]
            g[pos:pos + copy.size] = copy

    alu = rng.integers(0, 4, 300, dtype=np.int8)
    plant(alu, 40_000, 0.05, 0.15)
    line1 = rng.integers(0, 4, 6_000, dtype=np.int8)
    plant(line1, 300, 0.05, 0.20, trunc_frac=0.7)
    # centromeric alpha-satellite-like field: 2 Mbp of 171-bp monomers
    mono = rng.integers(0, 4, 171, dtype=np.int8)
    cen = int(size * 0.45)
    ncopy = 2_000_000 // 171
    arr = np.tile(mono, ncopy)
    mut = rng.random(arr.size) < 0.03
    arr[mut] = (arr[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
    g[cen:cen + arr.size] = arr
    # telomeric caps
    tel = np.tile(np.frombuffer(b"TTAGGG", np.uint8), 2000)
    telc = np.array([{65: 0, 67: 1, 71: 2, 84: 3}[c] for c in tel[:6]],
                    np.int8)
    telc = np.tile(telc, 2000)
    g[:telc.size] = telc
    g[-telc.size:] = (3 - telc)[::-1]
    # N assembly gaps: ~2% in a few dozen blocks (code 4)
    n_total = int(size * 0.02)
    nblocks = 30
    for _ in range(nblocks):
        blk = n_total // nblocks
        pos = int(rng.integers(telc.size, size - blk - telc.size))
        g[pos:pos + blk] = 4
    return g
