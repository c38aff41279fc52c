"""Read recipe `art_pairs`: scripts/make_chr21.py `sim_pairs`
(art_illumina-like pairs), frozen here so that later changes to the
repository's scripts cannot move the benchmark; changed only to return
each mate's origin and to draw fragments within one reference. Do not
edit: a change here changes every traffic mix that names the recipe.

Parameters: read_len, frag_mean, frag_sd, max_n, and `mates` (1: mate 1
alone, as single-end reads; 2, the default: pairs).
"""

import numpy as np


def sim_pairs(rng, genome, n, L=150, fmean=200, fsd=10, max_n=8):
    """scripts/make_chr21.py sim_pairs: fragment ~N(fmean,fsd) (>=L),
    mate1 fw at p, mate2 rc at p+frag-L; cycle-decaying quals,
    qual-driven sub errors; pairs touching more than max_n Ns dropped.
    Returns (c1, q1, c2, q2, pos1, pos2), quals as phred."""
    g = genome.codes
    frag = np.maximum(rng.normal(fmean, fsd, n).astype(np.int64), L)
    pos = genome.draw_starts(rng, n, frag.max() + 1)
    cyc = np.arange(L)
    qprof1 = np.clip(38 - cyc * 0.04 - rng.normal(0, 2, (n, L)), 2, 40)
    qprof2 = np.clip(36 - cyc * 0.05 - rng.normal(0, 2, (n, L)), 2, 40)

    def mate(p_start, rc, qprof):
        idx = p_start[:, None] + np.arange(L)[None, :]
        codes = g[idx].astype(np.int8)
        q = qprof.astype(np.int64)
        perr = 10.0 ** (-q / 10.0)
        err = rng.random((n, L)) < perr
        codes = np.where(err & (codes < 4),
                         (codes + rng.integers(1, 4, (n, L))) % 4, codes)
        if rc:
            comp = np.where(codes < 4, 3 - codes, codes)
            codes = comp[:, ::-1]
            q = q[:, ::-1]
        return codes, q.astype(np.uint8)

    c1, q1 = mate(pos, False, qprof1)
    p2 = pos + frag - L
    c2, q2 = mate(p2, True, qprof2)
    hasn = ((c1 == 4).sum(1) + (c2 == 4).sum(1)) > max_n
    keep = ~hasn
    return c1[keep], q1[keep], c2[keep], q2[keep], pos[keep], p2[keep]


def draw(rng, genome, n, p):
    """n units: pairs of reads (codes, quals, origin, strand), or mate 1
    alone where p["mates"] == 1."""
    out = []
    while len(out) < n:
        want = n - len(out)
        c1, q1, c2, q2, p1, p2 = sim_pairs(
            rng, genome, int(want * 1.05) + 16, p["read_len"],
            p["frag_mean"], p["frag_sd"], p["max_n"])
        k = min(want, c1.shape[0])
        m1 = list(zip(c1[:k].astype(np.uint8), q1[:k], p1[:k].tolist(),
                      [0] * k))
        if p.get("mates", 2) == 1:
            out += m1
        else:
            out += zip(m1, zip(c2[:k].astype(np.uint8), q2[:k],
                               p2[:k].tolist(), [1] * k))
    return out
