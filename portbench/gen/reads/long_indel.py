"""Read recipe `long_indel`: chip_smoke.py `long_corpus` with its
`mutate`, frozen here so that later changes to the repository's scripts
cannot move the benchmark. Do not edit: a change here changes every
traffic mix that names the recipe.

Parameters: len ([lo, hi] bp, uniform), sub (substitutions a base),
indel (1-3-bp insertions or deletions a base), qual ([lo, hi] phred).
"""

import numpy as np


def mutate(rng, codes, sub, indel=0.0):
    """chip_smoke.py mutate: codes with substitutions at rate sub and a
    1-3-bp insertion or deletion at rate indel a base (none within 100 bp
    of either end)."""
    c = codes.astype(np.int8).copy()
    err = rng.random(c.size) < sub
    c[err] = (c[err] + rng.integers(1, 4, int(err.sum()))) % 4
    for _ in range(int(rng.binomial(c.size, indel))):
        q = int(rng.integers(100, c.size - 100))
        n = int(rng.integers(1, 4))
        c = (np.concatenate([c[:q], rng.integers(0, 4, n), c[q:]])
             if rng.random() < 0.5 else np.delete(c, range(q, q + n)))
    return c.astype(np.uint8)


def draw(rng, genome, n, p):
    """n reads (codes, quals, origin, strand) of lengths uniform in
    p["len"] with mutate()'s errors, half reverse-complemented, quals
    uniform in p["qual"]."""
    g = genome.codes
    out = []
    lo, hi = p["qual"]
    for _ in range(n):
        L = int(rng.integers(p["len"][0], p["len"][1] + 1))
        s = int(genome.draw_starts(rng, None, L))
        c = mutate(rng, g[s:s + L], p["sub"], p["indel"])
        rc = rng.random() < 0.5
        if rc:
            c = (3 - c)[::-1].copy()
        out.append((c, rng.integers(lo, hi + 1, c.size).astype(np.uint8), s,
                    int(rc)))
    return out
