"""Read recipe `uniform_sub`: the `reads` helper of chip_smoke.py
`ecoli_corpus` (substitutions, quals uniform, half reverse-complemented),
frozen here so that later changes to the repository's scripts cannot
move the benchmark, with the read length, error rate and quals as
parameters and the origin kept. Do not edit: a change here changes every
traffic mix that names the recipe.

Parameters: read_len, sub (the substitution rate a base), qual ([lo, hi]
phred, uniform).
"""

import numpy as np


def draw(rng, genome, n, p):
    """n reads (codes, quals, origin, strand) of p["read_len"] bp at
    uniform positions, substitutions at rate p["sub"], half reverse-
    complemented, quals uniform in p["qual"]. A substitution's value is
    drawn only where there is one (the copy drew it for every base): the
    same distribution at a third of the time."""
    g = genome.codes
    L = p["read_len"]
    pos = genome.draw_starts(rng, n, L)
    codes = g[pos[:, None] + np.arange(L)[None, :]].astype(np.uint8)
    err = rng.random((n, L)) < p["sub"]
    codes[err] = (codes[err] + rng.integers(1, 4, int(err.sum()),
                                            dtype=np.uint8)) % 4
    rc = rng.random(n) < 0.5
    codes[rc] = (3 - codes[rc])[:, ::-1]
    lo, hi = p["qual"]
    quals = rng.integers(lo, hi + 1, (n, L), dtype=np.uint8)
    return list(zip(codes, quals, pos.tolist(), rc.astype(int).tolist()))
