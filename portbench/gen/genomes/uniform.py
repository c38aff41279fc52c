"""Genome recipe `uniform`: the genome line of chip_smoke.py
`ecoli_corpus` (uniform random codes), frozen here so that later changes
to the repository's scripts cannot move the benchmark. Do not edit: a
change here changes every configuration that names the recipe.

Each reference of the configuration's `refs` is drawn in turn from the
configuration's genome seed. Codes 0..3 (A, C, G, T), int8.
"""

import numpy as np


def make(rng, refs):
    """[(name, codes)] of the configuration's `refs` ([name, bp] each)."""
    return [(name, rng.integers(0, 4, int(bp), dtype=np.int8))
            for name, bp in refs]
