"""Bowtie 2's end-to-end scoring and its default mapping quality (MAPQ
version 2, bowtie2 unique.h BowtieMapq2), as a configuration's `scoring`
entry states them."""

import numpy as np


def f32(x):
    """A C float literal promoted to double, as Bowtie 2's built-in
    defaults are (scoring.h: -0.6f etc.)."""
    return float(np.float32(x))


class Scoring:
    """The `scoring` entry of a configuration: ma (match bonus), mp (max,
    min mismatch penalty), np (N penalty), rdg and rfg (read and
    reference gap open, extend), gbar, score_min and n_ceil (Bowtie 2
    function strings of the read length, type L only)."""

    def __init__(self, spec):
        self.ma = int(spec["ma"])
        self.mx, self.mn = (int(v) for v in spec["mp"])
        self.np = int(spec["np"])
        self.rdg_open, self.rdg_ext = (int(v) for v in spec["rdg"])
        self.rfg_open, self.rfg_ext = (int(v) for v in spec["rfg"])
        self.gbar = int(spec["gbar"])
        self.local = bool(spec.get("local", False))
        self.score_min = spec["score_min"]
        self.n_ceil = spec["n_ceil"]
        if self.local or self.score_min[0] != "L" or self.n_ceil[0] != "L":
            raise ValueError("the reference covers end-to-end scoring with "
                             "linear score_min and n_ceil only")

    def min_score(self, length):
        """score_min(L): C truncation of const + coeff * L."""
        _t, c, k = self.score_min
        return int(f32(c) + f32(k) * length)

    def max_ns(self, length):
        _t, c, k = self.n_ceil
        return min(int(f32(c) + f32(k) * length), length)

    def mm_pen(self, quals):
        """MN + floor((MX - MN) * min(Q, 40) / 40), per base."""
        q = np.minimum(np.asarray(quals, np.int64), 40)
        return self.mn + (q * (self.mx - self.mn)) // 40


# (share of the score range, MAPQ) for a read with no second-best score
_UNIQUE = ((0.8, 42), (0.7, 40), (0.6, 24), (0.5, 23), (0.4, 8), (0.3, 3))
# (share for bestdiff, MAPQ if the best is perfect, then (share for
# best_over, MAPQ) pairs and the MAPQ below them)
_SECOND = (
    (0.9, 39, (), 33), (0.8, 38, (), 27), (0.7, 37, (), 26),
    (0.6, 36, (), 22),
    (0.5, 35, ((0.84, 25), (0.68, 16)), 5),
    (0.4, 34, ((0.84, 21), (0.68, 14)), 4),
    (0.3, 32, ((0.88, 18), (0.67, 15)), 3),
    (0.2, 31, ((0.88, 17), (0.67, 11)), 0),
    (0.1, 30, ((0.88, 12), (0.67, 7)), 0),
)


def mapq_v2(best, secbest, perfect, minsc):
    """Bowtie 2's end-to-end MAPQ from the best score, the second-best
    (None: none), the perfect and the minimum valid score."""
    diff = max(1, perfect - minsc)
    over = best - minsc
    if secbest is None:
        for share, mq in _UNIQUE:
            if over >= diff * f32(share):
                return mq
        return 0
    bestdiff = abs(abs(best) - abs(secbest))
    for share, perf, steps, low in _SECOND:
        if bestdiff >= diff * f32(share):
            if over == diff:
                return perf
            for s2, mq in steps:
                if over >= diff * f32(s2):
                    return mq
            return low
    if bestdiff > 0:
        return 6 if over >= diff * f32(0.67) else 2
    return 1 if over >= diff * f32(0.67) else 0
