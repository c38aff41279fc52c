"""Bowtie 2's scoring, end to end or local, and its default mapping
quality (MAPQ version 2, bowtie2 unique.h BowtieMapq2), as a
configuration's `scoring` entry and its `local` key state them."""

import math

import numpy as np


def f32(x):
    """A C float literal promoted to double, as Bowtie 2's built-in
    defaults are (scoring.h: -0.6f etc.)."""
    return float(np.float32(x))


# Bowtie 2's function types of the read length (simple_func.h): constant,
# linear, square root, natural log
_FUNC = {"C": lambda x: 0.0, "L": float, "S": math.sqrt, "G": math.log}


def func(spec, length):
    """A Bowtie 2 function string [type, const, coeff] at a read length:
    C truncation of const + coeff * g(length)."""
    t, c, k = spec
    return int(f32(c) + f32(k) * _FUNC[t](length))


class Scoring:
    """The `scoring` entry of a configuration: ma (match bonus, local mode
    only), mp (max, min mismatch penalty), np (N penalty), rdg and rfg
    (read and reference gap open, extend), gbar, score_min and n_ceil
    (Bowtie 2 function strings of the read length, of type C, L, S or G);
    local: the configuration's `local` (Bowtie 2's --local)."""

    def __init__(self, spec, local=False):
        self.local = bool(local)
        self.ma = int(spec["ma"]) if self.local else 0
        self.mx, self.mn = (int(v) for v in spec["mp"])
        self.np = int(spec["np"])
        self.rdg_open, self.rdg_ext = (int(v) for v in spec["rdg"])
        self.rfg_open, self.rfg_ext = (int(v) for v in spec["rfg"])
        self.gbar = int(spec["gbar"])
        self.score_min = spec["score_min"]
        self.n_ceil = spec["n_ceil"]
        for f in (self.score_min, self.n_ceil):
            if f[0] not in _FUNC:
                raise ValueError(f"function type {f[0]}: Bowtie 2 has "
                                 f"{''.join(_FUNC)}")

    def min_score(self, length):
        """score_min(L)."""
        return func(self.score_min, length)

    def max_ns(self, length):
        return min(func(self.n_ceil, length), length)

    def perfect(self, length):
        """The best score a read of this length can have: ma for every
        base in local mode, 0 end to end."""
        return self.ma * length

    def mm_pen(self, quals):
        """MN + floor((MX - MN) * min(Q, 40) / 40), per base."""
        q = np.minimum(np.asarray(quals, np.int64), 40)
        return self.mn + (q * (self.mx - self.mn)) // 40

    def mapq(self, best, secbest, perfect, minsc):
        return mapq_v2(best, secbest, perfect, minsc, self.local)


# (share of the score range, MAPQ) for a read with no second-best score,
# and the MAPQ below the last share: end to end, local
_UNIQUE = (((0.8, 42), (0.7, 40), (0.6, 24), (0.5, 23), (0.4, 8),
            (0.3, 3)), 0)
_UNIQUE_LOCAL = (((0.8, 44), (0.7, 42), (0.6, 41), (0.5, 36), (0.4, 28),
                  (0.3, 24)), 22)
# (share for bestdiff, MAPQ if the best is perfect, then (share for
# best_over, MAPQ) pairs and the MAPQ below them); then the MAPQs where
# bestdiff is under every share, as (bestdiff > 0, share for best_over,
# MAPQ at or over it, below it)
_SECOND = ((
    (0.9, 39, (), 33), (0.8, 38, (), 27), (0.7, 37, (), 26),
    (0.6, 36, (), 22),
    (0.5, 35, ((0.84, 25), (0.68, 16)), 5),
    (0.4, 34, ((0.84, 21), (0.68, 14)), 4),
    (0.3, 32, ((0.88, 18), (0.67, 15)), 3),
    (0.2, 31, ((0.88, 17), (0.67, 11)), 0),
    (0.1, 30, ((0.88, 12), (0.67, 7)), 0),
), 0.67, (6, 2), (1, 0))
_SECOND_LOCAL = ((
    (0.9, 40, (), 40), (0.8, 39, (), 39), (0.7, 38, (), 38),
    (0.6, 37, (), 37),
    (0.5, 35, ((0.5, 25),), 20),
    (0.4, 34, ((0.5, 21),), 19),
    (0.3, 33, ((0.5, 18),), 16),
    (0.2, 32, ((0.5, 17),), 12),
    (0.1, 31, ((0.5, 14),), 9),
), 0.5, (11, 2), (1, 0))


def mapq_v2(best, secbest, perfect, minsc, local=False):
    """Bowtie 2's MAPQ from the best score, the second-best (None: none),
    the perfect and the minimum valid score; its local tables where
    local."""
    diff = max(1, perfect - minsc)
    over = best - minsc
    if secbest is None:
        steps, low = _UNIQUE_LOCAL if local else _UNIQUE
        for share, mq in steps:
            if over >= diff * f32(share):
                return mq
        return low
    rows, share0, some, none = _SECOND_LOCAL if local else _SECOND
    bestdiff = abs(abs(best) - abs(secbest))
    for share, perf, steps, low in rows:
        if bestdiff >= diff * f32(share):
            if over == diff:
                return perf
            for s2, mq in steps:
                if over >= diff * f32(s2):
                    return mq
            return low
    hi, lo = some if bestdiff > 0 else none
    return hi if over >= diff * f32(share0) else lo
