"""MAPQ V2 — the reference's default mapping-quality model.

Transliteration of the *decision table semantics* of BowtieMapq2
(unique.h:171-400): inputs are the best score, the best unchosen ("second
best") score if any, the perfect score and the minimum valid score for the
read length(s); output 0..42 (e2e) / 0..44 (local).
"""

from typing import Optional

import numpy as np


def _F(x: float) -> float:
    """C float literal promoted to double: the reference compares against
    `diff * (double)0.8f` etc. (unique.h:225+), so thresholds like 0.8 carry
    float32 representation error (0.8f -> 0.800000011920929). Reproducing
    this is required for MAPQ bit-parity."""
    return float(np.float32(x))


def mapq_v2(best: int, secbest: Optional[int], sc_per: int, sc_min: int,
            local: bool) -> int:
    diff = max(1, sc_per - sc_min)
    best_over = best - sc_min
    if not local:  # monotone / end-to-end
        if secbest is None:
            if best_over >= diff * _F(0.8): return 42
            if best_over >= diff * _F(0.7): return 40
            if best_over >= diff * _F(0.6): return 24
            if best_over >= diff * _F(0.5): return 23
            if best_over >= diff * _F(0.4): return 8
            if best_over >= diff * _F(0.3): return 3
            return 0
        bestdiff = abs(abs(best) - abs(secbest))
        if bestdiff >= diff * _F(0.9):
            return 39 if best_over == diff else 33
        if bestdiff >= diff * _F(0.8):
            return 38 if best_over == diff else 27
        if bestdiff >= diff * _F(0.7):
            return 37 if best_over == diff else 26
        if bestdiff >= diff * _F(0.6):
            return 36 if best_over == diff else 22
        if bestdiff >= diff * _F(0.5):
            if best_over == diff: return 35
            if best_over >= diff * _F(0.84): return 25
            if best_over >= diff * _F(0.68): return 16
            return 5
        if bestdiff >= diff * _F(0.4):
            if best_over == diff: return 34
            if best_over >= diff * _F(0.84): return 21
            if best_over >= diff * _F(0.68): return 14
            return 4
        if bestdiff >= diff * _F(0.3):
            if best_over == diff: return 32
            if best_over >= diff * _F(0.88): return 18
            if best_over >= diff * _F(0.67): return 15
            return 3
        if bestdiff >= diff * _F(0.2):
            if best_over == diff: return 31
            if best_over >= diff * _F(0.88): return 17
            if best_over >= diff * _F(0.67): return 11
            return 0
        if bestdiff >= diff * _F(0.1):
            if best_over == diff: return 30
            if best_over >= diff * _F(0.88): return 12
            if best_over >= diff * _F(0.67): return 7
            return 0
        if bestdiff > 0:
            return 6 if best_over >= diff * _F(0.67) else 2
        return 1 if best_over >= diff * _F(0.67) else 0
    else:  # local
        if secbest is None:
            if best_over >= diff * _F(0.8): return 44
            if best_over >= diff * _F(0.7): return 42
            if best_over >= diff * _F(0.6): return 41
            if best_over >= diff * _F(0.5): return 36
            if best_over >= diff * _F(0.4): return 28
            if best_over >= diff * _F(0.3): return 24
            return 22
        bestdiff = abs(abs(best) - abs(secbest))
        if bestdiff >= diff * _F(0.9): return 40
        if bestdiff >= diff * _F(0.8): return 39
        if bestdiff >= diff * _F(0.7): return 38
        if bestdiff >= diff * _F(0.6): return 37
        if bestdiff >= diff * _F(0.5):
            if best_over == diff: return 35
            if best_over >= diff * _F(0.5): return 25
            return 20
        if bestdiff >= diff * _F(0.4):
            if best_over == diff: return 34
            if best_over >= diff * _F(0.5): return 21
            return 19
        if bestdiff >= diff * _F(0.3):
            if best_over == diff: return 33
            if best_over >= diff * _F(0.5): return 18
            return 16
        if bestdiff >= diff * _F(0.2):
            if best_over == diff: return 32
            if best_over >= diff * _F(0.5): return 17
            return 12
        if bestdiff >= diff * _F(0.1):
            if best_over == diff: return 31
            if best_over >= diff * _F(0.5): return 14
            return 9
        if bestdiff > 0:
            return 11 if best_over >= diff * _F(0.5) else 2
        return 1 if best_over >= diff * _F(0.5) else 0


# ---------------- V3 (--mapq-v 3, unique.h:96 BowtieMapq3) ----------------
# Bin-lookup model: best and best-vs-secbest distances stratified into 11
# bins over the [scMin, scMax] score range (tables unique.cpp:26-66).

UNP_NOSEC_PERF = 44
UNP_NOSEC = (43, 42, 41, 36, 32, 27, 20, 11, 4, 1, 0)
UNP_SEC_PERF = (2, 16, 23, 30, 31, 32, 34, 36, 38, 40, 42)
UNP_SEC = (
    (2, 2, 2, 1, 1, 0, 0, 0, 0, 0, 0),
    (20, 14, 7, 3, 2, 1, 0, 0, 0, 0, 0),
    (20, 16, 10, 6, 3, 1, 0, 0, 0, 0, 0),
    (20, 17, 13, 9, 3, 1, 1, 0, 0, 0, 0),
    (21, 19, 15, 9, 5, 2, 2, 0, 0, 0, 0),
    (22, 21, 16, 11, 10, 5, 0, 0, 0, 0, 0),
    (23, 22, 19, 16, 11, 0, 0, 0, 0, 0, 0),
    (24, 25, 21, 30, 0, 0, 0, 0, 0, 0, 0),
    (30, 26, 29, 0, 0, 0, 0, 0, 0, 0, 0),
    (30, 27, 0, 0, 0, 0, 0, 0, 0, 0, 0),
    (30, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0),
)
PAIR_NOSEC_PERF = 44


def mapq_v3(best: int, secbest: Optional[int], sc_per: int, sc_min: int,
            paired: bool = False) -> int:
    """unique.h:96 BowtieMapq3 (paired reads always get 44)."""
    if paired:
        return PAIR_NOSEC_PERF
    sc_max = sc_per
    span = max(sc_max - sc_min, 1)
    bdist = sc_max - best          # lower = better
    best_bin = int(bdist * (10.0 / span) + 0.5)
    best_bin = min(best_bin, 10)
    if secbest is not None:
        diff = best - secbest
        diff_bin = min(int(diff * (10.0 / span) + 0.5), 10)
        if best == sc_max:
            return UNP_SEC_PERF[best_bin]
        return UNP_SEC[diff_bin][best_bin]
    if best == sc_max:
        return UNP_NOSEC_PERF
    return UNP_NOSEC[best_bin]
