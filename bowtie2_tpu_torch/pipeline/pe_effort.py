"""Paired-end effort model: -D fail-streak / mate-streak emulation.

The reference's paired extend loop (SwDriver::extendSeedsPaired,
aligner_sw_driver.cpp:1680-2640) gives up on a mate's anchor search after a
streak of candidate attempts that fail to produce a concordant pair:

  * streak limits: -D (15) halved to ceil(D/2) = 8 when both mates pass
    filters (bt2_search.cpp:3473-3476), applied per (mate, phase) call —
    exact end-to-end phase, 1-mismatch phase, seed phase each reset the
    counters (aligner_sw_driver.cpp:1694).
  * per-range mate streak: a seed range is retired after 10 consecutive
    attempts whose anchor aligned but found no concordant mate
    (maxMateStreak, bt2_search.cpp:472; check at :1841).
  * attempt order: ranges by ascending SA width (prioritizeSATups); a
    range smaller than nsm=5 elements yields all its rows at first visit,
    larger ranges one row per pass (round-robin) (:1812-1815).
  * mate order: the mate with FEWER exact-sweep elements anchors first
    (bt2_search.cpp:3537-3541); ties keep mate 1 first.
  * an attempt whose anchor DP fails still counts toward the streak
    ("failed until proven successful"); only a concordant pair resets it.

This module replays that schedule deterministically over the batch
pipeline's candidate slots (the within-range random row order of the
reference's RowSampler is approximated by our canonical SA order — exact
only for ranges of width 1, which dominate non-repetitive genomes).
Candidates the reference would never have attempted are excluded from
pairing and from mixed-mode reporting, reproducing its -D give-ups.
"""

from typing import Dict, List, Set, Tuple

import numpy as np

PE_NSM = 5              # "small range" threshold (aligner_sw_driver nsm)


def pe_streak_limit(fail_streak: int, khits: int, both_filt: bool = True
                    ) -> int:
    """streak[mate] (bt2_search.cpp:3452-3476): -D, + 10 per extra -k,
    halved (ceil) for paired reads with both mates passing filters."""
    streak = fail_streak
    if khits > 1:
        streak += (khits - 1) * 10
    if both_filt:
        streak = (streak + 1) // 2
    return max(streak, 1)


def attempt_order(ks: List[int], ranges: np.ndarray, widths: np.ndarray
                  ) -> List[int]:
    """Order candidate indices as the reference's extend loop visits them.

    ks: candidate indices in canonical (slot) order; ranges[k]: range id in
    width-sorted order; widths[k]: SA width of k's range.
    """
    by_range: Dict[int, List[int]] = {}
    order: List[int] = []
    for k in ks:
        by_range.setdefault(int(ranges[k]), []).append(k)
    rids = sorted(by_range)
    ptr = {j: 0 for j in rids}
    first = {j: True for j in rids}
    left = len(ks)
    while left:
        progressed = False
        for j in rids:
            rows = by_range[j]
            if ptr[j] >= len(rows):
                continue
            take = 1
            if first[j] and widths[rows[0]] < PE_NSM:
                take = len(rows) - ptr[j]
            first[j] = False
            for _ in range(take):
                order.append(rows[ptr[j]])
                ptr[j] += 1
                left -= 1
            progressed = True
        if not progressed:
            break
    return order


def simulate_mate(phases: List[List[int]], ranges: np.ndarray,
                  widths: np.ndarray, success: Set[int],
                  anchor_ok: Set[int], streak_limit: int,
                  mate_streak_limit: int = 10
                  ) -> Tuple[Set[int], Set[int]]:
    """Replay one mate's anchor attempts.

    phases: candidate index lists per phase (exact, 1mm/half, seed), each
    in canonical slot order. success: attempts that would yield a
    concordant pair; anchor_ok: attempts whose anchor alignment is valid.
    Returns (attempted, successful) sets.
    """
    attempted: Set[int] = set()
    succeeded: Set[int] = set()
    for ks in phases:
        if not ks:
            continue
        order = attempt_order(ks, ranges, widths)
        streak = 0
        mate_streak: Dict[int, int] = {}
        for k in order:
            if streak >= streak_limit:
                break
            j = int(ranges[k])
            if mate_streak.get(j, 0) >= mate_streak_limit:
                continue          # range retired
            attempted.add(k)
            if k in success:
                succeeded.add(k)
                streak = 0
                mate_streak[j] = 0
            else:
                streak += 1
                if k in anchor_ok:
                    # anchor aligned but no concordant mate
                    mate_streak[j] = mate_streak.get(j, 0) + 1
    return attempted, succeeded
