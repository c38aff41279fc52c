"""Alignment policy: SimpleFunc, scoring params, presets, derived budgets.

Mirrors the reference's policy semantics exactly where they affect output:
  * SimpleFunc f(x) = min(max(C + L*g(x), I), X), g ∈ {const, linear, sqrt,
    log}, result C-truncated toward zero (simple_func.h:90-111).
  * scoreMin e2e default L,-0.6,-0.6; local G,20,8 (scoring.h:50-56).
  * seed interval default S,1,1.15; seed len 22; -N 0; -D 15; -R 2
    (presets.cpp "sensitive"; aligner_seed_policy.h DEFAULT_*).
  * nCeil L,0,0.15 capped at read length (bt2_search.cpp:3427-3432).
  * maxReadGaps/maxRefGaps budget walk (scoring.cpp:42-104).
"""

import math
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

# The reference's built-in default constants are C FLOAT literals
# (scoring.h:50-56 DEFAULT_MIN_CONST (-0.6f) etc.), promoted to double when
# used — so the effective coefficient is float32(-0.6) = -0.6000000238...,
# which changes trunc() results (e.g. minsc(159) = -96, not -95). Values
# parsed from user policy strings are genuine doubles (PARSE_FUNC,
# aligner_seed_policy.cpp:48-75). Score parity requires both behaviors.
def _f32(x: float) -> float:
    return float(np.float32(x))

from bowtie2_tpu_torch.ops.sw import SWParams

FUNC_CONST, FUNC_LINEAR, FUNC_SQRT, FUNC_LOG = "C", "L", "S", "G"


@dataclass(frozen=True)
class SimpleFunc:
    type: str = FUNC_LINEAR
    const: float = 0.0
    coeff: float = 0.0
    mn: float = -1.7976931348623157e308
    mx: float = 1.7976931348623157e308

    def f(self, x: float) -> int:
        if self.type == FUNC_CONST:
            g = 0.0
        elif self.type == FUNC_LINEAR:
            g = x
        elif self.type == FUNC_SQRT:
            g = math.sqrt(x)
        elif self.type == FUNC_LOG:
            g = math.log(x)
        else:
            raise ValueError(self.type)
        ret = max(self.mn, min(self.mx, self.const + self.coeff * g))
        return int(ret)  # C-style truncation toward zero

    @staticmethod
    def parse(s: str) -> "SimpleFunc":
        parts = s.split(",")
        return SimpleFunc(type=parts[0], const=float(parts[1]),
                          coeff=float(parts[2]))


@dataclass
class Policy:
    """Full alignment policy (CLI-visible knobs + presets)."""
    local: bool = False
    # scoring (SWParams mirrors these for the kernel)
    match_bonus: int = 0
    mm_pen_max: int = 6
    mm_pen_min: int = 2
    n_pen: int = 1
    read_gap_open: int = 5
    read_gap_extend: int = 3
    ref_gap_open: int = 5
    ref_gap_extend: int = 3
    gap_barrier: int = 4          # --gbar
    ignore_quals: bool = False
    # functions of read length
    score_min: SimpleFunc = field(
        default_factory=lambda: SimpleFunc(FUNC_LINEAR, _f32(-0.6), _f32(-0.6)))
    n_ceil: SimpleFunc = field(
        default_factory=lambda: SimpleFunc(FUNC_LINEAR, 0.0, _f32(0.15)))
    seed_ival: SimpleFunc = field(
        default_factory=lambda: SimpleFunc(FUNC_SQRT, 1.0, 1.15, mn=1.0))
    # multiseed
    seed_len: int = 22
    seed_mms: int = 0
    no_1mm: bool = False          # --no-1mm-upfront: skip the 1-mm phase
    xeq: bool = False             # --xeq: CIGAR '='/'X' instead of 'M'
    seed_rounds: int = 2          # -R
    fail_streak: int = 15         # -D
    # reporting
    khits: int = 1                # -k
    all_hits: bool = False        # -a
    mhits: int = 50               # -M (default 50, bt2_search.cpp:343);
                                  # 0 = disabled (-k/-a set this, like the
                                  # reference's mutual exclusion)
    mapq_v: int = 2               # --mapq-v (bt2_search.cpp:486)
    # paired-end geometry
    minins: int = 0               # -I
    maxins: int = 500             # -X
    mate_fw_rc: str = "fr"        # --fr/--rf/--ff
    no_mixed: bool = False
    no_discordant: bool = False
    # concordant-pair geometry flags (bt2_search.cpp gOlapMatesOK/
    # gContainMatesOK/gDovetailMatesOK; defaults olap+contain OK,
    # dovetail NOT)
    olap_ok: bool = True
    contain_ok: bool = True
    dovetail_ok: bool = False
    nofw: bool = False
    norc: bool = False
    # --soft-clipped-unmapped-tlen (local only): TLEN from plain alignment
    # extents instead of soft-clip-extended coords (aligner_result.h:901)
    sc_unmapped_tlen: bool = False
    # --sam-xt: XT:i elapsed-us opt field (batch-amortized analog of the
    # reference's per-read timing, bt2_search.cpp:3305)
    sam_xt: bool = False
    # --no-exact-upfront: skip the exact end-to-end sweep phase
    # (bt2_search.cpp:252 doExactUpFront)
    no_exact: bool = False
    # --seed-boost: averageHitsPerSeed threshold gating re-seed rounds
    # (bt2_search.cpp:490 seedBoostThresh)
    seed_boost: int = 300
    # --omit-sec-seq: '*' SEQ/QUAL on secondary (0x100) records
    omit_sec_seq: bool = False
    # --sam-no-qname-trunc / --sam-append-comment (sam.cpp truncQname /
    # appendComment)
    sam_no_qname_trunc: bool = False
    sam_append_comment: bool = False
    # --seed: base for genRandSeed (pat.cpp:45); --non-deterministic uses
    # arbitrary per-read seeds instead (bt2_search.cpp:3270 rndArb)
    rng_seed: int = 0
    non_deterministic: bool = False
    # --bwa-sw-like: min score = a*max{T=30, c=5.5 * ln(len)} in float,
    # truncated (bt2_search.cpp:2960-2971), instead of score_min
    bwa_sw_like: bool = False

    def sw_params(self) -> SWParams:
        return SWParams(
            match_bonus=self.match_bonus,
            mm_pen_max=self.mm_pen_max if not self.ignore_quals else self.mm_pen_max,
            mm_pen_min=self.mm_pen_min if not self.ignore_quals else self.mm_pen_max,
            n_pen=self.n_pen,
            read_gap_open=self.read_gap_open,
            read_gap_extend=self.read_gap_extend,
            ref_gap_open=self.ref_gap_open,
            ref_gap_extend=self.ref_gap_extend,
            gap_barrier=self.gap_barrier,
            local=self.local,
        )

    # ---- derived, per read length ----
    def min_score(self, rdlen: int) -> int:
        if self.bwa_sw_like:
            # reference: max<float>(a*T, a*c*log(l)) — a*c is a float
            # product, log(l) a double, the product demoted to float by
            # the max<float> template (bt2_search.cpp:2964-2966)
            a = np.float32(self.match_bonus)
            ac = float(a * np.float32(5.5))
            return int(max(np.float32(float(a) * 30.0),
                           np.float32(ac * math.log(rdlen))))
        return self.score_min.f(rdlen)

    def perfect_score(self, rdlen: int) -> int:
        return self.match_bonus * rdlen

    def nceil(self, rdlen: int) -> int:
        return min(self.n_ceil.f(rdlen), rdlen)

    def interval(self, rdlen: int) -> int:
        return max(self.seed_ival.f(rdlen), 1)

    def n_seeds(self, rdlen: int, off: int = 0) -> int:
        if rdlen - off > self.seed_len:
            return 1 + (rdlen - off - self.seed_len) // self.interval(rdlen)
        return 1 if rdlen >= self.seed_len else 0

    def max_read_gaps(self, rdlen: int) -> int:
        """Budget walk, reference scoring.cpp:42 (returns num-1)."""
        minsc = self.min_score(rdlen)
        sc = rdlen * self.match_bonus
        num = 0
        first = True
        while sc >= minsc:
            sc -= (self.read_gap_open + self.read_gap_extend) if first \
                else self.read_gap_extend
            first = False
            num += 1
        return max(num - 1, 0)

    def max_ref_gaps(self, rdlen: int) -> int:
        minsc = self.min_score(rdlen)
        sc = rdlen * self.match_bonus
        num = 0
        first = True
        while sc >= minsc:
            sc -= self.match_bonus  # each ref gap also forgoes a match
            sc -= (self.ref_gap_open + self.ref_gap_extend) if first \
                else self.ref_gap_extend
            first = False
            num += 1
        return max(num - 1, 0)

    max_half: int = 15  # --dpad: cap on gaps per side (bt2_search.cpp:459)

    def band_halfwidth(self, rdlen: int) -> int:
        """Diagonal band half-width: the reference frames seed-extension
        rects over ±2*maxgap diagonals with maxgap capped at --dpad
        (dp_framer.cpp:93-100)."""
        g = min(max(self.max_read_gaps(rdlen), self.max_ref_gaps(rdlen)),
                self.max_half)
        return max(2 * g, 2)


def make_policy(preset: str = "sensitive", local: bool = False, **overrides) -> Policy:
    """Preset table = reference presets.cpp:26-96."""
    p = Policy()
    if local:
        p.local = True
        p.match_bonus = 2
        p.mm_pen_max, p.mm_pen_min = 6, 2
        p.score_min = SimpleFunc(FUNC_LOG, _f32(20.0), _f32(8.0))
        presets = {
            "very-fast": dict(fail_streak=5, seed_rounds=1, seed_mms=0,
                              seed_len=25, seed_ival=SimpleFunc(FUNC_SQRT, 1, 2.0, mn=1)),
            "fast": dict(fail_streak=10, seed_rounds=2, seed_mms=0,
                         seed_len=22, seed_ival=SimpleFunc(FUNC_SQRT, 1, 1.75, mn=1)),
            "sensitive": dict(fail_streak=15, seed_rounds=2, seed_mms=0,
                              seed_len=20, seed_ival=SimpleFunc(FUNC_SQRT, 1, 0.75, mn=1)),
            "very-sensitive": dict(fail_streak=20, seed_rounds=3, seed_mms=0,
                                   seed_len=20, seed_ival=SimpleFunc(FUNC_SQRT, 1, 0.5, mn=1)),
        }
    else:
        presets = {
            "very-fast": dict(fail_streak=5, seed_rounds=1, seed_mms=0,
                              seed_len=22, seed_ival=SimpleFunc(FUNC_SQRT, 0, 2.5, mn=1)),
            "fast": dict(fail_streak=10, seed_rounds=2, seed_mms=0,
                         seed_len=22, seed_ival=SimpleFunc(FUNC_SQRT, 0, 2.5, mn=1)),
            "sensitive": dict(fail_streak=15, seed_rounds=2, seed_mms=0,
                              seed_len=22, seed_ival=SimpleFunc(FUNC_SQRT, 1, 1.15, mn=1)),
            "very-sensitive": dict(fail_streak=20, seed_rounds=3, seed_mms=0,
                                   seed_len=20, seed_ival=SimpleFunc(FUNC_SQRT, 1, 0.5, mn=1)),
        }
    for k, v in presets[preset].items():
        setattr(p, k, v)
    for k, v in overrides.items():
        setattr(p, k, v)
    return p
