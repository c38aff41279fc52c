"""Full per-read RNG-trajectory replay of the reference search driver (SE).

Replays multiseedSearchWorker's per-read flow draw-for-draw on the host
for reads whose output depends on the search TRAJECTORY (equal-score
multimaps, XS from the found-set, effort-limited reads): exact/1mm
upfront phases, rankSeedHits, prioritizeSATups (RowSampler + Random1toN),
the extendSeeds loop with streaks/caps/-M tightening, and finishRead
selection. The replay consumes data the batched device pipeline already
produces (SA ranges, resolved rows, reference words); alignment scoring
is recomputed with the same bit-exact scoring as the device kernels.

Reference call stacks this mirrors (file:line, bowtie2 2.5.5):
  bt2_search.cpp:3505-3960  exact/1mm upfront + seed-round loop
  aligner_sw_driver.cpp:66-290   eeSaTups (EE phase draw accounting)
  aligner_sw_driver.cpp:492-738  prioritizeSATupsRands (RowSampler)
  aligner_sw_driver.cpp:921-1495 extendSeeds (element visits, streaks,
                                 tighten, report short-circuits)
  aligner_seed.h:1019-1080       rankSeedHits draw accounting
  aligner_seed.h:1223            sort1mmEe (score sort + streak shuffle)
  aligner_sw.cpp:794,877         per-backtrace reseed chain
  dp_framer.cpp:81               frameSeedExtensionRect + core diagonals
  aligner_sw_nuc.h:93            candidate order (score desc, col desc)
  aln_sink.cpp:643-1700          finishRead select + report caps

Scope (first cut): unpaired, end-to-end (non-local), -N 0, single seed
length, gReportOverhangs off — the default preset family. A read that
leaves the modeled scope raises ReplayAbort; the caller keeps the
canonical result for it.
"""

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from bowtie2_tpu_torch.pipeline.rng import Random1toN, RefRng, shuffle_portion

SEED_BOOST_THRESH = 300          # bt2_search.cpp:490 seedBoostThresh
NSM = 5                          # extendSeeds "small" range threshold


class ReplayAbort(Exception):
    """Read leaves the modeled scope; keep the canonical result."""


class RowSampler:
    """aligner_sw_driver.h:186 — weighted random range sampler.

    Mass per range = (nlex+nrex+1)^2 / size^2 (lensq=szsq=True at the
    only call site); next() throws a float32-derived dart scaled by the
    double total mass."""

    def __init__(self, satpos, sai: int, saf: int):
        self.masses = []
        self.elim = [False] * (saf - sai)
        self.mass = 0.0
        for i in range(sai, saf):
            ln = float(satpos[i].nlex + satpos[i].nrex + 1)
            num = ln * ln
            den = float(satpos[i].width) * float(satpos[i].width)
            m = num / den
            self.masses.append(m)
            self.mass += m

    def finished_range(self, i: int) -> None:
        self.elim[i] = True
        self.mass -= self.masses[i]

    def next(self, rnd: RefRng) -> int:
        rd = rnd.next_float() * self.mass
        mass_sofar = 0.0
        last_unelim = None
        for i, m in enumerate(self.masses):
            if not self.elim[i]:
                last_unelim = i
                mass_sofar += m
                if rd < mass_sofar:
                    return i
        return last_unelim


@dataclass
class SeedRange:
    """One (offidx, strand) seed hit: an exact SA range + extensions."""
    fw: bool
    offidx: int
    rdoff: int          # offset from 5' end of the READ (reference conv)
    seedlen: int
    top: int
    width: int
    nlex: int = 0
    nrex: int = 0


@dataclass
class EEHit:
    """Exact or 1mm end-to-end hit (aligner_seed.h EEHit)."""
    fw: bool
    top: int
    width: int
    score: int
    edit_pos: int = -1        # 5'-based read offset of the mismatch
    edit_chr: int = -1        # ref char code at the mismatch


@dataclass
class Aln:
    """A reported alignment (enough of AlnRes for selection/emission)."""
    score: int
    tidx: int
    refoff: int               # diagonal's 0-based text offset (row 0)
    fw: bool
    gapped: bool = False
    end_col: int = -1         # rect col of the end cell (gapped)
    rect_refl: int = -1       # rect's trimmed refl (gapped)


@dataclass
class ReplayInputs:
    """Everything the replay needs for ONE read, prepared in batch.

    resolve(top, elt) -> (tidx, toff, joined, straddled) — SA row
    top+elt mapped to text coordinates (straddled = the qlen extent
    crosses a fragment boundary; qlen is bound by the caller per range).
    joined_char(j) -> 0..3 ref code of joined-text position j, or None
    outside [0, joined_len).
    refwin(tidx, refl, W) -> int window codes (0..3, 4=N, 5=off-edge).
    """
    name: str
    seed: int                 # genRandSeed(read) ^ global --seed
    length: int
    codes_fw: np.ndarray      # (L,) read codes 0-4
    codes_rc: np.ndarray
    quals: np.ndarray         # (L,) phred, 5'->3'
    minsc: int
    perfect: int
    nceil: int
    ee_top: Tuple[int, int]       # exact sweep: fw, rc
    ee_width: Tuple[int, int]
    mined: Tuple[int, int]        # exactSweep min-edit bounds fw, rc
    mm1: List[EEHit] = field(default_factory=list)
    # seed phase: per round -> list[SeedRange] in instantiation order,
    # or None when the round can't run (offset off the end / interval)
    rounds: List[Optional[List[SeedRange]]] = field(default_factory=list)
    resolve: Callable = None      # (top, elt, qlen) -> tuple or None
    joined_char: Callable = None
    refwin: Callable = None
    tlen_of: Callable = None
    dp_cells: Callable = None     # (codes, quals, win) -> end-row H
    trace: Optional[list] = None  # debug: records DP problems


@dataclass
class Policy:
    khits: int = 1
    mhits: int = 50
    all_hits: bool = False
    fail_streak: int = 15         # -D
    max_iters: int = 400
    max_dp: int = 300
    max_ug: int = 300
    tighten: int = 3
    match_bonus: int = 0
    mm_pen_max: int = 6
    mm_pen_min: int = 2
    n_pen: int = 1
    read_gap_open: int = 5
    read_gap_extend: int = 3
    ref_gap_open: int = 5
    ref_gap_extend: int = 3
    gap_barrier: int = 4
    maxhalf: int = 15             # --dpad
    sw: object = None             # SWParams for the DP oracle


class SinkState:
    """AlnSinkWrap + ReportingState essentials for unpaired e2e."""

    def __init__(self, pol: Policy):
        self.pol = pol
        self.alns: List[Aln] = []
        self.done = False
        self.maxed = False

    def best2(self) -> Tuple[Optional[int], Optional[int]]:
        ss = sorted((a.score for a in self.alns), reverse=True)
        return (ss[0] if ss else None, ss[1] if len(ss) > 1 else None)

    def report(self, aln: Aln) -> bool:
        """True => policy short-circuit (ReportingState doneUnpaired)."""
        self.alns.append(aln)
        p = self.pol
        n = len(self.alns)
        if p.all_hits:
            return False
        if p.mhits > 0:          # -M mode (default)
            if n > p.mhits:
                self.maxed = True
                self.done = True
                return True
            return False
        if n >= p.khits:         # -k mode
            self.done = True
            return True
        return False


def mm_pen(pol: Policy, q: int) -> int:
    return pol.mm_pen_min + (min(int(q), 40)
                             * (pol.mm_pen_max - pol.mm_pen_min)) // 40


def max_gaps(pol: Policy, minsc: int, perfect: int) -> Tuple[int, int]:
    """Scoring::maxReadGaps/maxRefGaps: gaps affordable in the
    (perfect - minsc) budget; first gap open+extend, later extend."""
    budget = perfect - minsc
    out = []
    for op, ex in ((pol.read_gap_open, pol.read_gap_extend),
                   (pol.ref_gap_open, pol.ref_gap_extend)):
        n = 0
        cost = op + ex
        while cost <= budget:
            n += 1
            cost += ex
        out.append(n)
    return out[0], out[1]


class _Entry:
    """One satpos_ entry in the extend loop (EE or seed phase)."""

    __slots__ = ("top", "width", "r1n", "fixed", "is_small", "ee_hit",
                 "fw", "rdoff3", "seedlen", "qlen")

    def __init__(self, top, width, r1n, fixed, is_small, fw,
                 rdoff3, seedlen, qlen, ee_hit=None):
        self.top = top
        self.width = width
        self.r1n = r1n              # Random1toN or None (fixed element)
        self.fixed = fixed          # element index when r1n is None
        self.is_small = is_small
        self.fw = fw
        self.rdoff3 = rdoff3        # offset w.r.t. upstream end (see ref)
        self.seedlen = seedlen
        self.qlen = qlen            # hit length for straddle checks
        self.ee_hit = ee_hit        # EEHit when in eeMode

    def done(self) -> bool:
        if self.r1n is None:
            return self.fixed is None
        return self.r1n.done()

    def next_elt(self, rnd: RefRng) -> int:
        if self.r1n is None:
            e = self.fixed
            self.fixed = None
            return e
        return self.r1n.next(rnd)


class ReadReplay:
    """One read's trajectory replay."""

    def __init__(self, inp: ReplayInputs, pol: Policy):
        self.inp = inp
        self.pol = pol
        self.rng = RefRng(inp.seed)
        self.sink = SinkState(pol)
        self.minsc = inp.minsc
        self.seen: Dict[Tuple[int, bool], List[Tuple[int, int]]] = {}
        # RedundantAlns approximation: reported alignments' diagonal
        # SPANS per (tidx, fw); a new alignment sharing any diagonal
        # with a reported one is treated as cell-overlapping
        # (aligner_result.cpp:980 RedundantAlns::overlap)
        self.red_spans: Dict[Tuple[int, bool],
                             List[Tuple[int, int]]] = {}
        self.n_ex_iters = 0
        self.n_ex_dps = 0
        self.n_ex_ugs = 0
        self.n_dp_fail = 0
        self.n_ug_fail = 0
        self.avg_hits = None

    # ---------------- seenDiags interval store ----------------
    def _diag_present(self, tidx: int, refoff: int, fw: bool) -> bool:
        for (lo, hi) in self.seen.get((tidx, fw), ()):
            if lo <= refoff <= hi:
                return True
        return False

    def _diag_add(self, tidx: int, refoff: int, fw: bool,
                  hi: Optional[int] = None) -> None:
        self.seen.setdefault((tidx, fw), []).append(
            (refoff, refoff if hi is None else hi))

    # ---------------- top-level driver ----------------
    def run(self) -> SinkState:
        inp = self.inp
        done = False
        # PHASE 1: exact upfront
        if inp.ee_width[0] + inp.ee_width[1] > 0:
            ret = self.extend_loop(self._ee_exact_entries())
            done = ret in ("POLICY", "PERFECT", "HARD")
            if not done and self.minsc == inp.perfect:
                done = True
        # PHASE 2: 1mm upfront
        if not done and (inp.mined[0] <= 1 or inp.mined[1] <= 1) \
                and inp.mm1:
            ret = self.extend_loop(self._ee_1mm_entries())
            done = ret in ("POLICY", "PERFECT", "HARD")
            if not done and self.minsc == inp.perfect:
                done = True
        # PHASE 3: seed rounds
        if not done:
            for roundi, ranges in enumerate(inp.rounds):
                if ranges is None:
                    continue          # round skipped (offset/interval)
                nonz = [r for r in ranges if r.width > 0]
                if not nonz:
                    break             # searchAllSeeds empty -> done
                self.avg_hits = sum(r.width for r in nonz) / len(nonz)
                ret = self.extend_loop(self._seed_entries(ranges))
                if ret in ("POLICY", "PERFECT", "HARD"):
                    break
                if self.minsc == inp.perfect:
                    break
                if self.avg_hits < SEED_BOOST_THRESH:
                    break
        return self.sink

    # ---------------- entry construction ----------------
    def _trimmed_ranges(self, top, w, nelt_out, maxelt):
        """eeSaTups maxelt trimming: random sub-range, maybe 2 pieces."""
        if nelt_out + w <= maxelt:
            return [(top, w)]
        trim = nelt_out + w - maxelt
        rn = self.rng.next_u32() % w
        neww = w - trim
        if rn + neww > w:
            return [(top + rn, w - rn), (top, neww - (w - rn))]
        return [(top + rn, neww)]

    def _ee_exact_entries(self) -> List[_Entry]:
        inp, pol = self.inp, self.pol
        wf, wr = inp.ee_width
        tot = wf + wr
        maxelt = pol.max_iters
        entries = []
        nelt = 0
        if tot > 0:
            rn = self.rng.next_u32() % tot
            fw_first = rn < wf
            for fwi in (0, 1):
                fw = (fwi == 0) == fw_first
                w = wf if fw else wr
                top = inp.ee_top[0] if fw else inp.ee_top[1]
                if w == 0 or nelt >= maxelt:
                    continue
                hit = EEHit(fw, top, w, inp.perfect)
                for (t0, ww) in self._trimmed_ranges(top, w, nelt, maxelt):
                    if ww <= 0:
                        break
                    entries.append(_Entry(
                        t0, ww, Random1toN(ww, pol.all_hits), None,
                        True, fw, 0, inp.length, inp.length, ee_hit=hit))
                    nelt += ww
                    if nelt >= maxelt:
                        break
        return entries

    def _ee_1mm_entries(self) -> List[_Entry]:
        inp, pol = self.inp, self.pol
        hits = list(inp.mm1)
        hits.sort(key=lambda h: -h.score)
        streak = 0
        for i in range(1, len(hits)):
            if hits[i].score == hits[i - 1].score:
                streak = 2 if streak == 0 else streak + 1
            else:
                if streak > 1:
                    shuffle_portion(hits, i - streak, streak, self.rng)
                streak = 0
        if streak > 1:
            shuffle_portion(hits, len(hits) - streak, streak, self.rng)
        entries = []
        nelt = 0
        maxelt = pol.max_iters
        for h in hits:
            if nelt >= maxelt:
                break
            for (t0, ww) in self._trimmed_ranges(h.top, h.width, nelt,
                                                 maxelt):
                if ww <= 0:
                    break
                entries.append(_Entry(
                    t0, ww, Random1toN(ww, pol.all_hits), None, True,
                    h.fw, 0, inp.length, inp.length, ee_hit=h))
                nelt += ww
                if nelt >= maxelt:
                    break
        return entries

    def _seed_entries(self, ranges: List[SeedRange]) -> List[_Entry]:
        inp, pol = self.inp, self.pol
        rng = self.rng
        by = {}
        num_offs = 1 + max(r.offidx for r in ranges)
        for r in ranges:
            if r.width > 0:
                by[(r.fw, r.offidx)] = r
        # ---- rankSeedHits (aligner_seed.h:1019) ----
        ranked: List[SeedRange] = []
        if pol.all_hits:
            for i in range(1, num_offs):
                for fw in (True, False):
                    if (fw, i) in by:
                        ranked.append(by[(fw, i)])
            for fw in (True, False):
                if (fw, 0) in by:
                    ranked.append(by[(fw, 0)])
        else:
            sorted_set = set()
            while len(ranked) < len(by):
                rb = rng.next_bool()
                minsz = None
                minkey = None
                for fwi in (0, 1):
                    fw = fwi == (1 if rb else 0)
                    i = rng.next_u32() % num_offs
                    for _ in range(num_offs):
                        k = (fw, i)
                        if k in by and k not in sorted_set and \
                                (minsz is None or by[k].width < minsz):
                            minsz = by[k].width
                            minkey = k
                        i += 1
                        if i == num_offs:
                            i = 0
                sorted_set.add(minkey)
                ranked.append(by[minkey])
        # ---- prioritizeSATupsRands ----
        maxelt = pol.max_iters
        satpos: List[SeedRange] = []
        nelt = 0
        ext_ranges = {True: [], False: []}     # (p5, len, sz)
        for r in ranked:
            skip = False
            for (p5, ln, sz) in ext_ranges[r.fw]:
                if p5 <= r.rdoff and p5 + ln >= r.rdoff + r.seedlen \
                        and r.width <= sz:
                    skip = True
                    break
            if skip:
                continue
            satpos.append(r)
            nelt += r.width
            r.nlex, r.nrex = self._extend_range(r)
            if r.nlex > 0 or r.nrex > 0:
                p5 = r.rdoff - (r.nlex if r.fw else r.nrex)
                ext_ranges[r.fw].append(
                    (p5, r.seedlen + r.nlex + r.nrex, r.width))
        satpos.sort(key=lambda r: (r.width, r.top, r.offidx, r.rdoff,
                                   r.seedlen, not r.fw))
        nsmall = sum(1 for r in satpos if r.width <= NSM)
        L = inp.length
        entries: List[_Entry] = []
        nelt_added = 0

        def rdoff3(r):
            return r.rdoff if r.fw else (L - r.rdoff - r.seedlen)

        for j in range(min(nsmall, len(satpos))):
            if nelt_added >= maxelt:
                break
            r = satpos[j]
            entries.append(_Entry(
                r.top, r.width, Random1toN(r.width, pol.all_hits), None,
                r.width < NSM, r.fw, rdoff3(r), r.seedlen, r.seedlen))
            nelt_added += r.width
        if not (nelt_added >= maxelt or nsmall == len(satpos)):
            rows = RowSampler(satpos, nsmall, len(satpos))
            rands2 = [None] * len(satpos)
            while nelt_added < maxelt and nelt_added < nelt:
                ri = rows.next(rng) + nsmall
                if rands2[ri] is None:
                    rands2[ri] = Random1toN(satpos[ri].width,
                                            pol.all_hits)
                elt = rands2[ri].next(rng)
                if rands2[ri].done():
                    rows.finished_range(ri - nsmall)
                r = satpos[ri]
                entries.append(_Entry(
                    r.top + elt, 1, None, 0, True, r.fw, rdoff3(r),
                    r.seedlen, r.seedlen))
                nelt_added += 1
        return entries

    # ---------------- in-index range extension ----------------
    def _extend_range(self, r: SeedRange) -> Tuple[int, int]:
        """extend() (aligner_sw_driver.cpp:299): maximal exact extension
        of the whole range in the joined text. All occurrences must
        agree on the next char; the char must equal the read's (unless
        the read has N there); stop at text/fragment... the reference
        extends across fragment boundaries in the joined text, stopping
        only at the joined-text ends (the $) or on disagreement."""
        inp = self.inp
        L = inp.length
        codes = inp.codes_fw if r.fw else inp.codes_rc
        pos = [inp.resolve(r.top, e, r.seedlen) for e in range(r.width)]
        if any(p is None for p in pos):
            raise ReplayAbort("unresolved row in extend()")
        joined = [p[2] for p in pos]
        # pattern offset of the seed within `codes` (the searched text):
        poff = r.rdoff if r.fw else (L - r.rdoff - r.seedlen)
        nlex = nrex = 0
        for ii in range(poff):                       # leftward
            rdc = int(codes[poff - ii - 1])
            cs = set()
            ok = True
            for j in joined:
                c = inp.joined_char(j - ii - 1)
                if c is None:
                    ok = False
                    break
                cs.add(c)
            if not ok or len(cs) != 1:
                break
            if rdc <= 3 and next(iter(cs)) != rdc:
                break
            nlex += 1
            if nlex == 255:
                break
        for ii in range(L - poff - r.seedlen):       # rightward
            rdc = int(codes[poff + r.seedlen + ii])
            cs = set()
            ok = True
            for j in joined:
                c = inp.joined_char(j + r.seedlen + ii)
                if c is None:
                    ok = False
                    break
                cs.add(c)
            if not ok or len(cs) != 1:
                break
            if rdc <= 3 and next(iter(cs)) != rdc:
                break
            nrex += 1
            if nrex == 255:
                break
        # reference semantics: nlex/nrex are w.r.t. the READ's 5' axis
        if not r.fw:
            nlex, nrex = nrex, nlex
        return nlex, nrex

    # ---------------- the extend loop ----------------
    def extend_loop(self, entries: List[_Entry]) -> str:
        """extendSeeds' `while(true) for(i < maxi) while(elements)`
        structure (aligner_sw_driver.cpp:991-1496).

        EE mode runs EXACTLY ONE for-pass over the entries: each entry
        drains fully; score-tightening past the entry's score `break`s
        out of its drain (:1104) and the NEXT entry's top-of-loop check
        (:1055) exits the phase with EXTEND_PERFECT_SCORE. When the
        broken entry was the last one, the pass ends and the call
        returns EXTEND_EXHAUSTED_CANDIDATES — the read CONTINUES into
        the seed phase (bt2_search.cpp "Not done yet").

        Non-EE mode repeats for-passes (one element per pass for large
        ranges, full drain for small) until every entry is done."""
        inp, pol = self.inp, self.pol
        ee_mode = any(e.ee_hit is not None for e in entries)
        if not entries:
            return "EXHAUSTED"
        if ee_mode:
            for e in entries:
                if e.ee_hit.score < self.minsc:
                    return "PERFECT"
                while not e.done():
                    if self.minsc == inp.perfect \
                            and e.ee_hit.score < inp.perfect:
                        return "PERFECT"
                    if e.ee_hit.score < self.minsc:
                        break          # tighten passed this score (:1104)
                    if self.n_ex_dps >= pol.max_dp:
                        return "HARD"
                    if self.n_ex_ugs >= pol.max_ug:
                        return "HARD"
                    if self.n_ex_iters >= pol.max_iters:
                        return "HARD"
                    self.n_ex_iters += 1
                    elt = e.next_elt(self.rng)
                    ret = self._visit(e, elt, True)
                    if ret is not None:
                        return ret
            return "EXHAUSTED"
        while True:
            progressed = False
            for e in entries:
                if e.done():
                    continue
                first = True
                while not e.done() and (first or e.is_small):
                    if self.minsc == inp.perfect:
                        return "PERFECT"
                    if self.n_ex_dps >= pol.max_dp:
                        return "HARD"
                    if self.n_ex_ugs >= pol.max_ug:
                        return "HARD"
                    if self.n_ex_iters >= pol.max_iters:
                        return "HARD"
                    self.n_ex_iters += 1
                    first = False
                    progressed = True
                    elt = e.next_elt(self.rng)
                    ret = self._visit(e, elt, False)
                    if ret is not None:
                        return ret
            if not progressed:
                return "EXHAUSTED"

    # ---------------- one element visit ----------------
    def _visit(self, e: _Entry, elt: int, ee_mode: bool) -> Optional[str]:
        inp, pol = self.inp, self.pol
        res = inp.resolve(e.top, elt, e.qlen)
        if res is None:
            raise ReplayAbort("unresolved row")
        tidx, toff, _joined, straddled = res
        if ee_mode and straddled:
            return None                    # joinedToTextOff reject
        if tidx < 0:
            return None
        refoff = toff - e.rdoff3
        if self._diag_present(tidx, refoff, e.fw):
            return None
        if ee_mode:
            hit = e.ee_hit
            self._diag_add(tidx, refoff, e.fw)
            aln = Aln(hit.score, tidx, refoff, e.fw)
            return self._report(aln)
        read_gaps, ref_gaps = max_gaps(pol, self.minsc, inp.perfect)
        ungapped = read_gaps == 0 and ref_gaps == 0
        codes = inp.codes_fw if e.fw else inp.codes_rc
        if ungapped:
            self._diag_add(tidx, refoff, e.fw)
            self.n_ex_ugs += 1
            aln = self._ungapped_align(codes, tidx, refoff, e.fw)
            if aln is None:
                self.n_ug_fail += 1
                if self.n_ug_fail >= pol.fail_streak:
                    return "SOFT"
                return None
            self.n_ug_fail = 0
            return self._report(aln)
        return self._dp_visit(e, codes, tidx, toff, refoff,
                              read_gaps, ref_gaps)

    def _report(self, aln: Aln,
                span: Optional[Tuple[int, int]] = None) -> Optional[str]:
        if span is None:
            span = (aln.refoff, aln.refoff)
        key = (aln.tidx, aln.fw)
        for (lo, hi) in self.red_spans.get(key, ()):
            if span[0] <= hi and span[1] >= lo:
                return None
        self.red_spans.setdefault(key, []).append(span)
        if self.sink.report(aln):
            return "POLICY"
        self._tighten()
        return None

    def _tighten(self) -> None:
        pol = self.pol
        if pol.tighten <= 0 or pol.all_hits or pol.mhits == 0:
            return
        best, sec = self.sink.best2()
        if sec is None:
            return
        diff = best - sec
        bot = sec + (diff * 3) // 4
        if bot >= self.minsc:
            self.minsc = bot
            if self.minsc < self.inp.perfect:
                self.minsc += 1

    # ---------------- alignment evaluation ----------------
    def _ungapped_align(self, codes, tidx, refoff, fw) -> Optional[Aln]:
        inp, pol = self.inp, self.pol
        L = inp.length
        win = inp.refwin(tidx, refoff, L)
        quals = inp.quals if fw else inp.quals[::-1]
        score = 0
        for i in range(L):
            rc, fc = int(codes[i]), int(win[i])
            if fc >= 5:
                return None              # off edge (no overhangs)
            if rc >= 4 or fc == 4:
                score -= pol.n_pen
            elif rc == fc:
                score += pol.match_bonus
            else:
                score -= mm_pen(pol, quals[i])
        if score < self.minsc:
            return None
        return Aln(score, tidx, refoff, fw)

    def _dp_visit(self, e: _Entry, codes, tidx, toff, refoff,
                  read_gaps, ref_gaps) -> Optional[str]:
        """frameSeedExtensionRect + DP + nextAlignment emulation."""
        inp, pol = self.inp, self.pol
        L = inp.length
        maxgap = min(max(read_gaps, ref_gaps), pol.maxhalf)
        refl_pre = refoff - 2 * maxgap
        refr_pre = refoff + (L - 1) + 2 * maxgap
        tlen = inp.tlen_of(tidx)
        maxns = min(inp.nceil, L - 1)
        triml = max(0, -refl_pre - maxns)
        trimr = max(0, refr_pre - (tlen + maxns - 1))
        refl = refl_pre + triml
        refr = refr_pre - trimr
        core_lo = refl_pre + maxgap
        core_hi = refl_pre + 3 * maxgap
        # the anchor diagonal is added even if the rect is dead
        if refr < refl:
            self._diag_add(tidx, refoff, e.fw)
            return None
        self.n_ex_dps += 1
        self._diag_add(tidx, core_lo, e.fw, core_hi)
        win = inp.refwin(tidx, refl, refr - refl + 1)
        quals = inp.quals if e.fw else inp.quals[::-1]
        hrow, orow = inp.dp_cells(codes, quals, win)
        if inp.trace is not None:
            best = int(hrow.max())
            inp.trace.append(("dp", tidx, refl, refr, e.fw, self.minsc,
                              best if best >= self.minsc else None))
        cands = [(int(hrow[j]), j) for j in range(len(hrow))
                 if hrow[j] >= self.minsc]
        if not cands:
            self.n_dp_fail += 1
            if self.n_dp_fail >= pol.fail_streak:
                return "SOFT"
            return None
        self.n_dp_fail = 0
        cands.sort(key=lambda sj: (-sj[0], -sj[1]))
        for (sc, j) in cands:
            # one reseed per backtrace attempt (aligner_sw.cpp:794);
            # attempts that then fail redundancy still consumed theirs
            reseed = (self.rng.next_u32() + 1) & 0xFFFFFFFF
            self.rng.init((reseed + 1) & 0xFFFFFFFF)
            if sc < self.minsc:
                break
            # diagonal span of the best path ending at this cell:
            # start diag refl + origin col, end diag via end col
            start_refoff = refl + int(orow[j])
            end_refoff = refl + (j - 1) - (L - 1)
            span = (min(start_refoff, end_refoff),
                    max(start_refoff, end_refoff))
            aln = Aln(sc, tidx, start_refoff, e.fw, gapped=True,
                      end_col=j - 1, rect_refl=refl)
            ret = self._report(aln, span)
            if ret is not None:
                return ret
        return None
