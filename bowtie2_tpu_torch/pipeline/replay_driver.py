"""Builds seed_replay.ReplayInputs from the device pipeline, in batches.

Port of bowtie2_tpu/pipeline/replay_driver.py: the host logic is the
same; the batched searches go to this package's ops/fm.py (the fm_search
and sa_resolve kernels on the card).

The trajectory replay (pipeline/seed_replay.py) is pure host logic; this
module feeds it: batched FM searches for the cohort reads' seed/EE/1mm
SA ranges, batched SA resolution of every range element (capped), and
host accessors over the 2-bit reference words.

Used by the aligner's RNG-override hook for trajectory-class reads.
"""

from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

import numpy as np

from bowtie2_tpu_torch.ops import fm
from bowtie2_tpu_torch.pipeline.seed_replay import (EEHit, Policy,
                                                    ReplayAbort,
                                                    ReplayInputs, SeedRange,
                                                    mm_pen)

RESOLVE_CAP = 4096       # max elements resolved per SA range


class ReplayBuilder:
    def __init__(self, aligner):
        """aligner: an UnpairedAligner (provides .data, .idx, .pol,
        ._put, ._row_dtype and the seed-offset machinery)."""
        self.al = aligner
        self.data = aligner.data
        self.pol = aligner.pol
        d = self.data
        # seg tables: joined position -> global position
        self.seg_js = np.asarray(d.seg_joined_start, np.int64)
        self.seg_gs = np.asarray(d.seg_global_start, np.int64)
        self.seg_end = np.asarray(aligner._seg_end_joined, np.int64)
        self.jlen = int(self.seg_end[-1]) if self.seg_end.size else 0
        self.ref_cum = np.asarray(d.ref_cum, np.int64)
        self.ref_words = np.asarray(d.ref_words)
        self.refn_words = np.asarray(d.refn_words)

    # ---------------- host reference accessors ----------------
    def _global_char(self, g: int) -> int:
        w = int(self.ref_words[g >> 4])
        c = (w >> (2 * (g & 15))) & 3
        if (int(self.refn_words[g >> 5]) >> (g & 31)) & 1:
            return 4
        return c

    def make_joined_char(self):
        # scalar lookups: bisect on Python lists (= np.searchsorted with
        # side="right"), called per reference char by the replay
        js, gs, jlen = self.seg_js.tolist(), self.seg_gs.tolist(), self.jlen

        def joined_char(j: int) -> Optional[int]:
            if j < 0 or j >= jlen:
                return None
            s = bisect_right(js, j) - 1
            g = gs[s] + (j - js[s])
            return self._global_char(g)
        return joined_char

    def make_refwin(self):
        ref_cum = self.ref_cum

        def refwin(tidx: int, refl: int, W: int) -> np.ndarray:
            g0 = int(ref_cum[tidx]) + refl
            tlen = int(ref_cum[tidx + 1] - ref_cum[tidx])
            out = np.full(W, 5, np.int8)
            lo = max(refl, 0)
            hi = min(refl + W, tlen)
            if hi > lo:
                gp = np.arange(g0 + (lo - refl), g0 + (hi - refl))
                c = (self.ref_words[gp >> 4] >> (2 * (gp & 15))) & 3
                nm = (self.refn_words[gp >> 5] >> (gp & 31)) & 1
                out[lo - refl:hi - refl] = np.where(nm == 1, 4, c)
            return out
        return refwin

    # ---------------- batched device helpers ----------------
    def _sweep(self, pats: np.ndarray, lens: np.ndarray):
        """fm.exact_sweep over padded patterns; returns (top, bot, nedit)."""
        al = self.al
        from bowtie2_tpu_torch.pipeline.align import _np, _pow2_at_least
        n = pats.shape[0]
        np_ = _pow2_at_least(max(n, 1), lo=64)
        pp = np.zeros((np_, pats.shape[1]), np.int32)
        pp[:n] = pats
        ll = np.zeros(np_, np.int32)
        ll[:n] = lens
        jsw = fm.exact_sweep(al.idx.fw, al._put(np.ascontiguousarray(pp)),
                             al._put(ll))
        return (_np(jsw.top).astype(np.int64)[:n],
                _np(jsw.bot).astype(np.int64)[:n],
                _np(jsw.nedit)[:n])

    def _seed_search(self, seeds: np.ndarray, valid: np.ndarray,
                     slen: int):
        al = self.al
        from bowtie2_tpu_torch.pipeline.align import _np, _pow2_at_least
        n = seeds.shape[0]
        np_ = _pow2_at_least(max(n, 1), lo=64)
        ss = np.zeros((np_, slen), np.int32)
        ss[:n] = seeds
        vv = np.zeros(np_, bool)
        vv[:n] = valid
        ftab = min(self.data.fw.ftab_chars, slen)
        top, bot = fm.seed_search_exact(
            al.idx.fw, al._put(np.ascontiguousarray(ss)), al._put(vv),
            slen, ftab)
        return (_np(top).astype(np.int64)[:n],
                _np(bot).astype(np.int64)[:n])

    def _resolve_rows(self, rows: np.ndarray) -> np.ndarray:
        al = self.al
        from bowtie2_tpu_torch.pipeline.align import _np, _pow2_at_least
        n = rows.size
        np_ = _pow2_at_least(max(n, 1), lo=64)
        rr = np.zeros(np_, al._row_dtype)
        rr[:n] = rows
        jp = fm.sa_resolve(al.idx.fw, al._put(rr),
                           period=1 << self.data.off_rate)
        return _np(jp).astype(np.int64)[:n]

    # ---------------- the builder ----------------
    def build(self, records, trace: bool = False
              ) -> List[Optional[ReplayInputs]]:
        """Build ReplayInputs for each record (None = out of scope)."""
        pol = self.pol
        al = self.al
        d = self.data
        n = len(records)
        if pol.local:
            return [None] * n
        L_list = [int(r.seq.size) for r in records]
        Lmax = max(L_list)
        from bowtie2_tpu_torch.pipeline.align import pad_reads, _bucket
        fw, qu, rc, qu_r, lens = pad_reads(records, _bucket(Lmax))
        Lmax = fw.shape[1]

        # ---- exact sweep (both strands) ----
        pats = np.concatenate([fw, rc], axis=0).astype(np.int32)
        ll = np.concatenate([lens, lens]).astype(np.int32)
        top2, bot2, ned2 = self._sweep(pats, ll)
        ee_top = (top2[:n], top2[n:])
        ee_w = (np.where(ned2[:n] == 0, bot2[:n] - top2[:n], 0),
                np.where(ned2[n:] == 0, bot2[n:] - top2[n:], 0))
        mined = (ned2[:n], ned2[n:])

        # ---- 1mm variant discovery ----
        # Candidate corrected patterns in oneMmSearch's DISCOVERY ORDER
        # (matters: sort1mmEe is a stable_sort by score, so equal-score
        # hits keep this order before the shuffle). Enumeration
        # (aligner_seed.cpp:1026-1128): per strand (fw read first), the
        # fw-index pass finds mismatches in the pattern's LEFT half at
        # DESCENDING pattern offsets, then the mirror-index pass the
        # RIGHT half at ASCENDING offsets; per offset, substituted ref
        # chars ascending. halfFw = L>>1 (exact near half for the fw
        # pass = the last halfFw chars); halfBw = L>>1 + (L&1); the
        # left-half mismatch offsets are [0, halfBw-1], right
        # [halfBw, L-1]. Reads with 2+ Ns skip the phase; with ONE N
        # only the N position is substituted.
        var_meta = []           # (read i, strand fw?, p_pattern, c)
        var_rows = []
        pol_host = self._policy()
        for i in range(n):
            L = L_list[i]
            half_bw = (L >> 1) + (L & 1)
            ns_count = int((fw[i, :L] >= 4).sum())
            if ns_count > 1:
                continue
            for isfw, pat in ((True, fw[i]), (False, rc[i])):
                if (mined[0][i] if isfw else mined[1][i]) > 1:
                    continue
                # fw-index pass: left half, offsets descending; the
                # NEAR half (right) must be N-free for the pass to run
                if not (pat[half_bw:L] >= 4).any():
                    for p in range(half_bw - 1, -1, -1):
                        if ns_count == 1 and pat[p] < 4:
                            continue
                        for c in range(4):
                            if c != pat[p]:
                                row = pat.copy()
                                row[p] = c
                                var_meta.append((i, isfw, p, c))
                                var_rows.append(row)
                # mirror-index pass: right half, offsets ascending; the
                # NEAR half here is the pattern's LEFT half (exact)
                if not (pat[:half_bw] >= 4).any():
                    for p in range(half_bw, L):
                        if ns_count == 1 and pat[p] < 4:
                            continue
                        for c in range(4):
                            if c != pat[p]:
                                row = pat.copy()
                                row[p] = c
                                var_meta.append((i, isfw, p, c))
                                var_rows.append(row)
        mm1_by_read: Dict[int, List[EEHit]] = {i: [] for i in range(n)}
        if var_rows:
            vp = np.stack(var_rows).astype(np.int32)
            vl = np.array([L_list[m[0]] for m in var_meta], np.int32)
            vt, vb, vn = self._sweep(vp, vl)
            for (m, t, b, ne) in zip(var_meta, vt, vb, vn):
                i, isfw, p, c = m
                if ne != 0 or b <= t:
                    continue
                L = L_list[i]
                base = int(fw[i, p] if isfw else rc[i, p])
                # 5'-based mismatch offset and qual (rc: flip)
                p5 = p if isfw else (L - 1 - p)
                q = int(qu[i, p5])
                sc = (-pol_host.n_pen if base >= 4
                      else -mm_pen(pol_host, q))
                mm1_by_read[i].append(
                    EEHit(isfw, int(t), int(b - t), sc,
                          edit_pos=p5, edit_chr=int(c)))

        # ---- seed ranges per round ----
        nrounds = getattr(pol, "seed_rounds", 2)
        ivals = np.array([pol.interval(int(x)) for x in lens], np.int32)
        slen = pol.seed_len
        rounds_by_read: Dict[int, List] = {i: [] for i in range(n)}
        for roundi in range(nrounds):
            seed_rows = []
            seed_meta = []
            for i in range(n):
                L = L_list[i]
                ival = int(ivals[i])
                nr = min(nrounds, ival)
                if roundi >= nr or ival <= roundi:
                    rounds_by_read[i].append(None)
                    continue
                offset = (ival * roundi) // nr
                if offset > 0 and slen + offset > L:
                    rounds_by_read[i].append(None)
                    continue
                offs = []
                o = offset
                while o + slen <= L:
                    offs.append(o)
                    o += ival
                rounds_by_read[i].append([])
                for oi, off in enumerate(offs):
                    for isfw in (True, False):
                        sub = fw[i, off:off + slen] if isfw \
                            else rc[i, L - off - slen:L - off]
                        seed_rows.append(sub.astype(np.int32))
                        seed_meta.append((i, roundi, isfw, oi, off))
            if seed_rows:
                sp = np.stack(seed_rows)
                has_n = (sp >= 4).any(axis=1)
                st, sb = self._seed_search(sp, ~has_n, slen)
                for (m, t, b, hn) in zip(seed_meta, st, sb, has_n):
                    i, rd, isfw, oi, off = m
                    w = int(b - t) if not hn and b > t else 0
                    rounds_by_read[i][rd].append(
                        SeedRange(isfw, oi, off, slen, int(t), w))

        # ---- batched resolution of every range element ----
        need = set()
        per_read_abort = [False] * n

        def want(i, top, width):
            if width > RESOLVE_CAP:
                per_read_abort[i] = True
                return
            for e in range(width):
                need.add(int(top) + e)

        for i in range(n):
            for (tt, ww) in zip(ee_top, ee_w):
                if ww[i] > 0:
                    want(i, tt[i], int(ww[i]))
            for h in mm1_by_read[i]:
                want(i, h.top, h.width)
            for rd in rounds_by_read[i]:
                if rd:
                    for r in rd:
                        if r.width > 0:
                            want(i, r.top, r.width)
        rows = np.array(sorted(need), np.int64)
        jpos = self._resolve_rows(rows) if rows.size else rows
        row_pos = dict(zip(rows.tolist(), jpos.tolist()))

        # joined -> (tidx, toff, straddle) mapping (bisect on lists, as
        # in make_joined_char)
        seg_js, seg_gs = self.seg_js.tolist(), self.seg_gs.tolist()
        seg_end = self.seg_end.tolist()
        ref_cum = self.ref_cum
        ref_cum_l = ref_cum.tolist()

        def resolve(top, elt, qlen):
            j = row_pos.get(int(top) + int(elt))
            if j is None:
                return None
            s = bisect_right(seg_js, j) - 1
            straddled = j + qlen > seg_end[s]
            g = seg_gs[s] + (j - seg_js[s])
            tidx = bisect_right(ref_cum_l, g) - 1
            toff = g - ref_cum_l[tidx]
            return (tidx, toff, j, straddled)

        refwin = self.make_refwin()
        joined_char = self.make_joined_char()
        from bowtie2_tpu_torch.ops.sw import sw_full_numpy_cells
        swp = pol.sw_params()

        def dp_cells(codes, quals, win):
            return sw_full_numpy_cells(codes, quals, win, swp)

        from bowtie2_tpu_torch.pipeline.rng import gen_rand_seed, rng_name
        out: List[Optional[ReplayInputs]] = []
        for i in range(n):
            if per_read_abort[i]:
                out.append(None)
                continue
            rec = records[i]
            L = L_list[i]
            seed = gen_rand_seed(rec.seq, rec.qual + 33, rng_name(rec),
                                 seed=pol.rng_seed)
            out.append(ReplayInputs(
                name=rec.name, seed=int(seed), length=L,
                codes_fw=fw[i, :L].astype(np.int64),
                codes_rc=rc[i, :L].astype(np.int64),
                quals=qu[i, :L].astype(np.int64),
                minsc=int(pol.min_score(L)),
                perfect=int(pol.perfect_score(L)) if pol.local else 0,
                nceil=int(pol.nceil(L)),
                ee_top=(int(ee_top[0][i]), int(ee_top[1][i])),
                ee_width=(int(ee_w[0][i]), int(ee_w[1][i])),
                mined=(int(mined[0][i]), int(mined[1][i])),
                mm1=mm1_by_read[i],
                rounds=rounds_by_read[i],
                resolve=resolve,
                joined_char=joined_char,
                refwin=refwin,
                tlen_of=lambda t: int(ref_cum[t + 1] - ref_cum[t]),
                dp_cells=dp_cells,
                trace=[] if trace else None))
        return out

    def _policy(self) -> Policy:
        pol = self.pol
        sw = pol.sw_params()
        if pol.all_hits:
            big = 1 << 60
            streak, mxiter, mxdp, mxug = big, big, big, big
        else:
            kincr = max(pol.khits - 1, 0)
            streak = pol.fail_streak + kincr * 10
            mxiter = 400 + kincr * 20
            mxdp = 300 + kincr * 20
            mxug = 300 + kincr * 20
        return Policy(
            khits=pol.khits, mhits=pol.mhits, all_hits=pol.all_hits,
            fail_streak=streak,
            max_iters=mxiter, max_dp=mxdp, max_ug=mxug,
            tighten=3,
            match_bonus=sw.match_bonus, mm_pen_max=sw.mm_pen_max,
            mm_pen_min=sw.mm_pen_min, n_pen=sw.n_pen,
            read_gap_open=sw.read_gap_open,
            read_gap_extend=sw.read_gap_extend,
            ref_gap_open=sw.ref_gap_open,
            ref_gap_extend=sw.ref_gap_extend,
            gap_barrier=sw.gap_barrier,
            maxhalf=pol.max_half, sw=sw)
