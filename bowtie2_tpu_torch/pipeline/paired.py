"""Paired-end batched alignment on the device (torch + CUDA kernels).

Port of the paired-end half of bowtie2_tpu/pipeline/align.py
(`FusedPEBatch`, `PairedAligner`). A batch of pairs runs as one device
pipeline (`ops/fused.py::fused_pe`: the searches, the window gather, the
origin-tracking DP and the device pairing, each a CUDA kernel) that
`submit` enqueues without synchronising;
`collect_raw` reads its blob back, runs the mate-rescue DP for pairs
without a concordant combination, backtraces only the reported records
and builds the SAM lines with the native PE line builder. Output is
byte-identical to the JAX package's for the same index and pairs.

Batches whose fused DP budget overflows take the phase-by-phase host path
(`align_batch_host`); batches with a pair the device pairing cannot decide
(`hostneed`), and every batch under `force_host_pairing`, re-run the
pairing on the host from the per-slot export (`_collect_fused_legacy`).
A pair with a mate over 8192 bp takes the host path too: `submit` returns
("host", pairs, batch number), and `collect` / `collect_raw` align it
there with the long-read band DP (no mate rescue for long mates, as in
the JAX package).

Entry points take device=None, meaning the CUDA card; device="cpu" runs the
kernels' plain PyTorch versions (the tests do).
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bowtie2_tpu_torch.io.fastx import SeqRecord
from bowtie2_tpu_torch.io.sam import (FLAG_MATE1, FLAG_MATE2,
                                      FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED,
                                      FLAG_PAIRED, FLAG_PROPER, FLAG_REVERSE,
                                      FLAG_UNMAPPED, SamAlignment)
from bowtie2_tpu_torch.ops.fused import FusedPEResult
from bowtie2_tpu_torch.pipeline.align import (LEN_BUCKETS,
                                              AlignStats, BatchAligner,
                                              CandSet, DPPool, _batch_of,
                                              _bucket, _np, _round_batch,
                                              _u32pos, pad_reads)
from bowtie2_tpu_torch.pipeline.pe import (PE_DISCORD, pe_classify,
                                           rescue_window)
from bowtie2_tpu_torch.utils.metrics import TRACE

# the global coordinate from which the paired-end exports' int32 position
# words are ambiguous (_u32pos)
PE_COORD_LIMIT = (1 << 32) - 4096


@dataclass
class FusedPEBatch:
    """In-flight fused paired-end batch: device handles + host context.

    Read-row layout: mate-1 reads occupy rows [0, Bp), mate-2 rows
    [Bp, 2*Bp) (real pairs first, padding after, per half)."""
    pairs: Sequence[Tuple[SeqRecord, SeqRecord]]
    B: int                      # real pairs
    Bp: int                     # padded pairs (pow2)
    B2: int                     # 2 * Bp read rows
    Lmax: int
    T: int
    NC: int
    G: int
    lens: np.ndarray            # (B2,)
    fw: np.ndarray              # (B2, Lmax) host int8
    qu: np.ndarray
    rc: np.ndarray
    qu_r: np.ndarray
    minsc: np.ndarray
    perfect: np.ndarray
    filtered: np.ndarray
    yf: np.ndarray
    inst_read: np.ndarray       # (B2,) N-free instantiated seeds per read
    jboth: torch.Tensor         # device (2*B2, Lmax)
    jquals: torch.Tensor
    res: FusedPEResult
    pairing: object = None      # static pairing tuple passed to fused_pe
                                # (None = device pairing disabled)
    batch: int = -1             # submit's batch number (TRACE)

    @property
    def device(self) -> torch.device:
        return self.jboth.device


class PairedAligner(BatchAligner):
    """Aligns batches of read pairs: concordant search, mate rescue DP,
    discordant and mixed fallbacks (reference SwDriver::extendSeedsPaired +
    PairedEndPolicy, aligner_sw_driver.cpp / pe.cpp).

    Default path: the fused device search (ops/fused.py fused_pe) with
    the device pairing, host mate-rescue DP and the emission backtrace of
    only the reported records. `align_batch_host` is the phase-by-phase
    fallback (DP-budget overflow) and differential oracle;
    `force_host_pairing` makes every batch re-run the pairing on the host
    from the per-slot export."""

    force_host_pairing = False

    def __init__(self, data, policy, device=None, mesh=None,
                 shard_mesh=None):
        """As BatchAligner's. An index whose global coordinates reach
        PE_COORD_LIMIT raises: the paired-end exports carry positions as
        int32 words, which `_u32pos` decodes unambiguously only below it
        (the JAX package's PairedAligner gives wrong positions there)."""
        if int(data.ref_cum[-1]) >= PE_COORD_LIMIT:
            raise NotImplementedError(
                f"global coordinates of {int(data.ref_cum[-1])} bp reach "
                f"2^32 - 4096, past which the paired-end path's int32 "
                f"position words do not decode: a limit inherited from the "
                f"JAX package (ROADMAP.md §3); single-end alignment runs "
                f"on this index")
        super().__init__(data, policy, device=device, mesh=mesh,
                         shard_mesh=shard_mesh)

    def submit(self, pairs) -> Optional[FusedPEBatch]:
        """Enqueue the fused PE device pipeline for one batch of pairs (no
        host sync). A batch with a mate over the rectangle buckets is
        returned as ("host", pairs, batch number): collect runs it on
        align_batch_host, whose search is then in long mode (the band
        DP)."""
        if not pairs:
            return None
        batch = TRACE.next_batch()
        with TRACE.span("submit"):
            self._take_turn()
            if max(max(p[0].seq.size, p[1].seq.size) for p in pairs) \
                    > LEN_BUCKETS[-1]:
                return ("host", pairs, batch)
            return self._submit_fused(pairs, batch)

    def _submit_fused(self, pairs, batch: int) -> FusedPEBatch:
        pol = self.pol
        B = len(pairs)
        Bp = _round_batch(B, lo=128)
        dummy = SeqRecord(name="", seq=np.zeros(0, np.uint8),
                          qual=np.zeros(0, np.uint8))
        recs = [p[0] for p in pairs] + [dummy] * (Bp - B) + \
               [p[1] for p in pairs] + [dummy] * (Bp - B)
        B2 = 2 * Bp
        Lmax = _bucket(max(max(int(r.seq.size) for r in recs), 1))
        fw, qu, rc, qu_r, lens = pad_reads(recs, Lmax)

        ulen, inv = np.unique(lens, return_inverse=True)
        minsc = np.array([pol.min_score(int(l)) if l else 0
                          for l in ulen], np.int64)[inv]
        perfect = np.array([pol.perfect_score(int(l)) if pol.local else 0
                            for l in ulen], np.int64)[inv]
        nceil = np.array([pol.nceil(int(l)) if l else 0
                          for l in ulen], np.int32)[inv]
        n_count = (fw >= 4).sum(axis=1) - (Lmax - lens)
        filtered, yf = self._filters(recs, lens, n_count, nceil, minsc)
        live = ~filtered & (lens > 0)

        # paired-end seed-interval boost when BOTH mates pass filters
        # (bt2_search.cpp:3445-3448)
        okm = ~filtered
        ival_boost = okm & np.roll(okm, Bp)
        offs_all, valid_all = self._seed_offsets(lens, ival_boost)

        both = np.concatenate([fw, rc], axis=0)
        inst0 = self._inst_counts(both, offs_all, valid_all)
        inst_read = inst0[:B2] + inst0[B2:]

        T = self.NC_PER_READ
        G = pol.band_halfwidth(Lmax)
        NC = 2 * B2
        jboth = self._put(both).to(torch.int32)
        jquals = self._put(np.concatenate([qu, qu_r], axis=0)).to(torch.int32)
        live_or = self._live_orient(B2, paired=True)
        pairing = self._pe_pairing_static(minsc, perfect)
        res = self._fused("pe", (
            jboth, jquals, self._put(lens), self._put(offs_all),
            self._put(valid_all), self._put(minsc.astype(np.int32)),
            self._put(live), None if live_or is None else self._put(live_or),
            self._put(inst_read.astype(np.int32)), self._put(filtered)), dict(
            params=pol.sw_params(), band=G, seed_len=pol.seed_len,
            ftab_chars=self.data.fw.ftab_chars,
            half_ftab=min(self.data.fw.ftab_chars, pol.seed_len // 2),
            period=1 << self.data.off_rate, T=T, NC=NC,
            n1=pol.seed_mms >= 1, no_1mm=getattr(pol, "no_1mm", False),
            no_exact=getattr(pol, "no_exact", False), NCDP=max(B2, 512),
            pairing=pairing))
        return FusedPEBatch(
            pairs=pairs, B=B, Bp=Bp, B2=B2, Lmax=Lmax, T=T, NC=NC, G=G,
            lens=lens, fw=fw, qu=qu, rc=rc, qu_r=qu_r, minsc=minsc,
            perfect=perfect, filtered=filtered, yf=yf, inst_read=inst_read,
            jboth=jboth, jquals=jquals, res=res, pairing=pairing,
            batch=batch)

    def _pe_pairing_static(self, minsc, perfect):
        """Static pairing tuple for the device-side fused-PE pairing, or
        None when the host must run the full pairing anyway (k/-a modes
        re-rank whole combo lists) or when the int32 pairing key could
        overflow (extreme --score-min / --ma settings)."""
        from bowtie2_tpu_torch.pipeline.pe_effort import pe_streak_limit
        pol = self.pol
        if pol.all_hits or pol.khits > 1:
            return None
        bound = (int(np.abs(minsc).max(initial=0))
                 + int(np.abs(perfect).max(initial=0)) + 1) * 2
        if bound << 10 >= (1 << 31):      # 2*shift bits at T<=32
            return None
        if self.force_host_pairing:
            return None
        return (pol.mate_fw_rc, pol.minins, pol.maxins, pol.olap_ok,
                pol.contain_ok, pol.dovetail_ok,
                pe_streak_limit(pol.fail_streak, pol.khits, True))

    def collect(self, h: Optional[FusedPEBatch]) -> List[SamAlignment]:
        if h is None:
            return []
        TRACE.batch = _batch_of(h)
        with TRACE.span("collect"):
            self._use_batch(h)
            if isinstance(h, tuple) and h[0] == "host":
                return self.align_batch_host(h[1])
            return self._collect_fused(h)

    def collect_raw(self, h, suffix: bytes = b""
                    ) -> List[List[Tuple[int, bytes]]]:
        """collect(), but emit finished SAM line bytes via the native PE
        line builder: one group per PAIR, each entry (flag, line). The
        fast path builds concordant pairs fully vectorized (native C
        CIGAR/MD decode + line assembly); legacy/k-mode/host batches fall
        back to object records rendered to lines."""
        if h is None:
            return []
        TRACE.batch = _batch_of(h)
        with TRACE.span("collect"):
            self._use_batch(h)
            if isinstance(h, tuple) and h[0] == "host":
                return self._pe_groups_from_objects(
                    len(h[1]), self.align_batch_host(h[1]), suffix)
            dec = self._pe_decode(h)
            if dec is None:    # DP budget overflow
                return self._pe_groups_from_objects(
                    len(h.pairs), self.align_batch_host(h.pairs), suffix)
            rf, pf, ee, snz, cif = dec
            if self._host_pairing(h, pf):
                return self._pe_groups_from_objects(
                    h.B, self._collect_fused_legacy(h, ee, snz, cif), suffix)
            return self._collect_fused_fast_raw(h, rf, pf, cif, suffix)

    def _host_pairing(self, h: FusedPEBatch, pf) -> bool:
        """Whether a fused batch's pairing is re-run on the host
        (`_collect_fused_legacy`): device pairing off, or some pair that
        the device pairing flagged (counted in `hostneed_pairs`)."""
        from bowtie2_tpu_torch.ops.fused import PE_PAIR_FIELDS
        if h.pairing is None:
            return True
        n = int(np.count_nonzero(pf[PE_PAIR_FIELDS - 1, :h.B]))
        if n:
            self.metrics.add(hostneed_pairs=n)
        return n > 0

    @staticmethod
    def _pe_groups_from_objects(n_pairs, out, suffix):
        """Group a flat SamAlignment list into per-pair (flag, line)
        groups. A group holds one primary record per mate (half-mapped
        pairs may lead with the aligned MATE 2 record — finishRead
        order), plus any secondaries; a new group starts at a primary
        record for a mate the current group already has."""
        groups = []
        s1 = s2 = True          # force a new group at the first record
        for r in out:
            m1 = bool(r.flag & FLAG_MATE1)
            if not (r.flag & 0x100) and (s1 if m1 else s2):
                groups.append([])
                s1 = s2 = False
            if not (r.flag & 0x100):
                if m1:
                    s1 = True
                else:
                    s2 = True
            groups[-1].append((r.flag, r.line().encode() + suffix))
        assert len(groups) == n_pairs
        return groups

    def align_batch(self, pairs: Sequence[Tuple[SeqRecord, SeqRecord]]
                    ) -> List[SamAlignment]:
        return self.collect(self.submit(pairs))

    def align_pairs_fast(self, pairs, batch: int = 2048, depth: int = 3,
                         raw: bool = False) -> int:
        """Pipelined submit/collect over a whole corpus (bench helper)."""
        from collections import deque
        pend = deque()
        drain = self.collect_raw if raw else self.collect
        for k in range(0, len(pairs), batch):
            pend.append(self.submit(pairs[k:k + batch]))
            if len(pend) > depth:
                drain(pend.popleft())
        while pend:
            drain(pend.popleft())
        return len(pairs)

    @TRACE.traced("host_path")
    def align_batch_host(self, pairs: Sequence[Tuple[SeqRecord, SeqRecord]]
                         ) -> List[SamAlignment]:
        if not pairs:
            return []
        self.metrics.add(host_batches=1)
        pol = self.pol
        B = len(pairs)
        records = [p[0] for p in pairs] + [p[1] for p in pairs]
        cs = self._search_candidates(records, paired=True)
        ranked = self._rank_per_read(cs)

        # exact extents need backtrace of every ranked candidate
        all_ks = sorted({k for ks in ranked.values() for k in ks})
        if cs.pool is not None:
            tb_of = self._backtrace_sel(cs.pool, np.array(all_ks, np.int32))
            ext_lo = {k: int(cs.pool.win_start[k])
                      + tb_of[k][1]["ref_start_win"] for k in all_ks}
            ext_hi = {k: int(cs.end_pos[k]) for k in all_ks}
            scores = cs.pool.scores
        else:
            tb_of, ext_lo, ext_hi = {}, {}, {}
            scores = np.zeros(0, np.int64)

        # ---- pairing pass 1: cross products of per-mate candidates ----
        # Every concordant (k1, k2) classification; anchors that pair with
        # SOME valid opposite candidate are "successful attempts" for the
        # -D effort model below (the reference's mate-window DP would have
        # found that partner, aligner_sw_driver.cpp:2310).
        conc_raw: Dict[int, List[Tuple[int, int, int]]] = {}
        succ_cross: set = set()
        for i in range(B):
            l1 = ranked.get(i, [])
            l2 = ranked.get(B + i, [])
            combos = []
            for k1 in l1:
                for k2 in l2:
                    if cs.rid[k1] != cs.rid[k2]:
                        continue
                    typ = pe_classify(
                        pol.mate_fw_rc,
                        ext_lo[k1], ext_hi[k1], cs.cand_or[k1] == 0,
                        ext_lo[k2], ext_hi[k2], cs.cand_or[k2] == 0,
                        pol.minins, pol.maxins, pol.olap_ok, pol.contain_ok, pol.dovetail_ok)
                    if typ != PE_DISCORD:
                        combos.append((int(scores[k1] + scores[k2]), k1, k2))
                        succ_cross.add(k1)
                        succ_cross.add(k2)
            if combos:
                combos.sort(key=lambda c: -c[0])
                conc_raw[i] = combos

        # ---- -D fail-streak effort model (pe_effort.py) ----
        # seed-round suppression: mate with fewer exact-sweep elements
        # anchors first (bt2_search.cpp:3537-3541); if it instantiates no
        # N-free seeds (bt2_search.cpp:3948) OR its seed search finds no
        # SA ranges at all (:3968), the round's `break` skips the other
        # mate's seeding — and PE's halved round count (1 under -R 2)
        # means no seed phase for that mate at all
        B2 = 2 * B
        ee = cs.ee_elts[:B2] + cs.ee_elts[B2:]
        inst = cs.inst0[:B2] + cs.inst0[B2:]
        suppress = np.zeros(B2, bool)
        for i in range(B):
            if cs.filtered[i] or cs.filtered[B + i]:
                continue
            n1, n2_ = int(ee[i]), int(ee[B + i])
            first, second = ((B + i, i) if (n1 > 0 and n2_ > 0 and n1 > n2_)
                             else (i, B + i))
            if inst[first] == 0 or cs.seed_nz[first] == 0:
                suppress[second] = True
                suppress[first] = True
        eff = self._pe_effort_sets(cs, succ_cross, suppress)
        conc: Dict[int, List[Tuple[int, int, int]]] = {}
        for i, combos in conc_raw.items():
            kept = [c for c in combos
                    if c[1] in eff[i][1] or c[2] in eff[B + i][1]]
            if kept:
                conc[i] = kept

        def _eff_ranked(ri):
            return [k for k in ranked.get(ri, []) if k in eff[ri][0]]

        # ---- pass 2: mate rescue DP for pairs without a concordant combo ----
        rescue_specs = []   # (pair, anchor_k, opp_read_idx, opp_or, win_lo)
        for i in range(B):
            if i in conc:
                continue
            for mate, ri in ((0, i), (1, B + i)):
                lst = _eff_ranked(ri)
                if not lst:
                    continue
                ak = lst[0]
                wlo, whi, opp_fw = rescue_window(
                    pol.mate_fw_rc, ext_lo[ak], ext_hi[ak],
                    cs.cand_or[ak] == 0, mate == 0, pol.maxins)
                opp_ri = (B + i) if mate == 0 else i
                if cs.filtered[opp_ri] or cs.lens[opp_ri] == 0:
                    continue
                if _eff_ranked(opp_ri):
                    # opposite mate already aligned validly: no rescue
                    # (matches the reference's observed give-up behavior)
                    continue
                rescue_specs.append((i, ak, opp_ri, 0 if opp_fw else 1, wlo))

        rpool = None
        rtb = {}
        if cs.Lmax > LEN_BUCKETS[-1]:
            rescue_specs = []      # long reads: no rect-kernel mate rescue
        if rescue_specs:
            with TRACE.span("rescue"):
                Lmax = cs.Lmax
                Gr = max((pol.maxins + 32 - Lmax + 1) // 2,
                         pol.band_halfwidth(Lmax))
                r_read = np.array([s[2] for s in rescue_specs], np.int64)
                r_or = np.array([s[3] for s in rescue_specs], np.int64)
                r_wlo = np.array([s[4] for s in rescue_specs], np.int64)
                r_rid = np.searchsorted(
                    self.data.ref_cum,
                    np.array([ext_lo[s[1]] for s in rescue_specs]),
                    side="right") - 1
                rpool = self._run_dp(r_wlo, r_rid, r_read, r_or,
                                     cs.jboth, cs.jquals, cs.lens,
                                     Gr, Lmax, len(rescue_specs),
                                     full_width=True)
                r_valid = rpool.scores >= cs.minsc[r_read]
                rsel = np.nonzero(r_valid)[0].astype(np.int32)
                rtb = self._backtrace_sel(rpool, rsel)
                # classify each rescue result against its anchor
                for t in rsel.tolist():
                    (i, ak, opp_ri, opp_or, _) = rescue_specs[t]
                    if i in conc:
                        continue  # another rescue already made this pair CP
                    rlo = int(rpool.win_start[t]) + rtb[t][1]["ref_start_win"]
                    rhi = int(rpool.end_pos(np.array([t]))[0])
                    if opp_ri >= B:  # opposite is mate 2 → anchor is mate 1
                        typ = pe_classify(pol.mate_fw_rc,
                                          ext_lo[ak], ext_hi[ak],
                                          cs.cand_or[ak] == 0,
                                          rlo, rhi, opp_or == 0,
                                          pol.minins, pol.maxins, pol.olap_ok,
                                          pol.contain_ok, pol.dovetail_ok)
                    else:
                        typ = pe_classify(pol.mate_fw_rc,
                                          rlo, rhi, opp_or == 0,
                                          ext_lo[ak], ext_hi[ak],
                                          cs.cand_or[ak] == 0,
                                          pol.minins, pol.maxins, pol.olap_ok,
                                          pol.contain_ok, pol.dovetail_ok)
                    if typ != PE_DISCORD:
                        sc_sum = int(scores[ak] + rpool.scores[t])
                        conc.setdefault(i, []).append(
                            (sc_sum, ("r", ak, t, opp_ri, opp_or, rlo, rhi)))
                for i in list(conc.keys()):
                    conc[i].sort(key=lambda c: -c[0])

        # ---- emit ----
        with TRACE.span("host_emit"):
            st = AlignStats()
            out: List[SamAlignment] = []
            pending: list = []
            for i in range(B):
                rec1, rec2 = pairs[i]
                st.pairs += 1
                st.reads += 2
                l1 = _eff_ranked(i)
                l2 = _eff_ranked(B + i)

                def _xs_leg(lst, krep):
                    # best attempted alignment EXCLUDING the reported one
                    # (reference bestUnp1/2 — may outscore the pair choice)
                    for k in lst:
                        if k != krep:
                            return int(scores[k])
                    return None

                xs1 = _xs_leg(l1, l1[0] if l1 else -1)
                xs2 = _xs_leg(l2, l2[0] if l2 else -1)
                combos = conc.get(i)
                if combos:
                    sec_sum = combos[1][0] if len(combos) > 1 else None

                    def _unpack(combo):
                        if isinstance(combo[1], tuple):   # rescue pair
                            _, ak, t, opp_ri, opp_or, rlo, rhi = combo[1]
                            anchor = (ak, cs.pool, tb_of[ak],
                                      int(cs.cand_or[ak]), ext_lo[ak],
                                      ext_hi[ak])
                            resc = (t, rpool, rtb[t], opp_or, rlo, rhi)
                            return (anchor, resc) if opp_ri >= B \
                                else (resc, anchor)
                        _, k1, k2 = combo
                        return ((k1, cs.pool, tb_of[k1], int(cs.cand_or[k1]),
                                 ext_lo[k1], ext_hi[k1]),
                                (k2, cs.pool, tb_of[k2], int(cs.cand_or[k2]),
                                 ext_lo[k2], ext_hi[k2]))

                    def _rep_ks(combo):
                        if isinstance(combo[1], tuple):
                            _, ak, t, opp_ri, *_r = combo[1]
                            return (ak, -1) if opp_ri >= B else (-1, ak)
                        return combo[1], combo[2]

                    # -k/-a: up to khits ranked pairs; secondaries get 0x100 +
                    # MAPQ 255, the primary a real MAPQ only when a second-best
                    # pair exists (unique.h:202 k-mode convention)
                    kmode = pol.all_hits or pol.khits > 1
                    npairs = len(combos) if pol.all_hits \
                        else min(pol.khits, len(combos))
                    rank0_ok = False
                    # XS excludes the PRIMARY selection's slot; same value on
                    # every rank (selectByScore computes bestUnchosenP1/2 once
                    # from select[0], aln_sink.cpp)
                    kr1, kr2 = _rep_ks(combos[0])
                    xs1p, xs2p = _xs_leg(l1, kr1), _xs_leg(l2, kr2)
                    for r in range(npairs):
                        if r > 0 and not rank0_ok:
                            break
                        fmq = None
                        if kmode:
                            fmq = 255 if (r > 0 or sec_sum is None) else None
                        marg1, marg2 = _unpack(combos[r])
                        ok = self._emit_pair(st, out, cs, i, rec1, rec2,
                                             marg1, marg2,
                                             combos[r][0], sec_sum, "CP", True,
                                             xs1=xs1p, xs2=xs2p,
                                             secondary=r > 0, force_mq=fmq,
                                             pending=pending)
                        if r == 0:
                            rank0_ok = ok
                    if rank0_ok:
                        if len(combos) > 1:
                            st.conc_multi += 1
                        else:
                            st.conc_one += 1
                        continue
                # discordant: both mates aligned uniquely (any reference;
                # cross-chromosome pairs are discordant by construction)
                if not pol.no_discordant and len(l1) == 1 and len(l2) == 1:
                    k1, k2 = l1[0], l2[0]
                    ok = self._emit_pair(st, out, cs, i, rec1, rec2,
                                         (k1, cs.pool, tb_of[k1],
                                          int(cs.cand_or[k1]), ext_lo[k1],
                                          ext_hi[k1]),
                                         (k2, cs.pool, tb_of[k2],
                                          int(cs.cand_or[k2]), ext_lo[k2],
                                          ext_hi[k2]),
                                         int(scores[k1] + scores[k2]), None,
                                         "DP", False,
                                         force_mq=255 if (pol.all_hits or
                                                          pol.khits > 1)
                                         else None, pending=pending)
                    if ok:
                        st.disc += 1
                        continue
                # mixed / unaligned
                self._emit_mixed(st, out, cs, i, rec1, rec2, l1, l2, tb_of,
                                 pending)
            self._decode_pending(pending)
        self._merge_stats(st)
        return out

    # ------------------------------------------------------------------
    def _collect_fused(self, fpb: FusedPEBatch) -> List[SamAlignment]:
        """Decode the fused PE compact blob and dispatch.

        The dense pairing math (dedupe/rank, (pairs, T, T) concordance
        classification, -D fast-path effort, best-combo selection, rescue
        heads) ran ON DEVICE (ops/fused.py _pe_pairing); the fast path
        consumes its per-pair/per-read decisions directly and only runs
        rescue DP + emission on the host. The legacy host pairing remains
        for k/-a modes and for batches where any read needs the
        suppression 1mm-legality or non-fast -D replay (the device flags
        those via `hostneed`); it re-runs the full pairing from the
        per-slot export, byte-identical by construction."""
        dec = self._pe_decode(fpb)
        if dec is None:
            # DP budget overflow: rerun on the uncapped host path (rare)
            return self.align_batch_host(fpb.pairs)
        rf, pf, ee, snz, cif = dec
        if self._host_pairing(fpb, pf):
            return self._collect_fused_legacy(fpb, ee, snz, cif)
        return self._collect_fused_fast(fpb, rf, pf, cif)

    def _pe_decode(self, fpb: FusedPEBatch):
        """Pull + split the compact fused-PE blob. None on DP overflow
        (counted in `overflow_batches`, its dropped candidates in
        `overflow_dropped`)."""
        from bowtie2_tpu_torch.ops.fused import (PE_CI_FIELDS, PE_PAIR_FIELDS,
                                           PE_READ_FIELDS)
        B2, Bp, NC = fpb.B2, fpb.Bp, fpb.NC
        meta = _np(fpb.res.blob)
        rf = meta[:PE_READ_FIELDS * B2].reshape(PE_READ_FIELDS, B2)
        off = PE_READ_FIELDS * B2
        pf = meta[off:off + PE_PAIR_FIELDS * Bp].reshape(PE_PAIR_FIELDS, Bp)
        off += PE_PAIR_FIELDS * Bp
        ee = meta[off:off + B2]
        off += B2
        snz = meta[off:off + B2]
        off += B2
        cif = meta[off:off + PE_CI_FIELDS * NC].reshape(PE_CI_FIELDS, NC)
        off += PE_CI_FIELDS * NC
        n_dropped = int(meta[off])
        if n_dropped > 0:
            self.metrics.add(overflow_batches=1, overflow_dropped=n_dropped)
            return None
        return rf, pf, ee, snz, cif

    @TRACE.traced("repair_host")
    def _collect_fused_legacy(self, fpb: FusedPEBatch, ee, snz, cif
                              ) -> List[SamAlignment]:
        """Full host pairing from the per-slot export: pair candidates
        VECTORIZED, replay the -D effort model (fast path: any read whose
        per-phase candidate count fits under the streak limit attempts
        everything — the replay is only run for the rare reads that could
        actually give up), mate-rescue the rest, and emit.

        Semantics identical to align_batch_host (golden-tested); the
        per-pair Python cross-product loops of the legacy path
        (aligner_sw_driver.cpp:1680's per-read state machine analog) are
        replaced by (pairs, T, T) array classification."""
        from bowtie2_tpu_torch.pipeline.pe import pe_classify_np
        from bowtie2_tpu_torch.pipeline.pe_effort import (pe_streak_limit,
                                                    simulate_mate)
        pol = self.pol
        B, Bp, B2, T, NC = fpb.B, fpb.Bp, fpb.B2, fpb.T, fpb.NC
        self.metrics.add(repair_batches=1, repair_pairs=B)
        sf = _np(fpb.res.slots)
        large = self.idx.fw.large
        OCC = sf[0].astype(bool)
        AOK = sf[1].astype(bool)
        S = sf[2]
        OR = sf[3]
        RID = sf[4]
        LO = _u32pos(sf[5]) if large else sf[5].astype(np.int64)
        HI = _u32pos(sf[6]) if large else sf[6].astype(np.int64)
        RDEND = sf[7]
        EXACT = sf[8].astype(bool)
        HALF = sf[9].astype(bool)
        RANGEJ = sf[10]
        RWID = sf[11]
        CPOS = sf[12]
        MMUG = sf[13]
        ANCH = _u32pos(sf[14]) if large else sf[14].astype(np.int64)
        astart, ci_rid, ci_row, ci_lane, ci_score, ci_dplane = cif
        if large:
            astart = _u32pos(astart)

        pool = DPPool(G=fpb.G, Lmax=fpb.Lmax, n=NC,
                      win_start=astart.astype(np.int64),
                      rid=ci_rid.astype(np.int64),
                      scores=ci_score.astype(np.int64),
                      rows_end=ci_row, lanes_end=ci_lane,
                      dirs=fpb.res.dirs, jreads=fpb.res.jreads_c,
                      jquals=fpb.res.jquals_c, wins=fpb.res.wins,
                      dplane=ci_dplane)
        m = CPOS >= 0
        ci_or = np.zeros(NC, np.int64)
        ci_or[CPOS[m]] = OR[m]
        valid_ci = np.zeros(NC, bool)
        valid_ci[CPOS[m]] = AOK[m]
        cs = CandSet(B=B2, Lmax=fpb.Lmax, lens=fpb.lens, fw=fpb.fw,
                     qu=fpb.qu, rc=fpb.rc, qu_r=fpb.qu_r, minsc=fpb.minsc,
                     perfect=fpb.perfect, filtered=fpb.filtered, yf=fpb.yf,
                     n_cand=NC, cand_or=ci_or, rid=ci_rid.astype(np.int64),
                     valid=valid_ci,
                     end_pos=(astart + ci_lane).astype(np.int64), pool=pool)

        # ---- ranked representatives: dedupe by (orient, end) ----
        tj = np.arange(T)
        same = (OR[:, :, None] == OR[:, None, :]) & \
               (HI[:, :, None] == HI[:, None, :]) & \
               AOK[:, :, None] & AOK[:, None, :]
        bet = (S[:, None, :] > S[:, :, None]) | \
              ((S[:, None, :] == S[:, :, None]) &
               (tj[None, None, :] < tj[None, :, None]))
        rep = AOK & ~(same & bet).any(axis=2)
        rid_flat = np.repeat(np.arange(B2), T)
        order = np.lexsort((np.tile(tj, B2), (-S).reshape(-1),
                            (~rep).reshape(-1), rid_flat))
        ranked_slots = (order % T).reshape(B2, T)       # rank -> slot
        rankpos = np.empty((B2, T), np.int64)
        np.put_along_axis(rankpos, ranked_slots,
                          np.broadcast_to(tj, (B2, T)), axis=1)
        nrank = rep.sum(axis=1)

        # ---- concordant cross-products, vectorized (pairs, T, T) ----
        m1, m2 = slice(0, Bp), slice(Bp, B2)
        conc = (RID[m1][:, :, None] == RID[m2][:, None, :]) & \
            rep[m1][:, :, None] & rep[m2][:, None, :]
        from bowtie2_tpu_torch.pipeline.pe import PE_DISCORD as _PED
        typ = pe_classify_np(
            pol.mate_fw_rc,
            LO[m1][:, :, None], HI[m1][:, :, None],
            (OR[m1] == 0)[:, :, None],
            LO[m2][:, None, :], HI[m2][:, None, :],
            (OR[m2] == 0)[:, None, :],
            pol.minins, pol.maxins, pol.olap_ok, pol.contain_ok, pol.dovetail_ok)
        conc &= typ != _PED
        SUCC = np.concatenate([conc.any(axis=2), conc.any(axis=1)], axis=0)

        # ---- seed-round suppression (zero-seed-round `break` quirk) ----
        # The reference's PE rounds loop searches the mates in matemap
        # order and `break`s out of the loop — skipping the OTHER mate's
        # seed instantiation AND search — when the current mate either
        # instantiates no N-free seeds (bt2_search.cpp:3948) or its
        # searchAllSeeds finds no SA ranges at all (:3968). With PE's
        # halved round count (ceil(R/2) = 1 under -R 2) the skipped mate
        # never gets a seed round, so it can only align via the exact /
        # 1mm up-front phases or mate rescue. -R 3 gives PE a round 1,
        # which is exactly why the residual class aligns under -R 3.
        inst = fpb.inst_read
        n1e, n2e = ee[:Bp], ee[Bp:]
        swap = (n1e > 0) & (n2e > 0) & (n1e > n2e)
        inst_first = np.where(swap, inst[Bp:], inst[:Bp])
        snz_first = np.where(swap, snz[Bp:], snz[:Bp])
        both_ok = ~fpb.filtered[:Bp] & ~fpb.filtered[Bp:]
        supp_pair = both_ok & ((inst_first == 0) | (snz_first == 0))
        suppress = np.concatenate([supp_pair, supp_pair])

        # under suppression only exact-sweep hits and 1mm-upfront-
        # discoverable half candidates (ungapped anchor-diagonal mm <= 1)
        # survive; a half+seed dual-source candidate with 2+ mismatches
        # exists only through the blocked seed phase
        half_ok = HALF & np.where(suppress[:, None], MMUG <= 1, True)
        for ri in np.nonzero(suppress)[0]:
            # full oneMmSearch discoverability for the rare suppressed
            # rows: segment containment + --local mismatch-position
            # legality (aligner_seed.cpp:1231-1263)
            for k in np.nonzero(OCC[ri] & half_ok[ri] & ~EXACT[ri])[0]:
                ori = int(OR[ri, k])
                codes = (fpb.rc if ori else fpb.fw)[ri]
                quals = (fpb.qu_r if ori else fpb.qu)[ri]
                if not self._mm1_upfront_ok(codes, quals,
                                            int(fpb.lens[ri]),
                                            int(ANCH[ri, k])):
                    half_ok[ri, k] = False

        # ---- -D fail-streak effort (pe_effort.py), vectorized fast path ----
        nex = (OCC & EXACT).sum(axis=1)
        nhf = (OCC & half_ok & ~EXACT).sum(axis=1)
        nsd = (OCC & ~EXACT & ~HALF).sum(axis=1)
        ATT = OCC & np.where(suppress[:, None], EXACT | half_ok, True)
        SUC = ATT & SUCC
        if not pol.all_hits:
            limit = pe_streak_limit(pol.fail_streak, pol.khits, True)
            fast = (nex <= limit) & (nhf <= limit) & \
                np.where(suppress, True, nsd <= limit)
            for ri in np.nonzero(~fast)[0]:
                ks = np.nonzero(OCC[ri])[0]
                exact_l = [int(k) for k in ks if EXACT[ri, k]]
                half_l = [int(k) for k in ks
                          if half_ok[ri, k] and not EXACT[ri, k]]
                seed_l = [] if suppress[ri] else \
                    [int(k) for k in ks
                     if not EXACT[ri, k] and not HALF[ri, k]]
                att, suc = simulate_mate(
                    [exact_l, half_l, seed_l], RANGEJ[ri], RWID[ri],
                    set(np.nonzero(SUCC[ri])[0].tolist()),
                    set(np.nonzero(AOK[ri])[0].tolist()), limit)
                ATT[ri] = False
                ATT[ri, list(att)] = True
                SUC[ri] = False
                SUC[ri, list(suc)] = True

        # ---- best concordant combo per pair ----
        keep = conc & (SUC[m1][:, :, None] | SUC[m2][:, None, :])
        SS = S[m1].astype(np.int64)[:, :, None] + \
            S[m2].astype(np.int64)[:, None, :]
        # ordering = legacy stable sort: score desc, then enumeration order
        # (mate-1 rank asc, mate-2 rank asc)
        key = (SS << 20) - (rankpos[m1][:, :, None] << 10) - \
            rankpos[m2][:, None, :]
        key = np.where(keep, key, np.int64(-(1 << 62)))
        flatk = key.reshape(Bp, T * T)
        bestflat = flatk.argmax(axis=1)
        arangeBp = np.arange(Bp)
        has = keep.reshape(Bp, -1).any(axis=1)
        best_s1 = bestflat // T
        best_s2 = bestflat % T
        best_ss = SS.reshape(Bp, -1)[arangeBp, bestflat]
        n_kept = keep.reshape(Bp, -1).sum(axis=1)
        flatk2 = flatk.copy()
        flatk2[arangeBp, bestflat] = -(1 << 62)
        secflat = flatk2.argmax(axis=1)
        sec_ss = SS.reshape(Bp, -1)[arangeBp, secflat]

        # ---- eff-ranked heads (rescue anchors / discordant / mixed) ----
        BIGR = 1 << 30
        att_rank = np.where(rep & ATT, rankpos, BIGR)
        first_rank = att_rank.min(axis=1)
        first_slot = att_rank.argmin(axis=1)
        has_l = first_rank < BIGR
        att_rank2 = att_rank.copy()
        att_rank2[np.arange(B2), first_slot] = BIGR
        sec_rank = att_rank2.min(axis=1)
        sec_slot = att_rank2.argmin(axis=1)
        has_l2 = sec_rank < BIGR
        nL = (rep & ATT).sum(axis=1)

        # ---- mate rescue DP for pairs without a concordant combo ----
        real = np.arange(B)
        rescue_specs = []
        for i in real[~has[:B]]:
            for mate, ri in ((0, i), (1, Bp + i)):
                if not has_l[ri]:
                    continue
                ak_s = first_slot[ri]
                wlo, whi, opp_fw = rescue_window(
                    pol.mate_fw_rc, int(LO[ri, ak_s]), int(HI[ri, ak_s]),
                    OR[ri, ak_s] == 0, mate == 0, pol.maxins)
                opp_ri = (Bp + i) if mate == 0 else i
                if fpb.filtered[opp_ri] or fpb.lens[opp_ri] == 0:
                    continue
                if has_l[opp_ri]:
                    # opposite mate already has a valid alignment: the
                    # reference does not rescue-replace it with a worse
                    # squeezed-into-the-fragment alignment (observed: its
                    # mate DP never yields a concordant pair in this
                    # situation — the r1105-class give-ups)
                    continue
                rescue_specs.append((int(i), ri, int(ak_s), opp_ri,
                                     0 if opp_fw else 1, wlo))
        rpool = None
        rtb = {}
        rconc = {}       # pair -> ("r", ak_ci, t, opp_ri, opp_or, rlo, rhi,
                         #          sc_sum)
        rdisc = {}       # pair -> same payload, rescue pair classified
                         # DISCORDANT: the reference still reports both
                         # mates as unpaired alignments (msink->report with
                         # one NULL side, aligner_sw_driver.cpp:2417-2445),
                         # so a unique anchor + unique rescued mate emit as
                         # a discordant pair at finishRead
        if rescue_specs:
            with TRACE.span("rescue"):
                Lmax = fpb.Lmax
                Gr = max((pol.maxins + 32 - Lmax + 1) // 2,
                         pol.band_halfwidth(Lmax))
                r_read = np.array([s[3] for s in rescue_specs], np.int64)
                r_or = np.array([s[4] for s in rescue_specs], np.int64)
                r_wlo = np.array([s[5] for s in rescue_specs], np.int64)
                r_rid = np.searchsorted(
                    self.data.ref_cum,
                    np.array([int(LO[s[1], s[2]]) for s in rescue_specs]),
                    side="right") - 1
                self.metrics.add(mate_dps=len(rescue_specs))
                rpool = self._run_dp(r_wlo, r_rid, r_read, r_or,
                                     fpb.jboth, fpb.jquals, fpb.lens,
                                     Gr, Lmax, len(rescue_specs),
                                     full_width=True)
                r_valid = rpool.scores >= fpb.minsc[r_read]
                rsel = np.nonzero(r_valid)[0].astype(np.int32)
                rtb = self._backtrace_sel(rpool, rsel)
                for t in rsel.tolist():
                    (i, ari, ak_s, opp_ri, opp_or, _) = rescue_specs[t]
                    if i in rconc:
                        continue
                    rlo = int(rpool.win_start[t]) + rtb[t][1]["ref_start_win"]
                    rhi = int(rpool.end_pos(np.array([t]))[0])
                    alo, ahi = int(LO[ari, ak_s]), int(HI[ari, ak_s])
                    afw = OR[ari, ak_s] == 0
                    # opposite is mate 2 → anchor is mate 1
                    if opp_ri >= Bp:
                        typr = pe_classify(pol.mate_fw_rc, alo, ahi, afw,
                                           rlo, rhi, opp_or == 0,
                                           pol.minins, pol.maxins, pol.olap_ok,
                                           pol.contain_ok, pol.dovetail_ok)
                    else:
                        typr = pe_classify(pol.mate_fw_rc, rlo, rhi,
                                           opp_or == 0, alo, ahi, afw,
                                           pol.minins, pol.maxins, pol.olap_ok,
                                           pol.contain_ok, pol.dovetail_ok)
                    sc_sum = int(S[ari, ak_s]) + int(rpool.scores[t])
                    payload = ("r", int(CPOS[ari, ak_s]), t, opp_ri,
                               opp_or, rlo, rhi, sc_sum, ari, int(ak_s))
                    if typr != PE_DISCORD:
                        rconc[i] = payload
                    elif i not in rdisc:
                        rdisc[i] = payload

        # ---- ranked combo list per pair (top-k; default k=1 keeps the
        # vectorized argmax result, no per-pair argsort) ----
        khits_pe = 10**9 if pol.all_hits else max(pol.khits, 1)
        combo_of = {}
        for i in real[has[:B]]:
            if khits_pe > 1 and n_kept[i] > 1:
                fl = flatk[i]
                kk = min(khits_pe, int(n_kept[i]))
                ordk = np.argsort(-fl, kind="stable")[:kk]
                combo_of[i] = [(int(o) // T, int(o) % T) for o in ordk]
            else:
                combo_of[i] = [(int(best_s1[i]), int(best_s2[i]))]

        # ---- emission backtrace of everything reported ----
        need = set()
        for i in real[has[:B]]:
            for s1c, s2c in combo_of[i]:
                need.add(int(CPOS[i, s1c]))
                need.add(int(CPOS[Bp + i, s2c]))
        for i, rc_ in list(rconc.items()) + list(rdisc.items()):
            need.add(rc_[1])
        for i in real:
            if has[i] or i in rconc:
                continue
            for ri in (i, Bp + i):
                if has_l[ri]:
                    need.add(int(CPOS[ri, first_slot[ri]]))
        sel = np.array(sorted(need), np.int32)
        tb_of = {}
        if sel.size and not pol.local:
            # host gapless fast path: candidates whose score equals the
            # pure-diagonal score synthesize CIGAR/MD from the host ref
            # words, skipping the device backtrace round trip
            cand_read = np.zeros(NC, np.int64)
            cand_read[CPOS[m]] = np.broadcast_to(
                np.arange(B2)[:, None], (B2, T))[m]
            ri_s = cand_read[sel]
            or_s = ci_or[sel]
            codes_sel = np.where((or_s == 0)[:, None],
                                 fpb.fw[ri_s], fpb.rc[ri_s])
            quals_sel = np.where((or_s == 0)[:, None],
                                 fpb.qu[ri_s], fpb.qu_r[ri_s])
            tb_of, sel = self._gapless_tb(
                pool, sel, codes_sel, quals_sel, fpb.lens[ri_s],
                cs.end_pos[sel])
            sel = np.asarray(sel, np.int32)
        if sel.size:
            tb_of.update(self._walk_fused(pool, sel))

        # ---- per-pair emission ----
        st = AlignStats()
        out: List[SamAlignment] = []
        scores = pool.scores
        def _xs_for(ri, srep):
            """Best attempted alignment of mate ri EXCLUDING the reported
            slot (reference AlnSetSumm bestUnp1/2: XS is the best OTHER
            alignment, which may outscore the pair-chosen one)."""
            fs = int(first_slot[ri])
            if has_l[ri] and fs != srep:
                return int(S[ri, fs])
            ss = int(sec_slot[ri])
            if has_l2[ri] and ss != srep:
                return int(S[ri, ss])
            return None

        for i in range(B):
            rec1, rec2 = fpb.pairs[i]
            st.pairs += 1
            st.reads += 2
            emitted = False
            xs1 = _xs_for(i, int(first_slot[i]))
            xs2 = _xs_for(Bp + i, int(first_slot[Bp + i]))
            if has[i]:
                sec_sum = int(sec_ss[i]) if n_kept[i] > 1 else None
                kmode = pol.all_hits or pol.khits > 1
                rank0_ok = False
                # XS excludes the PRIMARY selection's coordinate and the
                # same value prints on every rank (selectByScore computes
                # bestUnchosenP1/2 once from select[0], aln_sink.cpp)
                s1_0, s2_0 = combo_of[i][0]
                xs1p = _xs_for(i, int(s1_0))
                xs2p = _xs_for(Bp + i, int(s2_0))
                for r, (s1, s2) in enumerate(combo_of[i]):
                    if r > 0 and not rank0_ok:
                        break
                    k1 = int(CPOS[i, s1])
                    k2 = int(CPOS[Bp + i, s2])
                    fmq = None
                    if kmode:
                        fmq = 255 if (r > 0 or sec_sum is None) else None
                    sc_sum_r = int(S[i, s1]) + int(S[Bp + i, s2])
                    ok = self._emit_pair(
                        st, out, cs, i, rec1, rec2,
                        (k1, pool, tb_of[k1], int(OR[i, s1]),
                         int(LO[i, s1]), int(HI[i, s1])),
                        (k2, pool, tb_of[k2], int(OR[Bp + i, s2]),
                         int(LO[Bp + i, s2]), int(HI[Bp + i, s2])),
                        sc_sum_r, sec_sum, "CP", True,
                        xs1=xs1p, xs2=xs2p,
                        secondary=r > 0, force_mq=fmq)
                    if r == 0:
                        rank0_ok = ok
                if rank0_ok:
                    if n_kept[i] > 1:
                        st.conc_multi += 1
                    else:
                        st.conc_one += 1
                    continue
                emitted = False
            elif i in rconc:
                (_, ak_ci, t, opp_ri, opp_or, rlo, rhi, sc_sum, ari,
                 ak_s) = rconc[i]
                if opp_ri >= Bp:
                    marg1 = (ak_ci, pool, tb_of[ak_ci], int(OR[ari, ak_s]),
                             int(LO[ari, ak_s]), int(HI[ari, ak_s]))
                    marg2 = (t, rpool, rtb[t], opp_or, rlo, rhi)
                else:
                    marg1 = (t, rpool, rtb[t], opp_or, rlo, rhi)
                    marg2 = (ak_ci, pool, tb_of[ak_ci], int(OR[ari, ak_s]),
                             int(LO[ari, ak_s]), int(HI[ari, ak_s]))
                kmode = pol.all_hits or pol.khits > 1
                ok = self._emit_pair(st, out, cs, i, rec1, rec2,
                                     marg1, marg2, sc_sum, None, "CP", True,
                                     xs1=xs1, xs2=xs2,
                                     force_mq=255 if kmode else None)
                if ok:
                    st.conc_one += 1
                    continue
            # discordant: both mates aligned uniquely (any reference)
            ri1, ri2 = i, Bp + i
            if not pol.no_discordant and nL[ri1] == 1 and nL[ri2] == 1:
                s1, s2 = int(first_slot[ri1]), int(first_slot[ri2])
                k1, k2 = int(CPOS[ri1, s1]), int(CPOS[ri2, s2])
                ok = self._emit_pair(
                    st, out, cs, i, rec1, rec2,
                    (k1, pool, tb_of[k1], int(OR[ri1, s1]),
                     int(LO[ri1, s1]), int(HI[ri1, s1])),
                    (k2, pool, tb_of[k2], int(OR[ri2, s2]),
                     int(LO[ri2, s2]), int(HI[ri2, s2])),
                    int(S[ri1, s1]) + int(S[ri2, s2]), None, "DP", False,
                    force_mq=255 if (pol.all_hits or pol.khits > 1)
                    else None)
                if ok:
                    st.disc += 1
                    continue
            # discordant with a rescue-found mate: the reference reports
            # rescue results as UNPAIRED alignments even when the rescued
            # pair is discordant (aligner_sw_driver.cpp:2417-2445), so a
            # unique anchor + a rescued opposite mate with no alignments
            # of its own pair up as YT:Z:DP at finishRead
            if not pol.no_discordant and i in rdisc:
                (_, ak_ci, t, opp_ri, opp_or, rlo, rhi, sc_sum, ari,
                 ak_s) = rdisc[i]
                if nL[ari] == 1 and nL[opp_ri] == 0:
                    aarg = (ak_ci, pool, tb_of[ak_ci], int(OR[ari, ak_s]),
                            int(LO[ari, ak_s]), int(HI[ari, ak_s]))
                    rarg = (t, rpool, rtb[t], opp_or, rlo, rhi)
                    marg1, marg2 = ((aarg, rarg) if opp_ri >= Bp
                                    else (rarg, aarg))
                    ok = self._emit_pair(
                        st, out, cs, i, rec1, rec2, marg1, marg2,
                        sc_sum, None, "DP", False,
                        force_mq=255 if (pol.all_hits or pol.khits > 1)
                        else None)
                    if ok:
                        st.disc += 1
                        continue
            # mixed / unaligned
            l1 = [int(CPOS[ri1, first_slot[ri1]])] if has_l[ri1] else []
            if has_l2[ri1]:
                l1.append(int(CPOS[ri1, sec_slot[ri1]]))
            l2 = [int(CPOS[ri2, first_slot[ri2]])] if has_l[ri2] else []
            if has_l2[ri2]:
                l2.append(int(CPOS[ri2, sec_slot[ri2]]))
            self._emit_mixed(st, out, cs, i, rec1, rec2, l1, l2, tb_of)
        self._merge_stats(st)
        return out

    def _pe_fast_prep(self, fpb: FusedPEBatch, rf, pf, cif):
        """Shared decode + rescue for the fast path: unpack the device
        pairing decisions, reconstruct the DP pool and run mate-rescue DP
        for conc-less pairs. Returns a namespace consumed by the object
        (_collect_fused_fast) and native-line (_collect_fused_fast_raw)
        emitters."""
        from types import SimpleNamespace
        pol = self.pol
        B, Bp, B2, T, NC = fpb.B, fpb.Bp, fpb.B2, fpb.T, fpb.NC
        large = self.idx.fw.large
        (r_fc, r_fo, r_flo32, r_fhi32, r_fs, r_hasl,
         r_sc, r_ss, r_hasl2, r_nl) = rf
        r_flo = _u32pos(r_flo32) if large else r_flo32.astype(np.int64)
        r_fhi = _u32pos(r_fhi32) if large else r_fhi32.astype(np.int64)
        (p_has, b1c, b1o, b1lo32, b1hi32, b1s,
         b2c, b2o, b2lo32, b2hi32, b2s, p_bss, p_sss, p_nk, _hn) = pf
        b1lo = _u32pos(b1lo32) if large else b1lo32.astype(np.int64)
        b1hi = _u32pos(b1hi32) if large else b1hi32.astype(np.int64)
        b2lo = _u32pos(b2lo32) if large else b2lo32.astype(np.int64)
        b2hi = _u32pos(b2hi32) if large else b2hi32.astype(np.int64)
        astart, ci_rid, ci_row, ci_lane, ci_score, ci_dplane = cif
        if large:
            astart = _u32pos(astart)

        pool = DPPool(G=fpb.G, Lmax=fpb.Lmax, n=NC,
                      win_start=astart.astype(np.int64),
                      rid=ci_rid.astype(np.int64),
                      scores=ci_score.astype(np.int64),
                      rows_end=ci_row, lanes_end=ci_lane,
                      dirs=fpb.res.dirs, jreads=fpb.res.jreads_c,
                      jquals=fpb.res.jquals_c, wins=fpb.res.wins,
                      dplane=ci_dplane)
        # sparse candidate attributes (only emitted candidates are read)
        ci_or = np.zeros(NC, np.int64)
        cand_read = np.zeros(NC, np.int64)
        mm = (r_fc >= 0) & (r_hasl != 0)
        ci_or[r_fc[mm]] = r_fo[mm]
        cand_read[r_fc[mm]] = np.arange(B2)[mm]
        mb = (b1c >= 0) & (p_has != 0)
        ci_or[b1c[mb]] = b1o[mb]
        cand_read[b1c[mb]] = np.arange(Bp)[mb]
        mb = (b2c >= 0) & (p_has != 0)
        ci_or[b2c[mb]] = b2o[mb]
        cand_read[b2c[mb]] = Bp + np.arange(Bp)[mb]
        cs = CandSet(B=B2, Lmax=fpb.Lmax, lens=fpb.lens, fw=fpb.fw,
                     qu=fpb.qu, rc=fpb.rc, qu_r=fpb.qu_r, minsc=fpb.minsc,
                     perfect=fpb.perfect, filtered=fpb.filtered, yf=fpb.yf,
                     n_cand=NC, cand_or=ci_or, rid=ci_rid.astype(np.int64),
                     valid=np.zeros(NC, bool),
                     end_pos=(astart + ci_lane).astype(np.int64), pool=pool)

        has = p_has.astype(bool)
        real = np.arange(B)

        # ---- mate rescue DP for pairs without a concordant combo ----
        rescue_specs = []
        for i in real[~has[:B]]:
            for mate, ri in ((0, i), (1, Bp + i)):
                if not r_hasl[ri]:
                    continue
                wlo, whi, opp_fw = rescue_window(
                    pol.mate_fw_rc, int(r_flo[ri]), int(r_fhi[ri]),
                    r_fo[ri] == 0, mate == 0, pol.maxins)
                opp_ri = (Bp + i) if mate == 0 else i
                if fpb.filtered[opp_ri] or fpb.lens[opp_ri] == 0:
                    continue
                if r_hasl[opp_ri]:
                    # opposite mate already has a valid alignment: the
                    # reference never rescue-replaces it (r1105 class)
                    continue
                rescue_specs.append((int(i), ri, opp_ri,
                                     0 if opp_fw else 1, wlo))
        rpool = None
        rtb = {}
        rconc = {}
        rdisc = {}
        if rescue_specs:
            with TRACE.span("rescue"):
                Lmax = fpb.Lmax
                Gr = max((pol.maxins + 32 - Lmax + 1) // 2,
                         pol.band_halfwidth(Lmax))
                r_read = np.array([s[2] for s in rescue_specs], np.int64)
                r_or = np.array([s[3] for s in rescue_specs], np.int64)
                r_wlo = np.array([s[4] for s in rescue_specs], np.int64)
                r_rid = np.searchsorted(
                    self.data.ref_cum,
                    np.array([int(r_flo[s[1]]) for s in rescue_specs]),
                    side="right") - 1
                self.metrics.add(mate_dps=len(rescue_specs))
                rpool = self._run_dp(r_wlo, r_rid, r_read, r_or,
                                     fpb.jboth, fpb.jquals, fpb.lens,
                                     Gr, Lmax, len(rescue_specs),
                                     full_width=True)
                r_valid = rpool.scores >= fpb.minsc[r_read]
                rsel = np.nonzero(r_valid)[0].astype(np.int32)
                rtb = self._backtrace_sel(rpool, rsel)
                for t in rsel.tolist():
                    (i, ari, opp_ri, opp_or, _) = rescue_specs[t]
                    if i in rconc:
                        continue
                    rlo = int(rpool.win_start[t]) + rtb[t][1]["ref_start_win"]
                    rhi = int(rpool.end_pos(np.array([t]))[0])
                    alo, ahi = int(r_flo[ari]), int(r_fhi[ari])
                    afw = r_fo[ari] == 0
                    # opposite is mate 2 → anchor is mate 1
                    if opp_ri >= Bp:
                        typr = pe_classify(pol.mate_fw_rc, alo, ahi, afw,
                                           rlo, rhi, opp_or == 0,
                                           pol.minins, pol.maxins, pol.olap_ok,
                                           pol.contain_ok, pol.dovetail_ok)
                    else:
                        typr = pe_classify(pol.mate_fw_rc, rlo, rhi,
                                           opp_or == 0, alo, ahi, afw,
                                           pol.minins, pol.maxins, pol.olap_ok,
                                           pol.contain_ok, pol.dovetail_ok)
                    sc_sum = int(r_fs[ari]) + int(rpool.scores[t])
                    payload = ("r", int(r_fc[ari]), t, opp_ri, opp_or, rlo,
                               rhi, sc_sum, ari)
                    if typr != PE_DISCORD:
                        rconc[i] = payload
                    elif i not in rdisc:
                        rdisc[i] = payload

        return SimpleNamespace(
            fpb=fpb, pool=pool, cs=cs, cand_read=cand_read, ci_or=ci_or,
            has=has, real=real, rpool=rpool, rtb=rtb, rconc=rconc,
            rdisc=rdisc, r_fc=r_fc, r_fo=r_fo, r_flo=r_flo, r_fhi=r_fhi,
            r_fs=r_fs, r_hasl=r_hasl, r_sc=r_sc, r_ss=r_ss,
            r_hasl2=r_hasl2, r_nl=r_nl, b1c=b1c, b1o=b1o, b1lo=b1lo,
            b1hi=b1hi, b1s=b1s, b2c=b2c, b2o=b2o, b2lo=b2lo, b2hi=b2hi,
            b2s=b2s, p_sss=p_sss, p_nk=p_nk)

    def _xs_fast(self, ns, ri, srep_cpos):
        """Best attempted alignment of mate ri EXCLUDING the reported
        candidate (reference AlnSetSumm bestUnp1/2)."""
        if ns.r_hasl[ri] and int(ns.r_fc[ri]) != srep_cpos:
            return int(ns.r_fs[ri])
        if ns.r_hasl2[ri] and int(ns.r_sc[ri]) != srep_cpos:
            return int(ns.r_ss[ri])
        return None

    def _emit_fast_pair(self, ns, i, st, out, tb_of):
        """Emit one pair from the device decisions (object records).
        Mirrors _collect_fused_legacy's default-mode emission order."""
        fpb = ns.fpb
        pol = self.pol
        Bp = fpb.Bp
        pool, cs, rpool, rtb = ns.pool, ns.cs, ns.rpool, ns.rtb
        rec1, rec2 = fpb.pairs[i]
        st.pairs += 1
        st.reads += 2
        ri1, ri2 = i, Bp + i
        xs1 = self._xs_fast(ns, ri1, int(ns.r_fc[ri1]))
        xs2 = self._xs_fast(ns, ri2, int(ns.r_fc[ri2]))
        if ns.has[i]:
            sec_sum = int(ns.p_sss[i]) if ns.p_nk[i] > 1 else None
            k1, k2 = int(ns.b1c[i]), int(ns.b2c[i])
            ok = self._emit_pair(
                st, out, cs, i, rec1, rec2,
                (k1, pool, tb_of[k1], int(ns.b1o[i]),
                 int(ns.b1lo[i]), int(ns.b1hi[i])),
                (k2, pool, tb_of[k2], int(ns.b2o[i]),
                 int(ns.b2lo[i]), int(ns.b2hi[i])),
                int(ns.b1s[i]) + int(ns.b2s[i]), sec_sum, "CP", True,
                xs1=self._xs_fast(ns, ri1, k1),
                xs2=self._xs_fast(ns, ri2, k2))
            if ok:
                if ns.p_nk[i] > 1:
                    st.conc_multi += 1
                else:
                    st.conc_one += 1
                return
        elif i in ns.rconc:
            (_, ak_ci, t, opp_ri, opp_or, rlo, rhi, sc_sum,
             ari) = ns.rconc[i]
            aarg = (ak_ci, pool, tb_of[ak_ci], int(ns.r_fo[ari]),
                    int(ns.r_flo[ari]), int(ns.r_fhi[ari]))
            rarg = (t, rpool, rtb[t], opp_or, rlo, rhi)
            marg1, marg2 = ((aarg, rarg) if opp_ri >= Bp
                            else (rarg, aarg))
            ok = self._emit_pair(st, out, cs, i, rec1, rec2,
                                 marg1, marg2, sc_sum, None, "CP", True,
                                 xs1=xs1, xs2=xs2)
            if ok:
                st.conc_one += 1
                return
        # discordant: both mates aligned uniquely (any reference)
        if not pol.no_discordant and ns.r_nl[ri1] == 1 and ns.r_nl[ri2] == 1:
            k1, k2 = int(ns.r_fc[ri1]), int(ns.r_fc[ri2])
            ok = self._emit_pair(
                st, out, cs, i, rec1, rec2,
                (k1, pool, tb_of[k1], int(ns.r_fo[ri1]),
                 int(ns.r_flo[ri1]), int(ns.r_fhi[ri1])),
                (k2, pool, tb_of[k2], int(ns.r_fo[ri2]),
                 int(ns.r_flo[ri2]), int(ns.r_fhi[ri2])),
                int(ns.r_fs[ri1]) + int(ns.r_fs[ri2]), None, "DP", False)
            if ok:
                st.disc += 1
                return
        # discordant with a rescue-found mate (YT:Z:DP at finishRead)
        if not pol.no_discordant and i in ns.rdisc:
            (_, ak_ci, t, opp_ri, opp_or, rlo, rhi, sc_sum,
             ari) = ns.rdisc[i]
            if ns.r_nl[ari] == 1 and ns.r_nl[opp_ri] == 0:
                aarg = (ak_ci, pool, tb_of[ak_ci], int(ns.r_fo[ari]),
                        int(ns.r_flo[ari]), int(ns.r_fhi[ari]))
                rarg = (t, rpool, rtb[t], opp_or, rlo, rhi)
                marg1, marg2 = ((aarg, rarg) if opp_ri >= Bp
                                else (rarg, aarg))
                ok = self._emit_pair(
                    st, out, cs, i, rec1, rec2, marg1, marg2,
                    sc_sum, None, "DP", False)
                if ok:
                    st.disc += 1
                    return
        # mixed / unaligned
        l1 = [int(ns.r_fc[ri1])] if ns.r_hasl[ri1] else []
        if ns.r_hasl2[ri1]:
            l1.append(int(ns.r_sc[ri1]))
        l2 = [int(ns.r_fc[ri2])] if ns.r_hasl[ri2] else []
        if ns.r_hasl2[ri2]:
            l2.append(int(ns.r_sc[ri2]))
        self._emit_mixed(st, out, cs, i, rec1, rec2, l1, l2, tb_of)

    def _fast_need(self, ns, pairs_iter):
        """Emission-backtrace candidate set for the given pairs."""
        need = set()
        Bp = ns.fpb.Bp
        for i in pairs_iter:
            if ns.has[i]:
                need.add(int(ns.b1c[i]))
                need.add(int(ns.b2c[i]))
                continue
            if i in ns.rconc:
                need.add(ns.rconc[i][1])
                continue
            if i in ns.rdisc:
                need.add(ns.rdisc[i][1])
            for ri in (i, Bp + i):
                if ns.r_hasl[ri]:
                    need.add(int(ns.r_fc[ri]))
        return need

    def _walk_fused(self, pool, sel):
        """_backtrace_sel for a fused path's chosen candidates, counted in
        `bt_walks` (every chosen slot in local mode, the gapped rest end
        to end)."""
        self.metrics.add(bt_walks=int(sel.size))
        return self._backtrace_sel(pool, sel)

    def _fast_tb(self, ns, need):
        """tb dict for the `need` candidates (gapless host synthesis +
        device backtrace for the rest)."""
        fpb, pool, cs = ns.fpb, ns.pool, ns.cs
        sel = np.array(sorted(need), np.int32)
        tb_of = {}
        if sel.size and not self.pol.local:
            ri_s = ns.cand_read[sel]
            or_s = ns.ci_or[sel]
            codes_sel = np.where((or_s == 0)[:, None],
                                 fpb.fw[ri_s], fpb.rc[ri_s])
            quals_sel = np.where((or_s == 0)[:, None],
                                 fpb.qu[ri_s], fpb.qu_r[ri_s])
            tb_of, sel = self._gapless_tb(
                pool, sel, codes_sel, quals_sel, fpb.lens[ri_s],
                cs.end_pos[sel])
            sel = np.asarray(sel, np.int32)
        if sel.size:
            tb_of.update(self._walk_fused(pool, sel))
        return tb_of

    def _collect_fused_fast(self, fpb: FusedPEBatch, rf, pf, cif
                            ) -> List[SamAlignment]:
        """Emit straight from the device pairing decisions (the common
        path): per-pair best concordant combo + per-read eff-ranked heads
        arrive in the compact blob, so the host only runs mate-rescue DP
        for conc-less pairs, the emission backtrace, and record building.
        Byte-identical to _collect_fused_legacy (same decision math,
        mirrored on device in ops/fused.py _pe_pairing; cross-checked by
        tests/test_pe_devpair.py and the golden corpora)."""
        ns = self._pe_fast_prep(fpb, rf, pf, cif)
        tb_of = self._fast_tb(ns, self._fast_need(ns, range(fpb.B)))
        st = AlignStats()
        out: List[SamAlignment] = []
        for i in range(fpb.B):
            self._emit_fast_pair(ns, i, st, out, tb_of)
        self._merge_stats(st)
        return out

    @TRACE.traced("emit_fast")
    def _collect_fused_fast_raw(self, fpb: FusedPEBatch, rf, pf, cif,
                                suffix: bytes
                                ) -> List[List[Tuple[int, bytes]]]:
        """_collect_fused_fast, emitting finished SAM line bytes via the
        native PE line builder (native/samemit.c sam_tails_pe): concordant
        pairs — the overwhelming majority — are built fully VECTORIZED
        (flags/positions/TLEN/XS as arrays, CIGAR/MD decoded in C from
        device-backtrace or host-synthesized gapless op columns); only
        rescue/discordant/mixed pairs and score-check failures take the
        per-pair object path. Returns one [(flag, line bytes)] group per
        pair."""
        from bowtie2_tpu_torch.native.samemit import (RefNameTable, XS_OMIT,
                                                sam_tails_pe_batch)
        pol = self.pol
        B, Bp = fpb.B, fpb.Bp
        ns = self._pe_fast_prep(fpb, rf, pf, cif)
        pool = ns.pool

        # ---- candidate decode: gapless synthesis + device backtrace ----
        vec0 = ns.real[ns.has[:B]]                    # candidate vec pairs
        need_vec = set()
        for i in vec0:
            need_vec.add(int(ns.b1c[i]))
            need_vec.add(int(ns.b2c[i]))
        sel = np.array(sorted(need_vec), np.int32)
        nsel = sel.size
        selidx = {int(k): t for t, k in enumerate(sel.tolist())}
        # per-candidate scalar fields, filled from both sources
        c_rdstart = np.zeros(nsel, np.int32)
        c_refwin = np.zeros(nsel, np.int64)
        c_nmm = np.zeros(nsel, np.int32)
        c_ngo = np.zeros(nsel, np.int32)
        c_ngc = np.zeros(nsel, np.int32)
        c_nrefn = np.zeros(nsel, np.int32)
        c_scchk = np.full(nsel, -(1 << 60), np.int64)
        Lsel = fpb.lens[ns.cand_read[sel]] if nsel else np.zeros(0, np.int64)
        or_s = ns.ci_or[sel]
        ri_s = ns.cand_read[sel]
        codes_sel = np.where((or_s == 0)[:, None],
                             fpb.fw[ri_s], fpb.rc[ri_s]) \
            if nsel else np.zeros((0, fpb.Lmax), np.int8)
        ops_cols = np.full(nsel, 0, np.int32)
        S_walk = 1
        ops_mat = np.zeros((1, max(nsel, 1)), np.uint8)
        if nsel:
            quals_sel = np.where((or_s == 0)[:, None],
                                 fpb.qu[ri_s], fpb.qu_r[ri_s])
            if not pol.local:
                okg, ops_syn, refwin_g, nmm_g, nrefn_g = self._gapless_tb_raw(
                    pool, sel, codes_sel, quals_sel, Lsel,
                    ns.cs.end_pos[sel])
            else:
                okg = np.zeros(nsel, bool)
            walk_sel = sel[~okg]
            tbw = {}
            if walk_sel.size:
                tbw = self._walk_fused(pool, walk_sel)
            # assemble a single (S, nsel) op matrix: gapless columns from
            # the host synthesis, walked columns from the device output
            S_walk = max((v[0].shape[0] for v in tbw.values()), default=1)
            S_walk = max(S_walk, fpb.Lmax)
            ops_mat = np.full((S_walk, nsel), 3, np.uint8)   # OP_NONE
            if okg.any():
                gi = np.nonzero(okg)[0]
                ops_mat[:ops_syn.shape[1], gi] = ops_syn[gi].T
                c_refwin[gi] = refwin_g[gi]
                c_nmm[gi] = nmm_g[gi]
                c_nrefn[gi] = nrefn_g[gi]
                c_scchk[gi] = pool.scores[sel[gi]]
            for k, (opcol, sc) in tbw.items():
                t = selidx[k]
                ops_mat[:opcol.shape[0], t] = opcol
                c_rdstart[t] = sc["read_start"]
                c_refwin[t] = sc["ref_start_win"]
                c_nmm[t] = sc["n_mm"]
                c_ngo[t] = sc["n_go"]
                c_ngc[t] = sc["n_gc"]
                c_nrefn[t] = sc["n_refn"]
                c_scchk[t] = sc["score_check"]
            ops_cols = np.arange(nsel, dtype=np.int32)

        # vec pairs must pass the score-check net on BOTH mates
        if nsel:
            t1 = np.array([selidx[int(ns.b1c[i])] for i in vec0], np.int64)
            t2 = np.array([selidx[int(ns.b2c[i])] for i in vec0], np.int64)
            chk = (c_scchk[t1] == pool.scores[ns.b1c[vec0]]) & \
                  (c_scchk[t2] == pool.scores[ns.b2c[vec0]])
            vec = vec0[chk]
            t1, t2 = t1[chk], t2[chk]
        else:
            vec = vec0
            t1 = t2 = np.zeros(0, np.int64)
        vec_mask = np.zeros(B, bool)
        vec_mask[vec] = True
        nv = vec.size

        # ---- vectorized record fields for the vec pairs (2 records each,
        # mate 1 at even rows) ----
        if nv:
            ri1, ri2 = vec, Bp + vec
            k1, k2 = ns.b1c[vec], ns.b2c[vec]
            o1, o2 = ns.b1o[vec], ns.b2o[vec]
            L1 = fpb.lens[ri1]
            L2 = fpb.lens[ri2]
            s1 = ns.b1s[vec].astype(np.int64)
            s2 = ns.b2s[vec].astype(np.int64)
            rid1 = pool.rid[k1]
            rid2 = pool.rid[k2]
            lo1, hi1 = ns.b1lo[vec], ns.b1hi[vec]
            lo2, hi2 = ns.b2lo[vec], ns.b2hi[vec]
            rdend1 = pool.rows_end[k1] + 1
            rdend2 = pool.rows_end[k2] + 1
            # TLEN from soft-clip-extended extents (aligner_result.h:1311)
            if pol.sc_unmapped_tlen:
                xl1, xh1, xl2, xh2 = lo1, hi1, lo2, hi2
            else:
                xl1 = lo1 - c_rdstart[t1]
                xh1 = hi1 + (L1 - rdend1)
                xl2 = lo2 - c_rdstart[t2]
                xh2 = hi2 + (L2 - rdend2)
            frag = np.maximum(xh1, xh2) - np.minimum(xl1, xl2) + 1
            fw1 = o1 == 0
            m1_up = np.where(xl1 == xl2, fw1, xl1 < xl2)
            tlen1 = np.where(m1_up, frag, -frag)
            cross = rid1 != rid2
            tlen1 = np.where(cross, 0, tlen1)
            # POS from the backtrace/gapless ref start (mirrors
            # _emit_aligned); PNEXT from the device LO export (mirrors
            # _emit_pair — track_origin keeps the two identical)
            pos1 = (pool.win_start[k1] + c_refwin[t1]
                    - self.data.ref_cum[rid1] + 1).astype(np.int64)
            pos2 = (pool.win_start[k2] + c_refwin[t2]
                    - self.data.ref_cum[rid2] + 1).astype(np.int64)
            pn1 = (lo1 - self.data.ref_cum[rid1] + 1).astype(np.int64)
            pn2 = (lo2 - self.data.ref_cum[rid2] + 1).astype(np.int64)
            # paired MAPQ (scalar decision table; cheap per pair)
            sec_sum = np.where(ns.p_nk[vec] > 1, ns.p_sss[vec], 0)
            has_sec = ns.p_nk[vec] > 1
            minsum = (fpb.minsc[ri1] + fpb.minsc[ri2]).astype(np.int64)
            persum = (fpb.perfect[ri1] + fpb.perfect[ri2]).astype(np.int64) \
                if pol.local else np.zeros(nv, np.int64)
            mq = np.empty(nv, np.int32)
            for t in range(nv):
                mq[t] = self._mapq(
                    int(s1[t] + s2[t]),
                    int(sec_sum[t]) if has_sec[t] else None,
                    int(persum[t]), int(minsum[t]), paired=True)
            # per-mate XS (vectorized _xs_fast)
            def _xs_vec(ri, k):
                first_other = (ns.r_hasl[ri] != 0) & (ns.r_fc[ri] != k)
                sec_other = (ns.r_hasl2[ri] != 0) & (ns.r_sc[ri] != k)
                return np.where(first_other, ns.r_fs[ri],
                                np.where(sec_other, ns.r_ss[ri], XS_OMIT))
            xs1 = _xs_vec(ri1, k1)
            xs2 = _xs_vec(ri2, k2)
            FP = FLAG_PAIRED | FLAG_PROPER
            flag1 = FP | FLAG_MATE1 | np.where(o1 != 0, FLAG_REVERSE, 0) \
                | np.where(o2 != 0, FLAG_MATE_REVERSE, 0)
            flag2 = FP | FLAG_MATE2 | np.where(o2 != 0, FLAG_REVERSE, 0) \
                | np.where(o1 != 0, FLAG_MATE_REVERSE, 0)

            def ilv(a1, a2, dt=np.int32):
                o = np.empty(2 * nv, dt)
                o[0::2] = a1
                o[1::2] = a2
                return o

            nrec = 2 * nv
            mode = np.ones(nrec, np.int8)
            flag = ilv(flag1, flag2)
            rname_i = ilv(rid1, rid2)
            posr = ilv(pos1, pos2)
            mapq = ilv(mq, mq)
            rnext_i = ilv(np.where(cross, rid2, -2),
                          np.where(cross, rid1, -2))
            pnext = ilv(pn2, pn1)
            tlen = ilv(tlen1, -tlen1)
            tlen[0::2][cross] = 0
            tlen[1::2][cross] = 0
            opt_as = ilv(s1, s2)
            opt_xs = ilv(xs1, xs2)
            xn = ilv(c_nrefn[t1], c_nrefn[t2])
            xm = ilv(c_nmm[t1], c_nmm[t2])
            xo = ilv(c_ngo[t1], c_ngo[t2])
            xg = ilv(c_ngc[t1], c_ngc[t2])
            ys = ilv(s2, s1)
            yt = np.ones(nrec, np.int8)                 # CP
            tsel = ilv(t1, t2, np.int64)
            codes_r = codes_sel[tsel]
            quals_r = quals_sel[tsel]
            rdlen = ilv(L1, L2)
            rdstart = c_rdstart[tsel]
            rdend = ilv(rdend1, rdend2)
            clip = rdstart + (rdlen - rdend)
            n_clip = int(np.count_nonzero(clip))
            if n_clip:
                self.metrics.add(clipped_records=n_clip,
                                 clipped_bases=int(clip.sum()))
            bound = (rdend - rdstart) + xg + 1
            if self._names_tab is None:
                self._names_tab = RefNameTable(self.data.ref_names)
            tails = sam_tails_pe_batch(
                mode, flag, rname_i, posr, mapq, rnext_i, pnext, tlen,
                opt_as, opt_xs, xn, xm, xo, xg, ys, yt,
                codes_r, quals_r, rdlen,
                ops_mat, ops_cols[tsel], rdstart, rdend, bound,
                self._names_tab, suffix, xeq=pol.xeq)

        # ---- stats for vec pairs + object path for the rest ----
        st = AlignStats()
        st.pairs += nv
        st.reads += 2 * nv
        multi = ns.p_nk[vec] > 1 if nv else np.zeros(0, bool)
        st.conc_multi += int(multi.sum())
        st.conc_one += int(nv - multi.sum())

        rest = [i for i in range(B) if not vec_mask[i]]
        groups: List[List[Tuple[int, bytes]]] = [None] * B
        if nv:
            for t, i in enumerate(vec.tolist()):
                nm = fpb.pairs[i][0].name.encode()
                nm2 = fpb.pairs[i][1].name.encode()
                tg1 = getattr(fpb.pairs[i][0], "tags", None)
                tg2 = getattr(fpb.pairs[i][1], "tags", None)
                l1 = nm + tails[2 * t] + (tg1.encode() if tg1 else b"")
                l2 = nm2 + tails[2 * t + 1] + (tg2.encode() if tg2 else b"")
                groups[i] = [(int(flag[2 * t]), l1),
                             (int(flag[2 * t + 1]), l2)]
        if rest:
            tb_of = self._fast_tb(ns, self._fast_need(ns, rest))
            for i in rest:
                out: List[SamAlignment] = []
                self._emit_fast_pair(ns, i, st, out, tb_of)
                groups[i] = [(r.flag, r.line().encode() + suffix)
                             for r in out]
        self._merge_stats(st)
        return groups

    # ------------------------------------------------------------------
    def _mm1_upfront_ok(self, codes: np.ndarray, quals: np.ndarray,
                        L: int, g0: int) -> bool:
        """Would the reference's 1mm-upfront phase discover the implied
        end-to-end <=1-mismatch hit at global diagonal start g0?

        oneMmSearch (aligner_seed.cpp:975) runs over the N-excised joined
        text, so the hit must fit one non-N segment of one reference; it
        bails for reads with >1 Ns; and in --local mode a hit is legal
        only if the running score stays positive through the mismatch
        from BOTH read ends and the e2e score clears minsc
        (aligner_seed.cpp:1231-1263) — which is why e.g. a last-base
        mismatch is NOT a local 1mm hit (a legal local alignment clips
        it instead). codes/quals are the aligned-orientation row."""
        pol = self.pol
        g0 = int(g0)
        if g0 < 0 or g0 + L > int(self.data.ref_cum[-1]):
            return False
        segs = self.data.seg_global_start
        si = int(np.searchsorted(segs, g0, side="right")) - 1
        if si < 0 or g0 + L > int(segs[si] + self.data.seg_len[si]):
            return False
        rw = self.data.ref_words
        gp = np.arange(g0, g0 + L)
        ref = ((rw[gp >> 4] >> (2 * (gp & 15))) & 3).astype(np.int64)
        rd = codes[:L].astype(np.int64)
        mism = (rd != ref) | (rd >= 4)
        idx = np.nonzero(mism)[0]
        if idx.size == 0:
            return True
        if idx.size > 1 or int((rd >= 4).sum()) > 1:
            return False
        p = int(idx[0])
        if rd[p] >= 4:
            pen = -pol.n_pen
        else:
            lo = pol.mm_pen_max if pol.ignore_quals else pol.mm_pen_min
            pen = -(lo + (min(int(quals[p]), 40)
                          * (pol.mm_pen_max - lo)) // 40)
        if not pol.local:
            return True
        ma = pol.match_bonus
        if p * ma + pen <= 0 or (L - 1 - p) * ma + pen <= 0:
            return False
        return (L - 1) * ma + pen >= pol.min_score(L)

    # ------------------------------------------------------------------
    def _pe_effort_sets(self, cs: CandSet, succ_cross: set,
                        suppress_seeds: np.ndarray = None):
        """Per-mate (attempted, successful) candidate sets under the
        reference's -D fail-streak schedule (pipeline/pe_effort.py).

        suppress_seeds[ri]: drop the read's SEED-phase candidates — models
        the reference's round loop `break` when the first mate (fewer
        exact hits) instantiates zero N-free seeds, which skips the other
        mate's seed search for the round (bt2_search.cpp:3948-3952); with
        PE's halved round count (1) that means no seed search at all."""
        from bowtie2_tpu_torch.pipeline.pe_effort import (pe_streak_limit,
                                                    simulate_mate)
        pol = self.pol
        n2 = len(cs.lens)
        eff = {}
        by_read: Dict[int, List[int]] = {}
        for k in range(cs.n_cand):
            by_read.setdefault(int(cs.cand_read[k]), []).append(k)
        if pol.all_hits:
            # -a: no effort limits (bt2_search.cpp:3458-3462)
            for ri in range(n2):
                ks = set(by_read.get(ri, []))
                eff[ri] = (ks, ks & succ_cross)
            return eff
        limit = pe_streak_limit(pol.fail_streak, pol.khits, True)
        for ri in range(n2):
            ks = by_read.get(ri, [])
            if not ks:
                eff[ri] = (set(), set())
                continue
            exact = [k for k in ks if cs.cand_exact[k]]
            if suppress_seeds is not None and suppress_seeds[ri]:
                # only 1mm-upfront-discoverable half candidates survive a
                # suppressed seed round (ungapped anchor mm <= 1 + the full
                # oneMmSearch segment/--local legality rules); the rest
                # exist only through the blocked seed phase
                halfp = [k for k in ks
                         if cs.cand_half[k] and not cs.cand_exact[k]
                         and cs.pool.mm_ug[k] <= 1
                         and self._mm1_upfront_ok(
                             (cs.rc if cs.cand_or[k] else cs.fw)[ri],
                             (cs.qu_r if cs.cand_or[k] else cs.qu)[ri],
                             int(cs.lens[ri]), int(cs.anchor[k]))]
                seedp = []
            else:
                halfp = [k for k in ks
                         if cs.cand_half[k] and not cs.cand_exact[k]]
                seedp = [k for k in ks
                         if not cs.cand_exact[k] and not cs.cand_half[k]]
            anchor_ok = {k for k in ks if cs.valid[k]}
            eff[ri] = simulate_mate([exact, halfp, seedp], cs.cand_rangej,
                                    cs.cand_rwidth, succ_cross, anchor_ok,
                                    limit)
        return eff

    def _emit_pair(self, st, out, cs, i, rec1, rec2, m1, m2, sc_sum,
                   sec_sum, yt, proper, xs1=None, xs2=None,
                   secondary=False, force_mq=None, pending=None) -> bool:
        """Emit both mates of a concordant/discordant pair. Returns False if
        a backtrace consistency check failed (caller falls through).

        xs1/xs2: per-mate XS:i (second-best distinct alignment of THAT mate
        among everything found for it, reference AlnSetSumm bestUnp2 —
        emitted on CP/DP records too, not just unpaired ones). secondary
        sets 0x100; force_mq overrides the computed MAPQ (k-mode
        conventions, unique.h:202: secondaries 255, primary real only when
        a second-best pair exists). pending: as in _emit_aligned."""
        pol = self.pol
        (k1, p1, t1, o1, lo1, hi1) = m1
        (k2, p2, t2, o2, lo2, hi2) = m2
        B = len(cs.lens) // 2
        L1 = int(cs.lens[i])
        L2 = int(cs.lens[B + i])
        s1 = int(p1.scores[k1])
        s2 = int(p2.scores[k2])
        # paired MAPQ: summed scores vs summed minima (unique.h paired path)
        minsum = int(cs.minsc[i] + cs.minsc[B + i])
        persum = int(cs.perfect[i] + cs.perfect[B + i]) if pol.local else 0
        mq = force_mq if force_mq is not None else \
            self._mapq(sc_sum, sec_sum, persum, minsum, paired=True)

        # TLEN: soft-clip-EXTENDED extents (reference getExtendedCoords /
        # setFragmentLength, aligner_result.h:1311-1341) — clipped bases
        # count toward the fragment; sign: upstream mate positive, ties
        # broken by strand (fw over rc) and mate-1 for --ff. Classification
        # above used the plain extents (aligner_sw_driver.cpp:2382
        # refExtent), matching the reference.
        if pol.sc_unmapped_tlen:
            # --soft-clipped-unmapped-tlen: clipped bases count as
            # unmapped, so TLEN uses the PLAIN alignment extents
            # (getExtendedCoords skips the trim adjustment when
            # flags.scUnMapped(), aligner_result.h:901)
            xl1, xh1, xl2, xh2 = lo1, hi1, lo2, hi2
        else:
            xl1 = lo1 - t1[1]["read_start"]
            xh1 = hi1 + (L1 - (int(p1.rows_end[k1]) + 1))
            xl2 = lo2 - t2[1]["read_start"]
            xh2 = hi2 + (L2 - (int(p2.rows_end[k2]) + 1))
        frag = max(xh1, xh2) - min(xl1, xl2) + 1
        fw1, fw2 = o1 == 0, o2 == 0
        if xl1 == xl2:
            m1_up = (fw1 and fw2) or (fw1 and not fw2)
        else:
            m1_up = xl1 < xl2
        tlen1 = frag if m1_up else -frag
        tlen2 = -tlen1
        rid1, rid2 = int(p1.rid[k1]), int(p2.rid[k2])
        if rid1 != rid2:
            # discordant pair across references: RNEXT names the other
            # mate's reference and TLEN is 0 (reference sam.cpp TLEN rule
            # for refid mismatch; pairs on different chromosomes can only
            # be discordant)
            tlen1 = tlen2 = 0
        rnext1 = "=" if rid1 == rid2 else self.data.ref_names[rid2]
        rnext2 = "=" if rid1 == rid2 else self.data.ref_names[rid1]

        sec_fl = 0x100 if secondary else 0
        fl1 = FLAG_PAIRED | FLAG_MATE1 | (FLAG_PROPER if proper else 0) \
            | (FLAG_MATE_REVERSE if o2 else 0) | sec_fl
        fl2 = FLAG_PAIRED | FLAG_MATE2 | (FLAG_PROPER if proper else 0) \
            | (FLAG_MATE_REVERSE if o1 else 0) | sec_fl
        codes1, quals1 = self._oriented(cs, i, o1)
        codes2, quals2 = self._oriented(cs, B + i, o2)
        n_pending = len(pending) if pending is not None else 0
        r1 = self._emit_aligned(rec1, L1, o1, codes1, quals1, p1, k1, t1,
                                s1, xs1, mq, yt, fl1, rnext1,
                                lo2 - int(self.data.ref_cum[rid2]) + 1,
                                tlen1, ys=s2, pending=pending)
        r2 = self._emit_aligned(rec2, L2, o2, codes2, quals2, p2, k2, t2,
                                s2, xs2, mq, yt, fl2, rnext2,
                                lo1 - int(self.data.ref_cum[rid1]) + 1,
                                tlen2, ys=s1, pending=pending)
        if r1 is None or r2 is None:
            if pending is not None:    # neither record is emitted
                del pending[n_pending:]
            # nor counted: take back the clip _emit_aligned counted
            for r, t, p, k, L in ((r1, t1, p1, k1, L1), (r2, t2, p2, k2, L2)):
                clip = t[1]["read_start"] + L - int(p.rows_end[k]) - 1
                if r is not None and clip:
                    self.metrics.add(clipped_records=-1, clipped_bases=-clip)
            return False
        out.append(r1)
        out.append(r2)
        return True

    def _emit_mixed(self, st, out, cs, i, rec1, rec2, l1, l2, tb_of,
                    pending=None):
        """No concordant/discordant pair: report mates individually
        (--no-mixed disables the aligned records). Field conventions for
        half-mapped pairs follow the reference (sam.cpp): the unmapped
        record carries the mapped mate's RNAME/POS, RNEXT "=", TLEN 0; the
        mapped record has RNEXT "=" and PNEXT = its own POS.

        Record order inside the pair follows the reference's finishRead
        appendance: in a half-mapped pair the ALIGNED mate's record comes
        first (its unpaired alignment is reported before the unaligned
        leftover record), mate 1 first otherwise (verified against the
        binary on reads_1/2.fq: all 290 mate2-first pairs are exactly
        the aligned-mate2 + unaligned-mate1 class). pending: as in
        _emit_aligned."""
        pol = self.pol
        B = len(cs.lens) // 2
        scores = cs.pool.scores
        mates = [(rec1, i, l1, l2), (rec2, B + i, l2, l1)]
        m1_al = bool(l1) and not pol.no_mixed
        m2_al = bool(l2) and not pol.no_mixed
        order = (1, 0) if (m2_al and not m1_al) else (0, 1)
        for mate in order:
            rec, ri, lst, other_lst = mates[mate]
            mate_flag = FLAG_MATE1 if mate == 0 else FLAG_MATE2
            other_aligned = bool(other_lst) and not pol.no_mixed
            fl = FLAG_PAIRED | mate_flag \
                | (0 if other_aligned else FLAG_MATE_UNMAPPED)
            if lst and not pol.no_mixed:
                best_k = lst[0]
                sec_k = lst[1] if len(lst) > 1 else None
                best = int(scores[best_k])
                sec = int(scores[sec_k]) if sec_k is not None else None
                per = int(cs.perfect[ri]) if pol.local else 0
                # k-mode convention (unique.h:202) also covers mixed-mode
                # records: without an observed second-best the search
                # "didn't really look" → MAPQ 255
                if (pol.all_hits or pol.khits > 1) and sec is None:
                    mq = 255
                else:
                    mq = self._mapq(best, sec, per, int(cs.minsc[ri]))
                orient = int(cs.cand_or[best_k])
                codes, quals = self._oriented(cs, ri, orient)
                rnext, pnext = ("*", 0)
                own_echo = False
                if not other_aligned:
                    # own coords echoed (reference half-mapped convention)
                    rnext = "="
                    own_echo = True
                else:
                    # both mates aligned but not as a pair: the reference
                    # still cross-references them (RNEXT the other's
                    # reference, '=' where it is this one's; PNEXT the
                    # other's POS; TLEN 0; sam.cpp mixed-mode convention)
                    ok2 = other_lst[0]
                    o_rid = int(cs.pool.rid[ok2])
                    rnext = "=" if o_rid == int(cs.pool.rid[best_k]) \
                        else self.data.ref_names[o_rid]
                    pnext = int(cs.pool.win_start[ok2]) \
                        + tb_of[ok2][1]["ref_start_win"] \
                        - int(self.data.ref_cum[o_rid]) + 1
                    fl |= FLAG_MATE_REVERSE if cs.cand_or[ok2] else 0
                r = self._emit_aligned(rec, int(cs.lens[ri]), orient, codes,
                                       quals, cs.pool, best_k, tb_of[best_k],
                                       best, sec, mq, "UP", fl,
                                       rnext=rnext, pnext=pnext,
                                       pending=pending)
                if r is not None:
                    if own_echo:
                        r.pnext = r.pos
                    out.append(r)
                    if sec is not None:
                        st.mate_al_multi += 1
                    else:
                        st.mate_al_one += 1
                    continue
            yf = self.YF_STR[int(cs.yf[ri])] if cs.filtered[ri] else None
            if other_aligned:
                ok = other_lst[0]
                o_rid = int(cs.pool.rid[ok])
                o_pos = ext_pos = int(cs.pool.win_start[ok]) \
                    + tb_of[ok][1]["ref_start_win"] \
                    - int(self.data.ref_cum[o_rid]) + 1
                fl |= FLAG_MATE_REVERSE if cs.cand_or[ok] else 0
                out.append(self._unaligned(
                    rec, yf, "UP", fl,
                    rname=self.data.ref_names[o_rid], pos=o_pos,
                    rnext="=", pnext=o_pos))
            else:
                out.append(self._unaligned(rec, yf, "UP", fl))
