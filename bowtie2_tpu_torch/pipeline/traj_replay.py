"""Production wiring of the RNG-trajectory replay (SE, e2e, -N 0).

Port of bowtie2_tpu/pipeline/traj_replay.py; the gapped records' DP and
backtrace run through this package's UnpairedAligner._run_dp and
_backtrace_sel (the sw_rect and backtrace kernels on the card).

Routes trajectory-class reads — imperfect multimaps and any read whose
XS depends on the reference's search ORDER rather than just its search
RESULTS — through the per-read draw-for-draw replay
(pipeline/seed_replay.py via pipeline/replay_driver.py) and overrides
the fused pipeline's canonical selection with the replay's prediction.

The replay yields, per read, the reference's accumulated alignment list
(sink.alns) and the RNG stream position at finishRead time; selection
then follows aln_sink.cpp:1073 selectByScore on the CONTINUED stream,
XS is the best unchosen score (AlnSetSumm bestUnchosenUScore), and the
SAM record for the chosen alignment is synthesized host-side (gapless)
or via one batched DP + forced-end-cell backtrace (gapped).

Reads outside the modeled scope (ReplayAbort, local mode, -N 1, -k/-a,
huge SA ranges) keep the canonical result — the same posture as
pipeline/replay.py for the exact-multimap class.

Reference: bt2_search.cpp:3321-3980 (per-read driver),
aligner_sw_driver.cpp:492-1495 (extendSeeds), aln_sink.cpp:643-1700
(finishRead).
"""

import sys
from typing import Dict, List, Optional

import numpy as np

from bowtie2_tpu_torch.io.sam import SamAlignment
from bowtie2_tpu_torch.pipeline.rng import select_by_score
from bowtie2_tpu_torch.pipeline.seed_replay import Aln, ReadReplay, ReplayAbort
from bowtie2_tpu_torch.utils.metrics import TRACE

# Master switch (tests can flip). When False the aligner behaves exactly
# as in round 4 (canonical selection for the trajectory class).
ENABLED = True

# Override to unaligned when the replay predicts the reference abandoned
# the read (-D streaks / caps) even though the pipeline found alignments.
UNAL_OVERRIDE = True


def eligible(pol) -> bool:
    """Scope gate: the replay models unpaired, end-to-end, -N 0,
    k=1 + -M (the default preset family)."""
    return (ENABLED and not pol.local and not pol.all_hits
            and pol.khits == 1 and pol.mhits > 0
            and getattr(pol, "seed_mms", 0) == 0
            and not pol.non_deterministic
            and not getattr(pol, "no_1mm", False)
            and not getattr(pol, "no_exact", False))


class _Pred:
    __slots__ = ("aln", "xs", "maxed", "nalns", "unal")

    def __init__(self, aln: Optional[Aln], xs: Optional[int],
                 maxed: bool, nalns: int, unal: bool = False):
        self.aln = aln
        self.xs = xs
        self.maxed = maxed
        self.nalns = nalns
        self.unal = unal


@TRACE.traced("replay")
def run_replays(aligner, records, ris) -> Dict[int, _Pred]:
    """Run ReplayBuilder + ReadReplay for the cohort; returns
    {ri: _Pred} for reads whose trajectory fit the model."""
    from bowtie2_tpu_torch.pipeline.replay_driver import ReplayBuilder
    builder = getattr(aligner, "_traj_builder", None)
    if builder is None:
        builder = ReplayBuilder(aligner)
        aligner._traj_builder = builder
    recs = [records[ri] for ri in ris]
    try:
        inputs = builder.build(recs)
    except ReplayAbort:
        return {}
    rpol = builder._policy()
    preds: Dict[int, _Pred] = {}
    n_abort = 0
    for ri, inp in zip(ris, inputs):
        if inp is None:
            n_abort += 1
            continue
        try:
            rr = ReadReplay(inp, rpol)
            sink = rr.run()
        except ReplayAbort:
            n_abort += 1
            continue
        except Exception as e:           # never let the replay kill a batch
            sys.stderr.write(f"traj replay error ({e}); canonical kept\n")
            n_abort += 1
            continue
        if not sink.alns:
            preds[ri] = _Pred(None, None, False, 0, unal=True)
            continue
        scores = [a.score for a in sink.alns]
        perm = select_by_score(scores, 1, rr.rng)
        prim = sink.alns[perm[0]]
        others = sorted(scores, reverse=True)
        xs = others[1] if len(others) > 1 else None
        preds[ri] = _Pred(prim, xs, sink.maxed, len(sink.alns))
    if n_abort:
        aligner.metrics.add(traj_abort=n_abort)
    return preds


def _gapless_record(aligner, rec, L, codes, quals, pred: _Pred,
                    minsc_ri: int) -> Optional[SamAlignment]:
    """Synthesize the SAM record for an ungapped e2e primary directly
    from the 2-bit reference words (no DP round trip)."""
    from bowtie2_tpu_torch.pipeline.align import (FLAG_REVERSE, cigar_string,
                                            decode_seq, qual_string)
    from bowtie2_tpu_torch.pipeline.backtrace import _REF_CHARS
    d = aligner.data
    a = pred.aln
    g0 = int(d.ref_cum[a.tidx]) + a.refoff
    tlen = int(d.ref_cum[a.tidx + 1] - d.ref_cum[a.tidx])
    if a.refoff < 0 or a.refoff + L > tlen:
        return None
    gp = np.arange(g0, g0 + L)
    rw, rn = d.ref_words, d.refn_words
    fc = ((rw[gp >> 4] >> (2 * (gp & 15))) & 3).astype(np.int64)
    fc = np.where((rn[gp >> 5] >> (gp & 31)) & 1, 4, fc)
    rd = codes.astype(np.int64)
    is_n = (rd >= 4) | (fc == 4)
    eq = (fc == rd) & ~is_n
    nmm = int((((~eq) & (rd < 4) & (fc != 4)) | is_n).sum())
    nrefn = int((fc == 4).sum())
    # score cross-check (reference scoring, e2e: matches score 0)
    p = aligner.pol.sw_params()
    q = np.minimum(quals.astype(np.int64), 40)
    mmpen = p.mm_pen_min + (q * (p.mm_pen_max - p.mm_pen_min)) // 40
    sub = np.where(eq, p.match_bonus, np.where(is_n, -p.n_pen, -mmpen))
    if int(sub.sum()) != a.score:
        return None
    ev = np.nonzero(~eq)[0]
    if aligner.pol.xeq and ev.size:
        change = np.nonzero(np.diff(eq))[0]
        bounds = np.concatenate([[0], change + 1, [L]])
        cigar = [("=" if eq[s] else "X", int(e - s))
                 for s, e in zip(bounds[:-1], bounds[1:])]
    else:
        cigar = [("=" if aligner.pol.xeq else "M", L)]
    parts = []
    prev = 0
    for e in ev.tolist():
        parts.append(str(e - prev))
        parts.append(_REF_CHARS[int(fc[e])])
        prev = e + 1
    parts.append(str(L - prev))
    md = "".join(parts)
    mq = aligner._mapq(a.score, pred.xs, 0, minsc_ri)
    flag = FLAG_REVERSE if not a.fw else 0
    opts = [("AS", "i", a.score)]
    if pred.xs is not None:
        opts.append(("XS", "i", pred.xs))
    opts += [("XN", "i", nrefn), ("XM", "i", nmm), ("XO", "i", 0),
             ("XG", "i", 0), ("NM", "i", nmm), ("MD", "Z", md),
             ("YT", "Z", "UU")]
    return SamAlignment(
        qname=rec.name, flag=flag,
        rname=d.ref_names[a.tidx], pos=a.refoff + 1, mapq=mq,
        cigar=cigar_string(cigar),
        seq=decode_seq(codes.astype(np.uint8)).decode(),
        qual=qual_string(quals), opts=opts,
        raw_tags=getattr(rec, "tags", None))


def emit_overrides(aligner, fb, preds: Dict[int, _Pred]
                   ) -> Dict[int, List[SamAlignment]]:
    """Build the SAM record group for each predicted read.

    Gapless primaries are synthesized host-side; gapped ones run ONE
    batched DP over the predicted windows with the backtrace forced to
    the replay's end cell. Reads whose record can't be validated
    (score mismatch) fall back to canonical (returned dict omits them).
    """
    pol = aligner.pol
    d = aligner.data
    out: Dict[int, List[SamAlignment]] = {}
    gapped = []          # (ri, pred)
    for ri, pred in preds.items():
        rec = fb.records[ri]
        L = int(fb.lens[ri])
        if pred.unal:
            if UNAL_OVERRIDE:
                out[ri] = [aligner._unaligned(rec)]
            continue
        a = pred.aln
        if a.gapped:
            gapped.append((ri, pred))
            continue
        codes = fb.fw[ri, :L] if a.fw else fb.rc[ri, :L]
        quals = fb.qu[ri, :L] if a.fw else fb.qu_r[ri, :L]
        r = _gapless_record(aligner, rec, L, codes, quals, pred,
                            int(fb.minsc[ri]))
        if r is not None:
            out[ri] = [r]
        else:
            aligner.metrics.add(traj_scorefail=1)
    if gapped:
        out.update(_emit_gapped(aligner, fb, gapped))
    return out


def _emit_gapped(aligner, fb, gapped) -> Dict[int, List[SamAlignment]]:
    """One batched DP + forced-end backtrace for gapped primaries."""
    import torch
    pol = aligner.pol
    d = aligner.data
    n = len(gapped)
    Lmax = fb.Lmax
    G = pol.band_halfwidth(Lmax)
    lens_c = np.array([int(fb.lens[ri]) for ri, _ in gapped], np.int64)
    Bc = n
    fw_c = np.stack([fb.fw[ri] for ri, _ in gapped])
    rc_c = np.stack([fb.rc[ri] for ri, _ in gapped])
    qu_c = np.stack([fb.qu[ri] for ri, _ in gapped])
    qur_c = np.stack([fb.qu_r[ri] for ri, _ in gapped])
    jboth = aligner._put(np.concatenate([fw_c, rc_c], axis=0)
                         ).to(torch.int32)
    jquals = aligner._put(np.concatenate([qu_c, qur_c], axis=0)
                          ).to(torch.int32)
    rid = np.array([p.aln.tidx for _, p in gapped], np.int64)
    refoff = np.array([p.aln.refoff for _, p in gapped], np.int64)
    anchor = d.ref_cum[rid] + refoff
    orient = np.array([0 if p.aln.fw else 1 for _, p in gapped], np.int64)
    read_idx = np.arange(n, dtype=np.int64)
    pool = aligner._run_dp(anchor - G, rid, read_idx, orient,
                           jboth, jquals, lens_c, G, Lmax, n)
    # force the backtrace to the replay's end cell
    end_ref = np.array(
        [p.aln.rect_refl + p.aln.end_col for _, p in gapped], np.int64)
    lanes = (d.ref_cum[rid] + end_ref) - pool.win_start[:n]
    width = Lmax + 2 * G + 1
    ok = (lanes >= 0) & (lanes < width)
    pool.lanes_end = pool.lanes_end.copy()
    pool.rows_end = pool.rows_end.copy()
    pool.lanes_end[:n] = np.where(ok, lanes, pool.lanes_end[:n])
    pool.rows_end[:n] = lens_c - 1
    pool.scores = pool.scores.copy()
    pool.scores[:n] = [p.aln.score for _, p in gapped]
    sel = np.nonzero(ok)[0]
    tbs = aligner._backtrace_sel(pool, sel)
    out: Dict[int, List[SamAlignment]] = {}
    pending: list = []
    for t, (ri, pred) in enumerate(gapped):
        if t not in tbs:
            aligner.metrics.add(traj_scorefail=1)
            continue
        rec = fb.records[ri]
        L = int(lens_c[t])
        a = pred.aln
        codes = fb.fw[ri, :L] if a.fw else fb.rc[ri, :L]
        quals = fb.qu[ri, :L] if a.fw else fb.qu_r[ri, :L]
        mq = aligner._mapq(a.score, pred.xs, 0, int(fb.minsc[ri]))
        r = aligner._emit_aligned(
            rec, L, int(orient[t]), codes, quals, pool, t, tbs[t],
            a.score, pred.xs, mq, "UU", pending=pending)
        if r is None:
            aligner.metrics.add(traj_scorefail=1)
            continue
        out[ri] = [r]
    aligner._decode_pending(pending)
    return out


def traj_overrides(aligner, fb, n_rank, ovr, rep_ctx=None
                   ) -> Dict[int, List[SamAlignment]]:
    """Main hook: called from the fused SE collect paths.

    fb: FusedBatch; n_rank: (Bp,) valid-rank counts; ovr: the
    exact/1mm replay overrides already claimed; rep_ctx: optional (Bp,)
    bool — read sits in repetitive seed context (some seed range with
    >= 2 elements), so the reference's sampled visits can surface a
    second-best the canonical ranking didn't. Returns
    {ri: [SamAlignment, ...]} record groups to emit verbatim."""
    pol = aligner.pol
    if not eligible(pol):
        return {}
    B = fb.B
    ris = [int(ri) for ri in range(B)
           if (n_rank[ri] >= 2
               or (rep_ctx is not None and n_rank[ri] >= 1
                   and bool(rep_ctx[ri])))
           and not fb.filtered[ri] and ri not in ovr]
    if not ris:
        return {}
    preds = run_replays(aligner, fb.records, ris)
    if not preds:
        return {}
    out = emit_overrides(aligner, fb, preds)
    if out:
        aligner.metrics.add(traj_overridden=len(out))
    return {ri: (recs, preds[ri].nalns) for ri, recs in out.items()}
