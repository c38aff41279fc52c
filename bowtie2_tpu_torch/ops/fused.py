"""Single-end batch pipeline on the device, end to end (torch + kernels).

Port of bowtie2_tpu/ops/fused.py (SE half). One call per batch runs

  exact sweep + seed search + half-read search     (fm kernels)
  -> per-read candidate slot assembly               (canonical budget order)
  -> SA resolution of every slot                    (sa_resolve kernel)
  -> straddle filter, anchor dedupe                 (per-read slot masks)
  -> compaction -> windows -> banded DP             (sw_rect kernel)
  -> per-read ranking (dedupe by (orient, end))
  -> backtrace of the reported candidates           (backtrace kernel)

and returns one uint8 blob whose bytes equal the JAX program's: packed
backtrace ops, then the int32 metadata vector (CHOSEN_FIELDS per chosen
candidate; layout decoded by pipeline/align.py). The glue between kernels
is plain torch: gathers, sorts and masks, compacting by sort as the JAX
program does, so a call issues no host synchronisation.
"""

from typing import NamedTuple, Optional

import torch

from bowtie2_tpu_torch.index.fmindex import FMHalf
from bowtie2_tpu_torch.ops import fm
from bowtie2_tpu_torch.ops.ref import gather_windows_aligned
from bowtie2_tpu_torch.ops.sw import (OP_NONE, SWParams, SWResult, backtrace,
                                      diag_readout, mm_penalty_from_qual,
                                      sw_banded)

NEG = -(1 << 29)
BIGKEY = 1 << 29

# number of per-chosen scalar fields in the metadata vector (host decode
# must match pipeline/align.py FusedBatch)
CHOSEN_FIELDS = 12

i32 = torch.int32


class SegTables(NamedTuple):
    """Joined-text segment geometry (device copies of IndexData tables)."""
    seg_joined_start: torch.Tensor   # (nseg,) int32
    seg_global_start: torch.Tensor   # (nseg,) int32
    seg_end_joined: torch.Tensor     # (nseg,) int32 = joined_start + len
    ref_cum: torch.Tensor            # (nref+1,) int32


class FusedResult(NamedTuple):
    blob: torch.Tensor   # (S*Bc + 4*(B*2*kk + Bc*CHOSEN_FIELDS + 1 + 8*B),)
                         # uint8: packed ops, then the int32 metadata bytes


def _ar(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=i32, device=dev)


def _set_drop(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
              dim: int = 0) -> torch.Tensor:
    """base.at[idx].set(vals, mode="drop") for idx in [0, n], where the
    index n (one past the end) marks entries to drop."""
    n = base.shape[dim]
    pad = base.narrow(dim, 0, 1)
    out = torch.cat([base, pad], dim=dim)
    if dim == 0:
        out[idx.long()] = vals.to(out.dtype)
    else:
        out[:, idx.long()] = vals.to(out.dtype)
    return out.narrow(dim, 0, n)


def _pack4(codes: torch.Tensor) -> torch.Tensor:
    """(B, L) int32 codes 0..5 → (B, ceil(L/8)) int32, 4 bits per code."""
    B, L = codes.shape
    if L % 8:
        codes = torch.cat([codes, torch.full((B, 8 - L % 8), 5, dtype=i32,
                                             device=codes.device)], dim=1)
    sh = 4 * torch.arange(8, dtype=torch.int64, device=codes.device)
    return (codes.to(torch.int64).view(B, -1, 8) << sh).sum(dim=2).to(i32)


def _extract_packed(words: torch.Tensor, offs: torch.Tensor, length: int
                    ) -> torch.Tensor:
    """Fixed-length windows from packed 4-bit rows: words (B, Lw) int32,
    offs (B, m) window starts → (B, m, length) int32 codes. Positions past
    the row read 0, as in the JAX op; callers mask by validity."""
    B, Lw = words.shape
    m = offs.shape[1]
    dev = words.device
    nw = (length + 7) // 8 + 1
    rel = torch.clamp(offs, min=0)
    if Lw <= max(32, nw):
        loc = words[:, None, :].expand(B, m, Lw)
        nsel = Lw
    else:
        w0 = rel // 8
        widx = torch.clamp(w0[:, :, None] + _ar(nw, dev), 0, Lw - 1)
        loc = words.gather(1, widx.reshape(B, -1).long()).reshape(B, m, nw)
        rel = rel - w0 * 8
        nsel = nw
    cpos = rel[:, :, None] + _ar(length, dev)              # (B, m, length)
    word_of = cpos // 8
    sel = loc.gather(2, torch.clamp(word_of, max=nsel - 1).long())
    sel = torch.where(word_of < nsel, sel, 0)
    return (sel >> (4 * (cpos % 8))) & 15


def _assemble_slots(B, T, lens, live_read, sw_top, sw_bot, sw_ned,
                    tops2, bots2, offs2, mlens2, halfs2, max_exact_rows):
    """Canonical-order candidate slots, (B, T) arrays: exact end-to-end
    hits first (fw then rc, up to max_exact_rows each), then seed/half SA
    ranges by ascending width with depth-major round-robin row allocation
    under the per-read budget T. tops2/...: (2B, M2) per orientation row.
    Returns slot_valid, slot_row, slot_or, slot_off, slot_exact,
    slot_mlen, slot_half — all (B, T)."""
    dev = lens.device
    M2 = tops2.shape[1]
    M = 2 * M2

    ex_w = torch.where((sw_ned == 0) & (sw_bot > sw_top), sw_bot - sw_top, 0)
    ex_w = torch.clamp(ex_w, max=max_exact_rows)
    ex_w = torch.where(torch.cat([live_read, live_read]), ex_w, 0)
    t_fw = torch.clamp(ex_w[:B], max=T)
    t_rc = torch.minimum(ex_w[B:], T - t_fw)
    rem = T - t_fw - t_rc

    w = torch.cat([bots2[:B] - tops2[:B], bots2[B:] - tops2[B:]], dim=1)
    w = torch.clamp(w, 0, BIGKEY - 1)
    w = torch.where(live_read[:, None], w, 0)
    tops = torch.cat([tops2[:B], tops2[B:]], dim=1)
    offs = torch.cat([offs2[:B], offs2[B:]], dim=1)
    mlens = torch.cat([mlens2[:B], mlens2[B:]], dim=1)
    halfs = torch.cat([halfs2[:B], halfs2[B:]], dim=1)
    oris = torch.cat([torch.zeros((B, M2), dtype=i32, device=dev),
                      torch.ones((B, M2), dtype=i32, device=dev)], dim=1)
    order = torch.argsort(torch.where(w == 0, BIGKEY, w), dim=1, stable=True)
    w, tops, offs, mlens, halfs, oris = (
        a.gather(1, order) for a in (w, tops, offs, mlens, halfs, oris))

    # depth-major round-robin: deepest full round Dstar, leftover to the
    # narrowest still-live ranges
    ds = _ar(T + 1, dev)
    f = torch.minimum(w[:, :, None], ds).sum(dim=1)              # (B, T+1)
    Dstar = torch.clamp((f <= rem[:, None]).sum(dim=1) - 1, min=0)
    used = f.gather(1, Dstar[:, None])[:, 0]
    extra_budget = rem - used
    alive = w > Dstar[:, None]
    extra = alive & (torch.cumsum(alive.to(i32), dim=1)
                     <= extra_budget[:, None])
    n = torch.minimum(w, Dstar[:, None]) + extra.to(i32)         # (B, M)

    # slot fill: sort a per-read key table, take the first T
    e4 = _ar(max_exact_rows, dev)
    key_fw = torch.where(e4 < t_fw[:, None], e4, BIGKEY)
    key_rc = torch.where(e4 < t_rc[:, None], max_exact_rows + e4, BIGKEY)
    dT = _ar(T, dev)
    seed_key = 8 + dT[None, :, None] * M + _ar(M, dev)[None, None, :]
    seed_key = torch.where(dT[None, :, None] < n[:, None, :], seed_key,
                           BIGKEY).reshape(B, T * M)
    keys = torch.sort(torch.cat([key_fw, key_rc, seed_key], dim=1),
                      dim=1).values[:, :T]

    slot_valid = keys < BIGKEY
    is_exact = keys < 2 * max_exact_rows
    ex_or = (keys >= max_exact_rows).to(i32)
    ex_d = torch.where(is_exact, keys % max_exact_rows, 0)
    q = torch.where(is_exact, 0, keys - 8)
    sd = q // M
    sj = (q % M).long()

    rdix = _ar(B, dev)[:, None]
    ex_row = sw_top.index_select(0, (ex_or * B + rdix).reshape(-1).long()) \
        .reshape(B, T) + ex_d
    seed_row = tops.gather(1, sj) + sd
    slot_row = torch.where(is_exact, ex_row, seed_row)
    slot_or = torch.where(is_exact, ex_or, oris.gather(1, sj))
    slot_off = torch.where(is_exact, 0, offs.gather(1, sj))
    slot_mlen = torch.where(is_exact, lens[:, None], mlens.gather(1, sj))
    slot_half = torch.where(is_exact, False, halfs.gather(1, sj))
    slot_row = torch.where(slot_valid, slot_row, 0)
    return (slot_valid, slot_row.to(i32), slot_or.to(i32),
            slot_off.to(i32), is_exact & slot_valid, slot_mlen.to(i32),
            slot_half)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, idx.reshape(-1).long()).reshape(
        idx.shape + t.shape[1:])


def _core(half: FMHalf, ref_words, refn_words, seg: SegTables,
          jboth, jquals, lens, offs_all, valid_all, minsc, live_read,
          live_or, params: SWParams, band: int, seed_len: int,
          ftab_chars: int, half_ftab: int, period: int, T: int,
          NC: int, n1: bool, max_exact_rows: int, no_1mm: bool,
          no_exact: bool = False, NCDP: Optional[int] = None):
    """Phases 1-4: searches → slots → SA resolve → DP. Returns a dict of
    the intermediates fused_se ranks and backtraces from."""
    G = band
    dev = jboth.device
    B2, Lmax = jboth.shape
    B = B2 // 2
    W = Lmax + 2 * G + 1
    lens2 = torch.cat([lens, lens])
    parange = _ar(Lmax, dev)[None, :]

    # reversed char streams with no gather: the reversed fw read is the
    # complement of the rc read row, rc[p] = comp(read[len-1-p])
    other = torch.cat([jboth[B:], jboth[:B]], dim=0)
    R = torch.where(other < 4, 3 - other, other)
    R = torch.where(parange < lens2[:, None], R, 5)
    jpack = _pack4(jboth)
    rpack = _pack4(R)

    # ---------------- phase 1+2: FM searches ----------------
    sweep = fm.exact_sweep_rr(half, R)
    smax = offs_all.shape[1]
    seeds = _extract_packed(jpack, offs_all, seed_len).reshape(-1, seed_len)
    top_s, bot_s = fm.seed_search_exact(half, seeds, valid_all.reshape(-1),
                                        seed_len, ftab_chars)
    seed_top = top_s.reshape(B2, smax)
    seed_bot = bot_s.reshape(B2, smax)

    # pigeonhole half-read search: reversed h2 is a prefix of R; reversed
    # h1 is R shifted by (len - mid)
    mid = lens2 // 2
    Hmax = Lmax // 2 + 1
    h2r = torch.where(parange[:, :Hmax] < (lens2 - mid)[:, None],
                      R[:, :Hmax], 5)
    h1r = _extract_packed(rpack, (lens2 - mid)[:, None], Hmax)[:, 0, :]
    h1r = torch.where(_ar(Hmax, dev)[None, :] < mid[:, None], h1r, 5)
    htop, hbot = fm.substring_search_rr(half, torch.cat([h1r, h2r], dim=0))
    half_off = torch.stack([torch.zeros_like(mid), mid], dim=1)
    half_mlen = torch.stack([mid, lens2 - mid], dim=1)
    half_top = htop.reshape(2, B2).T
    half_bot = hbot.reshape(2, B2).T
    if no_1mm:
        half_top = torch.zeros_like(half_top)
        half_bot = torch.zeros_like(half_bot)

    tops2 = torch.cat([seed_top, half_top], dim=1)
    bots2 = torch.cat([seed_bot, half_bot], dim=1)
    offs2 = torch.cat([offs_all, half_off], dim=1)
    mlens2 = torch.cat([torch.full((B2, smax), seed_len, dtype=i32,
                                   device=dev), half_mlen], dim=1)
    halfs2 = torch.cat([torch.zeros((B2, smax), dtype=torch.bool, device=dev),
                        torch.ones((B2, 2), dtype=torch.bool, device=dev)],
                       dim=1)
    if n1:
        # -N 1 pigeonhole: exact search of both halves of every seed
        hlen = seed_len // 2
        sh_offs = torch.clamp(torch.cat([offs_all, offs_all + hlen], dim=1),
                              0, Lmax - 1)
        sh_valid = torch.cat([offs_all + seed_len <= Lmax] * 2, dim=1)
        sh_seeds = _extract_packed(jpack, sh_offs, hlen).reshape(-1, hlen)
        shtop, shbot = fm.seed_search_exact(half, sh_seeds,
                                            sh_valid.reshape(-1), hlen,
                                            half_ftab)
        tops2 = torch.cat([tops2, shtop.reshape(B2, 2 * smax)], dim=1)
        bots2 = torch.cat([bots2, shbot.reshape(B2, 2 * smax)], dim=1)
        offs2 = torch.cat([offs2, sh_offs], dim=1)
        mlens2 = torch.cat([mlens2, torch.full((B2, 2 * smax), hlen,
                                               dtype=i32, device=dev)], dim=1)
        halfs2 = torch.cat([halfs2, torch.zeros((B2, 2 * smax),
                                                dtype=torch.bool,
                                                device=dev)], dim=1)

    # ---------------- phase 3a: slot assembly ----------------
    sweep_bot = sweep.top if no_exact else sweep.bot
    if live_or is not None:
        sweep_bot = torch.where(live_or, sweep_bot, sweep.top)
        bots2 = torch.where(live_or[:, None], bots2, tops2)
    (slot_valid, slot_row, slot_or, slot_off, slot_exact, slot_mlen,
     slot_half) = _assemble_slots(
        B, T, lens, live_read, sweep.top, sweep_bot, sweep.nedit,
        tops2, bots2, offs2, mlens2, halfs2, max_exact_rows)

    # ---------------- phase 3b: SA resolution of every slot ----------------
    jpos = fm.sa_resolve(half, slot_row.reshape(-1), period=period
                         ).reshape(B, T)
    # straddle filter: the matched stretch stays inside one segment; for
    # half-read slots the FULL read span must fit
    segi = torch.clamp(torch.searchsorted(seg.seg_joined_start, jpos,
                                          right=True) - 1, min=0)
    seg_js = _take(seg.seg_joined_start, segi)
    seg_end = _take(seg.seg_end_joined, segi)
    seg_ok = jpos + slot_mlen <= seg_end
    r0 = jpos - slot_off
    full_ok = (r0 >= seg_js) & (r0 + lens[:, None] <= seg_end)
    slot_valid = slot_valid & seg_ok & (~slot_half | full_ok)
    gpos = _take(seg.seg_global_start, segi) + (jpos - seg_js)
    anchor = (gpos - slot_off).to(i32)
    rid = (torch.searchsorted(seg.ref_cum, gpos.to(i32), right=True) - 1
           ).to(i32)

    # dedupe by (orient, anchor) within each read, keep the first slot;
    # half_only: the anchor is discoverable only via a half-read range
    same = (slot_or[:, :, None] == slot_or[:, None, :]) & \
           (anchor[:, :, None] == anchor[:, None, :]) & \
           slot_valid[:, :, None] & slot_valid[:, None, :]
    tt = _ar(T, dev)
    earlier = tt[None, :, None] > tt[None, None, :]
    dup = (same & earlier).any(dim=2)
    seed_src = slot_valid & ~slot_half & ~slot_exact
    half_only = (same & slot_half[:, None, :]).any(dim=2) \
        & ~(same & seed_src[:, None, :]).any(dim=2) \
        & ~(same & slot_exact[:, None, :]).any(dim=2)
    slot_valid = slot_valid & ~dup

    # ---------------- phase 4: compact -> windows -> DP ----------------
    flat_valid = slot_valid.reshape(-1)
    ckeys = torch.where(flat_valid, _ar(B * T, dev), BIGKEY)
    perm = torch.argsort(ckeys, stable=True)[:NC].to(i32)
    live_c = _take(ckeys, perm) < BIGKEY
    ci_read = torch.where(live_c, perm // T, 0)
    ci_slot = torch.where(live_c, perm % T, 0)
    flat_cs = (ci_read * T + ci_slot).long()

    c_anchor = anchor.reshape(-1)[flat_cs]
    c_or = slot_or.reshape(-1)[flat_cs]
    c_rid = torch.where(live_c, rid.reshape(-1)[flat_cs], 0)
    c_half = half_only.reshape(-1)[flat_cs] & live_c

    win_start = torch.where(live_c, c_anchor - G, 0)
    lo = _take(seg.ref_cum, c_rid)
    hi = _take(seg.ref_cum, c_rid + 1)
    wins, col_shift = gather_windows_aligned(ref_words, refn_words,
                                             win_start, lo, hi, W)
    astart = win_start - col_shift

    rows_idx = c_or * B + ci_read
    jreads_c = _take(jboth, rows_idx)
    jquals_c = _take(jquals, rows_idx)
    lens_c = torch.where(live_c, _take(lens, ci_read), 1).to(i32)
    rect_cols = lens_c + 2 * G + 1

    # ungapped anchor-diagonal readout of every candidate: the diagonal of
    # rect column G + i for read row i, at the row's own window shift
    # (the JAX program's 32-way select over col_shift, as one gather)
    read_live = parange < lens_c[:, None]
    diag = wins.gather(1, (col_shift[:, None] + G + parange).long())
    mmpen_c = mm_penalty_from_qual(jquals_c, params)
    isn = (jreads_c >= 4) | (diag == 4)
    oob = diag >= 5
    eq = (diag == jreads_c) & ~isn & ~oob
    sub = torch.where(eq, params.match_bonus,
                      torch.where(isn & ~oob, -params.n_pen, -mmpen_c))
    mm_ug = (((jreads_c != diag) | (jreads_c >= 4)) & read_live).sum(dim=1) \
        .to(i32)
    d_score = torch.where(read_live & ~oob, sub, 0).sum(dim=1).to(i32)
    d_oob = (read_live & oob).any(dim=1)

    # DP-lane bypass (e2e): a candidate whose anchor diagonal lies inside
    # the window with at most bypass_mm penalized positions is provably
    # diagonal-optimal; only the remainder is compacted into NCDP DP lanes
    ncdp = NC if NCDP is None else min(NCDP, NC)
    min_gap_cost = min(params.read_gap_open + params.read_gap_extend,
                       params.ref_gap_open + params.ref_gap_extend)
    max_pos_pen = max(params.mm_pen_max, params.n_pen, 1)
    bypass_mm = 0 if (params.local or params.match_bonus > 0) \
        else max((min_gap_cost - 1) // max_pos_pen, 0)
    if ncdp >= NC or bypass_mm == 0:
        res = sw_banded(jreads_c, jquals_c, lens_c, wins, params, G,
                        rect_cols, col_shift)
        dplane = _ar(NC, dev)
        n_dpdrop = torch.zeros((), dtype=i32, device=dev)
    else:
        needs_dp = live_c & ((mm_ug > bypass_mm) | d_oob)
        dpk = torch.where(needs_dp, _ar(NC, dev), BIGKEY)
        dperm = torch.argsort(dpk, stable=True)[:ncdp].to(i32)
        dlive = _take(dpk, dperm) < BIGKEY
        res_dp = sw_banded(_take(jreads_c, dperm), _take(jquals_c, dperm),
                           torch.where(dlive, _take(lens_c, dperm), 1),
                           _take(wins, dperm), params, G,
                           _take(rect_cols, dperm), _take(col_shift, dperm))
        dpos = torch.where(dlive, dperm, NC)
        res = SWResult(
            _set_drop(d_score, dpos, res_dp.score),
            _set_drop(lens_c - 1, dpos, res_dp.row),
            _set_drop(col_shift + G + lens_c - 1, dpos, res_dp.lane),
            res_dp.dirs)
        dplane = _set_drop(torch.full((NC,), -1, dtype=i32, device=dev),
                           dpos, _ar(ncdp, dev))
        n_dpdrop = torch.clamp(needs_dp.sum() - ncdp, min=0).to(i32)

    c_score = torch.where(live_c, res.score, NEG)
    c_valid = live_c & (c_score >= _take(minsc, ci_read)) & \
        ~(c_half & (mm_ug > 1))
    c_end = astart + res.lane

    # per-read seed-hit demand (SeedResults::averageHitsPerSeed inputs)
    seed_w_all = torch.clamp(seed_bot - seed_top, min=0)
    selt2 = seed_w_all.sum(dim=1).to(i32)
    snz2 = (seed_w_all > 0).sum(dim=1).to(i32)

    return dict(
        B=B, Lmax=Lmax, W=W, sweep=sweep, sweep_bot=sweep_bot,
        seed_elts=selt2[:B] + selt2[B:], seed_nz=snz2[:B] + snz2[B:],
        slot_or=slot_or, earlier=earlier, flat_valid=flat_valid, perm=perm,
        live_c=live_c, c_or=c_or, c_rid=c_rid, wins=wins, astart=astart,
        jreads_c=jreads_c, jquals_c=jquals_c, res=res, c_score=c_score,
        c_valid=c_valid, c_end=c_end, dplane=dplane, n_dpdrop=n_dpdrop)


def fused_se(half: FMHalf, ref_words, refn_words, seg: SegTables,
             jboth, jquals, lens, offs_all, valid_all, minsc, live_read,
             live_or=None, *, params: SWParams, band: int, seed_len: int,
             ftab_chars: int, half_ftab: int, period: int, T: int, kk: int,
             kk_bt: int, NC: int, n1: bool, max_exact_rows: int = 4,
             no_1mm: bool = False, no_exact: bool = False,
             NCDP: Optional[int] = None) -> FusedResult:
    """Whole single-end batch pipeline (bowtie2_tpu/ops/fused.py fused_se).

    jboth/jquals: (2B, Lmax) int32 fw+rc codes / quals; lens: (B,);
    offs_all/valid_all: (2B, smax) seed offsets (fw rows then rc rows);
    minsc: (B,) int32; live_read: (B,) bool; live_or: optional (2B,) bool
    per-orientation-row liveness (--nofw/--norc). kk = ranked slots
    returned per read, kk_bt = slots backtraced per read, NC = DP problem
    budget, NCDP = DP lanes after the gapless bypass."""
    cx = _core(half, ref_words, refn_words, seg, jboth, jquals, lens,
               offs_all, valid_all, minsc, live_read, live_or, params,
               band, seed_len, ftab_chars, half_ftab, period, T, NC, n1,
               max_exact_rows, no_1mm, no_exact, NCDP=NCDP)
    G = band
    B = cx["B"]
    dev = jboth.device
    (slot_or, flat_valid, perm, live_c, c_or, c_rid, wins, astart,
     jreads_c, jquals_c, res, c_score, c_valid, c_end, earlier) = (
        cx[k] for k in ("slot_or", "flat_valid", "perm", "live_c", "c_or",
                        "c_rid", "wins", "astart", "jreads_c", "jquals_c",
                        "res", "c_score", "c_valid", "c_end", "earlier"))

    # ---------------- phase 5: per-read ranking ----------------
    flat_ci = torch.where(live_c, perm, B * T)
    sc_sl = _set_drop(torch.full((B * T,), NEG, dtype=i32, device=dev),
                      flat_ci, torch.where(c_valid, c_score, NEG)
                      ).reshape(B, T)
    end_sl = _set_drop(torch.zeros(B * T, dtype=i32, device=dev), flat_ci,
                       c_end).reshape(B, T)
    cpos_sl = _set_drop(torch.zeros(B * T, dtype=i32, device=dev), flat_ci,
                        _ar(NC, dev)).reshape(B, T)
    vd_sl = sc_sl > NEG

    # dedupe by (orient, end): representative = max score, first on ties
    same2 = (slot_or[:, :, None] == slot_or[:, None, :]) & \
            (end_sl[:, :, None] == end_sl[:, None, :]) & \
            vd_sl[:, :, None] & vd_sl[:, None, :]
    better = (sc_sl[:, None, :] > sc_sl[:, :, None]) | \
             ((sc_sl[:, None, :] == sc_sl[:, :, None]) & earlier)
    rep = vd_sl & ~(same2 & better).any(dim=2)

    # rank key: score desc, slot index asc (canonical tie-break)
    rkey = torch.where(rep, sc_sl * 32 + (31 - _ar(T, dev))[None, :], NEG)
    rorder = torch.argsort(-rkey, dim=1, stable=True)[:, :kk]
    r_valid = rkey.gather(1, rorder) > NEG
    r_score = torch.where(r_valid, sc_sl.gather(1, rorder), NEG)

    # ---------------- phase 6: backtrace chosen ----------------
    ch_slot = rorder[:, :kk_bt]
    ch_ok = r_valid[:, :kk_bt]
    ch_ci = torch.where(ch_ok, cpos_sl.gather(1, ch_slot), 0).T.reshape(-1)
    ch_okf = ch_ok.T.reshape(-1)
    rows_sel = _take(res.row, ch_ci)
    lanes_sel = _take(res.lane, ch_ci)
    reads_sel = _take(jreads_c, ch_ci)
    quals_sel = _take(jquals_c, ch_ci)
    wins_sel = _take(wins, ch_ci)
    Bc = ch_ci.shape[0]
    zero = torch.zeros((), dtype=i32, device=dev)
    if params.local:
        # soft-clipped starts need the walk for every record
        bt = backtrace(res.dirs, ch_ci, rows_sel, lanes_sel, reads_sel,
                       quals_sel, wins_sel, params, G)
        ops_full = bt.ops
        rdstart, refstart = bt.read_start, bt.ref_start_win
        nmm, ngo, ngc, nrefn = bt.n_mm, bt.n_go, bt.n_gc, bt.n_refn
        sccheck = bt.score_check
        n_btdrop = zero
    else:
        # gapless fast path: walk the diagonal by readout; scan-walk only
        # the gapped remainder, compacted to an NBT budget
        (ops_syn, dscore, s_nmm, s_nrefn, s_base, gok) = diag_readout(
            reads_sel, quals_sel, wins_sel, rows_sel, lanes_sel,
            rows_sel + 1, params)
        gapless = ch_okf & gok & (dscore == _take(res.score, ch_ci))
        need_bt = ch_okf & ~gapless
        NBT = max(Bc // 4, 64)
        bkeys = torch.where(need_bt, _ar(Bc, dev), BIGKEY)
        gperm = torch.argsort(bkeys, stable=True)[:NBT].to(i32)
        glive = _take(bkeys, gperm) < BIGKEY
        gci = _take(ch_ci, gperm)
        gdpl = _take(cx["dplane"], gci)
        n_dplmiss = (glive & (gdpl < 0)).sum().to(i32)
        glive = glive & (gdpl >= 0)
        bt = backtrace(res.dirs, torch.clamp(gdpl, min=0),
                       _take(res.row, gci), _take(res.lane, gci),
                       _take(jreads_c, gci), _take(jquals_c, gci),
                       _take(wins, gci), params, G)
        pos = torch.where(glive, gperm, Bc)
        ops_full = torch.full((bt.ops.shape[0], Bc), OP_NONE,
                              dtype=torch.uint8, device=dev)
        ops_full[:ops_syn.shape[0]] = ops_syn
        ops_full = _set_drop(ops_full, pos, bt.ops, dim=1)
        z = torch.zeros(Bc, dtype=i32, device=dev)
        rdstart = _set_drop(z, pos, bt.read_start)
        refstart = _set_drop(s_base, pos, bt.ref_start_win)
        nmm = _set_drop(s_nmm, pos, bt.n_mm)
        ngo = _set_drop(z, pos, bt.n_go)
        ngc = _set_drop(z, pos, bt.n_gc)
        nrefn = _set_drop(s_nrefn, pos, bt.n_refn)
        sccheck = _set_drop(dscore, pos, bt.score_check)
        n_btdrop = torch.clamp(need_bt.sum() - NBT, min=0).to(i32) + n_dplmiss

    g_start = _take(astart, ch_ci) + refstart
    ch_rid = _take(c_rid, ch_ci)
    roff = g_start - _take(seg.ref_cum, ch_rid)
    # exact end-to-end sweep ranges per orientation (top low/high words +
    # width), then the per-read seed demand: the RNG-replay layer's inputs
    sweep = cx["sweep"]
    ee_w2 = torch.where((sweep.nedit == 0) & (cx["sweep_bot"] > sweep.top),
                        cx["sweep_bot"] - sweep.top, 0)
    ee_lo = sweep.top
    ee_hi = torch.zeros_like(ee_lo)
    ee_block = torch.cat([
        ee_lo[:B], ee_hi[:B], ee_w2[:B], ee_lo[B:], ee_hi[B:], ee_w2[B:],
        cx["seed_elts"], cx["seed_nz"]])
    # n_dropped: candidates beyond the NC DP budget or gapped backtraces
    # beyond the NBT budget (the host path then takes the batch)
    n_dropped = torch.clamp(flat_valid.sum() - NC, min=0).to(i32) \
        + n_btdrop + cx["n_dpdrop"]
    meta = torch.cat([t.reshape(-1).to(i32) for t in (
        r_score.T, r_valid.T, ch_okf, _take(c_or, ch_ci), ch_rid, roff,
        rdstart, rows_sel + 1, nmm, ngo, ngc, nrefn, sccheck,
        _take(c_score, ch_ci), n_dropped, ee_block)])
    blob = torch.cat([ops_full.reshape(-1), meta.view(torch.uint8)])
    return FusedResult(blob)
