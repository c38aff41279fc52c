"""Single-end batch pipeline on the device, end to end (torch + kernels).

Port of bowtie2_tpu/ops/fused.py (SE half). One call per batch runs

  exact sweep + seed search + half-read search     (fm kernels)
  -> per-read candidate slot assembly               (canonical budget order)
  -> SA resolution of every slot                    (sa_resolve kernel)
  -> straddle filter, anchor dedupe                 (per-read slot masks)
  -> compaction -> windows -> banded DP  (ref_gather and sw_rect kernels)
  -> per-read ranking (dedupe by (orient, end))
  -> backtrace of the reported candidates           (backtrace kernel)

and returns one uint8 blob whose bytes equal the JAX program's: packed
backtrace ops, then the int32 metadata vector (CHOSEN_FIELDS per chosen
candidate; layout decoded by pipeline/align.py). The glue between kernels
is plain torch: gathers, sorts and masks, compacting by sort as the JAX
program does, so a call issues no host synchronisation.

In the large index mode (index/fmindex.py) the searches' rows are int64
tensors holding uint32 values, and from the SA walk on the position
arithmetic (joined offsets, global positions, anchors, window starts and
ends) is int64, the segment tables' type; the exports wrap rows and
positions to int32 words where the JAX program casts them (`_i32`), and
the host decodes them (pipeline/align.py `_u32pos`). The int64 row mode
is the same with int64 rows, whose exact-sweep tops the SE export splits
into two int32 words, as the JAX program does.
"""

from typing import NamedTuple, Optional

import torch

from bowtie2_tpu_torch.index.fmindex import FMHalf
from bowtie2_tpu_torch.ops import _build, fm
from bowtie2_tpu_torch.ops._build import I, P, check, on_cpu, ptr
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
    """Joined-text segment geometry (device copies of IndexData tables):
    int32, or int64 in the large index mode."""
    seg_joined_start: torch.Tensor   # (nseg,)
    seg_global_start: torch.Tensor   # (nseg,)
    seg_end_joined: torch.Tensor     # (nseg,) = joined_start + len
    ref_cum: torch.Tensor            # (nref+1,)


class FusedResult(NamedTuple):
    blob: torch.Tensor   # (S*Bc + 4*(B*2*kk + Bc*CHOSEN_FIELDS + 1 + 8*B),)
                         # uint8: packed ops, then the int32 metadata bytes


def _ar(n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=i32, device=dev)


def _i32(t: torch.Tensor) -> torch.Tensor:
    """The int32 image of t: int64 values (the large mode's rows and global
    positions) wrap mod 2^32, as the JAX program's int32 casts do."""
    if t.dtype == torch.int64:
        t = ((t + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return t.to(i32)


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
    slot_mlen, slot_half, slot_rangej, slot_rwidth — all (B, T)."""
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
    # source-range bookkeeping of the PE -D effort model (pe_effort.py):
    # range id in width-sorted order (-2/-1 = exact fw/rc) and the source
    # range's full SA width
    ex_full = _i32(sw_bot - sw_top).index_select(
        0, (ex_or * B + rdix).reshape(-1).long()).reshape(B, T)
    slot_rangej = torch.where(is_exact, -2 + ex_or, sj.to(i32))
    slot_rwidth = torch.where(is_exact, ex_full, w.gather(1, sj))
    return (slot_valid, slot_row.to(sw_top.dtype), slot_or.to(i32),
            slot_off.to(i32), is_exact & slot_valid, slot_mlen.to(i32),
            slot_half, slot_rangej.to(i32), slot_rwidth.to(i32))


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t.index_select(0, idx.reshape(-1).long()).reshape(
        idx.shape + t.shape[1:])


def _core(half: FMHalf, ref_words, refn_words, seg: SegTables,
          jboth, jquals, lens, offs_all, valid_all, minsc, live_read,
          live_or, params: SWParams, band: int, seed_len: int,
          ftab_chars: int, half_ftab: int, period: int, T: int,
          NC: int, n1: bool, max_exact_rows: int, no_1mm: bool,
          no_exact: bool = False, NCDP: Optional[int] = None,
          track_origin: bool = False):
    """Phases 1-4: searches → slots → SA resolve → DP. Returns a dict of
    the intermediates fused_se ranks and backtraces from and fused_pe
    exports per slot (track_origin: the DP reports each path's origin)."""
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
     slot_half, slot_rangej, slot_rwidth) = _assemble_slots(
        B, T, lens, live_read, sweep.top, sweep_bot, sweep.nedit,
        tops2, bots2, offs2, mlens2, halfs2, max_exact_rows)

    # ---------------- phase 3b: SA resolution of every slot ----------------
    # positions take the row mode's tensor type, as the segment tables do
    # (int64 in the large mode: window starts may be negative near the
    # origin, and global positions may pass 2^31)
    pdt = half.row_dtype
    jpos = fm.sa_resolve(half, slot_row.reshape(-1), period=period
                         ).reshape(B, T).to(pdt)
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
    anchor = (gpos - slot_off).to(pdt)
    rid = (torch.searchsorted(seg.ref_cum, gpos.to(pdt), right=True) - 1
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
    # source flags aggregated over the duplicate group (the -D effort
    # model gives each anchor to the earliest phase that finds it)
    agg_exact = (same & slot_exact[:, None, :]).any(dim=2)
    agg_half = (same & slot_half[:, None, :]).any(dim=2)
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
        # the live candidates come first (perm), and every padding lane
        # after them is one problem (read 0 of the first slot's strand at
        # window 0, length 1): the DP runs the live lanes and the first
        # padding lane, whose result the other padding lanes take, as the
        # JAX program's export holds it for every lane
        n_cand = live_c.sum()
        res = sw_banded(jreads_c, jquals_c, lens_c, wins, params, G,
                        rect_cols, col_shift, track_origin=track_origin,
                        n_live=torch.clamp(n_cand + 1, max=NC))
        pad_k = torch.clamp(n_cand, max=NC - 1).reshape(1)
        pad = _ar(NC, dev) > n_cand

        def first_pad(f):
            return torch.where(pad, _take(f, pad_k), f)
        res = res._replace(
            score=first_pad(res.score), row=first_pad(res.row),
            lane=first_pad(res.lane),
            origin=None if res.origin is None else first_pad(res.origin))
        dplane = _ar(NC, dev)
        n_dpdrop = torch.zeros((), dtype=i32, device=dev)
    else:
        needs_dp = live_c & ((mm_ug > bypass_mm) | d_oob)
        dpk = torch.where(needs_dp, _ar(NC, dev), BIGKEY)
        dperm = torch.argsort(dpk, stable=True)[:ncdp].to(i32)
        dlive = _take(dpk, dperm) < BIGKEY
        # dperm puts the lanes that need the DP first: only those run
        res_dp = sw_banded(_take(jreads_c, dperm), _take(jquals_c, dperm),
                           torch.where(dlive, _take(lens_c, dperm), 1),
                           _take(wins, dperm), params, G,
                           _take(rect_cols, dperm), _take(col_shift, dperm),
                           track_origin=track_origin,
                           n_live=torch.clamp(needs_dp.sum(), max=ncdp))
        dpos = torch.where(dlive, dperm, NC)
        res = SWResult(
            _set_drop(d_score, dpos, res_dp.score),
            _set_drop(lens_c - 1, dpos, res_dp.row),
            _set_drop(col_shift + G + lens_c - 1, dpos, res_dp.lane),
            res_dp.dirs,
            _set_drop(col_shift + G, dpos, res_dp.origin)
            if track_origin else None)
        dplane = _set_drop(torch.full((NC,), -1, dtype=i32, device=dev),
                           dpos, _ar(ncdp, dev))
        n_dpdrop = torch.clamp(needs_dp.sum() - ncdp, min=0).to(i32)

    c_score = torch.where(live_c, res.score, NEG)
    c_valid = live_c & (c_score >= _take(minsc, ci_read)) & \
        ~(c_half & (mm_ug > 1))
    c_end = astart + res.lane

    # per-read seed-hit demand (SeedResults::averageHitsPerSeed inputs)
    seed_w_all = _i32(torch.clamp(seed_bot - seed_top, min=0))
    selt2 = seed_w_all.sum(dim=1).to(i32)
    snz2 = (seed_w_all > 0).sum(dim=1).to(i32)

    return dict(
        B=B, Lmax=Lmax, W=W, sweep=sweep, sweep_bot=sweep_bot,
        seed_elts=selt2[:B] + selt2[B:], seed_nz=snz2[:B] + snz2[B:],
        slot_valid=slot_valid, slot_or=slot_or, slot_rangej=slot_rangej,
        slot_rwidth=slot_rwidth, agg_exact=agg_exact, agg_half=agg_half,
        anchor=anchor, rid=rid, earlier=earlier, flat_valid=flat_valid,
        perm=perm, live_c=live_c, c_or=c_or, c_rid=c_rid, wins=wins,
        astart=astart, jreads_c=jreads_c, jquals_c=jquals_c, res=res,
        mm_ug=mm_ug, c_score=c_score, c_valid=c_valid, c_end=c_end,
        dplane=dplane, n_dpdrop=n_dpdrop)


def se_walks(Bc: int, local: bool) -> int:
    """The walks fused_se sends to the backtrace for Bc chosen slots: all
    of them in local mode (soft-clipped starts need the walk), the NBT
    lanes of the gapped remainder end to end."""
    return Bc if local else max(Bc // 4, 64)


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
    end_sl = _set_drop(torch.zeros(B * T, dtype=c_end.dtype, device=dev),
                       flat_ci, c_end).reshape(B, T)
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
        NBT = se_walks(Bc, False)
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
    # the rows' low and high int32 words (high words only in the int64 row
    # mode; the export wraps the low ones)
    ee_lo = sweep.top
    ee_hi = sweep.top >> 32 if half.i64 else torch.zeros_like(ee_lo)
    ee_block = torch.cat([
        ee_lo[:B], ee_hi[:B], ee_w2[:B], ee_lo[B:], ee_hi[B:], ee_w2[B:],
        cx["seed_elts"], cx["seed_nz"]])
    # n_dropped: candidates beyond the NC DP budget or gapped backtraces
    # beyond the NBT budget (the host path then takes the batch)
    n_dropped = torch.clamp(flat_valid.sum() - NC, min=0).to(i32) \
        + n_btdrop + cx["n_dpdrop"]
    meta = torch.cat([_i32(t.reshape(-1)) for t in (
        r_score.T, r_valid.T, ch_okf, _take(c_or, ch_ci), ch_rid, roff,
        rdstart, rows_sel + 1, nmm, ngo, ngc, nrefn, sccheck,
        _take(c_score, ch_ci), n_dropped, ee_block)])
    blob = torch.cat([ops_full.reshape(-1), meta.view(torch.uint8)])
    return FusedResult(blob)


# ---------------------------------------------------------------------------
# paired-end: every slot's metadata + the device half of the pairing
# ---------------------------------------------------------------------------

# per-slot metadata fields exported for host pairing / effort replay
PE_SLOT_FIELDS = 15
# per-compact-candidate fields for DPPool reconstruction: astart, rid, row,
# lane, score, dplane (candidate -> DP lane of the NCDP-compacted dirs, -1 =
# bypassed)
PE_CI_FIELDS = 6
# device-pairing exports (layout = pipeline/align.py PairedAligner):
# read (B2): first_cpos first_or first_lo first_hi first_s has_l
#            sec_cpos sec_s has_l2 nL
# pair (Bp): has b1_cpos b1_or b1_lo b1_hi b1_s b2_cpos b2_or b2_lo b2_hi
#            b2_s best_ss sec_ss n_kept hostneed
PE_READ_FIELDS = 10
PE_PAIR_FIELDS = 15

# pairing rank sentinel (the host mirror uses 1 << 30)
PAIR_BIGR = 1 << 30


class FusedPEResult(NamedTuple):
    blob: torch.Tensor      # int32 (PE_READ_FIELDS*B2 + PE_PAIR_FIELDS*Bp +
                            # 2*B2 + PE_CI_FIELDS*NC + 1,): the one transfer
                            # the fast path needs
    slots: torch.Tensor     # int32 (PE_SLOT_FIELDS, B2, T) per-slot metadata,
                            # read only on the host-replay path
    dirs: torch.Tensor      # device tensors kept for the emission backtrace
    jreads_c: torch.Tensor
    jquals_c: torch.Tensor
    wins: torch.Tensor


# the pairing policies in the kernel's numbering (csrc/pe_pairing.cu)
PE_POLICIES = {"ff": 0, "rr": 1, "fr": 2, "rf": 3}


def _pe_pairing(pairing, B, Bp, T_, aok, score, slot_or, rid, lo_p, hi_p,
                occ, exact, half, mmug, cpos, ee_read, seed_nz, inst_read,
                filtered):
    """Device half of PairedAligner._collect_fused's pairing (K10 PE,
    bowtie2_tpu/ops/fused.py _pe_pairing): the same tie-break orders and
    first-index argmax/argmin as the host numpy. Pairs that need the
    host's replay paths raise `hostneed`. Returns (read_fields
    (PE_READ_FIELDS, B), pair_fields (PE_PAIR_FIELDS, Bp)), int32. A CUDA
    tensor launches `pe_pairing` (csrc/pe_pairing.cu, two pairs a warp
    at T <= 16, one at T <= 32; B = 2 Bp); CPU tensors take the plain
    version."""
    args = (pairing, B, Bp, T_, aok, score, slot_or, rid, lo_p, hi_p, occ,
            exact, half, mmug, cpos, ee_read, seed_nz, inst_read, filtered)
    if on_cpu(score, "pe_pairing"):
        return _pe_pairing_plain(*args)
    (pe_pol, minins, maxins, olap_ok, contain_ok, dove_ok, limit) = pairing
    if not 1 <= T_ <= 32 or B != 2 * Bp or pe_pol not in PE_POLICIES:
        raise ValueError(f"pe_pairing: T={T_} (1..32), B={B} = 2 x "
                         f"Bp={Bp}, policy {pe_pol!r}")
    if limit is not None and limit < 0:
        raise ValueError(f"pe_pairing: limit {limit} < 0")
    dev = score.device
    ext = lo_p.dtype
    if ext not in (i32, torch.int64):
        raise TypeError(f"pe_pairing: int32 or int64 extents, not {ext}")

    def slot(t, dtype=i32, name="slot field"):
        t = t.view(torch.uint8) if t.dtype == torch.bool else t
        return check(t.contiguous(), name, dtype=dtype, shape=(B, T_),
                     device=dev)

    def read(t, dtype=i32, name="read field"):
        t = t.view(torch.uint8) if t.dtype == torch.bool else t
        return check(t.contiguous(), name, dtype=dtype, shape=(B,),
                     device=dev)
    u8 = torch.uint8
    ins = ([slot(t) for t in (aok, score, slot_or, rid)]
           + [slot(lo_p, ext, "lo_p"), slot(hi_p, ext, "hi_p")]
           + [slot(t, u8) for t in (occ, exact, half)]
           + [slot(mmug), slot(cpos)]
           + [read(t) for t in (ee_read, seed_nz, inst_read)]
           + [read(filtered, u8, "filtered")])
    read_fields = torch.empty((PE_READ_FIELDS, B), dtype=i32, device=dev)
    pair_fields = torch.empty((PE_PAIR_FIELDS, Bp), dtype=i32, device=dev)
    ptrs = [ptr(t) for t in ins]
    _build.call("pe_pairing", "pe_pairing", [P] * 6 + [I] + [P] * 9
                + [I] * 10 + [P, P],
                *ptrs[:6], int(ext == torch.int64), *ptrs[6:], Bp, T_,
                PE_POLICIES[pe_pol], minins, maxins, int(olap_ok),
                int(contain_ok), int(dove_ok),
                -1 if limit is None else limit,
                max(T_ - 1, 1).bit_length(), ptr(read_fields),
                ptr(pair_fields))
    return read_fields, pair_fields


def _pe_pairing_plain(pairing, B, Bp, T_, aok, score, slot_or, rid, lo_p,
                      hi_p, occ, exact, half, mmug, cpos, ee_read, seed_nz,
                      inst_read, filtered):
    """The plain K10 PE, as torch ops over (pairs, T, T) masks, as the JAX
    op computes it."""
    from bowtie2_tpu_torch.pipeline.pe import PE_DISCORD, pe_classify_torch
    (pe_pol, minins, maxins, olap_ok, contain_ok, dove_ok, limit) = pairing
    dev = score.device
    AOK = aok.to(torch.bool)
    S = score
    OR = slot_or
    tj = _ar(T_, dev)

    # dedupe by (orient, end): a slot loses to a same-key slot of higher
    # score, or of equal score and earlier index
    same = (OR[:, :, None] == OR[:, None, :]) & \
           (hi_p[:, :, None] == hi_p[:, None, :]) & \
           AOK[:, :, None] & AOK[:, None, :]
    s_gt = S[:, None, :] > S[:, :, None]
    s_eq = S[:, None, :] == S[:, :, None]
    t_lt = tj[None, None, :] < tj[None, :, None]
    rep = AOK & ~(same & (s_gt | (s_eq & t_lt))).any(dim=2)

    # rankpos[j] = rank under the key (~rep asc, -S asc, tj asc), counted
    # pairwise (tj makes every key distinct)
    nrep = (~rep).to(i32)
    less = (nrep[:, None, :] < nrep[:, :, None]) | \
           ((nrep[:, None, :] == nrep[:, :, None]) & (s_gt | (s_eq & t_lt)))
    rankpos = less.sum(dim=2).to(i32)

    # concordant cross-products (pairs, T, T)
    conc = (rid[:Bp, :, None] == rid[Bp:, None, :]) & \
        rep[:Bp][:, :, None] & rep[Bp:][:, None, :]
    typ = pe_classify_torch(
        pe_pol,
        lo_p[:Bp][:, :, None], hi_p[:Bp][:, :, None],
        (OR[:Bp] == 0)[:, :, None],
        lo_p[Bp:][:, None, :], hi_p[Bp:][:, None, :],
        (OR[Bp:] == 0)[:, None, :],
        minins, maxins, olap_ok, contain_ok, dove_ok)
    conc = conc & (typ != PE_DISCORD)
    SUCC = torch.cat([conc.any(dim=2), conc.any(dim=1)], dim=0)

    # zero-seed-round suppression (bt2_search.cpp:3948/:3968 `break`)
    n1e, n2e = ee_read[:Bp], ee_read[Bp:]
    swap = (n1e > 0) & (n2e > 0) & (n1e > n2e)
    inst_first = torch.where(swap, inst_read[Bp:], inst_read[:Bp])
    snz_first = torch.where(swap, seed_nz[Bp:], seed_nz[:Bp])
    both_ok = ~filtered[:Bp] & ~filtered[Bp:]
    supp_pair = both_ok & ((inst_first == 0) | (snz_first == 0))
    suppress = torch.cat([supp_pair, supp_pair])
    half_ok = half & torch.where(suppress[:, None], mmug <= 1, True)

    # -D fail-streak fast path; non-fast reads -> host replay
    nex = (occ & exact).sum(dim=1)
    nhf = (occ & half_ok & ~exact).sum(dim=1)
    nsd = (occ & ~exact & ~half).sum(dim=1)
    if limit is None:
        fast = torch.ones(B, dtype=torch.bool, device=dev)
    else:
        fast = (nex <= limit) & (nhf <= limit) & \
            torch.where(suppress, True, nsd <= limit)
    # suppressed rows with surviving half candidates need the host's
    # oneMmSearch legality refinement
    need_mm1 = suppress & (occ & half_ok & ~exact).any(dim=1)
    hostneed_read = (~fast) | need_mm1
    ATT = occ & torch.where(suppress[:, None], exact | half_ok, True)
    SUC = ATT & SUCC

    # best concordant combo per pair: (SS desc, mate-1 rank asc, mate-2
    # rank asc) packed into one int32 key (rankpos < T)
    keep = conc & (SUC[:Bp][:, :, None] | SUC[Bp:][:, None, :])
    SS = S[:Bp][:, :, None] + S[Bp:][:, None, :]
    shift = max(T_ - 1, 1).bit_length()
    KMIN = -(1 << 31) + 1
    key = torch.where(
        keep,
        (SS << (2 * shift)) - (rankpos[:Bp][:, :, None] << shift)
        - rankpos[Bp:][:, None, :],
        KMIN)
    flatk = key.reshape(Bp, T_ * T_)
    bestflat = torch.argmax(flatk, dim=1)
    has = keep.reshape(Bp, -1).any(dim=1)
    b_s1 = (bestflat // T_)[:, None]
    b_s2 = (bestflat % T_)[:, None]
    SSf = SS.reshape(Bp, -1)
    best_ss = SSf.gather(1, bestflat[:, None])[:, 0]
    n_kept = keep.reshape(Bp, -1).sum(dim=1).to(i32)
    flatk2 = flatk.scatter(1, bestflat[:, None], KMIN)
    sec_ss = SSf.gather(1, torch.argmax(flatk2, dim=1)[:, None])[:, 0]

    # eff-ranked heads (rescue anchors / discordant / mixed)
    att_rank = torch.where(rep & ATT, rankpos, PAIR_BIGR)
    first_rank = att_rank.min(dim=1).values
    first_slot = torch.argmin(att_rank, dim=1)
    has_l = first_rank < PAIR_BIGR
    att_rank2 = att_rank.scatter(1, first_slot[:, None], PAIR_BIGR)
    sec_slot = torch.argmin(att_rank2, dim=1)
    has_l2 = att_rank2.gather(1, sec_slot[:, None])[:, 0] < PAIR_BIGR
    nL = (rep & ATT).sum(dim=1).to(i32)

    def tk(arr, slot):       # positions wrap to int32 (host: _u32pos)
        return _i32(arr.gather(1, slot.reshape(-1, 1))[:, 0])

    fs, ss = first_slot, sec_slot
    read_fields = torch.stack([
        tk(cpos, fs), tk(OR, fs), tk(lo_p, fs), tk(hi_p, fs), tk(S, fs),
        has_l.to(i32), tk(cpos, ss), tk(S, ss), has_l2.to(i32), nL])
    pair_fields = torch.stack([
        has.to(i32),
        tk(cpos[:Bp], b_s1), tk(OR[:Bp], b_s1), tk(lo_p[:Bp], b_s1),
        tk(hi_p[:Bp], b_s1), tk(S[:Bp], b_s1),
        tk(cpos[Bp:], b_s2), tk(OR[Bp:], b_s2), tk(lo_p[Bp:], b_s2),
        tk(hi_p[Bp:], b_s2), tk(S[Bp:], b_s2),
        best_ss.to(i32), sec_ss.to(i32), n_kept,
        (hostneed_read[:Bp] | hostneed_read[Bp:]).to(i32)])
    return read_fields, pair_fields


def fused_pe(half: FMHalf, ref_words, refn_words, seg: SegTables,
             jboth, jquals, lens, offs_all, valid_all, minsc, live_read,
             live_or=None, inst_read=None, filtered=None,
             *, params: SWParams, band: int, seed_len: int, ftab_chars: int,
             half_ftab: int, period: int, T: int, NC: int, n1: bool,
             max_exact_rows: int = 4, no_1mm: bool = False,
             no_exact: bool = False, NCDP: Optional[int] = None,
             pairing=None) -> FusedPEResult:
    """Paired-end search half of the pipeline (bowtie2_tpu/ops/fused.py
    fused_pe): phases 1-4 of fused_se over a 2*Bp-read batch (mate-1 rows
    first, then mate-2) with the origin-tracking DP, exporting every slot's
    metadata (score, orientation, exact reference extents, source flags,
    SA-range bookkeeping) and, given `pairing`, the device pairing's
    per-read and per-pair fields. The dirs and compacted read/window
    tensors stay on the device for the emission backtrace."""
    cx = _core(half, ref_words, refn_words, seg, jboth, jquals, lens,
               offs_all, valid_all, minsc, live_read, live_or, params,
               band, seed_len, ftab_chars, half_ftab, period, T, NC, n1,
               max_exact_rows, no_1mm, no_exact, NCDP=NCDP,
               track_origin=True)
    B, T_ = cx["B"], cx["slot_valid"].shape[1]
    dev = jboth.device
    res = cx["res"]
    flat_ci = torch.where(cx["live_c"], cx["perm"], B * T_)

    def scat(vals, fill=0):
        return _set_drop(torch.full((B * T_,), fill, dtype=i32, device=dev),
                         flat_ci, _i32(vals)).reshape(B, T_)

    def scat_raw(vals):
        return _set_drop(torch.zeros(B * T_, dtype=vals.dtype, device=dev),
                         flat_ci, vals).reshape(B, T_)

    aok = scat(cx["c_valid"])
    score = scat(torch.where(cx["c_valid"], cx["c_score"], NEG), fill=NEG)
    # the device pairing keeps the true extents (int64 in the large mode);
    # the exported slot extents wrap to int32 (host: _u32pos)
    lo_p = scat_raw(cx["astart"] + res.origin)
    hi_p = scat_raw(cx["c_end"])
    lo, hi = _i32(lo_p), _i32(hi_p)
    rdend = scat(res.row + 1)
    cpos = scat(_ar(NC, dev), fill=-1)

    sweep = cx["sweep"]
    ee2 = _i32(torch.where((sweep.nedit == 0) & (cx["sweep_bot"] > sweep.top),
                           cx["sweep_bot"] - sweep.top, 0))
    ee_read = ee2[:B] + ee2[B:]                  # fw + rc rows per read

    n_dropped = (torch.clamp(cx["flat_valid"].sum() - NC, min=0)
                 + cx["n_dpdrop"]).to(i32).reshape(1)

    # per-slot ungapped anchor-diagonal mismatches (the zero-seed-round
    # suppression keeps only <= 1-mismatch half candidates) and e2e
    # diagonal start (the host gate re-derives the 1mm hit from it)
    mmug = scat(cx["mm_ug"])
    slot_fields = [
        cx["slot_valid"], aok.to(torch.bool), score, cx["slot_or"],
        cx["rid"], lo, hi, rdend, cx["agg_exact"], cx["agg_half"],
        cx["slot_rangej"], cx["slot_rwidth"], cpos, mmug, cx["anchor"]]
    ci_fields = [cx["astart"], cx["c_rid"], res.row, res.lane,
                 cx["c_score"], cx["dplane"]]
    slots = torch.stack([_i32(f) for f in slot_fields])

    Bp = B // 2
    if pairing is not None:
        read_fields, pair_fields = _pe_pairing(
            pairing, B, Bp, T_, aok, score, cx["slot_or"], cx["rid"],
            lo_p, hi_p, cx["slot_valid"], cx["agg_exact"], cx["agg_half"],
            mmug, cpos, ee_read, cx["seed_nz"].to(i32), inst_read, filtered)
    else:
        read_fields = torch.zeros((PE_READ_FIELDS, B), dtype=i32, device=dev)
        # hostneed=1 on every pair: no device decision to trust
        pair_fields = torch.zeros((PE_PAIR_FIELDS, Bp), dtype=i32,
                                  device=dev)
        pair_fields[PE_PAIR_FIELDS - 1] = 1

    blob = torch.cat(
        [read_fields.reshape(-1), pair_fields.reshape(-1), ee_read,
         # per-read round-0 seeds with a nonzero SA range: the reference's
         # rounds loop breaks when the first mate's seed search comes up
         # empty (bt2_search.cpp:3968-3971)
         cx["seed_nz"].to(i32)]
        + [_i32(f).reshape(-1) for f in ci_fields] + [n_dropped])
    return FusedPEResult(blob, slots, res.dirs, cx["jreads_c"],
                         cx["jquals_c"], cx["wins"])
