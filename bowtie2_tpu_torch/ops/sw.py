"""Rectangle gapped-extension DP and its direction walk, and the band-
coordinate DP and walk of long reads, in torch + CUDA.

Port of bowtie2_tpu/ops/sw.py. The DPs (`sw_banded`, `sw_banded_diag`),
the walks (`backtrace`, `backtrace_diag`) and the single-end gapless
readout (`diag_readout`) are hand-written kernels (csrc/sw_rect.cu,
csrc/backtrace.cu, csrc/sw_diag.cu, csrc/diag_readout.cu) for CUDA tensors;
beside each sits a plain PyTorch version of the same function, one or a
few torch ops per scan step, which runs for CPU tensors (the tests) and
which chip_smoke.py holds the kernels against on the card.

Scoring matches scoring.h defaults exactly in int32 (match 0 / mismatch
-(2..6 by qual) / N -1 / gaps -(5+3k)); end-to-end mode aligns the whole
read with a free start and end column inside the rect; local mode clamps
at 0 with a +2 match bonus and takes the best cell anywhere. Direction bits
are 4 per cell, 8 cells per int32 word (cell j in word j // 8 at bit
4 * (j % 8)): bits 0-1 the H source (H_DIAG/H_E/H_F/H_START), bit 2 E from
extension, bit 3 F from extension.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from bowtie2_tpu_torch.ops import _build
from bowtie2_tpu_torch.ops._build import I, P, check, on_cpu, ptr

NEG_INF = -(1 << 29)

H_DIAG, H_E, H_F, H_START = 0, 1, 2, 3
# per-step packed op byte: op (2 bits) | refchar (3 bits) | ismatch (1 bit)
OP_M, OP_I, OP_D, OP_NONE = 0, 1, 2, 3

class SWParams(NamedTuple):
    """Static scoring params."""
    match_bonus: int = 0          # 0 e2e / 2 local (scoring.h DEFAULT_MATCH_BONUS)
    mm_pen_max: int = 6           # MMP Q,6,2
    mm_pen_min: int = 2
    n_pen: int = 1
    read_gap_open: int = 5        # RDG 5,3 — first gap char costs open+extend
    read_gap_extend: int = 3
    ref_gap_open: int = 5         # RFG 5,3
    ref_gap_extend: int = 3
    gap_barrier: int = 4          # --gbar: no gaps within this many positions
                                  # of either read end
    local: bool = False


def mm_penalty_from_qual(quals: torch.Tensor, p: SWParams) -> torch.Tensor:
    """Qual-scaled mismatch penalty (scoring.h initPens COST_MODEL_QUAL):
    pen = MN + floor(min(q,40)/40 * (MX-MN))."""
    q = torch.clamp(quals.to(torch.int32), max=40)
    return (p.mm_pen_min
            + torch.div(q * (p.mm_pen_max - p.mm_pen_min), 40,
                        rounding_mode="floor")).to(torch.int32)


def bt_steps(Lmax: int, W: int, local: bool) -> int:
    """Backtrace walk length. M+I <= Lmax; total gap chars are bounded by
    the score budget (each costs >= extend=3; valid alignments only):
    e2e: -minsc ~ 0.6*L => D < L/4; local: (perfect-minsc)/3 < 2L/3."""
    slack = (2 * Lmax) // 3 + 48 if local else Lmax // 4 + 48
    return min(Lmax + slack, Lmax + W + 2)


class SWResult(NamedTuple):
    """The rectangle DP's result. With `n_live` (sw_banded), lanes below
    it hold the DP of their problem: score, row, lane, origin, and dirs
    rows below the lane's read length (rows the walk from any cell of the
    read can reach). Lanes at or past `n_live` hold the fill of a lane
    without a cell, score NEG_INF and row, lane and origin 0 (DEAD_FILL).
    Everything else of dirs, the rows at or past a lane's length and the
    whole of a dead lane, is unspecified. The band DP (`sw_banded_diag`)
    specifies every row."""
    score: torch.Tensor   # (B,) int32 best alignment score
    row: torch.Tensor     # (B,) int32 row of the best end
    lane: torch.Tensor    # (B,) int32 rect column of the best end
    dirs: torch.Tensor    # (Lmax, B, ceil(W/8)) int32 packed directions
    origin: Optional[torch.Tensor] = None  # (B,) int32 rect column of the
                          # first ref char the best path consumes (= the
                          # walk's ref_start_win), with track_origin=True


# what a lane at or past n_live holds: (score, row, lane, origin), the
# values of a problem without a cell
DEAD_FILL = (NEG_INF, 0, 0, 0)


class BTResult(NamedTuple):
    ops: torch.Tensor           # (S, Bc) uint8 packed op bytes, walk order
    read_start: torch.Tensor    # (Bc,) first read pos aligned
    ref_start_win: torch.Tensor  # (Bc,) window index of first ref char
    n_mm: torch.Tensor          # (Bc,) mismatches incl N positions (XM)
    n_go: torch.Tensor          # (Bc,) gap opens (XO)
    n_gc: torch.Tensor          # (Bc,) gap chars (XG)
    n_refn: torch.Tensor        # (Bc,) aligned positions over ref N (XN)
    score_check: torch.Tensor   # (Bc,) recomputed score


def unpack_dirs(dirs_packed, W: int) -> np.ndarray:
    """(Lmax, B, Wp) packed words → (Lmax, B, W) per-cell uint8 (tests)."""
    d = np.asarray(dirs_packed.cpu() if isinstance(dirs_packed, torch.Tensor)
                   else dirs_packed).astype(np.int64)
    cells = (d[:, :, :, None] >> (4 * np.arange(8))[None, None, None, :]) & 15
    return cells.reshape(d.shape[0], d.shape[1], -1)[:, :, :W].astype(np.uint8)


def _pack_cells(cells: torch.Tensor) -> torch.Tensor:
    """(B, W) 4-bit cell values → (B, ceil(W/8)) int32 words."""
    B, W = cells.shape
    if W % 8:
        cells = torch.cat([cells, cells.new_zeros((B, 8 - W % 8))], dim=1)
    sh = 4 * torch.arange(8, dtype=torch.int64, device=cells.device)
    words = (cells.to(torch.int64).view(B, -1, 8) << sh).sum(dim=2)
    return words.to(torch.int32)     # bit 31 wraps to the int32 sign


def _prefix_max_excl(x: torch.Tensor) -> torch.Tensor:
    """Exclusive running max along the last axis, floored at NEG_INF
    (sw.py's Kogge-Stone prefix includes its NEG_INF fill)."""
    cm = torch.cummax(x, dim=-1).values
    out = torch.cat([torch.full_like(x[..., :1], NEG_INF), cm[..., :-1]],
                    dim=-1)
    return torch.clamp(out, min=NEG_INF)


def _prefix_max_payload_excl(x: torch.Tensor, pay: torch.Tensor):
    """Exclusive running max along the last axis and the payload of the
    element that holds it, ties won by the LATER index (sw.py's
    `_prefix_max_payload_excl`): an NEG_INF fill with payload -1 stands
    before index 0. The max and the index are one int64 key, so the tie
    rule holds whatever cummax does on ties."""
    W = x.shape[1]
    xs = torch.cat([torch.full_like(x[:, :1], NEG_INF), x[:, :-1]], dim=1)
    ps = torch.cat([torch.full_like(pay[:, :1], -1), pay[:, :-1]], dim=1)
    idx = torch.arange(W, dtype=torch.int64, device=x.device)[None, :]
    key = torch.cummax((xs.to(torch.int64) << 20) + idx, dim=1).values
    arg = key - ((key >> 20) << 20)
    return (key >> 20).to(x.dtype), ps.gather(1, arg)


# ---------------------------------------------------------------------------
# rectangle DP
# ---------------------------------------------------------------------------

def _col_ok(refwins, rect_cols, col_lo):
    W = refwins.shape[1]
    ar = torch.arange(W, dtype=torch.int32, device=refwins.device)[None, :]
    if col_lo is None:
        return ar < rect_cols[:, None]
    return (ar >= col_lo[:, None]) & (ar < (col_lo + rect_cols)[:, None])


def _sw_banded_plain(reads, mmpen, read_lens, refwins, p: SWParams,
                     rect_cols, col_lo, n_live=None,
                     track_origin: bool = False) -> SWResult:
    B = reads.shape[0]
    n = B if n_live is None else min(max(int(n_live), 0), B)
    if n == B:
        return _sw_rect_plain(reads, mmpen, read_lens, refwins, p,
                              rect_cols, col_lo, track_origin)
    # the live lanes' DP, and the dead lanes' fill (their dirs are zero)
    dirs = reads.new_zeros((reads.shape[1], B, (refwins.shape[1] + 7) // 8))
    fields = [reads.new_full((B,), fill) for fill in DEAD_FILL]
    if n:
        live = _sw_rect_plain(
            reads[:n], mmpen[:n], read_lens[:n], refwins[:n], p,
            rect_cols[:n], None if col_lo is None else col_lo[:n],
            track_origin)
        dirs[:, :n] = live.dirs
        for f, v in zip(fields, (live.score, live.row, live.lane,
                                 live.origin)):
            if v is not None:
                f[:n] = v
    return SWResult(fields[0], fields[1], fields[2], dirs,
                    fields[3] if track_origin else None)


def _sw_rect_plain(reads, mmpen, read_lens, refwins, p: SWParams,
                   rect_cols, col_lo, track_origin: bool) -> SWResult:
    B, Lmax = reads.shape
    W = refwins.shape[1]
    dev = reads.device
    i32 = torch.int32
    refc = torch.where(_col_ok(refwins, rect_cols, col_lo), refwins, 5)
    colw = torch.arange(W, dtype=i32, device=dev)[None, :]
    lane_e = colw * p.read_gap_extend
    rgo = p.read_gap_open + p.read_gap_extend
    fgo = p.ref_gap_open + p.ref_gap_extend
    oob = refc >= 5
    ref_n = refc == 4
    pad = torch.full((B, 1), NEG_INF, dtype=i32, device=dev)

    h = torch.zeros((B, W), dtype=i32, device=dev)
    e = torch.full((B, W), NEG_INF, dtype=i32, device=dev)
    best = torch.full((B,), NEG_INF, dtype=i32, device=dev)
    best_row = torch.zeros(B, dtype=i32, device=dev)
    best_lane = torch.zeros(B, dtype=i32, device=dev)
    dirs = torch.empty((Lmax, B, (W + 7) // 8), dtype=i32, device=dev)
    if track_origin:
        # per cell, the rect column of the first ref char consumed on the
        # best path into it (-1: none yet), under the direction bits' tie
        # rules; o for H, oe for E
        o = torch.full((B, W), -1, dtype=i32, device=dev)
        oe = o.clone()
        best_origin = torch.zeros(B, dtype=i32, device=dev)
        neg1 = torch.full((B, 1), -1, dtype=i32, device=dev)
    for i in range(Lmax):
        rc = reads[:, i:i + 1]
        qp = mmpen[:, i:i + 1]
        active = (read_lens > i)[:, None]
        is_n = (rc >= 4) | ref_n
        eq = (refc == rc) & ~is_n & ~oob
        sub = torch.where(eq, p.match_bonus,
                          torch.where(is_n & ~oob, -p.n_pen, -qp))
        sub = torch.where(oob, NEG_INF // 2, sub).to(i32)

        e_open = h - fgo
        e_ext = e - p.ref_gap_extend
        e_cur = torch.maximum(e_open, e_ext)
        e_cur = torch.where(oob, NEG_INF, e_cur)
        e_from_ext = e_ext > e_open
        if p.gap_barrier > 0:
            # gap-state cells are dead within gbar rows of either read end
            bar = ((read_lens - p.gap_barrier <= i)
                   | (i < p.gap_barrier))[:, None]
            e_cur = torch.where(bar, NEG_INF, e_cur)

        h_diag = torch.cat([pad, h[:, :-1]], dim=1) + sub
        h_noF = torch.maximum(h_diag, e_cur)
        src_noF = torch.where(e_cur > h_diag, H_E, H_DIAG)
        f_arg = h_noF - rgo + p.read_gap_extend + lane_e
        if track_origin:
            # diag consumes ref char j (origin j if none yet); E consumes
            # none; an F run from k consumes k+1..j first
            o_sh = torch.cat([neg1, o[:, :-1]], dim=1)
            o_diag = torch.where(o_sh < 0, colw, o_sh)
            oe_new = torch.where(e_from_ext, oe, o)
            o_noF = torch.where(e_cur > h_diag, oe_new, o_diag)
            f_pre, o_F = _prefix_max_payload_excl(
                f_arg, torch.where(o_noF < 0, colw + 1, o_noF))
            f_cur = f_pre - lane_e
        else:
            f_cur = _prefix_max_excl(f_arg) - lane_e
        f_open = torch.cat([pad, h_noF[:, :-1]], dim=1) - rgo
        f_from_ext = f_cur > f_open
        if p.gap_barrier > 0:
            f_cur = torch.where(bar, NEG_INF, f_cur)

        h_cur = torch.maximum(h_noF, f_cur)
        src = torch.where(f_cur > h_noF, H_F, src_noF)
        if track_origin:
            o_cur = torch.where(f_cur > h_noF, o_F, o_noF)
        if p.local:
            clamp = (h_cur < 0) | ((h_cur == 0) & (src == H_DIAG))
            h_cur = torch.clamp(h_cur, min=0)
            src = torch.where(clamp, H_START, src)
            if track_origin:
                o_cur = torch.where(clamp, -1, o_cur)
        h_cur = torch.clamp(h_cur, min=NEG_INF)

        dirbits = (src | torch.where(e_from_ext, 4, 0)
                   | torch.where(f_from_ext, 8, 0))
        dirs[i] = _pack_cells(dirbits)

        row_best = h_cur.max(dim=1).values
        row_best_lane = torch.where(h_cur == row_best[:, None], colw,
                                    -1).max(dim=1).values
        if p.local:
            take = active[:, 0] & (row_best >= best)
        else:
            take = read_lens - 1 == i
        best = torch.where(take, row_best, best)
        best_row = torch.where(take, i, best_row)
        best_lane = torch.where(take, row_best_lane, best_lane).to(i32)
        if track_origin:
            row_origin = o_cur.gather(
                1, torch.clamp(row_best_lane, 0, W - 1)[:, None].long())[:, 0]
            best_origin = torch.where(take, row_origin, best_origin)
            o = torch.where(active, o_cur, o)
            oe = torch.where(active, oe_new, oe)

        h = torch.where(active, h_cur, h)
        e = torch.where(active, e_cur, e)
    return SWResult(best, best_row, best_lane, dirs,
                    best_origin if track_origin else None)


_SW_ARGS = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, P, P,
            P, P]


def _sw_banded_cuda(reads, mmpen, read_lens, refwins, p: SWParams,
                    rect_cols, col_lo, n_live=None,
                    track_origin: bool = False) -> SWResult:
    B, Lmax = reads.shape
    W = refwins.shape[1]
    dev = reads.device
    for t, n, shp in ((reads, "reads", (B, Lmax)), (mmpen, "mmpen", (B, Lmax)),
                      (read_lens, "read_lens", (B,)), (refwins, "refwins", None),
                      (rect_cols, "rect_cols", (B,))):
        check(t, n, shape=shp, device=dev)
    if col_lo is not None:
        check(col_lo, "col_lo", shape=(B,), device=dev)
    # the kernel reads a tensor's count on the card (no host sync) and
    # launches for every lane; a host count shrinks the grid to it
    n_ptr, n_run = None, B
    if isinstance(n_live, torch.Tensor):
        check(n_live, "n_live", shape=(), device=dev)
        n_ptr = ptr(n_live)
    elif n_live is not None:
        n_run = min(max(int(n_live), 0), B)
    if refwins.shape[0] != B or (W + 7) // 8 > 2048 or Lmax > 32767:
        raise ValueError(f"sw_rect: unsupported shape B={B} Lmax={Lmax} W={W}")
    if not -(1 << 24) < p.n_pen < (1 << 24):
        raise ValueError(f"sw_rect: n_pen {p.n_pen} out of range")
    score = torch.empty(B, dtype=torch.int32, device=dev)
    row = torch.empty(B, dtype=torch.int32, device=dev)
    lane = torch.empty(B, dtype=torch.int32, device=dev)
    dirs = torch.empty((Lmax, B, (W + 7) // 8), dtype=torch.int32, device=dev)
    args = [ptr(reads), ptr(mmpen), ptr(read_lens), ptr(refwins),
            ptr(rect_cols), None if col_lo is None else ptr(col_lo), n_ptr,
            B, n_run, Lmax, W, p.match_bonus, p.n_pen, p.read_gap_open,
            p.read_gap_extend, p.ref_gap_open, p.ref_gap_extend,
            p.gap_barrier, int(p.local),
            ptr(score), ptr(row), ptr(lane), ptr(dirs)]
    symbol = "sw_rect_origin" if track_origin else "sw_rect"
    origin = None
    if track_origin:
        origin = torch.empty(B, dtype=torch.int32, device=dev)
        args.append(ptr(origin))
    # the entry launches one warp a problem, or one block a problem for
    # the widest windows, and says which: counted as sw_rect[_origin] or
    # sw_rect[_origin]@block
    _build.call("sw_rect", symbol, _SW_ARGS + [P] * track_origin, *args,
                kinds=(symbol, f"{symbol}@block"))
    return SWResult(score, row, lane, dirs, origin)


def sw_banded(reads: torch.Tensor, quals: torch.Tensor,
              read_lens: torch.Tensor, refwins: torch.Tensor,
              params: SWParams, band: int,
              rect_cols: Optional[torch.Tensor] = None,
              col_lo: Optional[torch.Tensor] = None,
              track_origin: bool = False, n_live=None) -> SWResult:
    """Batched rectangle DP (bowtie2_tpu/ops/sw.py sw_banded).

    reads: (B, Lmax) int32 codes 0..4 (4=N); quals: (B, Lmax) int32;
    read_lens: (B,) int32; refwins: (B, W) int32 codes 0..5 (4=N, 5=out of
    reference), W >= Lmax + 2*band + 1. rect_cols (B,) = valid rect columns
    per problem (default read_len + 2*band + 1); col_lo (B,) = first rect
    column of word-aligned windows (default 0). track_origin=True also
    returns SWResult.origin, the rect column of the first ref char of each
    best path (the fused PE path's reference extents). n_live: the lanes
    to compute, the first n_live (None: all B); a 0-d int32 tensor on the
    batch's device (read there, without a host sync) or a Python int.
    SWResult says which outputs are specified. CPU tensors take the plain
    version, CUDA tensors the sw_rect kernel (sw_rect_origin with
    track_origin)."""
    args = sw_args(reads, quals, read_lens, refwins, params, band,
                   rect_cols, col_lo, n_live)
    if on_cpu(args[0], "sw_rect_origin" if track_origin else "sw_rect"):
        return _sw_banded_plain(*args, track_origin=track_origin)
    return _sw_banded_cuda(*args, track_origin=track_origin)


def sw_args(reads, quals, read_lens, refwins, params: SWParams, band: int,
            rect_cols=None, col_lo=None, n_live=None) -> tuple:
    """sw_banded's arguments as the kernel and its plain version take them:
    (reads, mmpen, read_lens, refwins, params, rect_cols, col_lo, n_live),
    int32 and contiguous, with the default rect_cols filled in; n_live
    stays None, a Python int or a 0-d int32 tensor."""
    i32 = torch.int32
    read_lens = read_lens.to(i32).contiguous()
    if rect_cols is None:
        rect_cols = read_lens + 2 * band + 1
    if isinstance(n_live, torch.Tensor):
        n_live = n_live.to(i32).reshape(())
    return (reads.to(i32).contiguous(),
            mm_penalty_from_qual(quals, params).contiguous(), read_lens,
            refwins.to(i32).contiguous(), params,
            rect_cols.to(i32).contiguous(),
            None if col_lo is None else col_lo.to(i32).contiguous(), n_live)


# ---------------------------------------------------------------------------
# direction walk
# ---------------------------------------------------------------------------

def _backtrace_plain(dirs, sel, rows, lanes, reads, mmpen, refwins,
                     p: SWParams, S: int) -> BTResult:
    Lmax, B, Wp = dirs.shape
    W = refwins.shape[1]
    Bc = sel.shape[0]
    dev = dirs.device
    i32 = torch.int32
    dsel = dirs.index_select(1, sel.long()).permute(1, 0, 2).reshape(Bc, -1)
    i, j = rows.clone(), lanes.clone()
    z = torch.zeros(Bc, dtype=i32, device=dev)
    mode, nmm, ngo, ngc, nrefn, score = z, z, z, z, z, z
    done = torch.zeros(Bc, dtype=torch.bool, device=dev)
    refmin = torch.full((Bc,), 1 << 30, dtype=i32, device=dev)
    ops = torch.empty((S, Bc), dtype=torch.uint8, device=dev)
    for s in range(S):
        ic = torch.clamp(i, 0, Lmax - 1).long()
        jc = torch.clamp(j, 0, W - 1).long()
        word = dsel.gather(1, (ic * Wp + jc // 8)[:, None])[:, 0]
        d = (word >> (4 * (jc % 8)).to(i32)) & 15
        src = d & 3
        rc = reads.gather(1, ic[:, None])[:, 0]
        qp = mmpen.gather(1, ic[:, None])[:, 0]
        fc = refwins.gather(1, jc[:, None])[:, 0]

        done_now = done | ((mode == 0) & (src == H_START)) | (i < 0)
        emit_m = (mode == 0) & (src == H_DIAG) & ~done_now
        emit_i = (((mode == 0) & (src == H_E)) | (mode == 1)) & ~done_now
        emit_d = (((mode == 0) & (src == H_F)) | (mode == 2)) & ~done_now
        is_n = (rc >= 4) | (fc == 4)
        ismatch = emit_m & (rc == fc) & ~is_n & (fc < 4)
        m_sc = torch.where(ismatch, p.match_bonus,
                           torch.where(is_n, -p.n_pen, -qp))
        e_ext = (d & 4) != 0
        f_ext = (d & 8) != 0
        i_open = emit_i & ~e_ext
        d_open = emit_d & ~f_ext
        score = (score + torch.where(emit_m, m_sc, 0)
                 - torch.where(emit_i, p.ref_gap_extend, 0)
                 - torch.where(i_open, p.ref_gap_open, 0)
                 - torch.where(emit_d, p.read_gap_extend, 0)
                 - torch.where(d_open, p.read_gap_open, 0)).to(i32)
        nmm = (nmm + (emit_m & ~ismatch & (rc < 4) & (fc != 4)).to(i32)
               + (emit_m & is_n).to(i32))
        nrefn = nrefn + (emit_m & (fc == 4)).to(i32)
        ngo = ngo + i_open.to(i32) + d_open.to(i32)
        ngc = ngc + emit_i.to(i32) + emit_d.to(i32)
        refmin = torch.where(emit_m | emit_d, torch.minimum(refmin, j), refmin)
        op = torch.where(emit_m, OP_M, torch.where(
            emit_i, OP_I, torch.where(emit_d, OP_D, OP_NONE)))
        ops[s] = (op | (torch.clamp(fc, 0, 5) << 2)
                  | (ismatch.to(i32) << 5)).to(torch.uint8)
        i2 = torch.where(emit_m | emit_i, i - 1, i)
        j2 = torch.where(emit_m | emit_d, j - 1, j)
        mode2 = torch.where(emit_i & e_ext, 1, torch.where(emit_d & f_ext, 2, 0))
        i = torch.where(done_now, i, i2)
        j = torch.where(done_now, j, j2)
        mode = torch.where(done_now, mode, mode2).to(i32)
        done = done_now | (i < 0)
    refmin = torch.where(refmin == (1 << 30), 0, refmin)
    return BTResult(ops, (i + 1).to(i32), refmin.to(i32), nmm, ngo, ngc,
                    nrefn, score)


_BT_ARGS = [P, I, I, I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P, P]


def _backtrace_cuda(dirs, sel, rows, lanes, reads, mmpen, refwins,
                    p: SWParams, S: int) -> BTResult:
    Lmax, B, Wp = dirs.shape
    Bc = sel.shape[0]
    W = refwins.shape[1]
    dev = dirs.device
    check(dirs, "dirs", device=dev)
    for t, n, shp in ((sel, "sel", (Bc,)), (rows, "rows", (Bc,)),
                      (lanes, "lanes", (Bc,)), (reads, "reads", (Bc, Lmax)),
                      (mmpen, "mmpen", (Bc, Lmax)),
                      (refwins, "refwins", (Bc, W))):
        check(t, n, shape=shp, device=dev)
    if (W - 1) // 8 >= Wp:
        raise ValueError(f"backtrace: window width {W} exceeds dirs {Wp}")
    ops = torch.empty((S, Bc), dtype=torch.uint8, device=dev)
    fields = torch.empty((7, Bc), dtype=torch.int32, device=dev)
    _build.call("backtrace", "backtrace", _BT_ARGS,
                ptr(dirs), Lmax, B, Wp, ptr(sel), ptr(rows), ptr(lanes),
                ptr(reads), ptr(mmpen), ptr(refwins), Bc, W, S,
                p.match_bonus, p.n_pen, p.read_gap_open, p.read_gap_extend,
                p.ref_gap_open, p.ref_gap_extend, ptr(ops), ptr(fields))
    return BTResult(ops, *fields.unbind(0))


def backtrace(dirs: torch.Tensor, sel: torch.Tensor, rows: torch.Tensor,
              lanes: torch.Tensor, reads: torch.Tensor, quals: torch.Tensor,
              refwins: torch.Tensor, params: SWParams, band: int) -> BTResult:
    """Walk chosen candidates' direction matrices (bowtie2_tpu/ops/sw.py
    backtrace). dirs: (Lmax, B, Wp) packed words from sw_banded; sel: (Bc,)
    indices into its batch; rows/lanes: (Bc,) best cells; reads/quals:
    (Bc, Lmax) of the selected candidates; refwins: (Bc, W), W <= 8*Wp."""
    i32 = torch.int32
    Lmax = dirs.shape[0]
    W = refwins.shape[1]
    S = bt_steps(Lmax, W, params.local)
    args = (dirs.contiguous(), sel.to(i32).contiguous(),
            rows.to(i32).contiguous(), lanes.to(i32).contiguous(),
            reads.to(i32).contiguous(),
            mm_penalty_from_qual(quals, params).contiguous(),
            refwins.to(i32).contiguous())
    if on_cpu(dirs, "backtrace"):
        return _backtrace_plain(*args, params, S)
    return _backtrace_cuda(*args, params, S)


# ---------------------------------------------------------------------------
# band-coordinate DP and its walk (reads over the rectangle buckets)
# ---------------------------------------------------------------------------
# Cell (i, d) is read row i against window column i + d, d in [0, 2G]:
# the diagonal move keeps d, E (ref gap) comes from the previous row's
# d + 1, F (read gap) from the same row's d - 1 through the same lazy-F
# prefix max as the rectangle DP. The direction words are (Lmax, B,
# ceil(BW / 8)), linear in the read length.

# rows a step of the band DP's plain version prepares at once
_DIAG_CHUNK = 128
# a key below every cell's (score, row, band column) key
_NO_KEY = -(1 << 62)


def _sw_banded_diag_plain(reads, mmpen, read_lens, refwins, p: SWParams,
                          band: int) -> SWResult:
    """sw_banded_diag with torch ops. The row recurrence runs one row at a
    time; what does not feed the next row is computed for a chunk of rows
    at once: the substitution scores and masks before the chunk, and after
    it the direction cells (from the recorded comparisons) and the best
    cell. The best cell is the maximum of the key (H, row, band column)
    over the cells the reference takes from: end to end row len-1, local
    every active row, where the reference's running `row_best >= best`
    over rows (rightmost column within a row) ends on that maximum (see
    csrc/sw_diag.cu)."""
    B, Lmax = reads.shape
    W = refwins.shape[1]
    BW = 2 * band + 1
    if W < BW:
        raise ValueError(f"sw_diag: window width {W} below the band {BW}")
    dev = reads.device
    i32, i64 = torch.int32, torch.int64
    lane = torch.arange(BW, dtype=i32, device=dev)
    lane_e = lane * p.read_gap_extend
    rgo = p.read_gap_open + p.read_gap_extend
    fgo = p.ref_gap_open + p.ref_gap_extend
    floor = 0 if p.local else NEG_INF

    # H, E and H without F in buffers one column wider than the band, the
    # extra column NEG_INF: h_up[:, d] is H(d + 1) (E's source, NEG_INF past
    # the band) and h_left[:, d] is H_noF(d - 1) (F's, NEG_INF before it)
    hx = torch.full((B, BW + 1), NEG_INF, dtype=i32, device=dev)
    hx[:, :BW] = 0                           # row -1: a free start
    ex = torch.full((B, BW + 1), NEG_INF, dtype=i32, device=dev)
    nx = torch.full((B, BW + 1), NEG_INF, dtype=i32, device=dev)
    h, h_up, e, e_up = hx[:, :BW], hx[:, 1:], ex[:, :BW], ex[:, 1:]
    h_noF, h_left = nx[:, 1:], nx[:, :BW]
    # the F scan's input, one column right: column d holds H_noF(d - 1) -
    # rgo + rde + (d - 1) * rde, and column 0 NEG_INF (the scan's floor)
    off = torch.cat([lane.new_zeros(1),
                     (lane_e + p.read_gap_extend - rgo)[:-1]])
    best_key = torch.full((B,), _NO_KEY, dtype=i64, device=dev)
    dirs = torch.empty((Lmax, B, (BW + 7) // 8), dtype=i32, device=dev)
    lens = read_lens.to(i64)
    for r0 in range(0, Lmax, _DIAG_CHUNK):
        r1 = min(r0 + _DIAG_CHUNK, Lmax)
        n = r1 - r0
        rows = torch.arange(r0, r1, dtype=i64, device=dev)
        # the band of row i covers window columns [i, i + BW), the start
        # clamped to the window as jax.lax.dynamic_slice clamps it
        cols = torch.clamp(rows, max=W - BW)[:, None] + lane.to(i64)
        refc = refwins[:, cols].permute(1, 0, 2)          # (n, B, BW)
        rc = reads[:, r0:r1].T[:, :, None]
        qp = mmpen[:, r0:r1].T[:, :, None]
        is_n = (rc >= 4) | (refc == 4)
        oob = refc >= 5
        eq = (refc == rc) & ~is_n & ~oob
        sub = torch.where(eq, p.match_bonus,
                          torch.where(is_n & ~oob, -p.n_pen, -qp))
        sub = torch.where(oob, NEG_INF // 2, sub).to(i32).contiguous()
        act = (lens[None, :] > rows[:, None])[:, :, None]
        mask_e = oob
        if p.gap_barrier > 0:
            bar = ((rows[:, None] < p.gap_barrier)
                   | (rows[:, None] >= lens[None, :] - p.gap_barrier)
                   )[:, :, None]
            mask_e = oob | bar
            bar_r = bar.unbind(0)
        mask_e = mask_e.contiguous()
        # per row: E from extension, E over the diagonal, F from
        # extension, F over H_noF, and H before the local clamp
        xe, eg, xf, fg = (torch.empty((n, B, BW), dtype=torch.bool,
                                      device=dev) for _ in range(4))
        hc = torch.empty((n, B, BW), dtype=i32, device=dev)
        for k, (sub_k, me_k, act_k, xe_k, eg_k, xf_k, fg_k, hc_k) in \
                enumerate(zip(sub.unbind(0), mask_e.unbind(0),
                              act.unbind(0), xe.unbind(0), eg.unbind(0),
                              xf.unbind(0), fg.unbind(0), hc.unbind(0))):
            # E: the previous row's band column d + 1
            e_open = h_up - fgo
            e_ext = e_up - p.ref_gap_extend
            torch.gt(e_ext, e_open, out=xe_k)
            e_cur = torch.maximum(e_open, e_ext).masked_fill_(me_k, NEG_INF)
            # diagonal: the previous row's same band column
            h_diag = h + sub_k
            torch.gt(e_cur, h_diag, out=eg_k)
            torch.maximum(h_diag, e_cur, out=h_noF)
            # F: the same row's band column d - 1 (lazy-F prefix max)
            f_cur = torch.cummax(h_left + off, dim=1).values - lane_e
            torch.gt(f_cur, h_left - rgo, out=xf_k)
            if p.gap_barrier > 0:
                f_cur.masked_fill_(bar_r[k], NEG_INF)
            torch.gt(f_cur, h_noF, out=fg_k)
            torch.maximum(h_noF, f_cur, out=hc_k)
            torch.where(act_k, torch.clamp(hc_k, min=floor), h, out=h)
            torch.where(act_k, e_cur, e, out=e)
        src = torch.where(fg, H_F, torch.where(eg, H_E, H_DIAG))
        if p.local:
            clamp = (hc < 0) | ((hc == 0) & (src == H_DIAG))
            src = torch.where(clamp, H_START, src)
        cells = src | (xe.to(i64) << 2) | (xf.to(i64) << 3)
        dirs[r0:r1] = _pack_cells(cells.view(n * B, BW)).view(n, B, -1)
        key = (torch.clamp(hc, min=floor).to(i64) << 32) \
            + rows[:, None, None] * 64 + lane
        take = act if p.local else \
            (rows[:, None] == lens[None, :] - 1)[:, :, None]
        kmax = torch.where(take, key, _NO_KEY).amax(dim=(0, 2))
        best_key = torch.maximum(best_key, kmax)
    none = best_key == _NO_KEY
    low = best_key & 0xFFFFFFFF
    return SWResult(torch.where(none, NEG_INF, best_key >> 32).to(i32),
                    torch.where(none, 0, low >> 6).to(i32),
                    torch.where(none, 0, low & 63).to(i32), dirs)


_SWD_ARGS = [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, I, P, P, P, P]


def _sw_banded_diag_cuda(reads, mmpen, read_lens, refwins, p: SWParams,
                         band: int) -> SWResult:
    B, Lmax = reads.shape
    W = refwins.shape[1]
    BW = 2 * band + 1
    dev = reads.device
    for t, n, shp in ((reads, "reads", (B, Lmax)), (mmpen, "mmpen", (B, Lmax)),
                      (read_lens, "read_lens", (B,)),
                      (refwins, "refwins", (B, W))):
        check(t, n, shape=shp, device=dev)
    # two band cells a lane of one warp; the best cell's row and band
    # column share 32 bits; every row's band lies inside the window
    if not 0 <= band <= 31 or W < Lmax + BW - 1 or Lmax >= (1 << 25):
        raise ValueError(f"sw_diag: unsupported shape B={B} Lmax={Lmax} "
                         f"W={W} band={band}")
    if not -(1 << 24) < p.n_pen < (1 << 24):
        raise ValueError(f"sw_diag: n_pen {p.n_pen} out of range")
    score = torch.empty(B, dtype=torch.int32, device=dev)
    row = torch.empty(B, dtype=torch.int32, device=dev)
    lane = torch.empty(B, dtype=torch.int32, device=dev)
    dirs = torch.empty((Lmax, B, (BW + 7) // 8), dtype=torch.int32,
                       device=dev)
    _build.call("sw_diag", "sw_diag", _SWD_ARGS,
                ptr(reads), ptr(mmpen), ptr(read_lens), ptr(refwins),
                B, Lmax, W, band, p.match_bonus, p.n_pen, p.read_gap_open,
                p.read_gap_extend, p.ref_gap_open, p.ref_gap_extend,
                p.gap_barrier, int(p.local),
                ptr(score), ptr(row), ptr(lane), ptr(dirs))
    return SWResult(score, row, lane, dirs)


def diag_args(reads, quals, read_lens, refwins, params: SWParams,
              band: int) -> tuple:
    """sw_banded_diag's arguments as the kernel and its plain version take
    them: (reads, mmpen, read_lens, refwins, params, band), int32 and
    contiguous."""
    i32 = torch.int32
    return (reads.to(i32).contiguous(),
            mm_penalty_from_qual(quals, params).contiguous(),
            read_lens.to(i32).contiguous(), refwins.to(i32).contiguous(),
            params, band)


def sw_banded_diag(reads: torch.Tensor, quals: torch.Tensor,
                   read_lens: torch.Tensor, refwins: torch.Tensor,
                   params: SWParams, band: int) -> SWResult:
    """Band DP for long reads (bowtie2_tpu/ops/sw.py sw_banded_diag).

    reads/quals: (B, Lmax) int32; read_lens (B,); refwins: (B, Lmax +
    2 * band + 1) int32 codes 0..5, rect-aligned (column c is the ref char
    at rect column c). Returns an SWResult whose `lane` is the BAND column
    d of the best cell (its rect column is row + d) and whose dirs are in
    band coordinates, (Lmax, B, ceil((2 * band + 1) / 8)) words (walk them
    with backtrace_diag). CPU tensors take the plain version, CUDA tensors
    the sw_diag kernel."""
    args = diag_args(reads, quals, read_lens, refwins, params, band)
    if on_cpu(args[0], "sw_diag"):
        return _sw_banded_diag_plain(*args)
    return _sw_banded_diag_cuda(*args)


# band-column move of each op (M, I, D, none) and whether it leaves the row
_BT_DI = (1, 1, 0, 0)
_BT_DD = (0, 1, -1, 0)


def _backtrace_diag_plain(dirs, sel, rows, lanes, reads, mmpen, refwins,
                          p: SWParams, band: int, S: int) -> BTResult:
    """backtrace_diag with torch ops. The walk's chain (cell, move, next
    cell) runs one step at a time and records each step's op, direction
    cell, row and band column; the op bytes and the seven fields are then
    computed from the records for all steps at once. A step of a walk that
    is done records OP_NONE at its frozen (clamped) cell, as the reference
    emits it; once every walk is done, the remaining steps repeat that."""
    Lmax, B, Wp = dirs.shape
    W = refwins.shape[1]
    BW = 2 * band + 1
    Bc = sel.shape[0]
    dev = dirs.device
    i32, i64 = torch.int32, torch.int64
    # each walk's direction words as one run of Lmax * Wp words
    dflat = dirs.index_select(1, sel.long()).permute(1, 0, 2).reshape(-1)
    base = torch.arange(Bc, dtype=i64, device=dev) * (Lmax * Wp)
    di = torch.tensor(_BT_DI, dtype=i64, device=dev)
    dd_tab = torch.tensor(_BT_DD, dtype=i64, device=dev)
    i, d = rows.to(i64), lanes.to(i64)
    mode = torch.zeros(Bc, dtype=i64, device=dev)
    done = torch.zeros(Bc, dtype=torch.bool, device=dev)
    rec_op, rec_dd, rec_i, rec_d = [], [], [], []
    for s in range(S):
        dc = torch.clamp(d, 0, BW - 1)
        ic = torch.clamp(i, 0, Lmax - 1)
        word = torch.take(dflat, base + ic * Wp + (dc >> 3))
        dd = (word >> ((dc & 7) << 2)) & 15
        src = dd & 3
        done_now = (done | ((mode == 0) & (src == H_START)) | (i < 0)
                    | (dc != d))
        op = torch.where(mode > 0, mode, src).masked_fill_(done_now, OP_NONE)
        rec_op.append(op)
        rec_dd.append(dd)
        rec_i.append(ic)
        rec_d.append(dc)
        # band moves: M -> (i-1, d); I -> (i-1, d+1); D -> (i, d-1); the
        # E or F extension bit of the move taken keeps its mode
        i = i - torch.take(di, op)
        d = d + torch.take(dd_tab, op)
        mode = op & -((dd >> (op + 1)) & 1)
        done = done_now | (i < 0)
        if s % 64 == 63 and bool(done.all()):
            break
    op = torch.stack(rec_op)                 # (steps, Bc)
    dd = torch.stack(rec_dd)
    ic = torch.stack(rec_i)
    j = ic + torch.stack(rec_d)              # rect column
    rc = reads.to(i64).gather(1, ic.T).T
    qp = mmpen.to(i64).gather(1, ic.T).T
    fc = refwins.to(i64).gather(1, torch.clamp(j, 0, W - 1).T).T
    em, ei, ed = op == OP_M, op == OP_I, op == OP_D
    is_n = (rc >= 4) | (fc == 4)
    ismatch = em & (rc == fc) & ~is_n & (fc < 4)
    m_sc = torch.where(ismatch, p.match_bonus,
                       torch.where(is_n, -p.n_pen, -qp))
    i_open = ei & ((dd & 4) == 0)
    d_open = ed & ((dd & 8) == 0)
    score = (torch.where(em, m_sc, 0) - ei * p.ref_gap_extend
             - i_open * p.ref_gap_open - ed * p.read_gap_extend
             - d_open * p.read_gap_open).sum(dim=0)
    nmm = (em & ~ismatch & (rc < 4) & (fc != 4)).sum(dim=0) \
        + (em & is_n).sum(dim=0)
    nrefn = (em & (fc == 4)).sum(dim=0)
    ngo = i_open.sum(dim=0) + d_open.sum(dim=0)
    ngc = ei.sum(dim=0) + ed.sum(dim=0)
    refmin = torch.where(em | ed, j, 1 << 30).amin(dim=0)
    refmin = torch.where(refmin == (1 << 30), 0, refmin)
    ops = torch.empty((S, Bc), dtype=torch.uint8, device=dev)
    n = op.shape[0]
    ops[:n] = op | (torch.clamp(fc, 0, 5) << 2) | (ismatch.to(i64) << 5)
    if n < S:       # every walk done: OP_NONE at its frozen cell from here
        ops[n:] = ops[n - 1]
    return BTResult(ops, (i + 1).to(i32), refmin.to(i32), nmm.to(i32),
                    ngo.to(i32), ngc.to(i32), nrefn.to(i32), score.to(i32))


_BTD_ARGS = [P, I, I, I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P, P]


def _backtrace_diag_cuda(dirs, sel, rows, lanes, reads, mmpen, refwins,
                         p: SWParams, band: int, S: int) -> BTResult:
    Lmax, B, Wp = dirs.shape
    Bc = sel.shape[0]
    W = refwins.shape[1]
    BW = 2 * band + 1
    dev = dirs.device
    check(dirs, "dirs", device=dev)
    for t, n, shp in ((sel, "sel", (Bc,)), (rows, "rows", (Bc,)),
                      (lanes, "lanes", (Bc,)), (reads, "reads", (Bc, Lmax)),
                      (mmpen, "mmpen", (Bc, Lmax)),
                      (refwins, "refwins", (Bc, W))):
        check(t, n, shape=shp, device=dev)
    if not 0 <= band <= 31 or not (BW + 7) // 8 <= Wp <= 8 or W < 1:
        raise ValueError(f"bt_diag: band {band} does not fit dirs of "
                         f"{Wp} words a row")
    ops = torch.empty((S, Bc), dtype=torch.uint8, device=dev)
    fields = torch.empty((7, Bc), dtype=torch.int32, device=dev)
    _build.call("sw_diag", "bt_diag", _BTD_ARGS,
                ptr(dirs), Lmax, B, Wp, ptr(sel), ptr(rows), ptr(lanes),
                ptr(reads), ptr(mmpen), ptr(refwins), Bc, W, S, band,
                p.match_bonus, p.n_pen, p.read_gap_open, p.read_gap_extend,
                p.ref_gap_open, p.ref_gap_extend, ptr(ops), ptr(fields))
    return BTResult(ops, *fields.unbind(0))


def backtrace_diag(dirs: torch.Tensor, sel: torch.Tensor, rows: torch.Tensor,
                   lanes: torch.Tensor, reads: torch.Tensor,
                   quals: torch.Tensor, refwins: torch.Tensor,
                   params: SWParams, band: int) -> BTResult:
    """Walk band-coordinate direction words from sw_banded_diag
    (bowtie2_tpu/ops/sw.py backtrace_diag). Moves: M -> (i-1, d); I ->
    (i-1, d+1); D -> (i, d-1). rows/lanes (Bc,) are best cells in band
    coordinates; ref_start_win is reported in RECT columns (row + d), so
    callers share the rectangle walk's position math. CPU tensors take the
    plain version, CUDA tensors the bt_diag kernel."""
    i32 = torch.int32
    Lmax = dirs.shape[0]
    S = bt_steps(Lmax, 2 * band + 1, params.local)
    args = (dirs.contiguous(), sel.to(i32).contiguous(),
            rows.to(i32).contiguous(), lanes.to(i32).contiguous(),
            reads.to(i32).contiguous(),
            mm_penalty_from_qual(quals, params).contiguous(),
            refwins.to(i32).contiguous())
    if on_cpu(dirs, "bt_diag"):
        return _backtrace_diag_plain(*args, params, band, S)
    return _backtrace_diag_cuda(*args, params, band, S)


def _diag_readout_plain(reads, quals, refwins, rows, lanes, lens,
                        params: SWParams):
    """The readout as torch ops, the JAX op's arrays one for one."""
    p = params
    i32 = torch.int32
    Bc, Lmax = reads.shape
    Wf = refwins.shape[1]
    dev = reads.device
    ar = torch.arange(Lmax, dtype=i32, device=dev)[None, :]
    base = lanes - rows
    idx = base[:, None] + ar
    inwin = (idx >= 0) & (idx < Wf)
    diag = refwins.gather(1, torch.clamp(idx, 0, Wf - 1).long())
    diag = torch.where(inwin, diag, 5)
    live = ar < lens[:, None]
    is_n = (reads >= 4) | (diag == 4)
    oob = diag >= 5
    eq = (diag == reads) & ~is_n & ~oob
    mmpen = mm_penalty_from_qual(quals, p)
    sub = torch.where(eq, p.match_bonus,
                      torch.where(is_n & ~oob, -p.n_pen, -mmpen))
    dscore = torch.where(live & ~oob, sub, 0).sum(dim=1).to(i32)
    gapless_ok = ~(live & oob).any(dim=1)
    n_mm = (live & ((~eq & (reads < 4) & (diag != 4)) | is_n)).sum(dim=1) \
        .to(i32)
    n_refn = (live & (diag == 4)).sum(dim=1).to(i32)
    rev = rows[:, None] - ar
    revc = torch.clamp(rev, 0, Lmax - 1).long()
    fc = torch.clamp(diag, 0, 5).gather(1, revc)
    ism = eq.to(i32).gather(1, revc)
    opbyte = torch.where(rev >= 0, OP_M | (fc << 2) | (ism << 5), OP_NONE)
    return (opbyte.to(torch.uint8).T.contiguous(), dscore, n_mm, n_refn,
            base.to(i32), gapless_ok)


_READOUT_ARGS = [P, P, P, P, P, P, I, I, I, I, I, I, I, P, P, P, P, P, P]


def _diag_readout_cuda(reads, quals, refwins, rows, lanes, lens,
                       p: SWParams):
    Bc, Lmax = reads.shape
    Wf = refwins.shape[1]
    dev = reads.device
    for t, n, shp in ((reads, "reads", (Bc, Lmax)),
                      (quals, "quals", (Bc, Lmax)),
                      (refwins, "refwins", (Bc, Wf)), (rows, "rows", (Bc,)),
                      (lanes, "lanes", (Bc,)), (lens, "lens", (Bc,))):
        check(t, n, shape=shp, device=dev)
    if Lmax == 0 or Wf == 0:
        raise ValueError(f"diag_readout: read length {Lmax} and window "
                         f"width {Wf} must be positive")
    ops = torch.empty((Lmax, Bc), dtype=torch.uint8, device=dev)
    fields = torch.empty((4, Bc), dtype=torch.int32, device=dev)
    ok = torch.empty(Bc, dtype=torch.bool, device=dev)
    _build.call("diag_readout", "diag_readout", _READOUT_ARGS,
                ptr(reads), ptr(quals), ptr(refwins), ptr(rows), ptr(lanes),
                ptr(lens), Bc, Lmax, Wf, p.match_bonus, p.mm_pen_min,
                p.mm_pen_max, p.n_pen, ptr(ops), ptr(fields[0]),
                ptr(fields[1]), ptr(fields[2]), ptr(fields[3]), ptr(ok))
    dscore, n_mm, n_refn, base = fields.unbind(0)
    return ops, dscore, n_mm, n_refn, base, ok


def diag_readout(reads, quals, refwins, rows, lanes, lens, params: SWParams):
    """Gapless readout along the diagonal ending at (rows, lanes)
    (bowtie2_tpu/ops/sw.py diag_readout; see there for why a candidate
    whose best score equals this diagonal's walks exactly this diagonal).
    reads, quals (Bc, Lmax), refwins (Bc, Wf), rows, lanes, lens (Bc,).
    CPU tensors take the plain version, CUDA tensors the diag_readout
    kernel (csrc/diag_readout.cu).

    Returns (ops (Lmax, Bc) uint8 in walk order, dscore, n_mm, n_refn,
    ref_start_win, gapless_ok)."""
    i32 = torch.int32
    args = tuple(t.to(i32).contiguous() for t in (reads, quals, refwins,
                                                  rows, lanes, lens))
    if on_cpu(args[0], "diag_readout"):
        return _diag_readout_plain(*args, params)
    return _diag_readout_cuda(*args, params)


# ---------------------- numpy oracles (replay layer) ----------------------

def sw_full_numpy_cells(read, quals, refwin, p: SWParams):
    """End-row cell vector of the unbanded e2e DP: H[L, j] for j in [0, R]
    and the start column of the best path ending at each cell. Used by the
    RNG-trajectory replay (pipeline/seed_replay.py) to enumerate backtrace
    candidates the way the reference's gatherCellsEe does. Same results as
    bowtie2_tpu/ops/sw.py's version, of which native/dpcells.c is a C
    transcription."""
    from bowtie2_tpu_torch.native.dpcells import dp_cells
    q = np.minimum(np.asarray(quals, np.int64), 40)
    mm = p.mm_pen_min + (q * (p.mm_pen_max - p.mm_pen_min)) // 40
    return dp_cells(read, mm, refwin, p)
