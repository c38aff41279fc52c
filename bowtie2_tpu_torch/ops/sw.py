"""Rectangle gapped-extension DP and its direction walk, in torch + CUDA.

Port of bowtie2_tpu/ops/sw.py. The DP (`sw_banded`) and the walk
(`backtrace`) are hand-written kernels (csrc/sw_rect.cu, csrc/backtrace.cu)
for CUDA tensors; beside each sits a plain PyTorch version of the same
function, one torch op per scan step, which runs for CPU tensors (the tests)
and which chip_smoke.py holds the kernels against on the card.

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

TRACK_ORIGIN_ITEM = ("ROADMAP.md queue 1, 'track_origin, fused_pe and "
                     "PairedAligner'")


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
    score: torch.Tensor   # (B,) int32 best alignment score
    row: torch.Tensor     # (B,) int32 row of the best end
    lane: torch.Tensor    # (B,) int32 rect column of the best end
    dirs: torch.Tensor    # (Lmax, B, ceil(W/8)) int32 packed directions


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
                     rect_cols, col_lo) -> SWResult:
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

        f_cur = _prefix_max_excl(h_noF - rgo + p.read_gap_extend + lane_e) \
            - lane_e
        f_open = torch.cat([pad, h_noF[:, :-1]], dim=1) - rgo
        f_from_ext = f_cur > f_open
        if p.gap_barrier > 0:
            f_cur = torch.where(bar, NEG_INF, f_cur)

        h_cur = torch.maximum(h_noF, f_cur)
        src = torch.where(f_cur > h_noF, H_F, src_noF)
        if p.local:
            clamp = (h_cur < 0) | ((h_cur == 0) & (src == H_DIAG))
            h_cur = torch.clamp(h_cur, min=0)
            src = torch.where(clamp, H_START, src)
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

        h = torch.where(active, h_cur, h)
        e = torch.where(active, e_cur, e)
    return SWResult(best, best_row, best_lane, dirs)


_SW_ARGS = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, P, P, P, P]


def _sw_banded_cuda(reads, mmpen, read_lens, refwins, p: SWParams,
                    rect_cols, col_lo) -> SWResult:
    B, Lmax = reads.shape
    W = refwins.shape[1]
    dev = reads.device
    for t, n, shp in ((reads, "reads", (B, Lmax)), (mmpen, "mmpen", (B, Lmax)),
                      (read_lens, "read_lens", (B,)), (refwins, "refwins", None),
                      (rect_cols, "rect_cols", (B,))):
        check(t, n, shape=shp, device=dev)
    if col_lo is not None:
        check(col_lo, "col_lo", shape=(B,), device=dev)
    if refwins.shape[0] != B or (W + 7) // 8 > 2048 or Lmax > 32767:
        raise ValueError(f"sw_rect: unsupported shape B={B} Lmax={Lmax} W={W}")
    score = torch.empty(B, dtype=torch.int32, device=dev)
    row = torch.empty(B, dtype=torch.int32, device=dev)
    lane = torch.empty(B, dtype=torch.int32, device=dev)
    dirs = torch.empty((Lmax, B, (W + 7) // 8), dtype=torch.int32, device=dev)
    _build.call("sw_rect", "sw_rect", _SW_ARGS,
                ptr(reads), ptr(mmpen), ptr(read_lens), ptr(refwins),
                ptr(rect_cols), None if col_lo is None else ptr(col_lo),
                B, Lmax, W, p.match_bonus, p.n_pen, p.read_gap_open,
                p.read_gap_extend, p.ref_gap_open, p.ref_gap_extend,
                p.gap_barrier, int(p.local),
                ptr(score), ptr(row), ptr(lane), ptr(dirs))
    return SWResult(score, row, lane, dirs)


def sw_banded(reads: torch.Tensor, quals: torch.Tensor,
              read_lens: torch.Tensor, refwins: torch.Tensor,
              params: SWParams, band: int,
              rect_cols: Optional[torch.Tensor] = None,
              col_lo: Optional[torch.Tensor] = None,
              track_origin: bool = False) -> SWResult:
    """Batched rectangle DP (bowtie2_tpu/ops/sw.py sw_banded).

    reads: (B, Lmax) int32 codes 0..4 (4=N); quals: (B, Lmax) int32;
    read_lens: (B,) int32; refwins: (B, W) int32 codes 0..5 (4=N, 5=out of
    reference), W >= Lmax + 2*band + 1. rect_cols (B,) = valid rect columns
    per problem (default read_len + 2*band + 1); col_lo (B,) = first rect
    column of word-aligned windows (default 0). CPU tensors take the plain
    version, CUDA tensors the sw_rect kernel."""
    if track_origin:
        raise NotImplementedError(
            f"sw_banded(track_origin=True) is not ported yet: see "
            f"{TRACK_ORIGIN_ITEM}")
    i32 = torch.int32
    reads = reads.to(i32).contiguous()
    read_lens = read_lens.to(i32).contiguous()
    refwins = refwins.to(i32).contiguous()
    mmpen = mm_penalty_from_qual(quals, params).contiguous()
    if rect_cols is None:
        rect_cols = read_lens + 2 * band + 1
    rect_cols = rect_cols.to(i32).contiguous()
    if col_lo is not None:
        col_lo = col_lo.to(i32).contiguous()
    if on_cpu(reads, "sw_rect"):
        return _sw_banded_plain(reads, mmpen, read_lens, refwins, params,
                                rect_cols, col_lo)
    return _sw_banded_cuda(reads, mmpen, read_lens, refwins, params,
                           rect_cols, col_lo)


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


def diag_readout(reads, quals, refwins, rows, lanes, lens, params: SWParams):
    """Gapless readout along the diagonal ending at (rows, lanes), as torch
    ops (bowtie2_tpu/ops/sw.py diag_readout; see there for why a candidate
    whose best score equals this diagonal's walks exactly this diagonal).

    Returns (ops (Lmax, Bc) uint8 in walk order, dscore, n_mm, n_refn,
    ref_start_win, gapless_ok)."""
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
