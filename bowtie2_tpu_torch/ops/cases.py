"""Seeded synthetic inputs for the exactness sweep of the rectangle DP
(`sw_rect`), the read sweep (`fm_sweep`), the half-read search
(`fm_substring`, on the read sweep's patterns), the seed search
(`fm_seed`), the direction walk (`backtrace`), the SE gapless readout
(`diag_readout`) and the SA-offset walk (`sa_resolve`): shapes, modes
and codes that the main path's first call does not reach. numpy only.

chip_smoke.py holds each kernel to its plain PyTorch version on every case
on the card; tests/test_torch_sw.py and tests/test_torch_fm.py hold the
plain versions to the JAX package's `sw_banded`, `exact_sweep_rr`,
`substring_search_rr`, `seed_search_exact`, `backtrace` and `sa_resolve`
on the same cases on the CPU.

DP cases cover window widths of both DP kernels (one warp a problem up to
256 and 512 columns, one block beyond) and both column counts a thread
(WPT 1 and 2), read lengths from 1 to 300, end-to-end and local mode, gap
barriers 0, 4 and 10, word-aligned windows (`col_lo`) and plain ones, N
codes in reads and windows, columns outside the reference, short reads
padded with N, and tandem repeats whose best cells tie. Origin cases
(`origin_cases`) aim at each rule of origin tracking: tied F runs, F runs
from column 0, the local clamp, rows past the read's end, the gap barrier
and the 533-column mate-rescue windows. Padded cases (`padded_origin_cases`)
lay their lanes out as the fused pipelines do: the live lanes first, then
length-1 padding lanes that carry real codes (the case's `n_live`).

Seed cases cover seed lengths 1, 10, 11, 22 and 40 (past the 32 codes
the seed kernel holds at once), ftab starts of fewer codes than the seed,
of all of it and none (K 0, and K past the seed), invalid seeds, Ns in
the ftab tail and in the stepped part, substitutions that empty the range
at every step, random seeds, and codes -1 (read as A) and 6 (an N).

Walk cases start from every DP case's best cells and from row 0, lane 0,
lane W - 1, a row past the read's end and a duplicated candidate; two
cases of random direction words add walks that run out of steps and
walks whose column goes below 0; a bulk case repeats one case's walks to
9,000 at scale 8, past the walk count at which the kernel runs one
thread a walk. Readout cases (`readout_cases`) hold diagonals that
start left of the window and run past its right end, Ns in reads and
windows, code-5 columns, rows 0 and Lmax - 1, lengths below and past
rows + 1, read lengths 1, 32, 33 and the main path's 128, and candidate
counts that are not a multiple of the kernel's tile. Resolve cases hold
rows at every walk length, marked rows, rows 0, n and z_off, the last
block's rows, and one bulk case that at scale 8 holds more rows than an
H100 runs threads at once, so the kernel's blocks (one thread a row) run
in several waves.

The large index mode's tables (`large_fm_case`) are made without a text:
random 2-bit BWT words over `rows` rows with checkpoints consistent with
them, marks at 1/32 density with their rank checkpoints and offsets below
n, a ftab computed from the table by backward search, and search states
and SA rows chosen to reach the rows past 2^31 at the default size
(2^31 + 2^27 rows), which no genome a test can build reaches: read,
half-read and seed patterns read off the table by LF walks from its top
rows (whose ranges stay alive and hold those rows), T-led ones (whose
ranges start near fchr[3] and run to the last row) and random ones, and
SA rows drawn mostly from the top of the row space.
chip_smoke.py holds the `_u32` kernels to their plain versions on it on
the card; tests/test_torch_zlarge.py runs the same builder at a small
`rows` against the JAX package's uint32 ops. Its twin `i64_fm_case` makes
the int64 row mode's tables (2^32 + 2^27 - 1 rows by default, with the
full checkpoints in a second int64 table, occ_cp64) and states past
2^32; chip_smoke.py holds the `_i64` kernels to their plain versions on
it, tests/test_torch_zzint64.py the plain versions at a small `rows` to
the JAX package's int64 ops.
"""

from typing import Callable, List, NamedTuple, Optional

import numpy as np

SW_WIDTHS = (8, 100, 224, 256, 257, 1000, 4100, 8300)
SW_LMAXES = (1, 37, 128, 300)
SW_GBARS = (4, 0, 10)
SW_BAND = 15

# (states, pattern columns): no state count is a multiple of a lane group
# or of a block, and 129 and 300 columns cross the kernel's staging chunk
SWEEP_SHAPES = ((1, 1), (3, 5), (37, 37), (101, 128), (67, 129), (13, 300))


class DPCase(NamedTuple):
    name: str
    reads: np.ndarray                # (B, Lmax) int32 codes, 4 past lens
    quals: np.ndarray                # (B, Lmax) int32
    lens: np.ndarray                 # (B,) int32 in 1..Lmax
    wins: np.ndarray                 # (B, W) int32 codes 0..5
    band: int
    rect_cols: Optional[np.ndarray]  # (B,) with col_lo, else the default
    col_lo: Optional[np.ndarray]
    local: bool
    gbar: int
    n_live: Optional[int] = None     # sw_banded's n_live (padded cases)

    def params(self) -> dict:
        """Keyword arguments of SWParams (either package's)."""
        return dict(match_bonus=2 if self.local else 0, local=self.local,
                    gap_barrier=self.gbar)


def _dp_case(rng, name, B, Lmax, W, local, gbar, with_col_lo, tie):
    G = SW_BAND
    lens = rng.integers(1, Lmax + 1, B).astype(np.int32)
    lens[0] = Lmax
    reads = rng.integers(0, 4, (B, Lmax)).astype(np.int32)
    wins = rng.integers(0, 4, (B, W)).astype(np.int32)
    if tie:
        for b in range(B):
            unit = rng.integers(0, 4, int(rng.integers(1, 4)))
            reads[b] = np.tile(unit, Lmax)[:Lmax]
            wins[b] = np.tile(unit, W)[:W]
    else:
        for b in range(B):
            # the read, with an indel and a few substitutions, near column G
            seg = reads[b, :lens[b]].copy()
            if seg.size > 20 and b % 3:
                p = int(rng.integers(5, seg.size - 5))
                seg = (np.concatenate([seg[:p], rng.integers(0, 4, 2), seg[p:]])
                       if b % 3 == 1 else np.delete(seg, [p, p + 1]))
            s = min(G + int(rng.integers(-3, 4)), max(W - 1, 0))
            seg = seg[:W - s]
            wins[b, s:s + seg.size] = seg
            for _ in range(int(rng.integers(0, 4))):
                wins[b, int(rng.integers(0, W))] = rng.integers(0, 4)
    reads[rng.random((B, Lmax)) < 0.02] = 4
    wins[rng.random((B, W)) < 0.02] = 4
    # out of the reference: a run at either end of some windows, and a
    # lone column inside one
    for b in range(0, B, 2):
        wins[b, :int(rng.integers(0, min(W, 9)))] = 5
        wins[b, W - int(rng.integers(0, min(W, 9))):] = 5
    if B > 1:
        wins[1, int(rng.integers(0, W))] = 5
    reads[np.arange(Lmax)[None, :] >= lens[:, None]] = 4
    quals = rng.integers(0, 42, (B, Lmax)).astype(np.int32)
    rect_cols = col_lo = None
    if with_col_lo:
        col_lo = rng.integers(0, 32, B).astype(np.int32)
        rect_cols = (lens + 2 * G + 1).astype(np.int32)
    return DPCase(name, reads, quals, lens, wins, G, rect_cols, col_lo,
                  local, gbar)


def dp_cases(seed: int = 0, scale: int = 1) -> List[DPCase]:
    """Two cases a window width (one e2e, one local) and two tandem-repeat
    tie cases; `scale` multiplies every case's problem count."""
    rng = np.random.default_rng(seed)
    out = []
    for idx, W in enumerate(SW_WIDTHS):
        for r in (0, 1):
            Lmax = SW_LMAXES[(idx + 2 * r) % len(SW_LMAXES)]
            gbar = SW_GBARS[(2 * idx + r) % len(SW_GBARS)]
            col = (idx + r) % 2 == 0
            local = bool(r)
            B = scale * (3 if W >= 4000 else 5)
            name = (f"W{W}_L{Lmax}_{'local' if local else 'e2e'}_g{gbar}"
                    f"{'_col_lo' if col else ''}")
            out.append(_dp_case(rng, name, B, Lmax, W, local, gbar, col,
                                tie=False))
    for W, Lmax, local in ((224, 128, False), (257, 37, True)):
        out.append(_dp_case(rng, f"tie_W{W}_L{Lmax}_"
                            f"{'local' if local else 'e2e'}",
                            scale * 6, Lmax, W, local, 4, True, tie=True))
    return out


def _embed_indel(rng, read, win, s, pos, kind, n):
    """Copy `read` into `win` from column s with a deletion from the read
    (`kind` "del": n window codes inserted after read position pos) or an
    insertion (`kind` "ins": read positions pos..pos+n left out)."""
    if kind == "del":
        seg = np.concatenate([read[:pos], rng.integers(0, 4, n), read[pos:]])
    else:
        seg = np.concatenate([read[:pos], read[pos + n:]])
    seg = seg[:max(win.size - s, 0)]
    win[s:s + seg.size] = seg


def origin_cases(seed: int = 0, scale: int = 1) -> List[DPCase]:
    """DP cases for origin tracking (sw_banded track_origin=True), each
    aimed at one of its rules:

    - `o_ftie`: deletions inside homopolymer runs, so that F runs of equal
      score start at several columns (the later column wins the tie);
    - `o_fcol0`: reads aligned from window column 0 that start with an
      insertion and then delete, so F runs start at column 0 from a cell
      whose origin is still -1;
    - `o_clamp`: local mode over noisy reads, where the clamp resets the
      origin many times a row;
    - `o_pastend`: reads much shorter than Lmax, whose rows past the end
      keep o and oe;
    - `o_gbar`: a gap barrier of 10 with indels near both read ends;
    - `o_W533`: mate-rescue windows of 533 columns (100-bp reads, Lmax
      128, full-width rectangles), with and without `col_lo`; the block
      DP kernel runs them."""
    rng = np.random.default_rng(seed + 300)
    G = SW_BAND
    out = []

    def base(B, Lmax, W, lens_lo):
        lens = rng.integers(lens_lo, Lmax + 1, B).astype(np.int32)
        lens[0] = Lmax
        reads = rng.integers(0, 4, (B, Lmax)).astype(np.int32)
        wins = rng.integers(0, 4, (B, W)).astype(np.int32)
        quals = rng.integers(0, 42, (B, Lmax)).astype(np.int32)
        return lens, reads, wins, quals

    def finish(name, reads, quals, lens, wins, local, gbar, rect_cols=None,
               col_lo=None):
        reads[np.arange(reads.shape[1])[None, :] >= lens[:, None]] = 4
        out.append(DPCase(name, reads, quals, lens, wins, G, rect_cols,
                          col_lo, local, gbar))

    for local in (False, True):
        mode = "local" if local else "e2e"
        # F-run ties: the read's deletion sits in a homopolymer run
        B, Lmax, W = 8 * scale, 64, 64 + 2 * G + 1
        lens, reads, wins, quals = base(B, Lmax, W, 40)
        for b in range(B):
            pos = int(rng.integers(10, int(lens[b]) - 10))
            c = int(rng.integers(0, 4))
            reads[b, pos - 3:pos + 3] = c
            n = int(rng.integers(1, 4))
            seg = np.concatenate([reads[b, :pos], np.full(n, c),
                                  reads[b, pos:lens[b]]])
            s = G + int(rng.integers(-2, 3))
            seg = seg[:W - s]
            wins[b, s:s + seg.size] = seg
        finish(f"o_ftie_{mode}", reads, quals, lens, wins, local, 0)
        # F runs from column 0: insertion at the read's start, then a
        # deletion, aligned from column 0 (no gap barrier)
        lens, reads, wins, quals = base(B, Lmax, W, 30)
        for b in range(B):
            r = reads[b, :lens[b]]
            k = int(rng.integers(1, 4))
            _embed_indel(rng, r[k:], wins[b], 0, int(rng.integers(2, 8)),
                         "del", int(rng.integers(1, 5)))
        finish(f"o_fcol0_{mode}", reads, quals, lens, wins, local, 0)
        # rows past the read's end
        B, Lmax = 6 * scale, 128
        W = Lmax + 2 * G + 1
        lens, reads, wins, quals = base(B, Lmax, W, 5)
        lens[1:] = rng.integers(5, 40, B - 1)
        for b in range(B):
            _embed_indel(rng, reads[b, :lens[b]], wins[b], G,
                         int(lens[b]) // 2, "ins" if b % 2 else "del", 2)
        finish(f"o_pastend_{mode}", reads, quals, lens, wins, local, 4)
        # gap barrier 10, indels near both ends
        B, Lmax = 8 * scale, 100
        W = Lmax + 2 * G + 1
        lens, reads, wins, quals = base(B, Lmax, W, 60)
        for b in range(B):
            L = int(lens[b])
            pos = int(rng.choice([int(rng.integers(3, 14)),
                                  int(rng.integers(L - 14, L - 3))]))
            _embed_indel(rng, reads[b, :L], wins[b], G, pos,
                         "ins" if b % 2 else "del", int(rng.integers(1, 4)))
        finish(f"o_gbar_{mode}", reads, quals, lens, wins, local, 10)
        # mate-rescue shape: 533 columns, full-width rectangles
        for with_col_lo in (False, True):
            B, Lmax, W = 4 * scale, 128, 533
            lens, reads, wins, quals = base(B, Lmax, W, 100)
            lens[:] = 100
            col_lo = rect_cols = None
            lo = np.zeros(B, np.int64)
            if with_col_lo:
                col_lo = rng.integers(0, 32, B).astype(np.int32)
                rect_cols = (W - col_lo).astype(np.int32)
                lo = col_lo.astype(np.int64)
            else:
                rect_cols = np.full(B, W, np.int32)
            for b in range(B):
                s = int(lo[b] + rng.integers(0, W - lo[b] - 110))
                _embed_indel(rng, reads[b, :100], wins[b], s,
                             int(rng.integers(20, 80)),
                             "ins" if b % 2 else "del", 3)
            wins[rng.random((B, W)) < 0.01] = 4
            finish(f"o_W533{'_col_lo' if with_col_lo else ''}_{mode}",
                   reads, quals, lens, wins, local, 4, rect_cols, col_lo)
    # the local clamp: noisy reads, where most rows restart paths
    B, Lmax, W = 8 * scale, 90, 90 + 2 * G + 1
    lens, reads, wins, quals = base(B, Lmax, W, 50)
    for b in range(B):
        seg = reads[b, :lens[b]].copy()
        noisy = rng.random(seg.size) < 0.25
        seg[noisy] = rng.integers(0, 4, int(noisy.sum()))
        wins[b, G:G + seg.size] = seg[:W - G]
    finish("o_clamp_local", reads, quals, lens, wins, True, 4)
    return out


# (Lmax, live lanes, padding lanes) of the padded cases, a unit of scale
PADDED_SHAPES = ((128, 11, 29), (200, 5, 7))


def padded_origin_cases(seed: int = 0, scale: int = 1,
                        shapes=PADDED_SHAPES, len_lo: int = 60
                        ) -> List[DPCase]:
    """DP cases laid out as the fused pipelines lay out their DP lanes
    (ops/fused.py `_core`): the n_live live lanes first, reads of len_lo
    to Lmax codes with an indel, in word-aligned windows (`col_lo` 0..31,
    rect columns len + 2G + 1, the window `gather_windows_aligned`'s
    width); then padding lanes of length 1 that carry a live lane's whole
    read and window, as the compacted candidates do, so their rows past
    the first are real codes. End to end and local, for each (Lmax, live
    lanes, padding lanes) of `shapes` (by default one and two words a
    thread, Lmax 128 and 200)."""
    rng = np.random.default_rng(seed + 500)
    G = SW_BAND
    out = []
    for Lmax, n_live, n_pad in shapes:
        n_live, n_pad = n_live * scale, n_pad * scale
        B = n_live + n_pad
        W = 32 * ((Lmax + 2 * G + 1 + 62) // 32)
        for local in (False, True):
            lens = rng.integers(len_lo, Lmax + 1, B).astype(np.int32)
            reads = rng.integers(0, 4, (B, Lmax)).astype(np.int32)
            wins = rng.integers(0, 4, (B, W)).astype(np.int32)
            col_lo = rng.integers(0, 32, B).astype(np.int32)
            for b in range(n_live):
                L = int(lens[b])
                reads[b, L:] = 4
                _embed_indel(rng, reads[b, :L], wins[b],
                             int(col_lo[b]) + G + int(rng.integers(-3, 4)),
                             int(rng.integers(10, L - 10)),
                             "ins" if b % 2 else "del", int(rng.integers(1, 4)))
            src = rng.integers(0, n_live, n_pad)
            reads[n_live:] = reads[src]
            wins[n_live:] = wins[src]
            col_lo[n_live:] = col_lo[src]
            lens[n_live:] = 1
            reads[rng.random((B, Lmax)) < 0.01] = 4
            quals = rng.integers(0, 42, (B, Lmax)).astype(np.int32)
            rect_cols = (lens + 2 * G + 1).astype(np.int32)
            out.append(DPCase(
                f"padded_L{Lmax}_{'local' if local else 'e2e'}", reads, quals,
                lens, wins, G, rect_cols, col_lo, local, 4, n_live))
    return out


def sweep_cases(genome: np.ndarray, seed: int = 0, scale: int = 1
                ) -> List[tuple]:
    """(name, rr) pairs: (B, L) int32 reversed patterns (rr[:, p] is the
    pattern's character len-1-p; 5 marks a step that does nothing). Rows
    are reversed genome substrings (long exact matches), some with
    substitutions, Ns or interior 5s, and random rows (restarts); each
    row's active length is drawn from 1..L. The last row of each case of
    more than one state holds a -1 and a 6."""
    rng = np.random.default_rng(seed)
    odd = np.random.default_rng(seed + 300)
    g = np.asarray(genome, np.int32)
    out = []
    for B, L in SWEEP_SHAPES:
        B = B * scale
        rr = np.full((B, L), 5, np.int32)
        for b in range(B):
            n = L if b == 0 else int(rng.integers(1, L + 1))
            kind = b % 5
            if kind == 4 or n > g.size:
                row = rng.integers(0, 4, n).astype(np.int32)
            else:
                s = int(rng.integers(0, g.size - n + 1))
                row = np.minimum(g[s:s + n][::-1], 4).copy()
            if kind == 1:
                row[rng.integers(0, n, 1 + n // 40)] = rng.integers(0, 4)
            elif kind == 2:
                row[rng.integers(0, n, 1 + n // 60)] = 4
            elif kind == 3:
                row[rng.integers(0, n, 1 + n // 50)] = 5
            rr[b, :n] = row
        if B > 1:
            # codes the plain versions clamp: -1 steps as A, 6 is skipped
            act = np.flatnonzero(rr[-1] < 5)
            rr[-1, odd.choice(act, min(2, act.size), replace=False)] = \
                (-1, 6)[:min(2, act.size)]
        out.append((f"B{B}_L{L}", rr))
    return out


# (seed length, ftab start): "ftab" starts from min(ftab_chars, L) codes
# (all of a seed no longer than the index's ftab key, fewer otherwise),
# "none" from the whole range (K 0), "over" from K = L + 1, which takes no
# ftab either
SEED_SHAPES = ((22, "ftab"), (22, "none"), (11, "ftab"), (10, "ftab"),
               (10, "over"), (1, "ftab"), (1, "none"), (40, "ftab"))
SEED_BATCH = 45        # seeds a case, a unit of scale


def seed_cases(genome: np.ndarray, ftab_chars: int, seed: int = 0,
               scale: int = 1) -> List[tuple]:
    """(name, seeds, valid, seed_len, K) tuples for seed_search_exact over
    an index of `genome` whose ftab keys have `ftab_chars` codes. Rows by
    b % 8: a genome substring (a hit); one with a substitution, at column
    (b // 8) mod L, so that over the rows the range empties at every step;
    an N in the ftab tail; an N in the stepped part; random codes; an
    invalid seed; a -1 (steps as A); and a 6 (dies as an N)."""
    rng = np.random.default_rng(seed + 200)
    g = np.asarray(genome, np.int32)
    out = []
    for L, role in SEED_SHAPES:
        K = {"ftab": min(ftab_chars, L), "none": 0, "over": L + 1}[role]
        B = SEED_BATCH * scale
        seeds = np.empty((B, L), np.int32)
        valid = np.ones(B, bool)
        tail = min(K, L)               # codes the ftab start resolves
        for b in range(B):
            s = int(rng.integers(0, g.size - L + 1))
            row = np.minimum(g[s:s + L], 4).copy()
            kind = b % 8
            if kind == 1:
                q = (b // 8) % L
                row[q] = (row[q] + int(rng.integers(1, 4))) % 4
            elif kind == 2:
                row[L - 1 - int(rng.integers(0, max(tail, 1)))] = 4
            elif kind == 3:
                row[int(rng.integers(0, max(L - tail, 1)))] = 4
            elif kind == 4:
                row = rng.integers(0, 4, L).astype(np.int32)
            elif kind == 5:
                valid[b] = False
            elif kind in (6, 7):
                row[int(rng.integers(0, L))] = -1 if kind == 6 else 6
            seeds[b] = row
        out.append((f"L{L}_{role}", seeds, valid, L, K))
    return out


# ---------------------------------------------------------------------------
# direction walk (backtrace)
# ---------------------------------------------------------------------------

class BTCase(NamedTuple):
    name: str
    dirs: np.ndarray       # (Lmax, B, Wp) int32 packed direction words
    sel: np.ndarray        # (Bc,) int32 problem of each walk
    rows: np.ndarray       # (Bc,) int32 start row
    lanes: np.ndarray      # (Bc,) int32 start column
    reads: np.ndarray      # (Bc, Lmax) int32
    quals: np.ndarray      # (Bc, Lmax) int32
    wins: np.ndarray       # (Bc, W) int32
    band: int
    local: bool
    gbar: int
    n_live: Optional[int] = None     # sw_banded's n_live (padded cases)

    def params(self) -> dict:
        """Keyword arguments of SWParams (either package's)."""
        return dict(match_bonus=2 if self.local else 0, local=self.local,
                    gap_barrier=self.gbar)


BULK_WALKS = 1125      # bulk walk case: walks a unit of scale
BULK_SOURCE = "W224_L128_e2e"   # the DP case it repeats (main-path shape)


def bt_case(c: DPCase, row: np.ndarray, lane: np.ndarray,
            dirs: np.ndarray, walks: int = 0) -> BTCase:
    """Walks over one DP case's direction words (`row`, `lane`, `dirs`
    from sw_banded on the case): each problem from its best cell, from
    row 0, from lane 0 and lane W - 1 of its best row, and from a row past
    its read's end (the last row when the read fills Lmax); the first walk
    again at the end (a duplicated candidate). `walks` > 0 repeats them to
    that many walks."""
    B, Lmax = c.reads.shape
    W = c.wins.shape[1]
    pb = np.arange(B)
    past = np.minimum(c.lens, Lmax - 1)
    sel = np.concatenate([pb] * 5 + [[0]])
    rows = np.concatenate([row, np.zeros(B, np.int64), row, row, past,
                           row[:1]])
    lanes = np.concatenate([lane, lane, np.zeros(B, np.int64),
                            np.full(B, W - 1), lane, lane[:1]])
    name = f"bt_{c.name}"
    if walks:
        pick = np.resize(np.arange(sel.size), walks)
        sel, rows, lanes = sel[pick], rows[pick], lanes[pick]
        name = f"bt_bulk{walks}_{c.name}"
    return BTCase(name, np.ascontiguousarray(dirs, np.int32),
                  sel.astype(np.int32), rows.astype(np.int32),
                  lanes.astype(np.int32), c.reads[sel], c.quals[sel],
                  c.wins[sel], c.band, c.local, c.gbar)


def bt_random_cases(seed: int = 0, scale: int = 1) -> List[BTCase]:
    """Random direction words, mostly diagonal moves, in both modes.
    In half the problems column 0 holds "F from F-extension" (a deletion
    that goes on): a walk that reaches it in mode 0 or 2 deletes at column
    0 for ever, its column going below 0, until the steps run out."""
    rng = np.random.default_rng(seed + 100)
    out = []
    for local, Lmax, W in ((False, 60, 150), (True, 45, 300)):
        B = 6 * scale
        src = rng.choice(4, size=(Lmax, B, W), p=[0.75, 0.1, 0.1, 0.05])
        cells = src | (rng.integers(0, 4, (Lmax, B, W)) << 2)
        cells[:, ::2, 0] = 2 | 8
        Wp = (W + 7) // 8
        pad = np.zeros((Lmax, B, 8 * Wp), np.int64)
        pad[:, :, :W] = cells
        words = (pad.reshape(Lmax, B, Wp, 8)
                 << (4 * np.arange(8))).sum(axis=3)
        dirs = words.astype(np.uint32).view(np.int32)
        Bc = 4 * B
        sel = np.tile(np.arange(B), 4)
        rows = rng.integers(-1, Lmax + 2, Bc)
        rows[:B] = Lmax - 1
        lanes = rng.integers(-2, W + 2, Bc)
        lanes[:B] = rng.integers(0, 12, B)
        reads = rng.integers(0, 5, (Bc, Lmax)).astype(np.int32)
        quals = rng.integers(0, 42, (Bc, Lmax)).astype(np.int32)
        wins = rng.integers(0, 6, (Bc, W)).astype(np.int32)
        out.append(BTCase(f"bt_random_{'local' if local else 'e2e'}_L{Lmax}"
                          f"_W{W}", dirs, sel.astype(np.int32),
                          rows.astype(np.int32), lanes.astype(np.int32),
                          reads, quals, wins, SW_BAND, local, 4))
    return out


def bt_cases(dp: Callable[[DPCase], tuple], seed: int = 0,
             scale: int = 1) -> List[BTCase]:
    """Every walk case: `dp(case)` gives (row, lane, dirs) numpy arrays of
    sw_banded on a DP case (either version: they are equal)."""
    dps = dp_cases(seed=seed, scale=scale)
    bulk = next(c for c in dps if c.name.startswith(BULK_SOURCE))
    return ([bt_case(c, *dp(c)) for c in dps]
            + [bt_case(bulk, *dp(bulk), walks=BULK_WALKS * scale)]
            + bt_random_cases(seed=seed, scale=scale))


# ---------------------------------------------------------------------------
# SA-offset walk (sa_resolve)
# ---------------------------------------------------------------------------

class ReadoutCase(NamedTuple):
    name: str
    reads: np.ndarray                # (Bc, Lmax) int32 codes 0..4
    quals: np.ndarray                # (Bc, Lmax) int32
    wins: np.ndarray                 # (Bc, Wf) int32 codes 0..5
    rows: np.ndarray                 # (Bc,) int32 in 0..Lmax - 1 (edge
                                     # cases: -1 and past Lmax too)
    lanes: np.ndarray                # (Bc,) int32 window columns
    lens: np.ndarray                 # (Bc,) int32 in 0..Lmax
    params: dict                     # SWParams keywords (either package's)


READOUT_LMAXES = (1, 32, 33, 128)      # 128: the main path's bucket
READOUT_BATCH = 45     # candidates a case, a unit of scale: not a multiple
                       # of the kernel's 32-candidate block nor of 16
# the edge cases' candidates (a unit of scale): 1, 17 and 50 are not
# multiples of 16 (byte stores of the op rows), 48 is one but not of 32 (a
# part block of 16-byte stores); at scale 8: 8, 136, 400 (16 but not 32)
# and 384 (whole blocks)
READOUT_EDGE_BATCHES = (1, 17, 48, 50)
# read lengths past the kernel's 256-step shared tile (the longest
# LEN_BUCKETS value among them), at a few candidates
READOUT_LONG_LMAXES = (768, 8192)
READOUT_LONG_BATCH = 3
READOUT_PARAMS = (("e2e", {}),
                  ("bonus", dict(match_bonus=2, mm_pen_max=5, mm_pen_min=1,
                                 n_pen=2)))


def _readout_case(rng, name, Bc, Lmax, Wf, params):
    rows = rng.integers(0, Lmax, Bc).astype(np.int32)
    rows[:2] = (0, Lmax - 1)
    # diagonals that start left of the window (base < 0), inside it, and
    # that run past its right end
    base = rng.integers(-4, max(Wf - Lmax, 0) + 5, Bc).astype(np.int32)
    base[2:4] = (-Lmax - 2, Wf + 1)            # wholly outside
    lanes = (base + rows).astype(np.int32)
    # lengths from 0 to Lmax: below rows + 1 (rows past the read) and
    # past it (positions no walk step reads)
    lens = rng.integers(0, Lmax + 1, Bc).astype(np.int32)
    lens[4:] = np.where(rng.random(Bc - 4) < 0.5, rows[4:] + 1, lens[4:])
    wins = rng.integers(0, 4, (Bc, Wf)).astype(np.int32)
    reads = rng.integers(0, 4, (Bc, Lmax)).astype(np.int32)
    for b in range(Bc):
        # the read copied off its diagonal, with a few substitutions
        p = np.arange(Lmax)
        idx = base[b] + p
        inw = (idx >= 0) & (idx < Wf)
        reads[b, inw] = wins[b, idx[inw]]
        sub = rng.random(Lmax) < 0.05
        reads[b, sub] = (reads[b, sub]
                         + rng.integers(1, 4, int(sub.sum()))) % 4
    # Ns in reads and windows, columns outside the reference (code 5): a
    # run at either end of some windows and lone ones inside
    reads[rng.random((Bc, Lmax)) < 0.03] = 4
    wins[rng.random((Bc, Wf)) < 0.03] = 4
    wins[rng.random((Bc, Wf)) < 0.01] = 5
    for b in range(0, Bc, 3):
        wins[b, :int(rng.integers(0, min(Wf, 6) + 1))] = 5
        wins[b, Wf - int(rng.integers(0, min(Wf, 6) + 1)):] = 5
    quals = rng.integers(0, 45, (Bc, Lmax)).astype(np.int32)
    return ReadoutCase(name, reads, quals, wins, rows, lanes, lens,
                       dict(params))


def _readout_edge_case(rng, name, Bc, Lmax, Wf, params):
    """A readout case whose best rows reach past the walk's ends (the
    fused path never has them: there lens = rows + 1 <= Lmax): candidate
    0 at row -1 (every step OP_NONE) on a diagonal wholly left of its
    window (every live position out of it); then, in turn, a row past the
    kernel's 256-step tile where Lmax allows (else Lmax - 1), past 2 Lmax
    and Lmax (steps up to rows - Lmax + 1 repeat position Lmax - 1), rows
    near -2^31 where rows - s wraps in int32 (-2^31: steps from 1 emit
    position Lmax - 1; -2^31 + Lmax - 2: the last step does;
    -2^31 + Lmax - 1: none does), -1 again, and the readout case's own
    row. Each keeps its diagonal's start column."""
    full = _readout_case(rng, name, max(Bc, 6), Lmax, Wf, params)
    c = full._replace(**{f: getattr(full, f)[:Bc] for f in (
        "reads", "quals", "wins", "rows", "lanes", "lens")})
    base = c.lanes.astype(np.int64) - c.rows
    rows = c.rows.astype(np.int64)
    lens = c.lens.copy()
    far = int(rng.integers(256, Lmax)) if Lmax > 256 else Lmax - 1
    edge_rows = (-1, far, 2 * Lmax + 5, Lmax, -2**31, -2**31 + Lmax - 2,
                 -2**31 + Lmax - 1, -1)
    for b in range(Bc):
        k = b % (len(edge_rows) + 1)
        if k < len(edge_rows):
            rows[b] = edge_rows[k]
    base[0] = -Lmax - 2
    lens[0] = Lmax
    return c._replace(rows=rows.astype(np.int32),
                      lanes=(base + rows).astype(np.int32), lens=lens)


def readout_cases(seed: int = 0, scale: int = 1) -> List[ReadoutCase]:
    """The SE gapless readout (`diag_readout`): every read length of
    READOUT_LMAXES, a window wider than the read (the fused path's shape)
    and one narrower, each with the default scores and with a match bonus
    and other penalties; the edge cases (`_readout_edge_case`: rows -1,
    past Lmax and near -2^31) at each READOUT_EDGE_BATCHES count, and at the
    READOUT_LONG_LMAXES lengths past the kernel's shared tile; `scale`
    multiplies the candidates of a case."""
    rng = np.random.default_rng(seed + 4242)
    out = []
    for Lmax in READOUT_LMAXES:
        for wkind, Wf in (("wide", Lmax + 61), ("narrow", Lmax // 2 + 3)):
            for pkind, params in READOUT_PARAMS:
                out.append(_readout_case(
                    rng, f"L{Lmax}_{wkind}_{pkind}", READOUT_BATCH * scale,
                    Lmax, Wf, params))
    # rows past either end of the walk, at the fused path's shape (Lmax
    # 128, window 224) and at an odd length, over READOUT_EDGE_BATCHES
    for Bc in READOUT_EDGE_BATCHES:
        for Lmax, Wf in ((128, 224), (33, 94)):
            out.append(_readout_edge_case(
                rng, f"edges_L{Lmax}_B{Bc}", Bc * scale, Lmax, Wf, {}))
    # reads longer than one shared tile of steps
    for Lmax in READOUT_LONG_LMAXES:
        out.append(_readout_edge_case(
            rng, f"long_L{Lmax}", READOUT_LONG_BATCH * scale, Lmax,
            Lmax + 61, dict(READOUT_PARAMS[1][1])))
    return out


RESOLVE_PERIODS = (1, 16, 32)
RESOLVE_KINDS = ("lengths", "ends", "bulk")


def walk_lengths(half, rows: np.ndarray, period: int) -> np.ndarray:
    """LF steps from each row to a marked row (at most `period`), from a
    host index half (index/build.py HalfIndex: bwt_words, occ_cp, fchr,
    z_off, mark_words)."""
    words = np.asarray(half.bwt_words).view(np.uint32).reshape(-1, 8)
    marks = np.asarray(half.mark_words).view(np.uint32)
    occ = np.asarray(half.occ_cp, np.int64)
    fchr = np.asarray(half.fchr, np.int64)
    sh = 2 * np.arange(16, dtype=np.uint32)
    lane = np.arange(128)
    row = np.asarray(rows, np.int64).copy()
    steps = np.zeros(row.size, np.int64)
    live = np.ones(row.size, bool)
    for _ in range(period):
        marked = ((marks[row >> 5] >> (row & 31).astype(np.uint32)) & 1) == 1
        live &= ~marked
        if not live.any():
            break
        r = row[live]
        block, pos = r >> 7, r & 127
        crumbs = ((words[block][:, :, None] >> sh) & 3).reshape(-1, 128)
        c = crumbs[np.arange(r.size), pos].astype(np.int64)
        below = ((crumbs == c[:, None]) & (lane < pos[:, None])).sum(axis=1)
        row[live] = (fchr[c] + occ[block, c] + below
                     - ((c == 0) & (r > half.z_off)))
        steps[live] += 1
    return steps


def resolve_cases(half, period: int, seed: int = 0, scale: int = 1
                  ) -> List[tuple]:
    """(kind, rows) pairs over one index half whose marks sit every
    `period` text positions (off_rate log2(period)):
    - lengths: `2 * scale` rows at every walk length 0 .. period - 1 that
      a random pool holds (marked rows are length 0);
    - ends: rows 0, n, z_off and its neighbours, and the last block's
      rows;
    - bulk: 8192 * scale^2 random rows (524,288 at scale 8, beyond the
      rows an H100 holds one a lane)."""
    rng = np.random.default_rng(seed + 7 * period)
    nrows = half.n + 1
    pool = rng.integers(0, nrows, 256 * period * scale)
    lens = walk_lengths(half, pool, period)
    picks = [pool[lens == k][:2 * scale] for k in range(period)]
    lengths = rng.permutation(np.concatenate(picks))
    last = np.arange(128 * ((nrows - 1) // 128), nrows)
    ends = np.concatenate([[0, half.n, half.z_off, max(half.z_off - 1, 0),
                            min(half.z_off + 1, half.n)], last])
    bulk = rng.integers(0, nrows, 8192 * scale * scale)
    return [(k, np.asarray(r, np.int32)) for k, r in
            zip(RESOLVE_KINDS, (lengths, ends, bulk))]


# ---------------------------------------------------------------------------
# band-coordinate DP and walk (sw_diag, bt_diag: reads over 8192 bp)
# ---------------------------------------------------------------------------

# (G, e2e Lmax, local Lmax): band widths BW = 2G + 1 from 5 to 61, so
# ceil(BW / 8) runs 1..8; row counts of one row, of part of a 32-row chunk
# and of several chunks
DIAG_SHAPES = ((2, 37, 100), (3, 100, 1), (10, 300, 37), (15, 129, 300),
               (30, 100, 64))
DIAG_GBARS = (4, 0, 10)
# (name, kind, G, Lmax, local, gap barrier) of the cases at the edges of
# the kernels' designs (see diag_cases)
DIAG_EDGES = (("short", "short", 10, 200, False, 4),
              ("short", "short", 10, 200, True, 0),
              ("odd", "embed", 15, 90, False, 4),
              ("odd", "embed", 15, 90, True, 0),
              ("long", "embed", 30, 700, False, 0),
              ("long", "embed", 30, 650, True, 4),
              ("longgap", "longgap", 30, 300, False, 0),
              ("longgap", "longgap", 30, 300, True, 10),
              ("g0", "embed", 0, 120, False, 4),
              ("g0", "embed", 0, 90, True, 0))


def _diag_case(rng, name, B, Lmax, G, local, gbar, kind="embed"):
    """One band-DP case, windows of Lmax + 2G + 1 columns. kind:
    - embed: each read copied into its window from a band column s, by
      b % 5: no indel (any s), a deletion of 1..G window codes, an
      insertion of 1..G read codes, and a net drift of +G and of -G from
      s = G (the path ends at the band's edge); substitutions after;
    - tie: tandem repeats in read and window (tied row maxima);
    - frun: a deletion inside a homopolymer run (F runs of equal score
      from several columns);
    - clamp: a quarter of the read's codes random (local: the clamp
      restarts paths many times a row);
    - short: every read 1-3 codes long, so nearly every row lies past its
      read's end;
    - longgap: a deletion or an insertion of 33 .. 2G - 5 codes (G = 30),
      a gap run longer than one 32-lane window of the walk;
    and at G = 0 (BW = 1) only the no-indel embedding.
    Every case has N codes in reads and windows, out-of-reference codes
    (5) at both ends of every other window, and reads shorter than Lmax
    (padded with N), whose rows past the end are part of the output."""
    BW = 2 * G + 1
    W = Lmax + BW
    lens = rng.integers(1, Lmax + 1, B).astype(np.int32)
    lens[0] = Lmax
    if B > 2:
        lens[1] = max(1, Lmax // 3)
    if kind == "short":
        lens = rng.integers(1, 4, B).astype(np.int32)
    reads = rng.integers(0, 4, (B, Lmax)).astype(np.int32)
    wins = rng.integers(0, 4, (B, W)).astype(np.int32)
    for b in range(B):
        L = int(lens[b])
        if kind == "tie":
            unit = rng.integers(0, 4, int(rng.integers(1, 4)))
            reads[b] = np.tile(unit, Lmax)[:Lmax]
            wins[b] = np.tile(unit, W)[:W]
            continue
        seg = reads[b, :L]
        if kind == "clamp":
            noisy = rng.random(L) < 0.25
            read = seg.copy()
            read[noisy] = rng.integers(0, 4, int(noisy.sum()))
            _embed_indel(rng, read, wins[b], G, L, "del", 0)
            continue
        if kind == "frun" and L > 20:
            pos = int(rng.integers(8, L - 8))
            c = int(rng.integers(0, 4))
            seg[pos - 3:pos + 3] = c
            n = int(rng.integers(1, min(3, G) + 1))
            s = int(rng.integers(0, BW - n))
            _embed_indel(rng, seg, wins[b], s, pos, "del", n)
            wins[b, s + pos:s + pos + n] = c
            continue
        if kind == "longgap":
            n = int(rng.integers(33, 2 * G - 4))
            if L >= 2 * n + 6:
                pos = int(rng.integers(3, L - n - 2))
                gap = "del" if b % 2 else "ins"
                s = (int(rng.integers(0, BW - n)) if gap == "del" else
                     int(rng.integers(n, BW)))
                _embed_indel(rng, seg, wins[b], s, pos, gap, n)
            else:
                _embed_indel(rng, seg, wins[b], G, L, "del", 0)
            continue
        ev = b % 5 if G > 0 else 0
        n = int(rng.integers(1, G + 1)) if ev in (1, 2) else G
        if L < 2 * n + 6 or ev == 0:
            _embed_indel(rng, seg, wins[b], int(rng.integers(0, BW)), L,
                         "del", 0)
        else:
            pos = int(rng.integers(3, L - n - 2))
            gap = "del" if ev in (1, 3) else "ins"
            s = (int(rng.integers(0, BW - n)) if ev == 1 else
                 int(rng.integers(n, BW)) if ev == 2 else G)
            _embed_indel(rng, seg, wins[b], s, pos, gap, n)
        for _ in range(int(rng.integers(0, 4))):
            wins[b, int(rng.integers(0, W))] = rng.integers(0, 4)
    reads[rng.random((B, Lmax)) < 0.02] = 4
    wins[rng.random((B, W)) < 0.02] = 4
    for b in range(0, B, 2):
        wins[b, :int(rng.integers(0, min(W, 9)))] = 5
        wins[b, W - int(rng.integers(0, min(W, 9))):] = 5
    reads[np.arange(Lmax)[None, :] >= lens[:, None]] = 4
    quals = rng.integers(0, 42, (B, Lmax)).astype(np.int32)
    return DPCase(name, reads, quals, lens, wins, G, None, None, local, gbar)


def diag_cases(seed: int = 0, scale: int = 1) -> List[DPCase]:
    """Band-DP cases (sw_banded_diag; `band` is G): an end-to-end and a
    local case at each DIAG_SHAPES band, gap barriers 0, 4 and 10 in turn,
    the tie, F-run and clamp cases, and the edges of the kernels' designs
    (DIAG_EDGES): reads of 1-3 codes in a 200-row bucket (rows past the
    read's end), an odd problem count (4 * scale + 3: a pair a block, the
    last one alone), 600-700 rows (direction words leave the DP's 64-row
    ring many times; the walk crosses its 256-row stages), gap runs longer
    than 32 at G = 30 and a band of one cell (G = 0). Every other case
    holds 5 * scale + 1 problems."""
    rng = np.random.default_rng(seed + 400)
    B = 5 * scale + 1
    out = []
    for idx, (G, l_e2e, l_local) in enumerate(DIAG_SHAPES):
        for r, Lmax in enumerate((l_e2e, l_local)):
            local = bool(r)
            gbar = DIAG_GBARS[(2 * idx + r) % len(DIAG_GBARS)]
            out.append(_diag_case(
                rng, f"d_G{G}_L{Lmax}_{'local' if local else 'e2e'}_g{gbar}",
                B, Lmax, G, local, gbar))
    for kind, G, Lmax, local, gbar in (
            ("tie", 3, 64, False, 4), ("tie", 15, 100, True, 0),
            ("frun", 10, 80, False, 0), ("frun", 10, 80, True, 4),
            ("clamp", 15, 90, True, 4)):
        out.append(_diag_case(
            rng, f"d_{kind}_G{G}_L{Lmax}_{'local' if local else 'e2e'}",
            B, Lmax, G, local, gbar, kind))
    for name, kind, G, Lmax, local, gbar in DIAG_EDGES:
        n = 4 * scale + 3 if name == "odd" else B
        out.append(_diag_case(
            rng, f"d_{name}_G{G}_L{Lmax}_{'local' if local else 'e2e'}",
            n, Lmax, G, local, gbar, kind))
    return out


def bt_diag_case(c: DPCase, row: np.ndarray, lane: np.ndarray,
                 dirs: np.ndarray) -> BTCase:
    """Walks over one band-DP case's direction words (`row`, `lane`, `dirs`
    from sw_banded_diag on the case, lanes in band columns): each problem
    from its best cell, from row 0, from band columns 0 and BW - 1 of its
    best row, and from a row past its read's end; the first walk again (a
    duplicated candidate); and problem 0 from row -1, from band columns -1
    and BW (done at once) and from row Lmax + 1 (rows clamp on every
    load)."""
    B, Lmax = c.reads.shape
    BW = 2 * c.band + 1
    pb = np.arange(B)
    past = np.minimum(c.lens, Lmax - 1)
    r0, l0 = int(row[0]), int(lane[0])
    sel = np.concatenate([pb] * 5 + [[0] * 5])
    rows = np.concatenate([row, np.zeros(B, np.int64), row, row, past,
                           [r0, -1, r0, r0, Lmax + 1]])
    lanes = np.concatenate([lane, lane, np.zeros(B, np.int64),
                            np.full(B, BW - 1), lane, [l0, l0, -1, BW, l0]])
    return BTCase(f"bt_{c.name}", np.ascontiguousarray(dirs, np.int32),
                  sel.astype(np.int32), rows.astype(np.int32),
                  lanes.astype(np.int32), c.reads[sel], c.quals[sel],
                  c.wins[sel], c.band, c.local, c.gbar)


def bt_diag_random_cases(seed: int = 0, scale: int = 1) -> List[BTCase]:
    """Random band-coordinate direction words in both modes, many of them
    gap moves, from random starts (rows -1 .. Lmax + 1, band columns -2 ..
    BW + 1): walks that leave the band on either side, walks that leave
    the rows, and, from problem 0's first cell, a walk that alternates I
    and D until the steps run out."""
    rng = np.random.default_rng(seed + 500)
    out = []
    for local, Lmax, G in ((False, 60, 10), (True, 45, 30), (False, 200, 2)):
        BW = 2 * G + 1
        W = Lmax + BW
        B = 6 * scale + 1
        src = rng.choice(4, size=(Lmax, B, BW), p=[0.55, 0.2, 0.2, 0.05])
        cells = src | (rng.integers(0, 4, (Lmax, B, BW)) << 2)
        # problem 0: I from even band columns, D from odd ones, no
        # extension: a walk from (Lmax - 1, 0) takes two steps a row
        cells[:, 0, :] = 1 + np.arange(BW) % 2
        Wp = (BW + 7) // 8
        pad = np.zeros((Lmax, B, 8 * Wp), np.int64)
        pad[:, :, :BW] = cells
        words = (pad.reshape(Lmax, B, Wp, 8)
                 << (4 * np.arange(8))).sum(axis=3)
        dirs = words.astype(np.uint32).view(np.int32)
        Bc = 4 * B + 1
        sel = np.resize(np.arange(B), Bc)
        rows = rng.integers(-1, Lmax + 2, Bc)
        rows[:B] = Lmax - 1
        lanes = rng.integers(-2, BW + 2, Bc)
        lanes[:B] = rng.integers(0, BW, B)
        lanes[0] = 0
        reads = rng.integers(0, 5, (Bc, Lmax)).astype(np.int32)
        quals = rng.integers(0, 42, (Bc, Lmax)).astype(np.int32)
        wins = rng.integers(0, 6, (Bc, W)).astype(np.int32)
        out.append(BTCase(f"btd_random_{'local' if local else 'e2e'}_L{Lmax}"
                          f"_G{G}", dirs, sel.astype(np.int32),
                          rows.astype(np.int32), lanes.astype(np.int32),
                          reads, quals, wins, G, local, 4))
    return out


def bt_diag_edge_cases(seed: int = 0, scale: int = 1) -> List[BTCase]:
    """Walks over made-up direction words whose runs end in mid-window:
    problem 0 all H_DIAG (random extension bits; local: H_START at one
    row), problem 1 all E from E-extension, problem 2 all F from
    F-extension. From each: the last row at the middle band column (an M
    run reaches row -1; an I run leaves the band at BW - 1), row Lmax +
    100 there (an M run meets the step limit S, the first 101 steps on
    the clamped last row), band column 0 of the last row and of row 20 (an
    I run from the band's left edge; one reaches row -1), band column BW - 1
    of the last and the middle row (a D run leaves the band at 0), and two
    more cells. Lmax 700 / 650 at G = 30 cross the walk's 256-row stages;
    G = 0 leaves a band of one cell. `scale` repeats each problem."""
    rng = np.random.default_rng(seed + 600)
    out = []
    for local, Lmax, G in ((False, 700, 30), (True, 650, 30), (False, 300, 0)):
        BW = 2 * G + 1
        W = Lmax + BW
        B = 3 * scale
        cells = np.zeros((Lmax, B, BW), np.int64)
        kind = np.arange(B) % 3
        cells[:, kind == 0, :] = rng.integers(0, 4, (Lmax, int(
            (kind == 0).sum()), BW)) << 2
        if local:
            cells[Lmax // 4, kind == 0, :] = 3
        cells[:, kind == 1, :] = 1 | 4
        cells[:, kind == 2, :] = 2 | 8
        Wp = (BW + 7) // 8
        pad = np.zeros((Lmax, B, 8 * Wp), np.int64)
        pad[:, :, :BW] = cells
        words = (pad.reshape(Lmax, B, Wp, 8)
                 << (4 * np.arange(8))).sum(axis=3)
        dirs = words.astype(np.uint32).view(np.int32)
        starts = [(Lmax - 1, G), (Lmax + 100, G), (Lmax - 1, 0), (20, 0),
                  (Lmax - 1, BW - 1), (Lmax // 2, BW - 1), (Lmax // 3, 5 % BW),
                  (0, G)]
        sel = np.repeat(np.arange(B), len(starts))
        rows = np.tile([r for r, _ in starts], B)
        lanes = np.tile([d for _, d in starts], B)
        Bc = sel.size
        reads = rng.integers(0, 5, (Bc, Lmax)).astype(np.int32)
        quals = rng.integers(0, 42, (Bc, Lmax)).astype(np.int32)
        wins = rng.integers(0, 6, (Bc, W)).astype(np.int32)
        out.append(BTCase(f"btd_edge_{'local' if local else 'e2e'}_L{Lmax}"
                          f"_G{G}", np.ascontiguousarray(dirs),
                          sel.astype(np.int32), rows.astype(np.int32),
                          lanes.astype(np.int32), reads, quals, wins, G,
                          local, 4))
    return out


def bt_diag_cases(dp: Callable[[DPCase], tuple], seed: int = 0,
                  scale: int = 1) -> List[BTCase]:
    """Every band-walk case: `dp(case)` gives (row, lane, dirs) numpy
    arrays of sw_banded_diag on a diag case (either version: they are
    equal)."""
    return ([bt_diag_case(c, *dp(c))
             for c in diag_cases(seed=seed, scale=scale)]
            + bt_diag_random_cases(seed=seed, scale=scale)
            + bt_diag_edge_cases(seed=seed, scale=scale))


# ---------------------------------------------------------------------------
# the large index mode's FM tables (uint32 row space)
# ---------------------------------------------------------------------------

# rows of the default large table: past 2^31 by 2^27 less one, so that the
# last block is one row short of full and a search from the whole range
# reads the row count's true checkpoint (about 17.8 M blocks: fm_blocks
# 0.86 GB, mark_rows 0.36 GB, offs 0.27 GB)
LARGE_ROWS = (1 << 31) + (1 << 27) - 1
I64_ROWS = (1 << 32) + (1 << 27) - 1   # the int64 mode's table
LARGE_FTAB = 5          # ftab key codes (4^5 keys) of the large table
_M32 = np.uint64(0xFFFFFFFF)
_I64_MIN = np.int64(-(1 << 63))


class LargeFmCase(NamedTuple):
    n: int                      # rows - 1
    z_off: int
    fm_blocks: np.ndarray       # uint32[nblocks, 12]: words, checkpoints
    fchr: np.ndarray            # uint32[5]
    ftab: np.ndarray            # uint32[2 * 4^K + 1]
    ftab_chars: int
    mark_rows: np.ndarray       # uint32[nblocks, 5]: mark words, rank cp
    offs: np.ndarray            # uint32[n_marked], each below n
    sweep_rr: np.ndarray        # (batch, 128) int32 reversed patterns
    substring_rr: np.ndarray    # (2 batch, 65) int32
    seeds: np.ndarray           # (8 batch, 22) int32
    seed_valid: np.ndarray      # (8 batch,) bool
    seed_len: int
    resolve_rows: np.ndarray    # (8 batch,) int64 rows
    occ_cp64: Optional[np.ndarray] = None  # int64[nblocks, 4]: the int64
                                # mode's checkpoints (i64_fm_case), whose
                                # fchr, ftab and offs are int64


def _popcount32(x: np.ndarray) -> np.ndarray:
    """Bits set in each uint32 (SWAR, no numpy 2 bitwise_count)."""
    x = x.astype(np.uint32, copy=True)
    x -= (x >> 1) & np.uint32(0x55555555)
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> 24).astype(np.int64)


def _crumb_counts(words: np.ndarray) -> np.ndarray:
    """(m,) uint32 words → (m, 4) counts of each 2-bit code in them."""
    lo = words & np.uint32(0x55555555)
    hi = (words >> 1) & np.uint32(0x55555555)
    c3 = _popcount32(lo & hi)
    c1 = _popcount32(lo) - c3
    c2 = _popcount32(hi) - c3
    return np.stack([16 - c1 - c2 - c3, c1, c2, c3], axis=1)


def lf_np(fm_blocks, fchr, z_off, i, c, occ_cp64=None):
    """LF(i, c) of a uint32-row table in int64 numpy, wrapping mod 2^32
    where the JAX package's uint32 op does (a row past the last block
    reads as 0xFFFFFFFF); with `occ_cp64`, of an int64-row table, whose
    checkpoints come from it (INT64_MIN past the last block) and whose
    adds wrap in int64. i: (m,) rows, c: (m,) codes 0..3."""
    i = np.asarray(i, np.int64)
    c = np.asarray(c, np.int64)
    nb = fm_blocks.shape[0]
    block = i >> 7
    past = block >= nb
    if occ_cp64 is not None:     # below row 0 after a fill: read as past
        past |= block < 0
    row = fm_blocks[np.clip(block, 0, nb - 1)]
    words = np.where(past[:, None], np.uint32(0xFFFFFFFF), row[:, :8])
    if occ_cp64 is not None:
        cp = np.where(past, _I64_MIN, occ_cp64[np.clip(block, 0, nb - 1), c])
    else:
        cp = np.where(past, 0xFFFFFFFF,
                      row[np.arange(i.size), 8 + c].astype(np.int64))
    pos = i & 127
    pat = (c * 0x55555555).astype(np.uint32)
    cnt = np.zeros(i.size, np.int64)
    for k in range(8):
        x = words[:, k] ^ pat
        eq = ~(x | (x >> 1)) & np.uint32(0x55555555)
        n = np.clip(pos - 16 * k, 0, 16)
        mask = np.where(n >= 16, 0xFFFFFFFF,
                        (1 << (2 * n)) - 1).astype(np.uint32)
        cnt += _popcount32(eq & mask)
    corr = ((c == 0) & (i > z_off)).astype(np.int64)
    with np.errstate(over="ignore"):
        out = fchr.astype(np.int64)[c] + cp + cnt - corr
    return out if occ_cp64 is not None else out & 0xFFFFFFFF


def _bwt_code(fm_blocks, row):
    """The 2-bit BWT code at each row."""
    w = fm_blocks[row >> 7, (row >> 4) & 7]
    return ((w >> (2 * (row & 15)).astype(np.uint32)) & 3).astype(np.int64)


def _large_patterns(rng, fm_blocks, fchr, z_off, B, L, tails=True,
                    occ_cp64=None):
    """(B, L) reversed patterns by b % 4: two of four read off the table
    by LF walks from rows in its top quarter (their backward searches keep
    a range holding the walk's next row all the way), one a run of Ts (its
    range climbs to the last rows), one random with some Ns; with `tails`
    each of an active length drawn from 1..L (the rest 5), the first of
    all L."""
    rows = fm_blocks.shape[0] * 128
    rr = rng.integers(0, 4, (B, L)).astype(np.int32)
    kind = np.arange(B) % 4
    rr[kind == 2] = 3
    rr[:, 0] = np.where(kind == 3, rr[:, 0], 3)
    walk = np.nonzero(kind < 2)[0]
    row = rng.integers(rows - rows // 4, rows, walk.size)
    for p in range(L):
        c = _bwt_code(fm_blocks, row)
        rr[walk, p] = c
        row = lf_np(fm_blocks, fchr, z_off, row, c, occ_cp64)
        row = np.where(row < rows, row, 0)
    noise = (kind == 3)[:, None] & (rng.random((B, L)) < 0.02)
    rr[noise] = 4
    if not tails:
        return rr
    n = rng.integers(1, L + 1, B)
    n[0] = L
    rr[np.arange(L)[None, :] >= n[:, None]] = 5
    return rr


def large_fm_case(seed: int = 0, rows: int = LARGE_ROWS,
                  batch: int = 16384, ftab_chars: int = LARGE_FTAB
                  ) -> LargeFmCase:
    """The large mode's FM tables over `rows` rows and the search states
    of the four kernels: `batch` read patterns of 128 columns, 2 batch
    half-read patterns of 65, 8 batch seeds of 22 codes and 8 batch SA
    rows (the main path's first-call shapes at the default 16,384). As
    the builder does, the sentinel row's BWT code is an A, the last
    block's codes past the rows are As, and neither counts in fchr."""
    assert rows < (1 << 32)
    return _fm_case(seed, rows, batch, ftab_chars, False)


def i64_fm_case(seed: int = 0, rows: int = I64_ROWS, batch: int = 16384,
                ftab_chars: int = LARGE_FTAB) -> LargeFmCase:
    """large_fm_case's twin in the int64 row mode: the same tables and
    states over `rows` rows (2^32 + 2^27 - 1 by default, one short of
    whole blocks), with the full checkpoints in `occ_cp64`, fchr, ftab
    and offs as int64 (offsets up to n, past 2^32 at the default size),
    and the SA rows drawn mostly past 2^32. At a small `rows` it serves
    the CPU tests; at a multiple of 128 the row past the last block is
    reached (INT64_MIN fill)."""
    return _fm_case(seed, rows, batch, ftab_chars, True)


def _fm_case(seed, rows, batch, ftab_chars, int64) -> LargeFmCase:
    rng = np.random.default_rng(seed)
    nb = -(-rows // 128)
    n = rows - 1
    words = rng.integers(0, 1 << 32, nb * 8, dtype=np.uint32)
    z_off = int(rng.integers(0, rows))
    for r in [z_off] + list(range(rows, nb * 128)):
        words[r >> 4] &= ~np.uint32(3 << (2 * (r & 15)))
    counts = np.zeros((nb, 4), np.int64)
    step = 1 << 22                               # words a pass
    for s in range(0, words.size, step):
        part = _crumb_counts(words[s:s + step])
        counts[s // 8:(s + part.shape[0]) // 8] = \
            part.reshape(-1, 8, 4).sum(axis=1)
    occ = np.concatenate([np.zeros((1, 4), np.int64),
                          np.cumsum(counts, axis=0)[:-1]])
    tot = counts.sum(axis=0)
    tot[0] -= 1 + nb * 128 - rows                # the sentinel, the pad
    fchr = np.concatenate([[1], 1 + np.cumsum(tot)]).astype(np.int64)
    assert fchr[4] == rows
    fm = np.empty((nb, 12), np.uint32)
    fm[:, :8] = words.reshape(nb, 8)
    fm[:, 8:] = (occ & 0xFFFFFFFF).astype(np.uint32)
    cp64 = occ if int64 else None
    del words, occ, counts
    # marks at 1/32 density (each bit the AND of five random bits), the
    # last row marked, so that every row's rank indexes offs
    marks = rng.integers(0, 1 << 32, nb * 4, dtype=np.uint32)
    for _ in range(4):
        marks &= rng.integers(0, 1 << 32, nb * 4, dtype=np.uint32)
    marks[(rows - 1) >> 5] |= np.uint32(1 << ((rows - 1) & 31))
    per = np.zeros(nb, np.int64)
    for s in range(0, marks.size, step):
        part = _popcount32(marks[s:s + step])
        per[s // 4:(s + part.size) // 4] = part.reshape(-1, 4).sum(axis=1)
    mark_rows = np.empty((nb, 5), np.uint32)
    mark_rows[:, :4] = marks.reshape(nb, 4)
    mark_rows[:, 4] = np.concatenate([[0], np.cumsum(per)[:-1]]).astype(
        np.uint32)
    offs = rng.integers(0, n, int(per.sum()),
                        dtype=np.int64 if int64 else np.uint32)
    del marks, per
    # ftab: each full K-mer's range by backward search from the last code
    K = ftab_chars
    keys = np.arange(4 ** K, dtype=np.int64)
    top = np.zeros(keys.size, np.int64)
    bot = np.full(keys.size, rows, np.int64)
    for q in range(K):                           # codes right to left
        c = (keys // 4 ** q) % 4
        top, bot = lf_np(fm, fchr, z_off, top, c, cp64), \
            lf_np(fm, fchr, z_off, bot, c, cp64)
    ftab = np.zeros(2 * keys.size + 1, np.int64)
    ftab[2 * keys + 1] = top
    ftab[2 * keys + 2] = bot
    # the states: patterns read off the table, T runs and random ones;
    # seeds are text-order patterns (the search runs right to left)
    srng = np.random.default_rng(seed + 1)
    sweep_rr = _large_patterns(srng, fm, fchr, z_off, batch, 128,
                               occ_cp64=cp64)
    substring_rr = _large_patterns(srng, fm, fchr, z_off, 2 * batch, 65,
                                   occ_cp64=cp64)
    S, slen = 8 * batch, 22
    seeds = np.ascontiguousarray(_large_patterns(
        srng, fm, fchr, z_off, S, slen, tails=False, occ_cp64=cp64)[:, ::-1])
    valid = srng.random(S) < 0.95
    # SA rows: most from the top quarter of the row space (past 2^31, or
    # in the int64 mode past 2^32, at the default size), the rest
    # anywhere, and the ends
    hi = srng.integers(rows - rows // 4, rows, S - S // 4 - 8)
    anyr = srng.integers(0, rows, S // 4)
    ends = np.array([0, n, z_off, max(z_off - 1, 0), min(z_off + 1, n),
                     rows - 128, rows - 2,
                     (1 << (32 if int64 else 31)) % rows], np.int64)
    resolve_rows = srng.permutation(np.concatenate([hi, anyr, ends]))
    tdt = np.int64 if int64 else np.uint32
    return LargeFmCase(
        n=n, z_off=z_off, fm_blocks=fm, fchr=fchr.astype(tdt),
        ftab=ftab.astype(tdt), ftab_chars=K, mark_rows=mark_rows,
        offs=offs, sweep_rr=sweep_rr, substring_rr=substring_rr,
        seeds=seeds, seed_valid=valid, seed_len=slen,
        resolve_rows=resolve_rows.astype(np.int64), occ_cp64=cp64)


# ---------------------------------------------------------------------------
# the window gather (K7)
# ---------------------------------------------------------------------------

class WindowCase(NamedTuple):
    """Word tables and windows of gather_windows / gather_windows_aligned:
    ref_words and refn_words int32 (uint32 bits), starts, lo and hi int32
    or int64 (the large mode's positions)."""
    name: str
    ref_words: np.ndarray
    refn_words: np.ndarray
    starts: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    width: int


WINDOW_WORDS = 200          # reference words a table (3,200 bp)
# widths: 16, 32 and 48 are whole multiples of the unaligned kernel's
# 16-code chunk, the others cut a chunk across rows (below 16 several)
WINDOW_WIDTHS = (1, 15, 17, 33, 189, 224, 533, 16, 32, 48)
WINDOW_KINDS = ("edges", "negative", "extremes", "large", "ragged")
WINDOW_BATCH = 23           # windows a case, a unit of scale
# the N runs of the tables' N mask, [start, end) in bases: runs that cross
# a reference word (16 bases) and an N word (32 bases), a whole N word and
# a run at the table's end
WINDOW_N_RUNS = ((28, 40), (250, 251), (500, 533), (1024, 1056),
                 (1100, 1230), (3190, 3200))


def _window_tables(rng):
    words = rng.integers(0, 1 << 32, WINDOW_WORDS, dtype=np.uint64)
    n = 16 * WINDOW_WORDS
    nmask = np.zeros(n + 32, bool)
    for a, b in WINDOW_N_RUNS:
        nmask[a:b] = True
    nmask[rng.integers(0, n, 40)] = True
    # the N table one word longer than the bases need: the two tables clip
    # at their own lengths
    nwords = np.packbits(nmask.reshape(-1, 32), axis=1,
                         bitorder="little").view("<u4").reshape(-1)
    return (words.astype(np.uint32).view(np.int32),
            nwords.astype(np.uint32).view(np.int32))


def window_cases(seed: int = 0, scale: int = 1) -> List[WindowCase]:
    """Every WINDOW_KINDS kind at every WINDOW_WIDTHS width:
    - edges: windows past either end of the table, in references of
      random extents [lo, hi) inside it (lo == hi among them);
    - negative: starts below 0, at and below -2^24 (the unaligned form's
      clamp) and near -2^31;
    - extremes: int32 starts near 2^31 - 1, whose positions wrap;
    - large: int64 starts past 2^31 (the large mode), references there,
      the words clipped to the table's last;
    - ragged: 1, 3, 5, ... windows (times scale; the width's index 2 k +
      1) as edges draws them, so that the aligned form's B x Wa / 16
      16-code groups end inside a warp (at width 1, Wa = 32)."""
    rng = np.random.default_rng(seed)
    out = []
    words, nwords = _window_tables(rng)
    n = 16 * WINDOW_WORDS
    B = WINDOW_BATCH * scale
    for kind in WINDOW_KINDS:
        for k, W in enumerate(WINDOW_WIDTHS):
            if kind == "ragged":
                Bk = (2 * k + 1) * scale
                starts = rng.integers(-W - 64, n + 64, Bk)
                lo = rng.integers(0, n // 2, Bk)
                hi = np.minimum(lo + rng.integers(0, n, Bk), n)
                dtype = np.int32
            elif kind == "edges":
                starts = rng.integers(-W - 64, n + 64, B)
                starts[:4] = [-W - 5, -3, n - W // 2 - 1, n + 10]
                lo = rng.integers(0, n, B)
                lo[:4] = [0, 0, n - 2 * W, n - 16]
                hi = np.minimum(lo + rng.integers(0, 2 * W + 200, B), n)
                hi[:4] = n
                dtype = np.int32
            elif kind == "negative":
                fixed = [-(1 << 24) - 1, -(1 << 24), -(1 << 24) + 1,
                         -(1 << 25) - 7, -(1 << 31) + 5, -1, -16, -31,
                         -32, -33]
                starts = np.concatenate([fixed, rng.integers(
                    -(3 << 24), 0, B - len(fixed))])
                lo = np.zeros(B, np.int64)
                hi = np.full(B, n)
                dtype = np.int32
            elif kind == "extremes":
                top = (1 << 31) - 1
                starts = top - rng.integers(0, 2 * W + 40, B)
                lo = np.full(B, top - 3 * W - 64)
                hi = np.full(B, top)
                dtype = np.int32
            else:
                base = (1 << 31) + (1 << 20)
                starts = base + rng.integers(-W - 64, 4096, B)
                lo = base + rng.integers(-2 * W, 2048, B)
                hi = lo + rng.integers(0, 4096, B)
                starts[:4] = [(1 << 31) - 3, 1 << 31, (1 << 32) + 17,
                              -5]
                dtype = np.int64
            out.append(WindowCase(
                f"{kind}_W{W}@x{scale}", words, nwords,
                np.asarray(starts, np.int64).astype(dtype),
                np.asarray(lo, np.int64).astype(dtype),
                np.asarray(hi, np.int64).astype(dtype), W))
    return out


# ---------------------------------------------------------------------------
# the paired-end device pairing (K10 PE)
# ---------------------------------------------------------------------------

class PairingCase(NamedTuple):
    """The arguments of ops/fused.py _pe_pairing after `pairing` (B, Bp,
    T and the slot and read arrays), as numpy arrays."""
    name: str
    pairing: tuple
    B: int
    Bp: int
    T: int
    arrays: tuple     # aok, score, slot_or, rid, lo_p, hi_p, occ, exact,
                      # half, mmug, cpos, ee_read, seed_nz, inst_read,
                      # filtered


# (policy, minins, maxins, olap_ok, contain_ok, dove_ok, limit): every
# policy, limit None and an int, each of the three overlap flags off
PAIRINGS = (("fr", 0, 500, True, True, False, 8),
            ("ff", 100, 400, False, True, True, None),
            ("rr", 0, 300, True, False, False, 2),
            ("rf", 50, 600, True, True, True, 1))
# slot counts: the kernel's two-pairs-a-warp form (T <= 16) and its
# one-pair-a-warp form (T <= 32), each with dead slots and full
PAIRING_TS = (1, 8, 15, 16, 17, 32)
PAIRING_BATCH = 29          # pairs a case at T >= 16, a unit of scale


def _pairing_arrays(rng, Bp, T, base, ext):
    """Slots of 2 Bp reads (mate 1 first): about two thirds valid, scores
    from a small set (ties), two references, mate-2 extents at inserts
    around the policies' ranges from a mate-1 slot, repeated (orient, end)
    keys (the dedupe), and read flags that raise the zero-seed-round
    suppression, the -D fast flags and need_mm1."""
    B = 2 * Bp
    aok = rng.random((B, T)) < 0.7
    score = np.where(aok, -6 * rng.integers(0, 4, (B, T))
                     - rng.integers(0, 2, (B, T)), -(1 << 29))
    orient = rng.integers(0, 2, (B, T))
    rid = rng.integers(0, 2, (B, T))
    ln = rng.integers(40, 151, (B, T))
    lo = base + rng.integers(0, 3000, (B, T))
    # mate 2: an insert from a mate-1 slot of the same pair
    src = rng.integers(0, T, (Bp, T))
    lo1 = np.take_along_axis(lo[:Bp], src, axis=1)
    ins = rng.integers(-80, 800, (Bp, T))
    lo[Bp:] = lo1 + ins - ln[Bp:]
    hi = lo + ln - 1
    # repeated (orient, end) keys within a read
    dup = rng.random((B, T)) < 0.2
    other = rng.integers(0, T, (B, T))
    hi = np.where(dup, np.take_along_axis(hi, other, axis=1), hi)
    orient = np.where(dup, np.take_along_axis(orient, other, axis=1),
                      orient)
    lo = np.where(aok, lo, 0)
    hi = np.where(aok, hi, 0)
    occ = aok & (rng.random((B, T)) < 0.9)
    exact = rng.random((B, T)) < 0.25
    half = rng.random((B, T)) < 0.35
    mmug = rng.integers(0, 4, (B, T))
    cpos = np.where(aok, rng.integers(0, 1 << 20, (B, T)), -1)
    ee_read = rng.choice([0, 0, 1, 3, 5], B)
    seed_nz = rng.choice([0, 1, 1, 4], B)
    inst_read = rng.choice([0, 1, 2, 6], B)
    filtered = rng.random(B) < 0.08
    i32 = np.int32
    return (aok.astype(i32), score.astype(i32), orient.astype(i32),
            rid.astype(i32), lo.astype(ext), hi.astype(ext), occ, exact,
            half, mmug.astype(i32), cpos.astype(i32), ee_read.astype(i32),
            seed_nz.astype(i32), inst_read.astype(i32), filtered)


def pairing_cases(seed: int = 0, scale: int = 1,
                  large: bool = False) -> List[PairingCase]:
    """Every PAIRINGS pairing at every PAIRING_TS slot count, int32
    extents, or with `large` int64 extents past 2^31 (written wrapped to
    int32). A case of T < 16 slots has 16 // T times the pairs, so that it
    holds concordant combinations too; the pair count is odd, so one
    pair's group of lanes has no partner in its warp."""
    rng = np.random.default_rng(seed)
    out = []
    base, ext = ((1 << 31) + (1 << 24), np.int64) if large \
        else (1 << 20, np.int32)
    for pairing in PAIRINGS:
        for T in PAIRING_TS:
            Bp = PAIRING_BATCH * scale * max(16 // T, 1) | 1
            out.append(PairingCase(
                f"{pairing[0]}_lim{pairing[6]}_T{T}"
                f"{'_large' if large else ''}@x{scale}", pairing,
                2 * Bp, Bp, T, _pairing_arrays(rng, Bp, T, base, ext)))
    return out
