"""Host-side traceback of banded DP direction matrices → CIGAR + edits.

The reference re-derives alignments with a branch-tree backtracer over
checkpointed DP state (BtBranchTracer, aligner_bt.h:544) because it discards
the matrix to save cache. We keep the full per-cell direction bits (cheap at
short-read scale) and walk them directly. Runs on host over the small set of
surviving candidates; a device backtrace kernel is a later optimization.

Geometry matches ops/sw.py column-space rect DP: cell (row i, col j)
refers to ref window index j directly.
"""

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from bowtie2_tpu_torch.ops.sw import H_DIAG, H_E, H_F, H_START, OP_NONE, SWParams

_REF_CHARS = "ACGTN?"


def cigar_md_from_packed(opcol: np.ndarray, read_start: int, read_end: int,
                         read_len: int, read: np.ndarray = None,
                         xeq: bool = False
                         ) -> Tuple[List[Tuple[str, int]], str]:
    """Decode one device-backtrace op column → (CIGAR ops, MD:Z string).

    opcol: (S,) uint8 packed bytes in walk order (read end → read start);
    byte layout matches ops/sw.py backtrace: op(2) | refchar(3) | ismatch(1).
    read_start/read_end delimit the aligned read span (soft clips outside).
    read (optional, oriented codes): enables leftmost normalization of
    equal-score gap placements in repeats (the reference's backtracer
    reports the leftmost variant).
    """
    ops = opcol & 3
    keep = ops != OP_NONE
    opsk = ops[keep][::-1].astype(np.int64)          # forward (5'→3') order
    refc = ((opcol[keep] >> 2) & 7)[::-1].astype(np.int64)
    ismatch = (((opcol[keep] >> 5) & 1) == 1)[::-1]

    if read is not None and (opsk == 1).any() | (opsk == 2).any():
        opsk, refc, ismatch = _left_align_gaps(opsk, refc, ismatch,
                                               read, read_start)

    cigar: List[Tuple[str, int]] = []
    if read_start > 0:
        cigar.append(("S", int(read_start)))
    if opsk.size:
        # --xeq splits M runs into '='/'X' by the match bit
        key = opsk * 4 + np.where((opsk == 0) & xeq, ismatch, 2)
        change = np.nonzero(np.diff(key))[0]
        bounds = np.concatenate([[0], change + 1, [opsk.size]])
        for s, e in zip(bounds[:-1], bounds[1:]):
            op = "MID"[int(opsk[s])]
            if xeq and op == "M":
                op = "=" if ismatch[s] else "X"
            cigar.append((op, int(e - s)))
    if read_end < read_len:
        cigar.append(("S", int(read_len - read_end)))

    # MD:Z — match run lengths, mismatch ref chars, ^-prefixed deletion runs;
    # insertions are invisible to MD. (reference Edit::printMD, edit.cpp)
    is_m = opsk == 0
    match_cum = np.concatenate([[0], np.cumsum(is_m & ismatch)])
    events = np.nonzero((is_m & ~ismatch) | (opsk == 2))[0]
    parts: List[str] = []
    prev = 0                      # index after the previous event
    in_del = False
    for e in events.tolist():
        nmatch = int(match_cum[e] - match_cum[prev])
        if opsk[e] == 2:          # deletion char
            if in_del and nmatch == 0:
                parts[-1] += _REF_CHARS[refc[e]]
            else:
                parts.append(str(nmatch))
                parts.append("^" + _REF_CHARS[refc[e]])
            in_del = True
        else:                     # mismatch
            parts.append(str(nmatch))
            parts.append(_REF_CHARS[refc[e]])
            in_del = False
        prev = e + 1
    parts.append(str(int(match_cum[-1] - match_cum[prev])))
    return cigar, "".join(parts)


def _left_align_gaps(opsk, refc, ismatch, read, read_start):
    """Shift each gap run left across preceding matching Ms while the
    score is unchanged (repeat runs): the leftmost equal-score placement,
    matching the reference backtracer's reported variant."""
    opsk = opsk.copy()
    refc = refc.copy()
    ismatch = ismatch.copy()
    n = opsk.size

    def read_pos_at(idx):
        # read position consumed by op idx (M/I consume read chars)
        return read_start + int(np.sum(opsk[:idx] != 2))

    t = 0
    while t < n:
        if opsk[t] not in (1, 2):
            t += 1
            continue
        e = t
        while e + 1 < n and opsk[e + 1] == opsk[t]:
            e += 1
        kind = opsk[t]
        while t > 0 and opsk[t - 1] == 0 and ismatch[t - 1]:
            if kind == 2:        # deletion run
                run = refc[t:e + 1].copy()
                if refc[t - 1] != run[-1]:
                    break
                opsk[t - 1:e] = 2
                opsk[e] = 0
                refc[t - 1] = refc[t - 1]          # prev M char leads run
                refc[t:e] = run[:-1]
                refc[e] = run[-1]
                ismatch[e] = True
            else:                # insertion run
                m_rpos = read_pos_at(t - 1)
                after = m_rpos + (e - t + 1)
                if after >= read.size or                         int(read[after]) != int(refc[t - 1]):
                    break
                mchar = refc[t - 1]
                opsk[t - 1:e] = 1
                opsk[e] = 0
                refc[t - 1:e] = 0
                refc[e] = mchar
                ismatch[e] = True
            t -= 1
            e -= 1
        t = e + 2
    return opsk, refc, ismatch


@dataclass
class Traceback:
    ops: List[Tuple[str, int]]        # CIGAR ops, read 5'→3' ('M','I','D','S')
    ref_start_win: int                # window index of first ref char consumed
    ref_len: int                      # ref chars consumed (M+D)
    n_mm: int                         # mismatches (XM)
    n_gap_opens: int                  # XO
    n_gap_chars: int                  # gap extends total incl first (XG)
    n_refn: int                       # alignment positions over ref N (XN)
    n_readn_mm: int                   # positions where read N counted
    md_parts: List[str] = field(default_factory=list)  # MD:Z value pieces
    read_start: int = 0               # first read pos aligned (local: soft clip)
    read_end: int = 0                 # one past last read pos aligned
    score_check: int = 0              # recomputed score (must equal kernel's)


def _mm_pen(q: int, p: SWParams) -> int:
    return p.mm_pen_min + (min(q, 40) * (p.mm_pen_max - p.mm_pen_min)) // 40


def backtrace_one(dirs: np.ndarray, row: int, lane: int, read: np.ndarray,
                  quals: np.ndarray, refwin: np.ndarray, params: SWParams) -> Traceback:
    """Walk one problem's direction matrix from its best cell.

    dirs: (Lmax, W) uint8; read/quals: (Lmax,); refwin: (W,) codes 0..5.
    """
    i, j = int(row), int(lane)
    read_end = i + 1
    ops_rev: List[str] = []      # per-base ops, emitted read-end-first
    ref_idx_rev: List[int] = []  # window index per M/D op (−1 for I)
    score = 0
    n_mm = n_go = n_gc = n_refn = n_readn = 0
    state = "H"
    while i >= 0:
        d = int(dirs[i, j])
        src = d & 3
        if state == "H":
            if src == H_START:
                break
            if src == H_DIAG:
                rc, fc = int(read[i]), int(refwin[j])
                ops_rev.append("M")
                ref_idx_rev.append(j)
                if rc >= 4 or fc == 4:
                    score -= params.n_pen
                    n_mm += 1
                    if fc == 4:
                        n_refn += 1
                    if rc >= 4:
                        n_readn += 1
                elif rc == fc:
                    score += params.match_bonus
                else:
                    score -= _mm_pen(int(quals[i]), params)
                    n_mm += 1
                i -= 1
                j -= 1
            elif src == H_E:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            # read char i inserted (gap in reference): RFG penalties
            ops_rev.append("I")
            ref_idx_rev.append(-1)
            ext = bool(d & 4)
            score -= params.ref_gap_extend
            n_gc += 1
            if not ext:
                score -= params.ref_gap_open
                n_go += 1
            i -= 1
            state = "E" if ext else "H"
        else:  # state == "F": ref char consumed, no read char (gap in read)
            ops_rev.append("D")
            ref_idx_rev.append(j)
            ext = bool(d & 8)
            score -= params.read_gap_extend
            n_gc += 1
            if not ext:
                score -= params.read_gap_open
                n_go += 1
            j -= 1
            state = "F" if ext else "H"
    read_start = i + 1

    ops = ops_rev[::-1]
    ref_idx = ref_idx_rev[::-1]
    ref_consumed = [x for x in ref_idx if x >= 0]
    ref_start_win = min(ref_consumed) if ref_consumed else 0

    # run-length CIGAR (+ soft clips in local mode)
    cigar: List[Tuple[str, int]] = []
    if read_start > 0:
        cigar.append(("S", read_start))
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + 1)
        else:
            cigar.append((op, 1))
    # trailing soft clip (local mode) is appended by the caller, which knows
    # the true (unpadded) read length

    # MD:Z — matches run-length, mismatches as ref char, deletions as ^chars
    md: List[str] = []
    run = 0
    rpos = read_start
    for op, widx in zip(ops, ref_idx):
        if op == "M":
            fc = int(refwin[widx])
            rc = int(read[rpos])
            if rc == fc and fc < 4:
                run += 1
            else:
                md.append(str(run))
                md.append("ACGTN"[min(fc, 4)])
                run = 0
            rpos += 1
        elif op == "D":
            md.append(str(run))
            run = 0
            md.append("^" + "ACGTN"[min(int(refwin[widx]), 4)])
            # consecutive deleted chars merge below
        else:  # I
            rpos += 1
    md.append(str(run))
    # merge consecutive deletions ("^A", "0", "^C" → "^AC")
    merged: List[str] = []
    k = 0
    while k < len(md):
        part = md[k]
        if part.startswith("^"):
            dele = part[1:]
            k += 1
            while k + 1 < len(md) and md[k] == "0" and md[k + 1].startswith("^"):
                dele += md[k + 1][1:]
                k += 2
            merged.append("^" + dele)
        else:
            merged.append(part)
            k += 1
    return Traceback(
        ops=cigar, ref_start_win=ref_start_win, ref_len=len(ref_consumed),
        n_mm=n_mm, n_gap_opens=n_go, n_gap_chars=n_gc, n_refn=n_refn,
        n_readn_mm=n_readn, md_parts=merged, read_start=read_start,
        read_end=read_end, score_check=score,
    )
