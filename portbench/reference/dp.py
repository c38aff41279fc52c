"""A plain banded DP: the best score a read can have around a known
origin on the genome, under a configuration's scoring (affine gaps,
quality-aware mismatches, N penalty, gap barrier, and in local mode the
match bonus), and the alignment that reaches it.

Cell (i, k) pairs read base i with genome position origin + i + k - pad.
End to end every read base is aligned; the alignment may start and end
at any column of the band. In local mode (the scoring's `local`) a cell
never scores below 0, an alignment starts and ends at any cell of the
band, and the read bases before and after it are soft-clipped. A band
of +-pad diagonals around the origin gives a lower bound on the best
alignment over the whole genome."""

import numpy as np

NEG = -(1 << 30)
DIAG, VERT, HORIZ = 0, 1, 2     # H's source: match/mismatch, 'I', 'D'


def banded(reads, quals, lens, origin, genome, sc, pad, flat=False,
           trace=False):
    """reads, quals: (n, Lmax) codes (0..4) and phred quals of each read
    as it lies on the genome's forward strand; lens (n,); origin (n,)
    the genome position of each read's first base; sc a Scoring. flat:
    every mismatch costs the largest penalty whatever its quality (the
    control). Returns the best score of each read (NEG: none) and, with
    trace, each read's (genome position of its first aligned base, CIGAR
    string, soft clips included)."""
    n, Lmax = reads.shape
    Wb = 2 * pad + 1
    G = genome.size
    lens = np.asarray(lens, np.int64)
    kk = np.arange(Wb)
    col0 = np.asarray(origin, np.int64)[:, None] - pad + kk[None, :]
    pen = np.full(quals.shape, sc.mx, np.int64) if flat else \
        sc.mm_pen(quals)
    rgo, rge = sc.rdg_open + sc.rdg_ext, sc.rdg_ext      # 'D', in a row
    fgo, fge = sc.rfg_open + sc.rfg_ext, sc.rfg_ext      # 'I', down a column
    h = np.zeros((n, Wb), np.int64)
    e = np.full((n, Wb), NEG, np.int64)
    local = sc.local
    best = np.full(n, NEG, np.int64)
    best_i = lens - 1
    best_k = np.zeros(n, np.int64)
    negcol = np.full((n, 1), NEG, np.int64)
    ext_e = kk[None, :] * rge
    if trace:
        src = np.zeros((Lmax, n, Wb), np.int8)     # h_nof's source
        from_f = np.zeros((Lmax, n, Wb), bool)      # h took 'D'
        e_ext = np.zeros((Lmax, n, Wb), bool)
        f_ext = np.zeros((Lmax, n, Wb), bool)
        zero = np.zeros((Lmax, n, Wb), bool)        # local: starts after it
    for i in range(Lmax):
        pos = col0 + i
        inb = (pos >= 0) & (pos < G)
        refc = np.where(inb, genome[np.clip(pos, 0, G - 1)], 5)
        rc = reads[:, i:i + 1].astype(np.int64)
        is_n = (rc == 4) | (refc == 4)
        eq = (refc == rc) & ~is_n
        sub = np.where(eq, sc.ma, np.where(is_n, -sc.np, -pen[:, i:i + 1]))
        sub = np.where(refc >= 5, NEG, sub)
        # 'I': from (i-1, k+1)
        hs = np.concatenate([h[:, 1:], negcol], axis=1)
        es = np.concatenate([e[:, 1:], negcol], axis=1)
        e_open, e_more = hs - fgo, es - fge
        e_cur = np.maximum(e_open, e_more)
        bar = (i < sc.gbar) | (i >= lens - sc.gbar)
        e_cur = np.where(bar[:, None], NEG, e_cur)
        hd = h + sub
        h_nof = np.maximum(hd, e_cur)
        # 'D': from (i, m < k), max over m of h_nof[m] - open - ext * (k - m)
        arg = h_nof + ext_e
        pre = np.maximum.accumulate(arg, axis=1)
        f_cur = np.concatenate([negcol, pre[:, :-1]], axis=1) - ext_e \
            - sc.rdg_open
        f_cur = np.where(bar[:, None], NEG, f_cur)
        h_cur = np.maximum(np.maximum(h_nof, f_cur), NEG)
        if local:
            h_cur = np.maximum(h_cur, 0)
        if trace:
            zero[i] = h_cur <= 0
            src[i] = np.where(e_cur > hd, VERT, DIAG)
            from_f[i] = f_cur > h_nof
            e_ext[i] = e_more > e_open
            f_prev = np.concatenate([negcol, f_cur[:, :-1]], axis=1)
            hn_prev = np.concatenate([negcol, h_nof[:, :-1]], axis=1)
            f_ext[i] = f_prev - rge > hn_prev - rgo
        active = (lens > i)[:, None]
        h = np.where(active, h_cur, h)
        e = np.where(active, e_cur, e)
        if local:
            rb = np.where(active[:, 0], h_cur.max(axis=1), NEG)
            up = rb > best
            best = np.where(up, rb, best)
            best_i = np.where(up, i, best_i)
            best_k = np.where(up, h_cur.argmax(axis=1), best_k)
            continue
        last = lens - 1 == i
        if last.any():
            rb = h_cur.max(axis=1)
            best = np.where(last, rb, best)
            best_k = np.where(last, h_cur.argmax(axis=1), best_k)
    best = np.where(best <= (0 if local else NEG // 2), NEG, best)
    if not trace:
        return best, None
    alns = []
    for r in range(n):
        if best[r] == NEG:
            alns.append(None)
            continue
        alns.append(_walk(src[:, r], from_f[:, r], e_ext[:, r], f_ext[:, r],
                          zero[:, r] if local else None, int(best_i[r]),
                          int(best_k[r]), int(origin[r]) - pad,
                          int(lens[r])))
    return best, alns


def _walk(src, from_f, e_ext, f_ext, zero, i, k, base, length):
    """The CIGAR from cell (i, k) back to row -1 or, in local mode (zero:
    the cells that score 0), to the first cell after one that scores 0,
    and the genome position of the first aligned base (base + i + k
    there). Read bases outside the alignment are soft-clipped."""
    ops = ["S"] * (length - 1 - i)
    state = HORIZ if from_f[i, k] else src[i, k]
    while i >= 0:
        if state == DIAG:
            ops.append("M")
            start = base + i + k
            i -= 1
            if i >= 0 and zero is not None and zero[i, k]:
                ops += ["S"] * (i + 1)
                break
            if i >= 0:
                state = HORIZ if from_f[i, k] else src[i, k]
        elif state == VERT:
            ops.append("I")
            more = e_ext[i, k]
            i, k = i - 1, k + 1
            state = VERT if more else (HORIZ if from_f[i, k] else src[i, k])
        else:
            ops.append("D")
            more = f_ext[i, k]
            k -= 1
            state = HORIZ if more else src[i, k]
    ops.reverse()
    cigar, run, last = [], 0, None
    for op in ops:
        if op != last and last is not None:
            cigar.append(f"{run}{last}")
            run = 0
        run += 1
        last = op
    cigar.append(f"{run}{last}")
    return start, "".join(cigar)
