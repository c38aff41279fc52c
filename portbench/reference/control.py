"""The control of the comparison: the reference put in the program's
place with one guarantee of the configuration broken. The configuration
states quality-aware mismatch penalties (`mp` MX,MN: MN + floor((MX - MN)
* min(Q, 40) / 40)); the control scores every mismatch at MX whatever its
quality, as a DP that drops the quality lookup would, aligns each read in
the band around its origin, and prints the records the program would
print for that alignment (in local mode a local alignment, its soft clips
included). `check.Judge` must find it not correct."""

import numpy as np

from portbench.reference.check import forward, reads_of
from portbench.reference.dp import banded
from portbench.reference.sam import (LETTERS, Record, cigar_ops, extent,
                                     recompute, revcomp)


def _aligned_line(name, flag, read, pos, cigar, score, mapq, genome, sc,
                  mate=b"*\t0\t0", extra=""):
    """The record of an alignment at `pos` of the joined sequence."""
    codes, quals = read[0], read[1]
    seq, qual = (revcomp(codes), quals[::-1]) if flag & 16 else \
        (codes, quals)
    ref, at = genome.locate(pos)
    head = (f"{name}\t{flag}\t{ref}\t{at + 1}\t{mapq}\t{cigar}\t"
            ).encode() + mate
    line = head + b"\t" + LETTERS[np.asarray(seq, np.int64)].tobytes() + \
        b"\t" + (np.asarray(qual, np.uint8) + 33).tobytes()
    f = recompute(Record(line), codes, quals, genome, sc)
    tags = (f"AS:i:{score}\tXN:i:0\tXM:i:{f['XM']}\tXO:i:{f['XO']}\t"
            f"XG:i:{f['XG']}\tNM:i:{f['NM']}\tMD:Z:{f['MD']}{extra}")
    return line + b"\t" + tags.encode()


def _unaligned_line(name, flag, read, extra):
    return (f"{name}\t{flag | 4}\t*\t0\t0\t*\t*\t0\t0\t").encode() + \
        LETTERS[np.asarray(read[0], np.int64)].tobytes() + b"\t" + \
        (np.asarray(read[1], np.uint8) + 33).tobytes() + extra.encode()


def control_groups(units, names, genome, judge):
    """The control's SAM groups for units (reads or pairs)."""
    sc, pad = judge.sc, judge.pad
    reads = [r for u in units for r in reads_of(u)]
    best, alns = banded(*forward(reads), genome.codes, sc, pad, flat=True,
                        trace=True)
    out, j = [], 0
    for unit, name in zip(units, names):
        rs = reads_of(unit)
        al = [(int(best[j + m]), alns[j + m], r) for m, r in enumerate(rs)]
        j += len(rs)
        if any(a is None for _s, a, _r in al):
            out.append([(0x41 if judge.paired else 4, _unaligned_line(
                name, 0x4D if judge.paired else 0, rs[0], "\tYT:Z:UU"))])
            continue
        if not judge.paired:
            s, (pos, cig), r = al[0]
            L = r[0].size
            mq = sc.mapq(s, None, sc.perfect(L), sc.min_score(L))
            out.append([(16 * r[3], _aligned_line(
                name, 16 * r[3], r, pos, cig, s, mq, genome, sc,
                extra="\tYT:Z:UU"))])
            continue
        (s1, (p1, c1), m1), (s2, (p2, c2), m2) = al
        (b1, e1), (b2, e2) = (extent(p, cigar_ops(c.encode()))
                              for p, c in ((p1, c1), (p2, c2)))
        frag = max(e1, e2) - min(b1, b2)
        L1, L2 = m1[0].size, m2[0].size
        mq = sc.mapq(s1 + s2, None, sc.perfect(L1) + sc.perfect(L2),
                     sc.min_score(L1) + sc.min_score(L2))
        first1 = b1 < b2 or (b1 == b2 and not m1[3])
        grp = []
        for me, other, mate, first, ys, (s, (p, c), r) in (
                (0x40, m2, p2, first1, s2, al[0]),
                (0x80, m1, p1, not first1, s1, al[1])):
            flag = 0x1 | 0x2 | me | 16 * r[3] | 0x20 * other[3]
            grp.append((flag, _aligned_line(
                name, flag, r, p, c, s, mq, genome, sc,
                mate=f"=\t{genome.locate(mate)[1] + 1}\t"
                f"{frag if first else -frag}".encode(),
                extra=f"\tYS:i:{ys}\tYT:Z:CP")))
        out.append(grp)
    return out
