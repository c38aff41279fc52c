"""What a SAM record of an end-to-end Bowtie 2 alignment must say, worked
out again from the genome, the read and the record's own position,
strand and CIGAR: the score (AS), the edits (NM, XM, XO, XG), the MD
string, the sequence and qualities as printed, and the MAPQ."""

import re

import numpy as np

from portbench.reference.score import mapq_v2

LETTERS = np.frombuffer(b"ACGTN", np.uint8)
_CIGAR = re.compile(rb"(\d+)([MIDNSHP=X])")


def revcomp(codes):
    c = np.asarray(codes)
    return np.where(c < 4, 3 - c, c)[::-1]


class Record:
    """One SAM line, split."""

    def __init__(self, line):
        f = line.rstrip(b"\n").split(b"\t")
        if len(f) < 11:
            raise ValueError(f"{len(f)} fields")
        self.qname = f[0].decode()
        self.flag = int(f[1])
        self.rname = f[2].decode()
        self.pos = int(f[3])
        self.mapq = int(f[4])
        self.cigar = f[5]
        self.rnext = f[6].decode()
        self.pnext = int(f[7])
        self.tlen = int(f[8])
        self.seq = f[9]
        self.qual = f[10]
        self.tags = {}
        for t in f[11:]:
            tag, typ, val = t.decode().split(":", 2)
            self.tags[tag] = int(val) if typ == "i" else val

    @property
    def aligned(self):
        return not self.flag & 4

    def ops(self):
        return [(int(n), op.decode()) for n, op in _CIGAR.findall(self.cigar)]

    def span(self):
        """(first, end) genome positions, 0-based, end exclusive."""
        ref = sum(n for n, op in self.ops() if op in "MD=XN")
        return self.pos - 1, self.pos - 1 + ref


def recompute(rec, codes, quals, genome, sc):
    """The fields an aligned record must carry, from the genome (gen/
    genome.py Genome) and the read (codes and quals as generated): a dict
    of AS, NM, XM, XO, XG, MD. Raises ValueError on an RNAME that is not
    one of the genome's references, or a CIGAR that does not fit the read
    or its reference."""
    r = np.asarray(codes, np.int64)
    q = np.asarray(quals, np.int64)
    if rec.flag & 16:
        r, q = revcomp(r), q[::-1]
    ops = rec.ops()
    if b"".join(b"%d%s" % (n, op.encode()) for n, op in ops) != rec.cigar:
        raise ValueError(f"CIGAR {rec.cigar!r} does not parse")
    if any(op not in "MID" for _n, op in ops):
        raise ValueError(f"CIGAR {rec.cigar!r}: end-to-end takes M, I, D")
    qlen = sum(n for n, op in ops if op in "MI")
    if qlen != r.size:
        raise ValueError(f"CIGAR {rec.cigar!r} spans {qlen} of "
                         f"{r.size} read bases")
    try:
        lo, hi = genome.bounds(rec.rname)
    except KeyError:
        raise ValueError(f"RNAME {rec.rname}") from None
    first, end = rec.span()
    first, end = first + lo, end + lo
    if first < lo or end > hi:
        raise ValueError(f"alignment {rec.pos}..{end - lo} leaves "
                         f"{rec.rname}")
    genome = genome.codes
    pen = sc.mm_pen(q)
    score = nm = xm = xo = xg = 0
    md, run = [], 0
    i, g = 0, first
    for n, op in ops:
        if op == "M":
            rr, gg = r[i:i + n], genome[g:g + n].astype(np.int64)
            is_n = (rr == 4) | (gg == 4)
            mis = (rr != gg) | is_n
            score += int(np.where(is_n, -sc.np,
                                  np.where(mis, -pen[i:i + n], sc.ma)).sum())
            nm += int(mis.sum())
            xm += int(mis.sum())
            last = 0
            for j in np.flatnonzero(mis):
                md.append(f"{run + int(j) - last}{chr(LETTERS[gg[j]])}")
                run, last = 0, int(j) + 1
            run += n - last
            i, g = i + n, g + n
        elif op == "I":
            score -= sc.rfg_open + sc.rfg_ext * n
            nm, xo, xg = nm + n, xo + 1, xg + n
            i += n
        else:
            score -= sc.rdg_open + sc.rdg_ext * n
            nm, xo, xg = nm + n, xo + 1, xg + n
            md.append(f"{run}")
            md.append("^" + LETTERS[genome[g:g + n]].tobytes().decode())
            run = 0
            g += n
    md.append(f"{run}")
    return {"AS": score, "NM": nm, "XM": xm, "XO": xo, "XG": xg,
            "MD": "".join(md)}


def read_errors(rec, name, codes, quals, genome, sc):
    """What is wrong with one record of one read, as a list of short
    strings (empty: nothing), leaving out MAPQ and the pair's fields."""
    err = []
    if rec.qname != name:
        return [f"QNAME {rec.qname} for {name}"]
    r = np.asarray(codes, np.int64)
    q = np.asarray(quals, np.uint8)
    if rec.aligned and rec.flag & 16:
        r, q = revcomp(r), q[::-1]
    if rec.seq != LETTERS[r].tobytes():
        err.append("SEQ")
    if rec.qual != (q + 33).tobytes():
        err.append("QUAL")
    if not rec.aligned:
        if "AS" in rec.tags:
            err.append("AS on an unaligned record")
        return err
    try:
        want = recompute(rec, codes, quals, genome, sc)
    except ValueError as e:
        return err + [str(e)]
    for tag, v in want.items():
        if rec.tags.get(tag) != v:
            err.append(f"{tag} {rec.tags.get(tag)} != {v}")
    if want["AS"] < sc.min_score(r.size):
        err.append(f"AS {want['AS']} below the minimum score")
    return err


def se_mapq_ok(rec, length, sc):
    """An unpaired record's MAPQ from its AS and XS."""
    return rec.mapq == mapq_v2(rec.tags["AS"], rec.tags.get("XS"), 0,
                               sc.min_score(length))


def pair_mapq_ok(rec, mate, lengths, sc):
    """A paired record's MAPQ: Bowtie 2 takes it from the pair's summed
    score against the summed minimum, and the second-best pair's sum,
    which SAM does not print: the MAPQ must be one that some second-best
    sum (or none) gives, and the same on both mates."""
    if rec.mapq != mate.mapq:
        return False
    best = rec.tags["AS"] + mate.tags["AS"]
    minsc = sc.min_score(lengths[0]) + sc.min_score(lengths[1])
    can = {mapq_v2(best, s, 0, minsc) for s in range(minsc, best + 1)}
    can.add(mapq_v2(best, None, 0, minsc))
    return rec.mapq in can


def pair_errors(r1, r2, lengths, sc, pe):
    """What is wrong with the pair's own fields of the two primary
    records of a pair (each mate's alignment is read_errors')."""
    err = []
    for r, m in ((r1, 0x40), (r2, 0x80)):
        if r.flag & (0x1 | m) != 0x1 | m:
            err.append(f"FLAG {r.flag} lacks {0x1 | m}")
    for r, o in ((r1, r2), (r2, r1)):
        if bool(r.flag & 0x8) != (not o.aligned):
            err.append("FLAG 0x8")
        if o.aligned and bool(r.flag & 0x20) != bool(o.flag & 0x10):
            err.append("FLAG 0x20")
        if r.aligned and o.aligned:
            if r.rnext != ("=" if r.rname == o.rname else o.rname) or \
                    r.pnext != o.pos:
                err.append(f"RNEXT/PNEXT {r.rnext} {r.pnext}")
            paired = r.tags.get("YT") in ("CP", "DP")
            if r.tags.get("YS") != (o.tags["AS"] if paired else None):
                err.append(f"YS {r.tags.get('YS')} != {o.tags['AS']}")
        elif r.aligned or o.aligned:
            a = r if r.aligned else o
            if (r.rname, r.pos, r.rnext, r.pnext, r.tlen) != \
                    (a.rname, a.pos, "=", a.pos, 0):
                err.append("an unaligned mate's placement")
    if not (r1.aligned and r2.aligned):
        if r1.flag & 0x2 or r2.flag & 0x2:
            err.append("FLAG 0x2 on a pair with an unaligned mate")
        return err
    if r1.tags.get("YT") not in ("CP", "DP") or r1.rname != r2.rname:
        if r1.tlen or r2.tlen or r1.flag & 0x2 or r2.flag & 0x2 or \
                r1.tags.get("YT") == "CP":
            err.append("TLEN, FLAG 0x2 or YT:Z:CP on mates aligned "
                       "unpaired or to two references")
        return err
    (s1, e1), (s2, e2) = r1.span(), r2.span()
    frag = max(e1, e2) - min(s1, s2)
    if s1 != s2:
        first = r1 if s1 < s2 else r2
    elif (r1.flag & 0x10) != (r2.flag & 0x10):
        first = r2 if r1.flag & 0x10 else r1
    else:
        first = r1
    for r in (r1, r2):
        if r.tlen != (frag if r is first else -frag):
            err.append(f"TLEN {r.tlen}, fragment {frag}")
    conc = [r.tags.get("YT") == "CP" for r in (r1, r2)]
    if conc[0] != conc[1] or any(bool(r.flag & 0x2) != conc[0]
                                 for r in (r1, r2)):
        err.append("YT:Z:CP and FLAG 0x2 disagree")
    elif conc[0]:
        if (r1.flag & 0x10) == (r2.flag & 0x10):
            err.append("concordant mates on one strand")
        if not pe["minins"] <= frag <= pe["maxins"]:
            err.append(f"concordant fragment {frag}")
    return err
