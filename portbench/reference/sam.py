"""What a SAM record of a Bowtie 2 alignment, end to end or local, must
say, worked out again from the genome, the read and the record's own
position, strand and CIGAR: the score (AS), the edits (NM, XM, XO, XG),
the MD string, the sequence and qualities as printed, the MAPQ, and a
pair's fields. A local alignment's soft clips are the read bases at
either end that it leaves out: they score nothing, POS is its first
aligned base, and SEQ and QUAL still hold the whole read."""

import re

import numpy as np

LETTERS = np.frombuffer(b"ACGTN", np.uint8)
_CIGAR = re.compile(rb"(\d+)([MIDNSHP=X])")
_MD = re.compile(r"(\d+)|\^([A-Z]+)|([A-Z])")     # MD:Z's three kinds


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
        return cigar_ops(self.cigar)

    def span(self):
        """(first, end) genome positions of the aligned bases, 0-based,
        end exclusive."""
        ref = sum(n for n, op in self.ops() if op in "MD=XN")
        return self.pos - 1, self.pos - 1 + ref

    def extent(self):
        """span() widened by the soft clips at either end: where the read
        would lie with its clipped bases aligned too."""
        return extent(self.pos - 1, self.ops())


def cigar_ops(cigar):
    """A CIGAR string (bytes) as [(length, op)]."""
    return [(int(n), op.decode()) for n, op in _CIGAR.findall(cigar)]


def clipped(ops):
    """(bases soft-clipped before, the ops between, bases clipped after).
    Raises ValueError on an S op anywhere but at either end."""
    lead = ops[0][0] if ops and ops[0][1] == "S" else 0
    trail = ops[-1][0] if len(ops) > 1 and ops[-1][1] == "S" else 0
    core = ops[bool(lead):len(ops) - bool(trail)]
    if not core or any(op == "S" for _n, op in core):
        raise ValueError("a soft clip not at an end of the CIGAR")
    return lead, core, trail


def extent(first, ops):
    """The genome extent, 0-based and end exclusive, of an alignment whose
    first aligned base is at `first`, with its soft-clipped bases counted
    as if aligned: Bowtie 2's fragment in local mode (TLEN includes soft
    clips unless --soft-clipped-unmapped-tlen)."""
    lead, core, trail = clipped(ops)
    ref = sum(n for n, op in core if op in "MD=XN")
    return first - lead, first + ref + trail


def ref_from_md(ops, seq, md):
    """The reference codes under an alignment's M and D ops, from the
    aligned read bases (`seq`, codes, soft clips left out) and its MD:Z
    string: a read base where MD counts a match, MD's base elsewhere."""
    code = {chr(c): j for j, c in enumerate(LETTERS)}
    items = []          # per M base: None (a match) or its reference code;
    for k, d, x in _MD.findall(md):       # per deletion: its codes, a list
        items += [None] * int(k) if k else \
            [[code[c] for c in d]] if d else [code[x]]
    ref, i, j = [], 0, 0                  # read base, MD item
    for n, op in ops:
        if op == "I":
            i += n
        elif op == "D":
            if j >= len(items) or not isinstance(items[j], list) or \
                    len(items[j]) != n:
                raise ValueError(f"MD {md!r} lacks a deletion of {n}")
            ref += items[j]
            j += 1
        else:
            got = items[j:j + n]
            if len(got) != n or any(isinstance(v, list) for v in got):
                raise ValueError(f"MD {md!r} does not fit {n}M")
            ref += [int(seq[i + t]) if v is None else v
                    for t, v in enumerate(got)]
            i, j = i + n, j + n
    if j != len(items):
        raise ValueError(f"MD {md!r} is longer than the alignment")
    return np.asarray(ref, np.int64)


def recompute(rec, codes, quals, genome, sc):
    """The fields an aligned record must carry, from the genome (gen/
    genome.py Genome) and the read (codes and quals as generated): a dict
    of AS, NM, XM, XO, XG, MD. Raises ValueError on an RNAME that is not
    one of the genome's references, or a CIGAR that does not fit the read
    or its reference, or soft-clips an end-to-end alignment."""
    r = np.asarray(codes, np.int64)
    q = np.asarray(quals, np.int64)
    if rec.flag & 16:
        r, q = revcomp(r), q[::-1]
    ops = rec.ops()
    if b"".join(b"%d%s" % (n, op.encode()) for n, op in ops) != rec.cigar:
        raise ValueError(f"CIGAR {rec.cigar!r} does not parse")
    lead, core, trail = clipped(ops) if sc.local else (0, ops, 0)
    if any(op not in "MID" for _n, op in core):
        raise ValueError(f"CIGAR {rec.cigar!r}: M, I and D only"
                         f"{', and S at either end' if sc.local else ''}")
    qlen = lead + trail + sum(n for n, op in core if op in "MI")
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
    end_r = r.size - trail
    return fields(core, r[lead:end_r], q[lead:end_r],
                  genome.codes[first:end].astype(np.int64), sc)


def fields(ops, r, q, ref, sc):
    """AS, NM, XM, XO, XG and MD of an alignment: its M, I and D ops, the
    aligned read bases and their quals (r, q: codes as they lie on the
    genome's forward strand, soft clips left out) and the reference codes
    under its M and D ops (ref)."""
    pen = sc.mm_pen(q)
    score = nm = xm = xo = xg = 0
    md, run = [], 0
    i, g = 0, 0
    for n, op in ops:
        if op == "M":
            rr, gg = r[i:i + n], ref[g:g + n]
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
            md.append("^" + LETTERS[ref[g:g + n]].tobytes().decode())
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
    return rec.mapq == sc.mapq(rec.tags["AS"], rec.tags.get("XS"),
                               sc.perfect(length), sc.min_score(length))


def pair_mapq_ok(rec, mate, lengths, sc):
    """A paired record's MAPQ: Bowtie 2 takes it from the pair's summed
    score against the summed minimum, and the second-best pair's sum,
    which SAM does not print: the MAPQ must be one that some second-best
    sum (or none) gives, and the same on both mates."""
    if rec.mapq != mate.mapq:
        return False
    best = rec.tags["AS"] + mate.tags["AS"]
    minsc = sc.min_score(lengths[0]) + sc.min_score(lengths[1])
    perfect = sc.perfect(lengths[0]) + sc.perfect(lengths[1])
    can = {sc.mapq(best, s, perfect, minsc)
           for s in [None, *range(minsc, best + 1)]}
    return rec.mapq in can


def pair_errors(r1, r2, lengths, sc, pe):
    """What is wrong with the pair's own fields of the two primary
    records of a pair (each mate's alignment is read_errors'). The
    fragment runs over both mates' spans (in local mode their extents,
    soft clips included), and TLEN is positive on the mate whose span
    starts first."""
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
    try:
        (s1, e1), (s2, e2) = (r.extent() if sc.local else r.span()
                              for r in (r1, r2))
    except ValueError as e:
        return err + [str(e)]
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
