"""The comparison that decides a run's `correct`.

For a sample of the reads whose records the timed window collected,
drawn from the run's seed, the reference works out again from the genome
and the read what each record must say (reference/sam.py), and the best
end-to-end score the read can have in a band around the place it was
drawn from (reference/dp.py). Three numbers come out:

- `missing`: reads of the window's batches with no primary record of
  their own (every read, not a sample; for pairs, each mate);
- `field_err`: sampled records whose printed fields disagree with the
  reference: SEQ, QUAL, RNAME, the CIGAR's fit, AS, NM, XM, XO, XG, MD,
  MAPQ, and for pairs FLAG, RNEXT, PNEXT, TLEN, YS, concordance;
- `miss_pct`: the share of the sampled reads that can align (the band's
  best reaches the minimum score and the read's Ns pass the N ceiling)
  whose record is unaligned or scores below the band's best.

In local mode (the configuration's `local`) the records are local
alignments with soft clips, and the band's best is the best local score.
"""

import numpy as np

from portbench.reference.dp import banded
from portbench.reference.sam import (Record, pair_errors, pair_mapq_ok,
                                     read_errors, revcomp, se_mapq_ok)
from portbench.reference.score import Scoring


def reads_of(unit):
    """A unit's reads: (codes, quals, origin, strand) each."""
    return list(unit) if isinstance(unit[0], tuple) else [unit]


def primaries(group):
    """The primary records of a group of (flag, line), in mate order."""
    recs = [Record(line) for flag, line in group if not flag & 0x100]
    recs.sort(key=lambda r: 0 if r.flag & 0x40 or not r.flag & 0x80 else 1)
    return recs


def by_name(blob):
    """The records of one batch's SAM text, grouped by QNAME:
    {qname: [(flag, line)]} in the order printed."""
    out = {}
    for line in blob.split(b"\n") if blob else ():
        f = line.split(b"\t", 2)
        if len(f) == 3 and f[1].isdigit():
            out.setdefault(f[0].decode(), []).append((int(f[1]), line))
    return out


def count_missing(names, groups, paired):
    """Reads among `names` that lack a primary record of their own in
    `groups` (by_name's): for pairs, one primary record of each mate."""
    want = (0x40, 0x80) if paired else (0,)
    miss = 0
    for name in names:
        got = {flag & 0xC0 for flag, _line in groups.get(name, ())
               if not flag & 0x100}
        miss += sum(m not in got for m in want)
    return miss


def sample(n_units, lengths, seed, size):
    """Indices of the units to check: `size` of them drawn from the seed,
    with the longest unit among them."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 2])
    pick = rng.choice(n_units, min(size, n_units), replace=False)
    longest = int(np.argmax(lengths))
    if longest not in pick:
        pick[0] = longest
    return sorted(int(i) for i in pick)


def forward(reads):
    """Reads (codes, quals, origin, strand) as they lie on the genome's
    forward strand, padded to the longest: (codes, quals, lengths,
    origins) for reference/dp.py."""
    lens = np.array([r[0].size for r in reads], np.int64)
    fw = np.zeros((len(reads), int(lens.max())), np.uint8)
    fq = np.zeros_like(fw)
    for j, (c, q, _o, strand) in enumerate(reads):
        fw[j, :c.size] = revcomp(c) if strand else c
        fq[j, :c.size] = q[::-1] if strand else q
    return fw, fq, lens, np.array([r[2] for r in reads], np.int64)


def band_best(reads, genome, sc, pad):
    """The best score of each read (end to end, or local) in a band of
    +-pad diagonals around its origin."""
    return banded(*forward(reads), genome, sc, pad)[0]


class Judge:
    """The comparison for one configuration and traffic mix, over a
    genome (gen/genome.py Genome) of one or more references."""

    def __init__(self, genome, config, traffic, paired):
        self.genome = genome
        self.sc = Scoring(config["scoring"], config.get("local", False))
        self.pe = config.get("pe")
        self.pad = int(traffic["ref_band"])
        self.size = int(traffic["check_units"])
        self.paired = bool(paired)

    def numbers(self, units, names, groups):
        """field_err and miss_pct over (unit, name, group) triples."""
        sc = self.sc
        field_err = 0
        scored = []          # (read, record or None)
        for unit, name, group in zip(units, names, groups):
            reads = reads_of(unit)
            try:
                recs = primaries(group)
            except (ValueError, IndexError):
                field_err += len(reads)
                continue
            if len(recs) != len(reads):
                field_err += len(reads)
                continue
            for read, rec in zip(reads, recs):
                bad = read_errors(rec, name, read[0], read[1], self.genome,
                                  sc)
                if rec.aligned and not bad and (
                        not self.paired or rec.tags.get("YT") == "UP") \
                        and not se_mapq_ok(rec, read[0].size, sc):
                    bad.append("MAPQ")
                field_err += bool(bad)
                scored.append((read, rec if not bad else None))
            if self.paired:
                r1, r2 = recs
                lens = (reads[0][0].size, reads[1][0].size)
                bad = pair_errors(r1, r2, lens, sc, self.pe)
                if not bad and r1.aligned and r2.aligned and \
                        r1.tags.get("YT") in ("CP", "DP") and \
                        not pair_mapq_ok(r1, r2, lens, sc):
                    bad.append("MAPQ")
                field_err += bool(bad)
        eligible = misses = 0
        if scored:
            best = band_best([r for r, _ in scored], self.genome.codes, sc,
                             self.pad)
            for (read, rec), b in zip(scored, best):
                L = read[0].size
                if b < sc.min_score(L) or \
                        int((read[0] == 4).sum()) > sc.max_ns(L):
                    continue
                eligible += 1
                misses += bool(rec is None or not rec.aligned or
                               rec.tags["AS"] < b)
        return {"field_err": int(field_err),
                "miss_pct": float(100.0 * misses / max(eligible, 1)),
                "eligible": eligible, "misses": misses}

    def judge(self, batches, seed):
        """The numbers of a run: batches is the window's collected
        batches as (units, SAM text of the batch, names)."""
        units, names, groups, missing = [], [], [], 0
        for u, blob, n in batches:
            g = by_name(blob)
            missing += count_missing(n, g, self.paired)
            units += u
            names += n
            groups += [g.get(x, []) for x in n]
        out = {"missing": missing}
        if not units:
            out.update(field_err=0, miss_pct=100.0, eligible=0, misses=0)
            return out
        lengths = [sum(r[0].size for r in reads_of(u)) for u in units]
        pick = sample(len(units), lengths, seed, self.size)
        out.update(self.numbers([units[i] for i in pick],
                                [names[i] for i in pick],
                                [groups[i] for i in pick]))
        return out
