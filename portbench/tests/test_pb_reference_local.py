"""The plain reference's local mode held to Bowtie 2 itself: the records
that Bowtie 2 2.5.5 wrote for the lambda phage example reads with
`--local` (tests/golden/lambda_local.sam.gz, unpaired, and
lambda_pe_local.sam.gz, paired), under its --sensitive-local scoring.
No genome is needed: each record's reference bases come from its own
SEQ, CIGAR and MD:Z."""

import collections
import gzip
import os

import numpy as np
import pytest

from portbench.manifest import ROOT
from portbench.reference.sam import (Record, clipped, fields, pair_errors,
                                     pair_mapq_ok, ref_from_md, se_mapq_ok)
from portbench.reference.score import Scoring

SENSITIVE_LOCAL = {"ma": 2, "mp": [6, 2], "np": 1, "rdg": [5, 3],
                   "rfg": [5, 3], "gbar": 4, "score_min": ["G", 20, 8],
                   "n_ceil": ["L", 0, 0.15]}
PE = {"minins": 0, "maxins": 500, "orient": "fr"}
CODES = np.full(256, 4, np.int64)
CODES[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)


def golden(name):
    with gzip.open(os.path.join(ROOT, "tests", "golden",
                                name + ".sam.gz")) as f:
        return [Record(line) for line in f if not line.startswith(b"@")]


@pytest.fixture(scope="module")
def sam():
    """The aligned records of the unpaired file, and the paired file's
    primary records as (mate 1, mate 2) by YT."""
    se = [r for r in golden("lambda_local") if r.aligned]
    mates = collections.defaultdict(list)
    for r in golden("lambda_pe_local"):
        if not r.flag & 0x100:
            mates[r.qname].append(r)
    pairs = collections.defaultdict(list)
    for a, b in mates.values():
        r1, r2 = (a, b) if a.flag & 0x40 else (b, a)
        pairs[r1.tags.get("YT")].append((r1, r2))
    pe = [r for p in mates.values() for r in p if r.aligned]
    return {"se": se, "pe": pe, "pairs": pairs}


def tags_from_md(rec, sc):
    """AS, NM, XM, XO, XG and MD worked out from the record alone."""
    seq = CODES[np.frombuffer(rec.seq, np.uint8)]
    qual = np.frombuffer(rec.qual, np.uint8).astype(np.int64) - 33
    lead, core, trail = clipped(rec.ops())
    end = seq.size - trail
    r, q = seq[lead:end], qual[lead:end]
    return fields(core, r, q, ref_from_md(core, r, rec.tags["MD"]), sc)


def wrong(check, sam, sc):
    """The records (or pairs) of one check where the reference and
    Bowtie 2 disagree, and how many it compared."""
    if check in ("se_fields", "pe_fields"):
        recs = sam[check[:2]]
        return [(r.qname, r.cigar) for r in recs
                if tags_from_md(r, sc) != {k: r.tags.get(k) for k in
                                           ("AS", "NM", "XM", "XO", "XG",
                                            "MD")}], len(recs)
    if check == "se_mapq":
        recs = [r for r in sam["se"] if r.tags.get("YT") == "UU"]
        return [(r.qname, r.mapq) for r in recs
                if not se_mapq_ok(r, len(r.seq), sc)], len(recs)
    cp = sam["pairs"]["CP"]
    lens = [(len(a.seq), len(b.seq)) for a, b in cp]
    if check == "cp_tlen":
        return [(a.qname, a.tlen, b.tlen) for (a, b), ls in zip(cp, lens)
                if pair_errors(a, b, ls, sc, PE)], len(cp)
    return [(a.qname, a.mapq) for (a, b), ls in zip(cp, lens)
            if not pair_mapq_ok(a, b, ls, sc)], len(cp)


@pytest.mark.parametrize("check", ["se_fields", "pe_fields", "se_mapq",
                                   "cp_tlen", "cp_mapq"])
def test_local_reference_agrees_with_bowtie2(sam, check):
    """AS (and NM, XM, XO, XG, MD) on every aligned record; MAPQ from AS,
    XS and the read length on every YT:Z:UU record; TLEN (with the rest
    of the pair's fields) and a MAPQ that some second-best pair sum
    gives, on every concordant pair."""
    sc = Scoring(SENSITIVE_LOCAL, local=True)
    bad, n = wrong(check, sam, sc)
    assert n > 0 and not bad, (len(bad), n, bad[:5])


def test_golden_local_files_have_what_the_checks_need(sam):
    """Soft clips at both ends, gaps, second-best scores, and concordant
    pairs with clipped mates are all there to be compared."""
    ops = [r.ops() for r in sam["se"] + sam["pe"]]
    assert sum(o[0][1] == "S" for o in ops) > 100
    assert sum(o[-1][1] == "S" for o in ops) > 100
    assert sum(any(op in "ID" for _n, op in o) for o in ops) > 100
    assert sum("XS" in r.tags for r in sam["se"]) > 10
    assert sum(b"S" in a.cigar or b"S" in b.cigar
               for a, b in sam["pairs"]["CP"]) > 100


def test_soft_clip_inside_the_cigar_is_refused():
    with pytest.raises(ValueError):
        clipped([(5, "M"), (3, "S"), (5, "M")])
    with pytest.raises(ValueError):
        clipped([(5, "S")])
    assert clipped([(2, "S"), (5, "M"), (1, "I"), (4, "M"), (3, "S")]) == \
        (2, [(5, "M"), (1, "I"), (4, "M")], 3)


def test_end_to_end_refuses_soft_clips():
    from portbench.reference.sam import recompute
    from portbench.gen.genome import Genome

    g = Genome([("g", np.zeros(100, np.uint8))])
    line = b"r\t0\tg\t11\t42\t2S8M\t*\t0\t0\tAAAAAAAAAA\tIIIIIIIIII"
    e2e = Scoring(dict(SENSITIVE_LOCAL, score_min=["L", -0.6, -0.6]))
    with pytest.raises(ValueError):
        recompute(Record(line), np.zeros(10), np.full(10, 40), g, e2e)
    got = recompute(Record(line), np.zeros(10), np.full(10, 40), g,
                    Scoring(SENSITIVE_LOCAL, local=True))
    assert got == {"AS": 16, "NM": 0, "XM": 0, "XO": 0, "XG": 0, "MD": "8"}


@pytest.mark.parametrize("where", ["lead", "trail", "none"])
def test_local_band_clips_a_bad_end(where):
    """A high-quality mismatch at the second base from an end: the local
    band's best clips two bases (a match bonus of 2 lost, a penalty of 6
    saved); end to end the read keeps every base."""
    from portbench.reference.dp import banded

    genome = np.random.default_rng(7).integers(0, 4, 400).astype(np.uint8)
    read = genome[100:150].copy()
    j = {"lead": 1, "trail": 48, "none": None}[where]
    if j is not None:
        read[j] = (read[j] + 1) % 4
    args = (read[None], np.full((1, 50), 40, np.uint8), [50], [100],
            genome)
    best, alns = banded(*args, Scoring(SENSITIVE_LOCAL, local=True), 8,
                        trace=True)
    want = {"lead": (96, (102, "2S48M")), "trail": (96, (100, "48M2S")),
            "none": (100, (100, "50M"))}[where]
    assert (int(best[0]), alns[0]) == want
    e2e = Scoring(dict(SENSITIVE_LOCAL, score_min=["L", -0.6, -0.6]))
    best, alns = banded(*args, e2e, 8, trace=True)
    assert (int(best[0]), alns[0]) == ((-6, (100, "50M")) if j is not None
                                       else (0, (100, "50M")))
