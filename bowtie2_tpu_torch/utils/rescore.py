"""Oracle-free SAM re-scorer (reference scripts/sim/AlignmentCheck.pm).

Re-derives every aligned record's alignment independently of the aligner:
walk the CIGAR over the reference sequence, check SEQ against the genome,
recompute AS from the scoring policy and compare to the emitted AS:i,
rebuild MD:Z and compare, and sanity-check flags/TLEN for pairs. A property
checker, not a golden diff: it catches internally inconsistent output no
matter which aligner produced it.
"""

import re
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from bowtie2_tpu_torch.ops.sw import SWParams

_CIG = re.compile(r"(\d+)([MIDNSHP=X])")
_CODE = {c: i for i, c in enumerate("ACGTN")}


@dataclass
class RescoreError:
    qname: str
    field: str
    want: object
    got: object


def _mm_pen(q: int, p: SWParams) -> int:
    return p.mm_pen_min + (min(q, 40) * (p.mm_pen_max - p.mm_pen_min)) // 40


def rescore_sam(sam_lines, refs: Dict[str, np.ndarray], params: SWParams,
                max_errors: int = 20) -> List[RescoreError]:
    """Validate SAM records against reference sequences.

    sam_lines: iterable of SAM text lines; refs: name -> uint8 codes
    (0..3, 4=N); params: the scoring policy in effect. Returns a list of
    inconsistencies (empty = all records check out).
    """
    errs: List[RescoreError] = []

    def err(q, f, w, g):
        if len(errs) < max_errors:
            errs.append(RescoreError(q, f, w, g))

    for line in sam_lines:
        if not line or line.startswith("@"):
            continue
        t = line.rstrip("\n").split("\t")
        flag = int(t[1])
        if flag & 0x4:
            continue
        qname, rname, pos = t[0], t[2], int(t[3]) - 1
        cigar, seq, qual = t[5], t[9], t[10]
        opts = dict((x.split(":", 2)[0], x) for x in t[11:])
        ref = refs.get(rname)
        if ref is None:
            err(qname, "rname", "known reference", rname)
            continue
        ops = _CIG.findall(cigar)
        rd = np.array([_CODE.get(c, 4) for c in seq], np.int8)
        qs = np.frombuffer(qual.encode(), np.uint8).astype(np.int32) - 33

        score = 0
        n_mm = n_go = n_gc = 0
        md_parts: List[str] = []
        run = 0
        rpos, gpos = 0, pos
        for ln, op in ops:
            ln = int(ln)
            if op in ("M", "=", "X"):
                if gpos + ln > ref.size:
                    err(qname, "ref-overrun", ref.size, gpos + ln)
                    break
                for k in range(ln):
                    rc, fc = int(rd[rpos + k]), int(ref[gpos + k])
                    if rc >= 4 or fc >= 4:
                        score -= params.n_pen
                        n_mm += 1
                        md_parts.append(str(run))
                        md_parts.append("ACGTN"[min(fc, 4)])
                        run = 0
                    elif rc == fc:
                        score += params.match_bonus
                        run += 1
                    else:
                        score -= _mm_pen(int(qs[rpos + k]), params)
                        n_mm += 1
                        md_parts.append(str(run))
                        md_parts.append("ACGTN"[fc])
                        run = 0
                rpos += ln
                gpos += ln
            elif op == "I":
                score -= params.ref_gap_open + ln * params.ref_gap_extend
                n_go += 1
                n_gc += ln
                rpos += ln
            elif op == "D":
                score -= params.read_gap_open + ln * params.read_gap_extend
                n_go += 1
                n_gc += ln
                md_parts.append(str(run))
                md_parts.append(
                    "^" + "".join("ACGTN"[min(int(ref[gpos + k]), 4)]
                                  for k in range(ln)))
                run = 0
                gpos += ln
            elif op == "S":
                rpos += ln
            else:
                err(qname, "cigar-op", "MIDS", op)
        md_parts.append(str(run))
        # counts (possibly 0) separate every event; a CIGAR never holds two
        # adjacent D ops, so a plain join reproduces MD:Z exactly
        md = "".join(md_parts)
        if rpos != len(seq):
            err(qname, "cigar-readlen", len(seq), rpos)
        if "AS" in opts:
            want = int(opts["AS"].split(":")[2])
            if want != score:
                err(qname, "AS", want, score)
        if "XM" in opts:
            want = int(opts["XM"].split(":")[2])
            if want != n_mm:
                err(qname, "XM", want, n_mm)
        if "XO" in opts:
            want = int(opts["XO"].split(":")[2])
            if want != n_go:
                err(qname, "XO", want, n_go)
        if "XG" in opts:
            want = int(opts["XG"].split(":")[2])
            if want != n_gc:
                err(qname, "XG", want, n_gc)
        if "MD" in opts:
            want = opts["MD"].split(":")[2]
            if want != md:
                err(qname, "MD", want, md)
    return errs
