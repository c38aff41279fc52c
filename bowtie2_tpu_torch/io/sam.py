"""SAM output formatting.

Counterpart of the reference's SamConfig/AlnSinkSam (sam.h:56-562,
aln_sink.h:1296): header (@HD/@SQ/@PG), mandatory fields, and the optional
field set bowtie2 emits by default, in the same order:
AS, (XS), XN, XM, XO, XG, NM, (YF), MD, YT.

Records are produced in read (input) order — the ordered-output contract of
the reference's OutputQueue reorder mode (outq.h:38).
"""

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from bowtie2_tpu_torch.constants import decode_seq

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_MATE1 = 0x40
FLAG_MATE2 = 0x80
FLAG_SECONDARY = 0x100


@dataclass
class SamAlignment:
    """One output record (aligned or not)."""
    qname: str
    flag: int
    rname: str = "*"
    pos: int = 0                  # 1-based
    mapq: int = 0
    cigar: str = "*"
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    opts: List[Tuple[str, str, object]] = field(default_factory=list)
    raw_tags: str = None       # --preserve-tags passthrough (SAM tag text)

    def line(self) -> str:
        core = [self.qname, str(self.flag), self.rname, str(self.pos),
                str(self.mapq), self.cigar, self.rnext, str(self.pnext),
                str(self.tlen), self.seq, self.qual]
        for tag, typ, val in self.opts:
            core.append(f"{tag}:{typ}:{val}")
        out = "\t".join(core)
        if self.raw_tags:
            out += self.raw_tags
        return out


import numpy as np


def qual_string(quals, offset: int = 33) -> str:
    return (np.asarray(quals, dtype=np.uint8) + offset).tobytes().decode("ascii")


def cigar_string(ops: List[Tuple[str, int]]) -> str:
    if not ops:
        return "*"
    return "".join(f"{ln}{op}" for op, ln in ops)


class SamWriter:
    def __init__(self, out, ref_names: List[str], ref_lens, prog_args: str,
                 version: str = "0.1.0", no_head: bool = False,
                 no_sq: bool = False, rg_id: Optional[str] = None,
                 rg_fields: Optional[List[str]] = None):
        self.out = out
        self.ref_names = ref_names
        self.rg_id = rg_id
        if not no_head:
            out.write("@HD\tVN:1.5\tSO:unsorted\tGO:query\n")
            if not no_sq:
                for name, ln in zip(ref_names, ref_lens):
                    out.write(f"@SQ\tSN:{name}\tLN:{int(ln)}\n")
            if rg_id:
                rg = "".join(f"\t{f}" for f in (rg_fields or []))
                out.write(f"@RG\tID:{rg_id}{rg}\n")
            out.write(f"@PG\tID:bowtie2\tPN:bowtie2-tpu\tVN:{version}\t"
                      f"CL:\"{prog_args}\"\n")

    def write(self, rec: SamAlignment) -> None:
        self.out.write(rec.line())
        if self.rg_id:
            self.out.write(f"\tRG:Z:{self.rg_id}")
        self.out.write("\n")


def write_fastq_record(f, rec) -> None:
    """Dump one read as FASTQ (--un/--al read splitting; the reference
    does this in its Perl wrapper by re-parsing SAM flags)."""
    seq = decode_seq(rec.seq.astype("uint8")).decode()
    f.write(f"@{rec.name}\n{seq}\n+\n{qual_string(rec.qual)}\n")
