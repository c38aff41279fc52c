"""Host-side sequence file parsing: FASTA and FASTQ.

Counterpart of the reference's pat.h/pat.cpp parser family (FASTQ pat.h:771,
FASTA pat.h:556). The reference parses one lightly-locked batch at a time per
thread; here parsing is a host-side generator feeding fixed-shape padded
batches to the device pipeline (pipeline/align.py pad_reads + the CLI's
length-bucketed windowing, cli/main.py).

Supports plain and gzip files (by extension / magic byte).
"""

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from bowtie2_tpu_torch.constants import encode_seq, revcomp


@dataclass
class SeqRecord:
    name: str
    seq: np.ndarray   # uint8 codes 0..4
    qual: np.ndarray  # uint8 phred scores (0..41+); 40s if FASTA
    qc_fail: bool = False  # upstream QC flag (qseq field 11 + --qc-filter)
    tags: str = None       # --preserve-tags: input BAM aux fields as SAM text
    comment: str = None    # header text after the first whitespace
                           # (--sam-no-qname-trunc / --sam-append-comment)


def _open_text(path: str):
    """Open possibly-compressed read/reference files. Codecs detected by
    magic bytes (seekable) or extension (pipes): gzip, bzip2, xz, zstd —
    the reference handles gz natively and bz2/zst/lz4 via wrapper FIFOs /
    zstd_decompress.cpp; here the stdlib codecs cover gz/bz2/xz and zstd
    uses the zstandard module when present (fails loudly otherwise)."""
    f = open(path, "rb")

    def wrap(kind):
        if kind == "gz":
            return io.BufferedReader(gzip.GzipFile(fileobj=f))
        if kind == "bz2":
            import bz2
            return io.BufferedReader(bz2.BZ2File(f))
        if kind == "xz":
            import lzma
            return io.BufferedReader(lzma.LZMAFile(f))
        if kind == "zst":
            try:
                import zstandard
            except ImportError as e:
                raise RuntimeError(
                    f"{path}: zstd input needs the 'zstandard' module"
                ) from e
            return io.BufferedReader(
                zstandard.ZstdDecompressor().stream_reader(f))
        return None

    if f.seekable():
        magic = f.read(6)
        f.seek(0)
        kind = None
        if magic[:2] == b"\x1f\x8b":
            kind = "gz"
        elif magic[:3] == b"BZh":
            kind = "bz2"
        elif magic[:6] == b"\xfd7zXZ\x00":
            kind = "xz"
        elif magic[:4] == b"\x28\xb5\x2f\xfd":
            kind = "zst"
        return wrap(kind) or f
    for ext, kind in ((".gz", "gz"), (".bz2", "bz2"), (".xz", "xz"),
                      (".zst", "zst")):
        if path.endswith(ext):
            return wrap(kind)
    return io.BufferedReader(f)  # pipe/FIFO: rely on extension


def read_fasta(path: str, _fh=None,
               full_names: bool = False) -> List[Tuple[str, np.ndarray]]:
    """Parse FASTA → [(name, codes uint8 incl N)]. Name is the first
    whitespace token unless full_names (index builds keep the whole
    header so --fullref can print it at align time, sam.cpp fullRef)."""
    out = []
    name = None
    chunks: List[bytes] = []
    with (_fh or _open_text(path)) as f:
        for line in f:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    out.append((name, encode_seq(b"".join(chunks))))
                hdr = line[1:]
                name = ((hdr.decode().strip() if full_names
                         else hdr.split()[0].decode())
                        if hdr.strip() else "")
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        out.append((name, encode_seq(b"".join(chunks))))
    return out


# Solexa → Phred conversion table (reference qual.h / gen_solqual_lookup.pl):
# phred = round(10 * log10(1 + 10^(solexa/10)))
_SOLEXA_TO_PHRED = np.array(
    [int(round(10 * np.log10(1 + 10 ** (s / 10.0)))) for s in range(-64, 65)],
    dtype=np.int16)


def iter_fastq(path: str, qual_offset: int = 33, _fh=None,
               solexa: bool = False, int_quals: bool = False
               ) -> Iterator[SeqRecord]:
    """Stream FASTQ records. Phred+33 by default (--phred64 → 64);
    --solexa-quals maps Solexa scale to Phred; --int-quals parses
    space-separated integers."""
    with (_fh or _open_text(path)) as f:
        while True:
            h = f.readline()
            if not h:
                return
            h = h.rstrip(b"\r\n")
            if not h:
                continue
            if not h.startswith(b"@"):
                raise ValueError(f"bad FASTQ header line: {h[:50]!r}")
            seq = f.readline().rstrip(b"\r\n")
            plus = f.readline()
            qual = f.readline().rstrip(b"\r\n")
            if not plus.startswith(b"+"):
                raise ValueError(f"malformed FASTQ record {h[:50]!r}")
            if int_quals:
                q = np.array([int(x) for x in qual.split()], dtype=np.int16)
            else:
                if len(qual) != len(seq):
                    raise ValueError(f"malformed FASTQ record {h[:50]!r}")
                q = (np.frombuffer(qual, dtype=np.uint8).astype(np.int16)
                     - (64 if solexa else qual_offset))
            if solexa and not int_quals:
                q = _SOLEXA_TO_PHRED[np.clip(q, -64, 64) + 64]
            # split on the FIRST whitespace char only: the reference's
            # Read.name is the whole header line, so the comment must be
            # reconstructable verbatim (genRandSeed hashes the full name)
            buf = h[1:]
            sp = -1
            for j, b in enumerate(buf):
                if b in (32, 9):
                    sp = j
                    break
            yield SeqRecord(
                name=(buf if sp < 0 else buf[:sp]).decode(),
                seq=encode_seq(seq),
                qual=np.clip(q, 0, 62).astype(np.uint8),
                comment=buf[sp + 1:].decode() if sp >= 0 else None,
            )


def iter_fasta_reads(path: str, _fh=None) -> Iterator[SeqRecord]:
    """FASTA as reads: qualities fixed at 40 (reference uses Phred 40 / 'I')."""
    for name, codes in read_fasta(path, _fh=_fh):
        yield SeqRecord(name=name, seq=codes, qual=np.full(codes.size, 40, np.uint8))


def iter_reads(path: str, fmt: str = "auto", qual_offset: int = 33) -> Iterator[SeqRecord]:
    if fmt == "auto":
        f = _open_text(path)
        buffered = f if isinstance(f, io.BufferedReader) else io.BufferedReader(f)
        first = buffered.peek(1)[:1]
        fmt = "fasta" if first == b">" else "fastq"
        if fmt == "fasta":
            return iter_fasta_reads(path, _fh=buffered)
        return iter_fastq(path, qual_offset, _fh=buffered)
    if fmt == "fasta":
        return iter_fasta_reads(path)
    return iter_fastq(path, qual_offset)


def iter_raw(path: str, _fh=None) -> Iterator[SeqRecord]:
    """One sequence per line (reference pat.h:920); quals fixed at 40,
    names are 0-based line ordinals."""
    with (_fh or _open_text(path)) as f:
        for i, line in enumerate(f):
            seq = line.rstrip(b"\r\n")
            if not seq:
                continue
            codes = encode_seq(seq)
            yield SeqRecord(name=str(i), seq=codes,
                            qual=np.full(codes.size, 40, np.uint8))


def _qual_codes(qual: bytes, qual_offset: int) -> np.ndarray:
    q = np.frombuffer(qual, dtype=np.uint8).astype(np.int16) - qual_offset
    return np.clip(q, 0, 62).astype(np.uint8)


def iter_tab(path: str, qual_offset: int = 33, _fh=None):
    """tab5/tab6 paired format (reference pat.h:619):
    tab5: name\\tseq1\\tqual1\\tseq2\\tqual2
    tab6: name1\\tseq1\\tqual1\\tname2\\tseq2\\tqual2
    Yields (SeqRecord, SeqRecord) pairs."""
    with (_fh or _open_text(path)) as f:
        for line in f:
            t = line.rstrip(b"\r\n").split(b"\t")
            if len(t) < 5:
                continue
            if len(t) >= 6:
                n1, s1, q1, n2, s2, q2 = t[:6]
            else:
                n1, s1, q1, s2, q2 = t[:5]
                n2 = n1
            yield (SeqRecord(n1.split()[0].decode(), encode_seq(s1),
                             _qual_codes(q1, qual_offset)),
                   SeqRecord(n2.split()[0].decode(), encode_seq(s2),
                             _qual_codes(q2, qual_offset)))


def iter_interleaved(path: str, fmt: str = "auto", qual_offset: int = 33):
    """Paired records interleaved in one file (reference --interleaved)."""
    it = iter_reads(path, fmt=fmt, qual_offset=qual_offset)
    while True:
        r1 = next(it, None)
        if r1 is None:
            return
        r2 = next(it, None)
        if r2 is None:
            raise ValueError("odd number of reads in interleaved input")
        yield (r1, r2)


def iter_many(paths, fmt: str = "auto", qual_offset: int = 33,
              raw: bool = False, solexa: bool = False,
              int_quals: bool = False) -> Iterator[SeqRecord]:
    """Reads from a comma-separated list / list of files, in order."""
    if isinstance(paths, str):
        paths = paths.split(",")
    for p in paths:
        if raw:
            it = iter_raw(p)
        elif solexa or int_quals:
            it = iter_fastq(p, qual_offset, solexa=solexa,
                            int_quals=int_quals)
        else:
            it = iter_reads(p, fmt=fmt, qual_offset=qual_offset)
        yield from it


def trim_record(rec: SeqRecord, trim5: int, trim3: int) -> SeqRecord:
    """-5/--trim5 and -3/--trim3 (reference pat.h trimming)."""
    if trim5 == 0 and trim3 == 0:
        return rec
    end = rec.seq.size - trim3
    return SeqRecord(rec.name, rec.seq[trim5:end].copy(),
                     rec.qual[trim5:end].copy())


SEQ4BIT = np.full(16, 4, np.uint8)
for _i, _c in ((1, 0), (2, 1), (4, 2), (8, 3)):   # A C G T; others → N
    SEQ4BIT[_i] = _c


def _bam_aux_to_sam(buf: bytes) -> str:
    """Decode a BAM aux-field blob into SAM tag text ("\tXX:t:val...").

    Reference --preserve-tags keeps the raw blob and re-emits it
    (pat.cpp:1503, sam.cpp); SAM output needs the text form."""
    import struct
    out = []
    off = 0
    n = len(buf)
    SZ = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}
    FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i",
           "I": "<I", "f": "<f"}
    while off + 3 <= n:
        tag = buf[off:off + 2].decode("ascii", "replace")
        typ = chr(buf[off + 2])
        off += 3
        if typ == "A":
            out.append(f"{tag}:A:{chr(buf[off])}")
            off += 1
        elif typ in SZ:
            v = struct.unpack_from(FMT[typ], buf, off)[0]
            off += SZ[typ]
            if typ == "f":
                out.append(f"{tag}:f:{v:g}")
            else:
                out.append(f"{tag}:i:{v}")
        elif typ in ("Z", "H"):
            end = buf.index(b"\x00", off)
            out.append(f"{tag}:{typ}:{buf[off:end].decode('ascii', 'replace')}")
            off = end + 1
        elif typ == "B":
            sub = chr(buf[off])
            cnt = struct.unpack_from("<i", buf, off + 1)[0]
            off += 5
            vals = []
            for _ in range(cnt):
                v = struct.unpack_from(FMT[sub], buf, off)[0]
                off += SZ[sub]
                vals.append(f"{v:g}" if sub == "f" else str(v))
            out.append(f"{tag}:B:{sub}," + ",".join(vals))
        else:
            break                      # unknown type: stop decoding
    return "".join("\t" + t for t in out)


def iter_bam(path: str, preserve_tags: bool = False) -> Iterator[SeqRecord]:
    """Read records from a BAM file (reference pat.h:813 BAM input).

    BGZF is a sequence of concatenated gzip members, which Python's gzip
    module reads natively. Secondary/supplementary records are skipped;
    reverse-flagged records are restored to original read orientation.
    """
    import struct

    with gzip.open(path, "rb") as f:
        if f.read(4) != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", f.read(4))[0]
        f.read(l_text)
        n_ref = struct.unpack("<i", f.read(4))[0]
        for _ in range(n_ref):
            l_name = struct.unpack("<i", f.read(4))[0]
            f.read(l_name + 4)
        while True:
            bs = f.read(4)
            if len(bs) < 4:
                return
            block_size = struct.unpack("<i", bs)[0]
            rec = f.read(block_size)
            (_refid, _pos, l_rn, _mapq, _bin, n_cig, flag, l_seq,
             _nref, _npos, _tlen) = struct.unpack("<iiBBHHHiiii", rec[:32])
            if flag & 0x900:          # secondary/supplementary
                continue
            off = 32
            name = rec[off:off + l_rn - 1].decode()
            off += l_rn + 4 * n_cig
            nsb = (l_seq + 1) // 2
            sb = np.frombuffer(rec[off:off + nsb], np.uint8)
            codes = np.empty(l_seq, np.uint8)
            codes[0::2] = SEQ4BIT[sb >> 4][:(l_seq + 1) // 2]
            codes[1::2] = SEQ4BIT[sb & 0xF][:l_seq // 2]
            off += nsb
            qual = np.frombuffer(rec[off:off + l_seq], np.uint8).copy()
            if qual.size and qual[0] == 0xFF:
                qual = np.full(l_seq, 40, np.uint8)
            if flag & 0x10:
                codes = revcomp(codes)
                qual = qual[::-1].copy()
            tags = None
            if preserve_tags:
                aux_off = off + l_seq
                tags = _bam_aux_to_sam(rec[aux_off:])
            yield SeqRecord(name=name, seq=codes,
                            qual=np.clip(qual, 0, 62).astype(np.uint8),
                            tags=tags)


def iter_qseq(path: str, qual_offset: int = 64, _fh=None,
              qc_filter: bool = False) -> Iterator[SeqRecord]:
    """Illumina qseq format (reference read_qseq.cpp): 11 tab fields;
    name built from machine_run_lane_tile_x_y, '.' means N. With
    qc_filter, reads whose QC field (11th) is 0 keep their bases/quals but
    are marked qc_fail: downstream they take the filtered path and emit
    YF:Z:QC with the real SEQ/QUAL (reference bt2_search.cpp:3405-3408,
    aligner_result.cpp:1100)."""
    with (_fh or _open_text(path)) as f:
        for line in f:
            t = line.rstrip(b"\r\n").split(b"\t")
            if len(t) < 11:
                continue
            name = b"_".join(t[0:6]).decode()
            seq = t[8].replace(b".", b"N")
            yield SeqRecord(name=name, seq=encode_seq(seq),
                            qual=_qual_codes(t[9], qual_offset),
                            qc_fail=qc_filter and t[10] == b"0")


def iter_fasta_continuous(path: str, k: int, ival: int, _fh=None
                          ) -> Iterator[SeqRecord]:
    """-F k,i: sample length-k reads every i bases from each FASTA sequence
    (reference FASTA-continuous, pat.h:698). Read names are
    "{seqname}_{offset}"; only full-length windows are emitted; quals fixed
    at 40 ('I'), matching the reference's constant qualities."""
    for name, codes in read_fasta(path, _fh=_fh):
        for off in range(0, max(codes.size - k, 0) + 1, max(ival, 1)):
            if off + k > codes.size:
                break
            yield SeqRecord(name=f"{name}_{off}",
                            seq=codes[off:off + k].copy(),
                            qual=np.full(k, 40, np.uint8))
