"""Importer for reference bowtie2 index files (.bt2 / .bt2l).

Lets users point bt2x at an existing bowtie2 index: the reference
sequences (with N stretches) and names are reconstructed exactly from the
.1/.3/.4 files, then the port's index layout is built from them.
The BWT itself is rebuilt rather than translated — the on-disk "side"
layout (bt2_idx.h:1867) is designed for 64-byte cache lines, not for
gathers, and the SA sample is re-marked by text position (constants.py).

File layouts (reference bt2_io.cpp:39 readIntoMemory, reference.cpp:100,
ref_read.h:79, EbwtParams bt2_idx.h:133-167):
  .1.bt2: [1u32][len][lineRate][linesPerSide][offRate][ftabChars][flags]
          [nPat][plen*nPat][nFrag][rstarts*3*nFrag][ebwt bytes]
          [zOff][fchr*5][ftab][eftab][names \\0-separated]
  .3.bt2: [1u32][sz][ (off, len, firstـu8) * sz ]
  .4.bt2: 2-bit packed unambiguous bases, crumb i at byte i>>2 bits (i&3)*2
"""

import os
import struct
from typing import List, Tuple

import numpy as np

from bowtie2_tpu_torch.index.build import IndexData, build_index_from_refs


def _off_dtype(large: bool):
    return np.uint64 if large else np.uint32


def read_bt2_refs(prefix: str) -> List[Tuple[str, np.ndarray]]:
    """Reconstruct [(name, codes incl N)] from a bowtie2 index."""
    large = os.path.exists(prefix + ".1.bt2l")
    ext = ".bt2l" if large else ".bt2"
    osz = 8 if large else 4
    odt = _off_dtype(large)

    with open(prefix + ".3" + ext, "rb") as f:
        one = struct.unpack("<I", f.read(4))[0]
        if one != 1:
            raise ValueError("big-endian .bt2 indexes are not supported")
        nrec = int(np.frombuffer(f.read(osz), odt)[0])
        recs = []
        for _ in range(nrec):
            off = int(np.frombuffer(f.read(osz), odt)[0])
            ln = int(np.frombuffer(f.read(osz), odt)[0])
            first = f.read(1)[0] != 0
            recs.append((off, ln, first))

    with open(prefix + ".4" + ext, "rb") as f:
        packed = np.frombuffer(f.read(), np.uint8)
    total_unambig = sum(r[1] for r in recs)
    idx = np.arange(total_unambig)
    codes_unambig = ((packed[idx >> 2] >> ((idx & 3) << 1)) & 3).astype(np.uint8)

    # header of .1 for names
    with open(prefix + ".1" + ext, "rb") as f:
        data = f.read()
    pos = 4  # endianness sentinel
    ln = int(np.frombuffer(data[pos:pos + osz], odt)[0]); pos += osz
    line_rate, _lps, off_rate, ftab_chars, _flags = struct.unpack(
        "<iiiii", data[pos:pos + 20]); pos += 20
    npat = int(np.frombuffer(data[pos:pos + osz], odt)[0]); pos += osz
    pos += npat * osz                                   # plen
    nfrag = int(np.frombuffer(data[pos:pos + osz], odt)[0]); pos += osz
    pos += nfrag * 3 * osz                              # rstarts
    # EbwtParams size math (bt2_idx.h:133-167)
    bwt_sz = ln // 4 + 1
    side_sz = 1 << line_rate
    side_bwt_sz = side_sz - osz * 4
    num_sides = (bwt_sz + side_bwt_sz - 1) // side_bwt_sz
    ebwt_tot = num_sides * side_sz
    ftab_len = (1 << (ftab_chars * 2)) + 1
    eftab_len = ftab_chars * 2
    pos += ebwt_tot                                     # ebwt
    pos += osz                                          # zOff
    pos += 5 * osz                                      # fchr
    pos += (ftab_len + eftab_len) * osz                 # ftab + eftab
    # names are newline-separated full FASTA header lines, NUL-terminated;
    # SAM RNAME uses the first whitespace token (as our FASTA reader does)
    blob = data[pos:].split(b"\x00")[0]
    names = [n.split()[0].decode() for n in blob.split(b"\n") if n.strip()]
    if len(names) != npat:
        raise ValueError(f"parsed {len(names)} names, expected {npat}")

    # stitch per-reference code arrays (off = Ns before each stretch)
    refs = []
    cur: List[np.ndarray] = []
    consumed = 0
    for off, lnr, first in recs:
        if first and cur:
            refs.append(np.concatenate(cur) if cur else np.zeros(0, np.uint8))
            cur = []
        cur.append(np.full(off, 4, np.uint8))
        cur.append(codes_unambig[consumed:consumed + lnr])
        consumed += lnr
    if cur:
        refs.append(np.concatenate(cur))
    if len(refs) != npat:
        raise ValueError(f"reconstructed {len(refs)} refs, expected {npat}")
    return list(zip(names, refs))


def import_bt2(prefix: str, ftab_chars: int = 10, off_rate: int = 5
               ) -> IndexData:
    """Build a bt2x IndexData from an existing bowtie2 index prefix."""
    return build_index_from_refs(read_bt2_refs(prefix),
                                 ftab_chars=ftab_chars, off_rate=off_rate)
