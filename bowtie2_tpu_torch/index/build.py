"""Index construction: FASTA → device-friendly FM-index arrays.

Equivalent role to the reference's bowtie2-build (bt2_build.cpp driver +
Ebwt::buildToDisk bt2_idx.h:1714), but the output layout is designed for TPU
gathers rather than 64-byte cache-line "sides" (bt2_idx.h:1867-1886):

  * BWT packed 2 bits/base into uint32 words (16 bases/word), SoA.
  * Occ checkpoints every OCC_BLOCK(=128) bases: int32[nblocks, 4] counts of
    each char strictly before the block. One LF step = gather 8 contiguous
    words + one checkpoint row, then a 128-lane unpack-compare-sum on the VPU.
  * ftab: first FTAB_CHARS chars of the query resolved with one lookup
    (reference ftab, bt2_idx.h:1476 ftabLoHi), stored as a searchsorted
    boundary array F with short-suffix disambiguation (key*2+isFull).
  * SA sample marked by TEXT POSITION (pos % 2^OFF_RATE == 0), unlike the
    reference's row marking (bt2_idx.h:1607 walkLeft): the resolve walk is
    then bounded by 2^OFF_RATE LF steps — a fixed trip count for lax.scan.
    Marked rows are a bitmask + rank checkpoints (every 128 rows), values in
    a compact int32 array.

Ambiguity handling follows the reference (ref_read.h RefRecord): N stretches
are excluded from the indexed "joined" text; a segment table maps joined
offsets back to (reference, offset) (reference.h:59 BitPairReference +
bt2_idx.h joinedToTextOff). The full reference sequences (with N) are kept
2-bit packed + N bitmask for DP window gathers (BitPairReference::getStretch
equivalent).

A mirror index over the reversed joined text is built alongside (reference's
.rev.1/2.bt2, EBWT_ENTIRE_REV bt2_idx.h:100-105) for bidirectional /
1-mismatch seed search.
"""

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from bowtie2_tpu_torch.constants import FTAB_CHARS, OCC_BLOCK, OFF_RATE, WORDS_PER_BLOCK
from bowtie2_tpu_torch.index.sa import suffix_array
from bowtie2_tpu_torch.io.fastx import read_fasta


# chunk size for the streaming build passes: big enough to amortize numpy
# dispatch, small enough that per-chunk temporaries (~10x chunk bytes) stay
# cache/RAM-friendly — genome-scale builds were dominated by 4-8x full-text
# temporaries before chunking (36.5 GB peak at 1 Gbp)
_CHUNK = 1 << 25        # 32M chars; multiple of OCC_BLOCK and 32


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """uint8 codes (values 0..3) → uint32 words, 16 codes/word, crumb j at
    bits 2j. Chunked: peak extra memory ~6x chunk size, not 6x text size."""
    n = codes.size
    nwords = (n + 15) // 16
    out = np.zeros(nwords, dtype=np.uint32)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    for s in range(0, n, _CHUNK):
        e = min(s + _CHUNK, n)
        ln = e - s
        lw = (ln + 15) // 16
        padded = np.zeros(lw * 16, dtype=np.uint32)
        padded[:ln] = codes[s:e]
        np.bitwise_or.reduce(padded.reshape(lw, 16) << shifts, axis=1,
                             out=out[s // 16:s // 16 + lw])
    return out


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """bool array → uint32 words, bit j of word w = bits[32w+j]. Chunked."""
    n = bits.size
    nwords = (n + 31) // 32
    out = np.zeros(nwords, dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint32)[None, :]
    for s in range(0, n, _CHUNK):
        e = min(s + _CHUNK, n)
        ln = e - s
        lw = (ln + 31) // 32
        padded = np.zeros(lw * 32, dtype=np.uint32)
        padded[:ln] = bits[s:e]
        np.bitwise_or.reduce(padded.reshape(lw, 32) << shifts, axis=1,
                             out=out[s // 32:s // 32 + lw])
    return out


@dataclass
class HalfIndex:
    """One direction's FM index (host numpy arrays)."""
    n: int                    # joined text length (BWT has n+1 rows)
    z_off: int                # row whose BWT char is the sentinel
    bwt_words: np.ndarray     # uint32[ceil((n+1)/16)], padded to whole blocks
    occ_cp: np.ndarray        # int32[nblocks, 4]
    fchr: np.ndarray          # int32[5]: C[c] = first row of suffixes starting with c
    ftab: np.ndarray          # int32[2*4^K + 1] searchsorted boundaries
    ftab_chars: int
    # SA sample (may be absent for the mirror index)
    mark_words: Optional[np.ndarray] = None   # uint32[ceil((n+1)/32)] → padded
    mark_cp: Optional[np.ndarray] = None      # int32[nblocks]: marked rows < 128*b
    offs: Optional[np.ndarray] = None         # int32[n_marked]


@dataclass
class IndexData:
    """Full index (both directions + reference data). Host container."""
    ref_names: List[str]
    ref_lens: np.ndarray          # int64[nrefs] full lengths incl N
    ref_cum: np.ndarray           # int64[nrefs+1] cumulative full lengths
    # non-N segment table (joined ↔ reference mapping)
    seg_joined_start: np.ndarray  # int64[nsegs]
    seg_global_start: np.ndarray  # int64[nsegs]  (global = ref_cum[ref]+off)
    seg_len: np.ndarray           # int64[nsegs]
    # reference bases in global coordinate space
    ref_words: np.ndarray         # uint32 2-bit packed, N stored as 0
    refn_words: np.ndarray        # uint32 bitmask of N positions
    fw: HalfIndex = None
    bw: HalfIndex = None
    off_rate: int = OFF_RATE

    @property
    def n_joined(self) -> int:
        return self.fw.n

    def joined_to_global(self, jpos: np.ndarray) -> np.ndarray:
        """Joined text offsets → global reference-space offsets."""
        jpos = np.asarray(jpos, dtype=np.int64)
        seg = np.searchsorted(self.seg_joined_start, jpos, side="right") - 1
        return self.seg_global_start[seg] + (jpos - self.seg_joined_start[seg])

    def global_to_ref(self, gpos: np.ndarray):
        """Global offsets → (ref_id, ref_off)."""
        gpos = np.asarray(gpos, dtype=np.int64)
        rid = np.searchsorted(self.ref_cum, gpos, side="right") - 1
        return rid, gpos - self.ref_cum[rid]


def _build_half(text: np.ndarray, ftab_chars: int, with_sa_sample: bool,
                off_rate: int, large: bool = False,
                threads: int = 1) -> HalfIndex:
    """large=True stores row-space arrays (occ_cp/fchr/ftab/offs) as int64
    — the ".bt2l" analog (reference btypes.h TIndexOffU 64-bit switch,
    bt2_idx.h:100-105) — required when the joined text reaches 2^31 bp
    (GRCh38 is ~3.1 Gbp). Device kernels pick the row dtype up from the
    arrays; the small mode stays int32 (2x less HBM and faster).

    Every post-SA pass streams over _CHUNK-sized row windows: the BWT
    gather + 2-bit pack, per-block occ counts, SA-sample marks + rank
    checkpoints and the ftab histogram never materialize another
    text-sized temporary (the pre-streaming build peaked at ~36 bytes/bp;
    the SA itself is now the only O(n) resident besides the outputs).
    threads > 1 runs the independent row-window passes on a thread pool
    (numpy releases the GIL for the heavy ops) — the analog of the
    reference's bowtie2-build --threads bucket pool (blockwise_sa.h:255),
    applied to the linear-time layout instead of bucket sorting."""
    rdt = np.int64 if large else np.int32
    n = int(text.size)
    sa = suffix_array(text)          # length n+1, sa[0] == n
    nrows = n + 1
    nblocks = (nrows + OCC_BLOCK - 1) // OCC_BLOCK
    npad = nblocks * OCC_BLOCK
    period = 1 << off_rate

    bwt_words = np.zeros(npad // 16, dtype=np.uint32)
    per_block = np.zeros((nblocks, 4), dtype=np.int64)
    mark_words = np.zeros(npad // 32, np.uint32) if with_sa_sample else None
    mark_pb = np.zeros(nblocks, np.int64) if with_sa_sample else None
    nchunks = (npad + _CHUNK - 1) // _CHUNK
    offs_parts: list = [None] * nchunks
    z_parts: list = [0] * nchunks
    sh2 = (2 * np.arange(16, dtype=np.uint32))[None, :]
    sh1 = np.arange(32, dtype=np.uint32)[None, :]

    def _rows_pass(ci: int) -> None:
        s = ci * _CHUNK
        e = min(s + _CHUNK, npad)
        ln = e - s
        bwtc = np.zeros(ln, dtype=np.uint8)
        if s < nrows:
            rows = sa[s:min(e, nrows)]
            # BWT char of row r = text[sa[r] - 1]; sa == 0 (row z_off) gets
            # a spurious 'A' that occ queries subtract at query time, and
            # sa == n (the sentinel row) wraps to text[n - 1]
            prev = (rows.astype(np.int64) - 1) % nrows
            np.minimum(prev, n - 1, out=prev)
            bwtc[:rows.size] = text[prev]
            zm = np.nonzero(rows == 0)[0]
            if zm.size:
                z_parts[ci] = s + int(zm[0]) + 1     # +1: 0 is "none"
                bwtc[zm[0]] = 0
            if with_sa_sample:
                marked = np.zeros(ln, dtype=bool)
                marked[:rows.size] = (rows % period) == 0
                lw = ln // 32
                np.bitwise_or.reduce(
                    padded_b := marked.astype(np.uint32).reshape(lw, 32)
                    << sh1, axis=1,
                    out=mark_words[s // 32:s // 32 + lw])
                del padded_b
                mark_pb[s // OCC_BLOCK:e // OCC_BLOCK] = \
                    marked.reshape(-1, OCC_BLOCK).sum(axis=1)
                offs_parts[ci] = rows[marked[:rows.size]].astype(rdt)
        # 2-bit pack + per-block counts (padding zeros pollute only the
        # LAST block's 'A' count; subtracted after the loop)
        lw = ln // 16
        np.bitwise_or.reduce(
            bwtc.astype(np.uint32).reshape(lw, 16) << sh2, axis=1,
            out=bwt_words[s // 16:s // 16 + lw])
        blk = bwtc.reshape(-1, OCC_BLOCK)
        for c in range(4):
            per_block[s // OCC_BLOCK:e // OCC_BLOCK, c] = \
                (blk == c).sum(axis=1)

    if threads > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=threads) as ex:
            list(ex.map(_rows_pass, range(nchunks)))
    else:
        for ci in range(nchunks):
            _rows_pass(ci)

    z_off = max(z_parts) - 1
    assert z_off >= 0
    per_block[-1, 0] -= npad - nrows
    occ_cp = np.concatenate(
        [np.zeros((1, 4), np.int64),
         np.cumsum(per_block, axis=0)[:-1]]).astype(rdt)

    # fchr: C[c] = 1 + #chars < c in text  (sentinel occupies row 0)
    counts = np.bincount(text, minlength=4)[:4]
    fchr = np.concatenate([[1], 1 + np.cumsum(counts)]).astype(rdt)[:5]

    # ftab boundaries: ftab[v] = #suffixes whose disambiguated K-char key
    # (key*2 + isFull) is < v. The count is ORDER-INDEPENDENT, so no SA
    # gather and no sorted-key array are needed at all: build per-position
    # keys with sequential shifted adds (cache-friendly), histogram them
    # per chunk (the 2*4^K-bin counts stay cache-resident), prefix-sum.
    K = ftab_chars
    assert K <= 15, "ftab keys are uint32 (4^15 max)"
    nbin = 2 * 4**K

    def _ftab_pass(s: int) -> np.ndarray:
        e = min(s + _CHUNK, n + 1)
        ln = e - s
        win = np.zeros(ln + K, dtype=np.uint8)
        take = min(e + K, n) - s
        if take > 0:
            win[:take] = text[s:s + take]
        keys = np.zeros(ln, dtype=np.uint32)
        for j in range(K):
            keys *= 4
            keys += win[j:j + ln]
        keys *= 2
        full_end = max(n - K + 1 - s, 0)
        keys[:min(full_end, ln)] += 1    # isFull: suffix has >= K chars
        return np.bincount(keys, minlength=nbin)

    starts = list(range(0, n + 1, _CHUNK))
    if threads > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=threads) as ex:
            counts_k = sum(ex.map(_ftab_pass, starts),
                           np.zeros(nbin, np.int64))
    else:
        counts_k = np.zeros(nbin, dtype=np.int64)
        for s in starts:
            counts_k += _ftab_pass(s)
    ftab = np.concatenate([[0], np.cumsum(counts_k)]).astype(rdt)
    del counts_k

    half = HalfIndex(
        n=n, z_off=z_off, bwt_words=bwt_words, occ_cp=occ_cp, fchr=fchr,
        ftab=ftab, ftab_chars=K,
    )
    if with_sa_sample:
        half.mark_words = mark_words
        half.mark_cp = np.concatenate(
            [[0], np.cumsum(mark_pb)[:-1]]).astype(np.int32)
        half.offs = np.concatenate([p for p in offs_parts if p is not None])
    return half


def build_index(fasta_path: str, ftab_chars: int = FTAB_CHARS,
                off_rate: int = OFF_RATE, mirror: bool = False,
                large: Optional[bool] = None, threads: int = 1) -> IndexData:
    refs = read_fasta(fasta_path)
    if not refs:
        raise ValueError(f"no sequences in {fasta_path}")
    return build_index_from_refs(refs, ftab_chars, off_rate, mirror, large,
                                 threads)


def build_index_from_refs(refs, ftab_chars: int = FTAB_CHARS,
                          off_rate: int = OFF_RATE, mirror: bool = False,
                          large: Optional[bool] = None,
                          threads: int = 1) -> IndexData:
    """refs: [(name, uint8 codes incl N)]. mirror=True additionally builds
    the reversed-text index (the reference's .rev.1/2.bt2); no current
    search path uses it (kept for future in-index bidirectional -N 1
    work), so default off."""
    names = [r[0] for r in refs]
    lens = np.array([r[1].size for r in refs], dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(lens)])

    # segment table: non-N stretches, in order
    seg_j, seg_g, seg_l = [], [], []
    joined_parts = []
    jpos = 0
    for ri, (_, codes) in enumerate(refs):
        isn = codes >= 4
        # boundaries of non-N runs
        d = np.diff(np.concatenate([[1], isn.view(np.int8), [1]]).astype(np.int8))
        starts = np.nonzero(d == -1)[0]
        ends = np.nonzero(d == 1)[0]
        for s, e in zip(starts, ends):
            seg_j.append(jpos)
            seg_g.append(cum[ri] + s)
            seg_l.append(e - s)
            joined_parts.append(codes[s:e])
            jpos += e - s
    if jpos == 0:
        raise ValueError("reference contains no unambiguous (non-N) bases")
    joined = np.concatenate(joined_parts).astype(np.uint8)
    del joined_parts

    # global reference arrays (N stored as A + N bitmask)
    allcodes = np.concatenate([r[1] for r in refs]).astype(np.uint8)
    nmask = allcodes >= 4
    packed_src = np.where(nmask, 0, allcodes).astype(np.uint8)
    del allcodes
    ref_words = pack_2bit(packed_src)
    del packed_src
    refn_words = pack_bits(nmask)
    del nmask

    data = IndexData(
        ref_names=names, ref_lens=lens, ref_cum=cum,
        seg_joined_start=np.array(seg_j, dtype=np.int64),
        seg_global_start=np.array(seg_g, dtype=np.int64),
        seg_len=np.array(seg_l, dtype=np.int64),
        ref_words=ref_words,
        refn_words=refn_words,
        off_rate=off_rate,
    )
    if large is None:
        # auto: int64 row space once the joined text nears 2^31 rows
        # (reference bowtie2-build picks .bt2l past ~4 GB, bowtie2-build:61)
        large = jpos >= (1 << 31) - 64
    data.fw = _build_half(joined, ftab_chars, True, off_rate, large,
                          threads)
    if mirror:
        data.bw = _build_half(joined[::-1].copy(), ftab_chars, False,
                              off_rate, large, threads)
    return data


# ---------------------------- save / load ----------------------------

def save_index(data: IndexData, prefix: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(prefix)) or ".", exist_ok=True)
    meta = {
        "version": 1,
        "ref_names": data.ref_names,
        "off_rate": data.off_rate,
        "fw": {"n": data.fw.n, "z_off": data.fw.z_off, "ftab_chars": data.fw.ftab_chars},
        "bw": None if data.bw is None else
              {"n": data.bw.n, "z_off": data.bw.z_off, "ftab_chars": data.bw.ftab_chars},
    }
    arrays = {
        "ref_lens": data.ref_lens, "ref_cum": data.ref_cum,
        "seg_joined_start": data.seg_joined_start,
        "seg_global_start": data.seg_global_start, "seg_len": data.seg_len,
        "ref_words": data.ref_words, "refn_words": data.refn_words,
    }
    for tag, h in (("fw", data.fw), ("bw", data.bw)):
        if h is None:
            continue
        arrays[f"{tag}_bwt"] = h.bwt_words
        arrays[f"{tag}_occ"] = h.occ_cp
        arrays[f"{tag}_fchr"] = h.fchr
        arrays[f"{tag}_ftab"] = h.ftab
        if h.mark_words is not None:
            arrays[f"{tag}_mark"] = h.mark_words
            arrays[f"{tag}_markcp"] = h.mark_cp
            arrays[f"{tag}_offs"] = h.offs
    np.savez_compressed(prefix + ".bt2t.npz", **arrays)
    with open(prefix + ".bt2t.json", "w") as f:
        json.dump(meta, f)


def load_index(prefix: str) -> IndexData:
    with open(prefix + ".bt2t.json") as f:
        meta = json.load(f)
    z = np.load(prefix + ".bt2t.npz")

    def half(tag):
        m = meta[tag]
        if m is None:
            return None
        h = HalfIndex(
            n=m["n"], z_off=m["z_off"], bwt_words=z[f"{tag}_bwt"],
            occ_cp=z[f"{tag}_occ"], fchr=z[f"{tag}_fchr"], ftab=z[f"{tag}_ftab"],
            ftab_chars=m["ftab_chars"],
        )
        if f"{tag}_mark" in z:
            h.mark_words = z[f"{tag}_mark"]
            h.mark_cp = z[f"{tag}_markcp"]
            h.offs = z[f"{tag}_offs"]
        return h

    return IndexData(
        ref_names=meta["ref_names"], ref_lens=z["ref_lens"], ref_cum=z["ref_cum"],
        seg_joined_start=z["seg_joined_start"],
        seg_global_start=z["seg_global_start"], seg_len=z["seg_len"],
        ref_words=z["ref_words"], refn_words=z["refn_words"],
        fw=half("fw"), bw=half("bw"), off_rate=meta["off_rate"],
    )
