"""ctypes wrapper for the native CIGAR/MD decoder (samemit.c).

Batched translation of device-backtrace op columns into CIGAR and MD:Z
strings — the host-side half of SAM record emission. Falls back to the
numpy implementation (pipeline/backtrace.py cigar_md_from_packed) when the
native build is unavailable; both produce identical strings (tested).
"""

import ctypes
from typing import List, Tuple

import numpy as np

from bowtie2_tpu_torch.native import _build

_lib = ctypes.CDLL(_build("samemit", "samemit.c"))
_lib.cigar_md_batch.restype = ctypes.c_int
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_lib.cigar_md_batch.argtypes = [
    _u8p, ctypes.c_int64, ctypes.c_int64,
    _i32p, _i32p, _i32p, _i32p, _i32p, _i8p, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_int,
    ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
]


def cigar_md_batch(ops: np.ndarray, cols: np.ndarray,
                   read_start: np.ndarray, read_end: np.ndarray,
                   read_len: np.ndarray, bound: np.ndarray,
                   reads: np.ndarray, xeq: bool = False
                   ) -> Tuple[List[str], List[str]]:
    """Decode CIGAR+MD for n records.

    ops: (S, Bc) uint8 device backtrace output; cols: (n,) column per
    record; reads: (n, Lmax) int8 oriented codes. Returns (cigars, mds).
    """
    n = int(cols.size)
    if n == 0:
        return [], []
    ops = np.ascontiguousarray(ops)
    reads = np.ascontiguousarray(reads, dtype=np.int8)
    Lmax = reads.shape[1]
    cigar_stride = 8 * Lmax // 2 + 64
    md_stride = 4 * Lmax + 64
    cig = ctypes.create_string_buffer(n * cigar_stride)
    md = ctypes.create_string_buffer(n * md_stride)
    bad = _lib.cigar_md_batch(
        ops, ops.shape[0], ops.shape[1],
        np.ascontiguousarray(cols, np.int32),
        np.ascontiguousarray(read_start, np.int32),
        np.ascontiguousarray(read_end, np.int32),
        np.ascontiguousarray(read_len, np.int32),
        np.ascontiguousarray(bound, np.int32),
        reads, Lmax, n, int(xeq), cig, cigar_stride, md, md_stride)
    if bad:
        raise RuntimeError(f"cigar_md_batch: {bad} records overflowed")
    raw_c, raw_m = cig.raw, md.raw
    cigars = []
    mds = []
    for r in range(n):
        o = r * cigar_stride
        cigars.append(raw_c[o:raw_c.index(b"\0", o)].decode("ascii"))
        o = r * md_stride
        mds.append(raw_m[o:raw_m.index(b"\0", o)].decode("ascii"))
    return cigars, mds


_lib.sam_tails_batch.restype = ctypes.c_int
_lib.sam_tails_batch.argtypes = [
    _i8p,                                   # mode
    _i32p, _i32p, _i32p, _i32p,             # flag rname pos mapq
    _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,  # as xs xn xm xo xg
    _i8p, _i8p, _i32p, ctypes.c_int64,      # codes quals rdlen Lmax
    _u8p, ctypes.c_int64, ctypes.c_int64,   # ops S Bc
    _i32p, _i32p, _i32p, _i32p,             # cols read_start read_end bound
    ctypes.c_char_p, _i32p,                 # names name_off
    ctypes.c_char_p, ctypes.c_int64,        # suffix n
    ctypes.c_int,                           # xeq
    ctypes.c_char_p, ctypes.c_int64, _i32p,  # out stride outlen
]

XS_OMIT = -(1 << 31)


class RefNameTable:
    """Refnames flattened for the C line builder (built once per index)."""

    def __init__(self, names):
        offs = [0]
        blob = bytearray()
        for s in names:
            blob.extend(s.encode())
            offs.append(len(blob))
        self.blob = bytes(blob)
        self.offs = np.array(offs, np.int32)


def sam_tails_batch(mode, flag, rname_i, pos, mapq, opt_as, opt_xs,
                    xn, xm, xo, xg, codes, quals, rdlen,
                    ops, cols, read_start, read_end, bound,
                    names: RefNameTable, suffix: bytes,
                    xeq: bool = False):
    """Build SAM line tails (everything after QNAME) for n records.

    Returns a list of bytes objects (one per record)."""
    n = int(flag.size)
    if n == 0:
        return []
    ops = np.ascontiguousarray(ops)
    codes = np.ascontiguousarray(codes, np.int8)
    quals = np.ascontiguousarray(quals, np.int8)
    Lmax = codes.shape[1]
    stride = 8 * Lmax + 512
    out = ctypes.create_string_buffer(n * stride)
    outlen = np.zeros(n, np.int32)
    a32 = lambda x: np.ascontiguousarray(x, np.int32)
    bad = _lib.sam_tails_batch(
        np.ascontiguousarray(mode, np.int8),
        a32(flag), a32(rname_i), a32(pos), a32(mapq),
        a32(opt_as), a32(opt_xs), a32(xn), a32(xm), a32(xo), a32(xg),
        codes, quals, a32(rdlen), Lmax,
        ops, ops.shape[0], ops.shape[1],
        a32(cols), a32(read_start), a32(read_end), a32(bound),
        names.blob, names.offs, suffix, n, int(xeq), out, stride, outlen)
    if bad:
        raise RuntimeError(f"sam_tails_batch: {bad} records overflowed")
    raw = out.raw
    return [raw[r * stride:r * stride + outlen[r]] for r in range(n)]


_lib.sam_tails_pe.restype = ctypes.c_int
_lib.sam_tails_pe.argtypes = [
    _i8p,                                   # mode
    _i32p, _i32p, _i32p, _i32p,             # flag rname pos mapq
    _i32p, _i32p, _i32p,                    # rnext pnext tlen
    _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,  # as xs xn xm xo xg
    _i32p, _i8p,                            # ys yt
    _i8p, _i8p, _i32p, ctypes.c_int64,      # codes quals rdlen Lmax
    _u8p, ctypes.c_int64, ctypes.c_int64,   # ops S Bc
    _i32p, _i32p, _i32p, _i32p,             # cols read_start read_end bound
    ctypes.c_char_p, _i32p,                 # names name_off
    ctypes.c_char_p, ctypes.c_int64,        # suffix n
    ctypes.c_int,                           # xeq
    ctypes.c_char_p, ctypes.c_int64, _i32p,  # out stride outlen
]


def sam_tails_pe_batch(mode, flag, rname_i, pos, mapq, rnext_i, pnext,
                       tlen, opt_as, opt_xs, xn, xm, xo, xg, ys, yt,
                       codes, quals, rdlen,
                       ops, cols, read_start, read_end, bound,
                       names: RefNameTable, suffix: bytes,
                       xeq: bool = False):
    """Build PE SAM line tails (everything after QNAME) for n records.

    CIGAR/MD decode from packed walk-op columns like sam_tails_batch;
    adds RNEXT/PNEXT/TLEN, YS:i (YS_OMIT = omit), YT:Z (0 UU / 1 CP /
    2 DP / 3 UP). rname_i/rnext_i: -1 '*', -2 '=', else name index.
    Returns a list of bytes objects (one per record)."""
    n = int(flag.size)
    if n == 0:
        return []
    ops = np.ascontiguousarray(ops)
    codes = np.ascontiguousarray(codes, np.int8)
    quals = np.ascontiguousarray(quals, np.int8)
    Lmax = codes.shape[1]
    stride = 8 * Lmax + 512
    out = ctypes.create_string_buffer(n * stride)
    outlen = np.zeros(n, np.int32)
    a32 = lambda x: np.ascontiguousarray(x, np.int32)
    bad = _lib.sam_tails_pe(
        np.ascontiguousarray(mode, np.int8),
        a32(flag), a32(rname_i), a32(pos), a32(mapq),
        a32(rnext_i), a32(pnext), a32(tlen),
        a32(opt_as), a32(opt_xs), a32(xn), a32(xm), a32(xo), a32(xg),
        a32(ys), np.ascontiguousarray(yt, np.int8),
        codes, quals, a32(rdlen), Lmax,
        ops, ops.shape[0], ops.shape[1],
        a32(cols), a32(read_start), a32(read_end), a32(bound),
        names.blob, names.offs, suffix, n, int(xeq), out, stride, outlen)
    if bad:
        raise RuntimeError(f"sam_tails_pe: {bad} records overflowed")
    raw = out.raw
    return [raw[r * stride:r * stride + outlen[r]] for r in range(n)]


_lib.pad_reads_c.restype = None
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_lib.pad_reads_c.argtypes = [
    _i8p, _i8p, _i64p, _i32p, ctypes.c_int64, ctypes.c_int64,
    _i8p, _i8p, _i8p, _i8p,
]


def pad_reads_c(allseq, allq, starts, lens, B, Lmax):
    """Native batch padding: → (fw, qu, rc, qu_r) int8 (B, Lmax) arrays."""
    fw = np.empty((B, Lmax), np.int8)
    qu = np.empty((B, Lmax), np.int8)
    rc = np.empty((B, Lmax), np.int8)
    qu_r = np.empty((B, Lmax), np.int8)
    _lib.pad_reads_c(np.ascontiguousarray(allseq, np.int8),
                     np.ascontiguousarray(allq, np.int8),
                     np.ascontiguousarray(starts, np.int64),
                     np.ascontiguousarray(lens, np.int32),
                     B, Lmax, fw, qu, rc, qu_r)
    return fw, qu, rc, qu_r
