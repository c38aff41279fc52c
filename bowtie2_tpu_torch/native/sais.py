"""ctypes wrapper for the native SA-IS suffix sorter (sais.c)."""

import ctypes

import numpy as np

from bowtie2_tpu_torch.native import _build

_lib = ctypes.CDLL(_build("sais", "sais.c"))
_lib.sais_u8.restype = ctypes.c_int
_lib.sais_u8.argtypes = [
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int64, ctypes.c_int64,
]
_lib.sais_u8_32.restype = ctypes.c_int
_lib.sais_u8_32.argtypes = [
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32),
    ctypes.c_int64, ctypes.c_int64,
]


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of `text` (uint8 codes 0..K-2) + implicit sentinel.

    Matches index.sa.suffix_array_doubling's contract: length n+1, first
    entry n (the sentinel suffix). Texts below 2^32-64 chars (every
    genome up to ~4.29 Gbp — GRCh38 is 3.1) use the 4-byte-index SA-IS:
    half the peak memory AND half the random-access DRAM traffic of the
    int64 path, which only engages beyond that. Returns uint32 in the
    small mode, int64 in the large mode; callers index/cast numerically.
    """
    n = int(text.size)
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    # shift codes up so 0 is free for the sentinel
    t = np.empty(n + 1, dtype=np.uint8)
    t[:n] = text + 1
    t[n] = 0
    if n + 1 < (1 << 32) - 64:
        sa = np.empty(n + 1, dtype=np.uint32)
        rc = _lib.sais_u8_32(
            t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int64(n + 1),
            ctypes.c_int64(int(t.max()) + 1),
        )
        if rc != 0:
            raise RuntimeError(f"sais_u8_32 failed: {rc}")
        return sa
    sa = np.empty(n + 1, dtype=np.int64)
    rc = _lib.sais_u8(
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n + 1),
        ctypes.c_int64(int(t.max()) + 1),
    )
    if rc != 0:
        raise RuntimeError(f"sais_u8 failed: {rc}")
    return sa
