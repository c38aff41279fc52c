"""ctypes wrapper for the native end-row DP cell oracle (dpcells.c).

A C transcription of the JAX package's NumPy `sw_full_numpy_cells`, called
through ops/sw.py's function of that name; a failed build raises."""

import ctypes

import numpy as np

from bowtie2_tpu_torch.native import _build

_lib = ctypes.CDLL(_build("dpcells", "dpcells.c"))
_lib.dp_cells.restype = ctypes.c_int
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_lib.dp_cells.argtypes = [
    _i64p, _i64p, ctypes.c_int64, _i64p, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
    _i64p, _i64p, _i64p,
]


def dp_cells(read: np.ndarray, mm: np.ndarray, refwin: np.ndarray, p):
    """read/mm: (L,) int64 codes and mismatch penalties; refwin: (R,)
    int64 codes; p: SWParams. Returns (H, HO), each (R+1,) int64."""
    read = np.ascontiguousarray(read, np.int64)
    mm = np.ascontiguousarray(mm, np.int64)
    refwin = np.ascontiguousarray(refwin, np.int64)
    R = refwin.size
    H = np.empty(R + 1, np.int64)
    HO = np.empty(R + 1, np.int64)
    work = np.empty(6 * (R + 1), np.int64)
    _lib.dp_cells(read, mm, read.size, refwin, R, p.match_bonus, p.n_pen,
                  p.read_gap_open, p.read_gap_extend, p.ref_gap_open,
                  p.ref_gap_extend, p.gap_barrier, H, HO, work)
    return H, HO
