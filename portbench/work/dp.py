"""The rectangle DP's work, frozen from chip_smoke.py (`dp_work`,
OPS_DP_CELL, OPS_DP_CELL_ORIGIN) so that later changes there cannot move
the benchmark's rooflines. Do not edit."""

import json
import os

import numpy as np

# the least integer operations one DP cell of the affine-gap recurrence
# needs: the substitution score (compare, select), E and F (two subtracts
# and a max each), the diagonal add, H as the max of three (two maxes),
# the best-cell compare: 12; with origin tracking the origin of the
# diagonal move (compare, select), of E (select), of H without F
# (select), the F payload (select) and the cell's origin (select): 17.
OPS_DP_CELL = 12
OPS_DP_CELL_ORIGIN = 17

with open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def dp_work(lens, rect_cols, col_lo, origin):
    """chip_smoke.py dp_work on the live problems of a DP call: each
    problem's read rows (a code and a penalty each) and its rect columns
    of the window (a code each), its length, rect columns and first
    column; the direction words of its rows over its rect columns; the
    best cell's fields (and origin) written. lens, rect_cols: arrays over
    the live problems; col_lo: whether the call
    passed first columns. Returns (bytes, cells)."""
    ln = np.clip(np.asarray(lens, np.int64), 0, None)
    rc = np.clip(np.asarray(rect_cols, np.int64), 0, None)
    cells = int((ln * rc).sum())
    dir_words = int((ln * ((rc + 7) // 8)).sum())
    per_problem = 4 * (2 + bool(col_lo)) + 4 * (3 + bool(origin))
    byt = int(ln.sum()) * 8 + int(rc.sum()) * 4 + dir_words * 4 + \
        ln.size * per_problem
    return byt, cells


def least_seconds(byt, cells, origin):
    """The least time the card could take for the work: the larger of
    the bytes over the HBM bandwidth and the integer operations over the
    32-bit integer peak (peaks.json)."""
    ops = cells * (OPS_DP_CELL_ORIGIN if origin else OPS_DP_CELL)
    return max(byt / PEAKS["hbm_bytes_per_s"]["value"],
               ops / PEAKS["int32_ops_per_s"]["value"])
