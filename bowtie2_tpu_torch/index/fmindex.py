"""Device-resident FM index as torch tensors.

`FMIndex.from_host` turns the numpy `IndexData` that `index/build.py`
loads into the tables the kernels read. The layout is the JAX package's,
bit for bit: `fm_blocks` packs the 8 BWT words and the 4 occ checkpoints
of one 128-bp block into one 48-byte row, so an LF step is one row load;
`mark_rows` packs the SA-sample mark bits of a block with their rank
checkpoint. Tables the JAX package keeps as uint32 are int32 tensors here
with the same bits (torch has thin uint32 coverage; the kernels read them
as uint32).

Two row modes, as in the JAX package (bowtie2_tpu/index/fmindex.py):
- small: rows, fchr, ftab and offs are int32, for a joined text below
  2^31 bp with global coordinates below 2^31;
- large: the row space is uint32 up to 2^32 - 1 rows (GRCh38 fits). The
  index was built with `large=True` (int64 host tables, chosen by the
  builder once the joined text nears 2^31 bp), or its global coordinates
  pass 2^31 (a genome whose references hold long N runs). The device
  tables keep the low 32 bits of each value (int32 tensors with uint32
  bits), `ref_cum` is int64, and at the tensor API rows are int64 tensors
  holding the uint32 values (`FMHalf.row_dtype`); the kernels compute in
  uint32 and wrap where the JAX package's uint32 ops wrap;
- int64: a joined text of 2^32 - 1 bp or more (n + 1 >= 2^32 rows). The
  checkpoints no longer fit fm_blocks' 32-bit columns 8:12 (which keep
  their low 32 bits), so each half carries a second table, `occ_cp64`
  (int64[nblocks, 4], the full checkpoints), read beside the fused row on
  every LF step, and fchr, ftab and offs are int64 tensors holding their
  true values; rows and positions are int64 at the API and in the
  kernels (the `_i64` C entries). `half_from_tables` takes the mode from
  its `occ_cp64` argument, so a genome of any size can be put in it.
`FMHalf.large` is true in both wide modes (rows and positions are int64
tensors), `FMHalf.i64` only in the int64 one.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from bowtie2_tpu_torch.index.build import HalfIndex, IndexData

# the joined-text row count from which FMIndex.from_host takes the int64
# row mode (bowtie2_tpu/index/fmindex.py:100)
INT64_ROWS = 1 << 32


class FMHalf(NamedTuple):
    """One direction's tables. n and z_off are Python ints, so a kernel
    launch reads them without a device round trip."""
    n: int                      # joined text length (BWT has n + 1 rows)
    z_off: int                  # row whose BWT char is the sentinel
    fm_blocks: torch.Tensor     # int32[nblocks, 12]: cols 0:8 BWT words,
                                # cols 8:12 occ checkpoints
    fchr: torch.Tensor          # int32[5]
    ftab: torch.Tensor          # int32[2*4^K + 1]
    mark_rows: torch.Tensor     # int32[nblocks, 5]: cols 0:4 mark bits,
                                # col 4 mark-rank checkpoint
    offs: torch.Tensor          # int32[n_marked]; int64 in the int64 mode
    row_dtype: torch.dtype = torch.int32   # rows at the tensor API: int32,
                                # or int64 (large and int64 modes)
    occ_cp64: Optional[torch.Tensor] = None  # int64[nblocks, 4], the full
                                # checkpoints, only in the int64 mode

    @property
    def nrows(self) -> int:
        return self.n + 1

    @property
    def large(self) -> bool:
        """Rows and positions are int64 tensors at the API: the uint32 row
        space (the `_u32` entries) or the int64 one (the `_i64` entries)."""
        return self.row_dtype == torch.int64

    @property
    def i64(self) -> bool:
        """The int64 row space past 2^32 rows (`occ_cp64` present)."""
        return self.occ_cp64 is not None


class ShardedFMHalf(NamedTuple):
    """FMHalf's twin in the sharded index mode (dist/sharded.py): the big
    tables are ops/fm.py ShardedRows (the owner's row, or zeros), the
    small ones stay whole on the home device. Field names match FMHalf,
    so ops/fm.py and ops/fused.py take either."""
    n: int
    z_off: int
    fm_blocks: object           # ShardedRows of int32[per, 12]
    fchr: torch.Tensor          # int32[5], home device
    ftab: torch.Tensor          # int32[2*4^K + 1], home device
    mark_rows: object           # ShardedRows of int32[per, 5], sharded as
                                # fm_blocks is
    offs: object                # ShardedRows of int32[per_off] (int64
                                # in the int64 mode)
    row_dtype: torch.dtype = torch.int32
    occ_cp64: object = None     # ShardedRows of int64[per, 4], sharded as
                                # fm_blocks is, only in the int64 mode

    @property
    def nrows(self) -> int:
        return self.n + 1

    @property
    def large(self) -> bool:
        return self.row_dtype == torch.int64

    @property
    def i64(self) -> bool:
        return self.occ_cp64 is not None


def _low32(a: np.ndarray) -> np.ndarray:
    """The low 32 bits of each value, as uint32 (int64 tables of the large
    mode wrap; int32 tables keep their bits)."""
    if a.dtype == np.int64:
        return (a & np.int64(0xFFFFFFFF)).astype(np.uint32)
    return a.astype(np.uint32, copy=False)


def pack_fm_blocks(bwt_words: np.ndarray, occ_cp: np.ndarray, nrdt=None):
    """[bwt8|occ4] fusion of one direction's BWT → (uint32[nblocks, 12],
    occ_cp64): the checkpoints keep their low 32 bits in columns 8:12, the
    exact value below 2^32 rows; with an int64 row type `nrdt` the full
    checkpoints come back as occ_cp64 (int64[nblocks, 4]), else None
    (bowtie2_tpu/index/fmindex.py pack_fm_blocks)."""
    nblocks = occ_cp.shape[0]
    fm = np.empty((nblocks, 12), dtype=np.uint32)
    fm[:, :8] = bwt_words.reshape(nblocks, 8).view(np.uint32)
    fm[:, 8:] = _low32(occ_cp)
    occ_cp64 = occ_cp.astype(np.int64, copy=False) \
        if nrdt is not None and np.dtype(nrdt) == np.int64 else None
    return fm, occ_cp64


def pack_mark_rows(mark_words: np.ndarray, mark_cp: np.ndarray) -> np.ndarray:
    """[mark bits (4 words) | rank checkpoint] per block → uint32[nb, 5]."""
    nblocks = mark_words.shape[0]
    rows = np.empty((nblocks, 5), dtype=np.uint32)
    rows[:, :4] = mark_words
    rows[:, 4] = mark_cp.astype(np.uint32, copy=False)
    return rows


def _as_i32(a: np.ndarray, device) -> torch.Tensor:
    """uint32/int32/int64 numpy array → int32 tensor with the bits of each
    value's low 32 (uint32 bits for the large mode's int64 tables)."""
    a = np.ascontiguousarray(_low32(np.asarray(a)))
    return torch.from_numpy(a.view(np.int32)).to(device)


def resolve_device(device) -> torch.device:
    """Entry points take device=None for the card; raise without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "bowtie2_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' explicitly to run "
                "the plain PyTorch versions of the kernels")
        return torch.device("cuda")
    return torch.device(device)


class FMIndex(NamedTuple):
    fw: FMHalf
    bw: Optional[FMHalf]
    ref_words: torch.Tensor     # int32 (uint32 bits): 2-bit global reference
    refn_words: torch.Tensor    # int32 (uint32 bits): N bitmask
    ref_cum: torch.Tensor       # int32[nrefs + 1]; int64 in large mode
    n_ref_total: int

    @staticmethod
    def from_host(data: IndexData, device=None,
                  int64_rows: Optional[bool] = None) -> "FMIndex":
        """The index on `device`, in the row mode its size needs: int64
        rows from 2^32 rows (INT64_ROWS), else large or small (is_large).
        `int64_rows=True` puts any index in the int64 mode, as a genome of
        4.29 Gbp would be (the tests and chip_smoke.py hold it to the
        other modes that way)."""
        device = resolve_device(device)
        if int64_rows is None:
            int64_rows = data.fw.n + 1 >= INT64_ROWS
        large = int64_rows or is_large(data)

        def half(h: HalfIndex):
            if h is None:
                return None
            nblocks = h.occ_cp.shape[0]
            mark = h.mark_words if h.mark_words is not None else \
                np.zeros(nblocks * 4, dtype=np.uint32)
            markcp = h.mark_cp if h.mark_cp is not None else \
                np.zeros(nblocks, dtype=np.int32)
            offs = h.offs if h.offs is not None else np.zeros(1, np.int32)
            fm, occ_cp64 = pack_fm_blocks(
                h.bwt_words, h.occ_cp, np.int64 if int64_rows else None)
            return half_from_tables(
                h.n, h.z_off, fm, h.fchr, h.ftab,
                pack_mark_rows(mark.reshape(nblocks, -1), markcp), offs,
                large, device, occ_cp64=occ_cp64)

        return FMIndex(
            fw=half(data.fw), bw=half(data.bw),
            ref_words=_as_i32(data.ref_words, device),
            refn_words=_as_i32(data.refn_words, device),
            ref_cum=torch.from_numpy(np.asarray(data.ref_cum, np.int64)).to(
                device) if large else _as_i32(data.ref_cum, device),
            n_ref_total=int(data.ref_cum[-1]))


def half_from_tables(n: int, z_off: int, fm_blocks: np.ndarray, fchr,
                     ftab, mark_rows: np.ndarray, offs, large: bool,
                     device, occ_cp64: Optional[np.ndarray] = None
                     ) -> FMHalf:
    """An FMHalf on `device` from packed host tables (fm_blocks uint32[nb,
    12], mark_rows uint32[nb, 5]; fchr, ftab and offs of any integer
    type): with `occ_cp64` (int64[nb, 4], the full checkpoints) in the
    int64 row mode, whose fchr, ftab and offs are int64 tensors of their
    true values; else in the large row mode or the small one."""
    if occ_cp64 is not None:
        def i64(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.asarray(a).astype(np.int64, copy=False))).to(device)
        return FMHalf(
            n=int(n), z_off=int(z_off), fm_blocks=_as_i32(fm_blocks, device),
            fchr=i64(fchr), ftab=i64(ftab),
            mark_rows=_as_i32(mark_rows, device), offs=i64(offs),
            row_dtype=torch.int64, occ_cp64=i64(occ_cp64))
    return FMHalf(
        n=int(n), z_off=int(z_off), fm_blocks=_as_i32(fm_blocks, device),
        fchr=_as_i32(fchr, device), ftab=_as_i32(ftab, device),
        mark_rows=_as_i32(mark_rows, device), offs=_as_i32(offs, device),
        row_dtype=torch.int64 if large else torch.int32)


def row_mode(data: IndexData) -> str:
    """The row mode FMIndex.from_host takes for `data`: "int64", "large"
    (uint32 rows) or "small"."""
    if data.fw.n + 1 >= INT64_ROWS:
        return "int64"
    return "large" if is_large(data) else "small"


def is_large(data: IndexData) -> bool:
    """The uint32 row mode: a forced-large build (int64 host tables) or
    global coordinates past int32 (long N runs, or a joined text near
    2^31 bp). The JAX package's large mode follows the host tables'
    dtype only; on a small-table index whose coordinates pass 2^31 it
    would wrap its int32 reference offsets, so the port takes the large
    mode there, which gives the forced-large build's results."""
    return (data.fw.occ_cp.dtype == np.int64
            or int(data.ref_cum[-1]) >= (1 << 31))
