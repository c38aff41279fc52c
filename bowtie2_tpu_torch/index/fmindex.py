"""Device-resident FM index as torch tensors.

`FMIndex.from_host` turns the numpy `IndexData` that `index/build.py`
loads into the tables the kernels read. The layout is the JAX package's,
bit for bit: `fm_blocks` packs the 8 BWT words and the 4 occ checkpoints
of one 128-bp block into one 48-byte row, so an LF step is one row load;
`mark_rows` packs the SA-sample mark bits of a block with their rank
checkpoint. Tables the JAX package keeps as uint32 are int32 tensors here
with the same bits (torch has thin uint32 coverage; the kernels read them
as uint32).

Only the int32 row mode exists in the port so far: a joined text of 2^31
bp or more (the index's int64 ".bt2l"-analog mode) raises.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from bowtie2_tpu_torch.index.build import HalfIndex, IndexData

LARGE_INDEX_ITEM = ("ROADMAP.md queue 1, 'large (uint32/int64 row) index "
                    "mode'")


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
    offs: torch.Tensor          # int32[n_marked]

    @property
    def nrows(self) -> int:
        return self.n + 1


def pack_fm_blocks(bwt_words: np.ndarray, occ_cp: np.ndarray) -> np.ndarray:
    """[bwt8|occ4] fusion of one direction's BWT → uint32[nblocks, 12]."""
    nblocks = occ_cp.shape[0]
    fm = np.empty((nblocks, 12), dtype=np.uint32)
    fm[:, :8] = bwt_words.reshape(nblocks, 8).view(np.uint32)
    fm[:, 8:] = occ_cp.astype(np.uint32, copy=False)
    return fm


def pack_mark_rows(mark_words: np.ndarray, mark_cp: np.ndarray) -> np.ndarray:
    """[mark bits (4 words) | rank checkpoint] per block → uint32[nb, 5]."""
    nblocks = mark_words.shape[0]
    rows = np.empty((nblocks, 5), dtype=np.uint32)
    rows[:, :4] = mark_words
    rows[:, 4] = mark_cp.astype(np.uint32, copy=False)
    return rows


def _as_i32(a: np.ndarray, device) -> torch.Tensor:
    """uint32/int32 numpy array → int32 tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)


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
    ref_cum: torch.Tensor       # int32[nrefs + 1]
    n_ref_total: int

    @staticmethod
    def from_host(data: IndexData, device=None) -> "FMIndex":
        device = resolve_device(device)
        if data.fw.occ_cp.dtype == np.int64 or data.fw.n + 1 >= (1 << 31) \
                or int(data.ref_cum[-1]) >= (1 << 31):
            raise NotImplementedError(
                "a genome of 2^31 bp or more needs the large index mode, not "
                f"yet ported: see {LARGE_INDEX_ITEM}")

        def half(h: HalfIndex):
            if h is None:
                return None
            nblocks = h.occ_cp.shape[0]
            mark = h.mark_words if h.mark_words is not None else \
                np.zeros(nblocks * 4, dtype=np.uint32)
            markcp = h.mark_cp if h.mark_cp is not None else \
                np.zeros(nblocks, dtype=np.int32)
            offs = h.offs if h.offs is not None else np.zeros(1, np.int32)
            return FMHalf(
                n=int(h.n), z_off=int(h.z_off),
                fm_blocks=_as_i32(pack_fm_blocks(h.bwt_words, h.occ_cp),
                                  device),
                fchr=_as_i32(h.fchr, device),
                ftab=_as_i32(h.ftab, device),
                mark_rows=_as_i32(pack_mark_rows(mark.reshape(nblocks, -1),
                                                 markcp), device),
                offs=_as_i32(offs, device))

        return FMIndex(
            fw=half(data.fw), bw=half(data.bw),
            ref_words=_as_i32(data.ref_words, device),
            refn_words=_as_i32(data.refn_words, device),
            ref_cum=_as_i32(data.ref_cum, device),
            n_ref_total=int(data.ref_cum[-1]))
