"""Reference-window materialization on the device (K7).

Port of bowtie2_tpu/ops/ref.py (BitPairReference::getStretch,
reference.h:98-111): for each DP candidate, expand a window of 2-bit packed
reference into codes 0..5, where 4 = N (from the ambiguity bitmask) and
5 = outside the candidate's reference sequence. Window positions are in
global reference space (index/build.py IndexData): int32 in the small
index mode, int64 in the large mode, whose global coordinates may pass
2^31 (word indices, below 2^28, are the same values either way).

Both forms are one CUDA kernel each on the card (csrc/ref_gather.cu: the
aligned form `ref_gather_aligned`, `_sh` over sharded word tables; the
unaligned form `ref_gather`); their plain PyTorch versions, a word gather
and unpack as the JAX ops compute it, run only for CPU tensors.

In the sharded index mode the word tables are `ShardedWords`:
`gather_windows_aligned` takes them (the kernel reads each word from the
shard that owns it; the plain version gathers them with K12, ops/fm.py
take_sharded), `gather_windows` does not, as in the JAX package.
"""

import ctypes
from typing import NamedTuple

import torch

from bowtie2_tpu_torch.ops import _build
from bowtie2_tpu_torch.ops._build import I, P, check, on_cpu, ptr
from bowtie2_tpu_torch.ops.fm import ShardedRows, take_sharded

i32 = torch.int32


class ShardedWords(NamedTuple):
    """A word table (ref_words or refn_words) split over the shards of the
    sharded index mode (dist/sharded.py)."""
    words: ShardedRows


def _positions(starts: torch.Tensor) -> torch.Tensor:
    """Window starts in their mode's type: int64 stays, else int32."""
    return starts if starts.dtype == torch.int64 else starts.to(i32)


def _take_words(table, idx: torch.Tensor) -> torch.Tensor:
    """Word gather clipped to the table: windows near reference edges run
    past either end, and their codes are masked to 5 by the callers. On
    ShardedWords, not clipped: a word no shard owns is 0 (base A, masked
    the same way), as the JAX package's sharded gather gives it."""
    if isinstance(table, ShardedWords):
        return take_sharded(table.words, idx)
    flat = torch.clamp(idx, 0, table.shape[0] - 1).long().reshape(-1)
    return table.index_select(0, flat).reshape(idx.shape)


def _unpack(words: torch.Tensor, bits: int) -> torch.Tensor:
    """(B, n) int32 words → (B, n * 32 // bits) fields of `bits` bits."""
    per = 32 // bits
    sh = bits * torch.arange(per, dtype=i32, device=words.device)
    return ((words[:, :, None] >> sh) & ((1 << bits) - 1)).reshape(
        words.shape[0], -1)


def _tables(ref_words, refn_words, starts, lo, hi):
    """A kernel call's checked arguments: the starts in their mode's type,
    lo and hi in the same type, all on the tables' card."""
    starts = _positions(starts).contiguous()
    dev = starts.device
    for name, t in (("ref_words", ref_words), ("refn_words", refn_words)):
        rows = t.words.addrs if isinstance(t, ShardedWords) else t
        check(rows, name, dtype=torch.int64 if isinstance(
            t, ShardedWords) else torch.int32, device=dev)
    lo = check(lo.to(starts.dtype).contiguous(), "lo", dtype=starts.dtype,
               shape=starts.shape, device=dev)
    hi = check(hi.to(starts.dtype).contiguous(), "hi", dtype=starts.dtype,
               shape=starts.shape, device=dev)
    return starts, lo, hi


def _gather_windows_plain(ref_words, refn_words, starts, lo, hi, width):
    """The plain unaligned gather, as the JAX op computes it. A start
    below -2^24 has its word index clamped there (the JAX op's clip), so
    its first codes' in-row offsets fall below 0: they read the row's first
    word, and those positions lie outside any reference (code 5)."""
    dev = starts.device
    starts = _positions(starts)
    ar_w = torch.arange(width, dtype=i32, device=dev)[None, :]
    nw = width // 16 + 2
    wstart = torch.clamp(starts, min=-(1 << 24)) >> 4
    widx = wstart[:, None] + torch.arange(nw, dtype=i32, device=dev)[None, :]
    crumbs = _unpack(_take_words(ref_words, widx), 2)
    off = (starts - (wstart << 4))[:, None]
    code = crumbs.gather(1, torch.clamp(off + ar_w, min=0).long())

    nn = width // 32 + 2
    nstart = wstart >> 1
    nidx = nstart[:, None] + torch.arange(nn, dtype=i32, device=dev)[None, :]
    nbits = _unpack(_take_words(refn_words, nidx), 1)
    noff = (starts - (nstart << 5))[:, None]
    is_n = nbits.gather(1, torch.clamp(noff + ar_w, min=0).long()) == 1
    code = torch.where(is_n, 4, code)

    pos = starts[:, None] + ar_w
    oob = (pos < lo[:, None]) | (pos >= hi[:, None])
    return torch.where(oob, 5, code).to(i32)


def gather_windows(ref_words: torch.Tensor, refn_words: torch.Tensor,
                   starts: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   width: int) -> torch.Tensor:
    """starts/lo/hi: (B,) global positions (int32, or int64 in the large
    mode) → (B, width) int32 codes; positions outside [lo, hi) are code 5.
    The word tables are whole (the JAX op's plain take): ShardedWords
    raise. A CUDA tensor launches `ref_gather`."""
    if isinstance(ref_words, ShardedWords) or \
            isinstance(refn_words, ShardedWords):
        raise TypeError("gather_windows reads whole word tables; sharded "
                        "ones go through gather_windows_aligned")
    if on_cpu(starts, "ref_gather"):
        return _gather_windows_plain(ref_words, refn_words, starts, lo, hi,
                                     width)
    starts, lo, hi = _tables(ref_words, refn_words, starts, lo, hi)
    B = starts.shape[0]
    out = torch.empty((B, width), dtype=i32, device=starts.device)
    _build.call("ref_gather", "ref_gather",
                [P, ctypes.c_longlong, P, ctypes.c_longlong, P, P, P, I,
                 ctypes.c_longlong, ctypes.c_longlong, P],
                ptr(ref_words), ref_words.shape[0], ptr(refn_words),
                refn_words.shape[0], ptr(starts), ptr(lo), ptr(hi),
                int(starts.dtype == torch.int64), B, width, ptr(out))
    return out


def aligned_width(width: int) -> int:
    """Gathered width of a `gather_windows_aligned` row for a rect width:
    covers width + 31 shift columns and is a multiple of 32."""
    return 32 * ((width + 31 + 31) // 32)


def _gather_windows_aligned_plain(ref_words, refn_words, starts, lo, hi,
                                  width):
    """The plain aligned gather, as the JAX op computes it."""
    dev = starts.device
    starts = _positions(starts)
    Wa = aligned_width(width)
    astart = starts & ~31
    col_shift = starts - astart
    wstart = astart >> 4
    widx = wstart[:, None] + torch.arange(Wa // 16, dtype=i32,
                                          device=dev)[None, :]
    code = _unpack(_take_words(ref_words, widx), 2)
    nidx = (astart >> 5)[:, None] + torch.arange(Wa // 32, dtype=i32,
                                                 device=dev)[None, :]
    nbits = _unpack(_take_words(refn_words, nidx), 1)
    code = torch.where(nbits == 1, 4, code)
    pos = astart[:, None] + torch.arange(Wa, dtype=i32, device=dev)[None, :]
    oob = (pos < lo[:, None]) | (pos >= hi[:, None]) \
        | (pos < starts[:, None])
    return torch.where(oob, 5, code).to(i32), col_shift.to(i32)


def gather_windows_aligned(ref_words: torch.Tensor, refn_words: torch.Tensor,
                           starts: torch.Tensor, lo: torch.Tensor,
                           hi: torch.Tensor, width: int):
    """Word-aligned gather: the row begins at `starts & ~31`, so the
    unpacked crumbs and N bits are the window with no realignment.

    Returns (win (B, Wa) codes with Wa = aligned_width(width), col_shift
    (B,) in [0, 32)); the rect's columns live at [col_shift, col_shift +
    width). Positions outside [lo, hi) or left of `starts` are code 5. A
    CUDA tensor launches `ref_gather_aligned`, or `ref_gather_aligned_sh`
    over ShardedWords (both tables sharded)."""
    sharded = isinstance(ref_words, ShardedWords)
    if on_cpu(starts, "ref_gather_aligned_sh" if sharded
              else "ref_gather_aligned"):
        return _gather_windows_aligned_plain(ref_words, refn_words, starts,
                                             lo, hi, width)
    if sharded != isinstance(refn_words, ShardedWords):
        raise TypeError("gather_windows_aligned: both word tables sharded, "
                        "or neither")
    starts, lo, hi = _tables(ref_words, refn_words, starts, lo, hi)
    B, Wa = starts.shape[0], aligned_width(width)
    win = torch.empty((B, Wa), dtype=i32, device=starts.device)
    shift = torch.empty(B, dtype=i32, device=starts.device)
    if sharded:
        w, n = ref_words.words, refn_words.words
        tabs = [P, I, I, P, I, I]
        targs = (ptr(w.addrs), w.per, w.S, ptr(n.addrs), n.per, n.S)
        entry = "ref_gather_aligned_sh"
    else:
        tabs = [P, ctypes.c_longlong, P, ctypes.c_longlong]
        targs = (ptr(ref_words), ref_words.shape[0], ptr(refn_words),
                 refn_words.shape[0])
        entry = "ref_gather_aligned"
    _build.call("ref_gather", entry,
                tabs + [P, P, P, I, ctypes.c_longlong, I, P, P],
                *targs, ptr(starts), ptr(lo), ptr(hi),
                int(starts.dtype == torch.int64), B, Wa, ptr(win),
                ptr(shift))
    return win, shift
