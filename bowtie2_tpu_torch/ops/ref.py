"""Reference-window materialization on the device, as torch ops.

Port of bowtie2_tpu/ops/ref.py (BitPairReference::getStretch,
reference.h:98-111): for each DP candidate, expand a window of 2-bit packed
reference into codes 0..5, where 4 = N (from the ambiguity bitmask) and
5 = outside the candidate's reference sequence. One word gather plus
shifts and masks, no loop: these stay plain torch ops on every device.
Window positions are in global reference space (index/build.py IndexData).
"""

import torch

i32 = torch.int32


def _take_words(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Word gather clipped to the table: windows near reference edges run
    past either end, and their codes are masked to 5 by the callers."""
    flat = torch.clamp(idx, 0, table.shape[0] - 1).long().reshape(-1)
    return table.index_select(0, flat).reshape(idx.shape)


def _unpack(words: torch.Tensor, bits: int) -> torch.Tensor:
    """(B, n) int32 words → (B, n * 32 // bits) fields of `bits` bits."""
    per = 32 // bits
    sh = bits * torch.arange(per, dtype=i32, device=words.device)
    return ((words[:, :, None] >> sh) & ((1 << bits) - 1)).reshape(
        words.shape[0], -1)


def gather_windows(ref_words: torch.Tensor, refn_words: torch.Tensor,
                   starts: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   width: int) -> torch.Tensor:
    """starts/lo/hi: (B,) int32 global positions → (B, width) int32 codes;
    positions outside [lo, hi) are code 5."""
    dev = starts.device
    starts = starts.to(i32)
    ar_w = torch.arange(width, dtype=i32, device=dev)[None, :]
    nw = width // 16 + 2
    wstart = torch.clamp(starts, min=-(1 << 24)) >> 4
    widx = wstart[:, None] + torch.arange(nw, dtype=i32, device=dev)[None, :]
    crumbs = _unpack(_take_words(ref_words, widx), 2)
    off = (starts - (wstart << 4))[:, None]
    code = crumbs.gather(1, (off + ar_w).long())

    nn = width // 32 + 2
    nstart = wstart >> 1
    nidx = nstart[:, None] + torch.arange(nn, dtype=i32, device=dev)[None, :]
    nbits = _unpack(_take_words(refn_words, nidx), 1)
    noff = (starts - (nstart << 5))[:, None]
    is_n = nbits.gather(1, (noff + ar_w).long()) == 1
    code = torch.where(is_n, 4, code)

    pos = starts[:, None] + ar_w
    oob = (pos < lo[:, None]) | (pos >= hi[:, None])
    return torch.where(oob, 5, code).to(i32)


def aligned_width(width: int) -> int:
    """Gathered width of a `gather_windows_aligned` row for a rect width:
    covers width + 31 shift columns and is a multiple of 32."""
    return 32 * ((width + 31 + 31) // 32)


def gather_windows_aligned(ref_words: torch.Tensor, refn_words: torch.Tensor,
                           starts: torch.Tensor, lo: torch.Tensor,
                           hi: torch.Tensor, width: int):
    """Word-aligned gather: the row begins at `starts & ~31`, so the
    unpacked crumbs and N bits are the window with no realignment.

    Returns (win (B, Wa) codes with Wa = aligned_width(width), col_shift
    (B,) in [0, 32)); the rect's columns live at [col_shift, col_shift +
    width). Positions outside [lo, hi) or left of `starts` are code 5."""
    dev = starts.device
    starts = starts.to(i32)
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
