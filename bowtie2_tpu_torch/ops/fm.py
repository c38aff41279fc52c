"""Batched FM-index searches and SA resolution, in torch + CUDA.

Port of bowtie2_tpu/ops/fm.py. The four loop-shaped ops each run as one
hand-written kernel launch for CUDA tensors (csrc/fm_search.cu: sweep,
substring and seed search; csrc/sa_resolve.cu), sharing one LF step over
the fused [bwt8|occ4] index rows (csrc/fm_common.cuh). Beside each sits
its plain PyTorch version, one torch step per scan step of the JAX op,
taken only for CPU tensors.

Core math (classic FM index, = reference Ebwt::mapLF bt2_idx.h:2313):
    LF(i, c)  = fchr[c] + Occ(c, i)
    Occ(c, i) = #occurrences of c in bwt[0:i)
Occ is the block's checkpoint plus the in-block count over 8 words of
2-bit crumbs; the sentinel row (z_off) stores a spurious 'A' which is
subtracted when (c == 0 and i > z_off).
"""

from typing import NamedTuple, Tuple

import torch

from bowtie2_tpu_torch.constants import OCC_BLOCK
from bowtie2_tpu_torch.index.fmindex import FMHalf
from bowtie2_tpu_torch.ops import _build
from bowtie2_tpu_torch.ops._build import I, P, check, on_cpu, ptr

i32 = torch.int32


class SweepResult(NamedTuple):
    top: torch.Tensor
    bot: torch.Tensor
    nedit: torch.Tensor   # lower bound on edits; 0 → [top,bot) are exact hits


# ---------------------------------------------------------------------------
# plain LF step (K2)
# ---------------------------------------------------------------------------

def _rows(half: FMHalf, block: torch.Tensor) -> torch.Tensor:
    """fm_blocks rows of `block`; rows past the last block read as
    0xFFFFFFFF (jnp.take's fill for an out-of-range uint32 gather, which
    the JAX op reaches at i = n + 1 when n + 1 is a multiple of 128)."""
    nb = half.fm_blocks.shape[0]
    rows = half.fm_blocks.index_select(0, torch.clamp(block, max=nb - 1).long())
    return torch.where((block >= nb)[:, None], -1, rows)


def _crumbs(words: torch.Tensor) -> torch.Tensor:
    """(B, 8) int32 (uint32 bits) → (B, 128) int32 2-bit crumbs."""
    sh = 2 * torch.arange(16, dtype=i32, device=words.device)
    return ((words[:, :, None] >> sh) & 3).reshape(words.shape[0], OCC_BLOCK)


def _occ_rows(half: FMHalf, i: torch.Tensor, c: torch.Tensor, rows):
    lane = torch.arange(OCC_BLOCK, dtype=i32, device=i.device)[None, :]
    pos = i % OCC_BLOCK
    crumbs = _crumbs(rows[:, :8])
    inb = ((crumbs == c[:, None]) & (lane < pos[:, None])).sum(dim=1)
    cp = rows[:, 8:12].gather(1, c.long()[:, None])[:, 0]
    corr = ((c == 0) & (i > half.z_off)).to(i32)
    return (cp + inb - corr).to(i32)


def occ_batch(half: FMHalf, i: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """#occurrences of per-state char c (0..3) in bwt[0:i). i, c: (B,)."""
    i = i.to(i32)
    c = c.to(i32)
    return _occ_rows(half, i, c, _rows(half, i // OCC_BLOCK))


def lf_batch(half: FMHalf, i: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Batched LF mapping (reference mapLF). i, c: (B,)."""
    c = c.to(i32)
    return (half.fchr.index_select(0, c.long()) + occ_batch(half, i, c)).to(i32)


def ftab_lookup_batch(half: FMHalf, keys: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched ftab range lookup. keys: (B,) base-4 ints (first K chars)."""
    k = keys.long()
    return half.ftab.index_select(0, 2 * k + 1), half.ftab.index_select(0, 2 * k + 2)


def _lf2(half, top, bot, cc):
    """One LF step of both range ends (the JAX ops concatenate them)."""
    both = lf_batch(half, torch.cat([top, bot]), torch.cat([cc, cc]))
    return both[:top.shape[0]], both[top.shape[0]:]


def _fm_args(half: FMHalf):
    return (ptr(half.fm_blocks), half.fm_blocks.shape[0], ptr(half.fchr),
            half.z_off, half.nrows)


def _check_half(half: FMHalf, dev) -> None:
    check(half.fm_blocks, "fm_blocks", device=dev)
    check(half.fchr, "fchr", shape=(5,), device=dev)


# ---------------------------------------------------------------------------
# exact sweep (K3): backward search of the whole read, restart on empty
# ---------------------------------------------------------------------------

def _sweep_plain(half: FMHalf, rr: torch.Tensor) -> SweepResult:
    B, L = rr.shape
    top = torch.zeros(B, dtype=i32, device=rr.device)
    bot = torch.full((B,), half.nrows, dtype=i32, device=rr.device)
    nedit = torch.zeros(B, dtype=i32, device=rr.device)
    for p in range(L):
        c = rr[:, p]
        active = c < 5
        is_n = c >= 4
        ntop, nbot = _lf2(half, top, bot, torch.clamp(c, 0, 3))
        empty = (ntop >= nbot) | is_n
        top2 = torch.where(empty, 0, ntop)
        bot2 = torch.where(empty, half.nrows, nbot)
        top = torch.where(active, top2, top)
        bot = torch.where(active, bot2, bot)
        nedit = torch.where(active, nedit + empty.to(i32), nedit)
    return SweepResult(top, bot, nedit)


def exact_sweep_rr(half: FMHalf, rr: torch.Tensor) -> SweepResult:
    """Exact end-to-end sweep on a pre-reversed char stream (rr[:, p] =
    read[len-1-p], 5 = inactive). (B,) top/bot/nedit; nedit == 0 with a
    nonempty range means [top, bot) are exact hits."""
    rr = rr.to(i32).contiguous()
    if on_cpu(rr, "fm_sweep"):
        return _sweep_plain(half, rr)
    dev = rr.device
    _check_half(half, dev)
    B, L = rr.shape
    out = torch.empty((3, B), dtype=i32, device=dev)
    _build.call("fm_search", "fm_sweep", [P, I, P, I, I, P, I, I, P, P, P],
                *_fm_args(half), ptr(rr), B, L,
                ptr(out[0]), ptr(out[1]), ptr(out[2]))
    return SweepResult(out[0], out[1], out[2])


def _reverse_stream(reads: torch.Tensor, lengths: torch.Tensor):
    """rr[:, p] = reads[len-1-p] for p < len, 5 past the length."""
    B, L = reads.shape
    pos = lengths.to(i32)[:, None] - 1 - torch.arange(L, dtype=i32,
                                                      device=reads.device)
    rr = reads.to(i32).gather(1, torch.clamp(pos, 0, L - 1).long())
    return torch.where(pos >= 0, rr, 5)


def exact_sweep(half: FMHalf, reads: torch.Tensor, lengths: torch.Tensor
                ) -> SweepResult:
    """Batched exact sweep. reads: (B, Lmax) int codes (4=N); lengths: (B,)."""
    return exact_sweep_rr(half, _reverse_stream(reads, lengths))


# ---------------------------------------------------------------------------
# substring search (K5): like the sweep, but an empty range kills the state
# ---------------------------------------------------------------------------

def _substring_plain(half: FMHalf, rr: torch.Tensor):
    B, L = rr.shape
    top = torch.zeros(B, dtype=i32, device=rr.device)
    bot = torch.full((B,), half.nrows, dtype=i32, device=rr.device)
    for p in range(L):
        c = rr[:, p]
        active = c < 5
        dead = (c >= 4) | ~(top < bot)
        ntop, nbot = _lf2(half, top, bot, torch.clamp(c, 0, 3))
        top = torch.where(active, torch.where(dead, 1, ntop), top)
        bot = torch.where(active, torch.where(dead, 0, nbot), bot)
    return top, torch.maximum(top, bot)


def substring_search_rr(half: FMHalf, rr: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward exact search of pre-reversed strings (rr[:, p] =
    s[len-1-p], 5 = inactive). Returns (top, bot); empty: top >= bot."""
    rr = rr.to(i32).contiguous()
    if on_cpu(rr, "fm_substring"):
        return _substring_plain(half, rr)
    dev = rr.device
    _check_half(half, dev)
    B, L = rr.shape
    out = torch.empty((2, B), dtype=i32, device=dev)
    _build.call("fm_search", "fm_substring", [P, I, P, I, I, P, I, I, P, P],
                *_fm_args(half), ptr(rr), B, L, ptr(out[0]), ptr(out[1]))
    return out[0], out[1]


def substring_search(half: FMHalf, seqs: torch.Tensor, lengths: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward exact search of variable-length strings. seqs: (B, Lmax)
    int codes (4=N); lengths: (B,). Empty ranges have top >= bot."""
    return substring_search_rr(half, _reverse_stream(seqs, lengths))


# ---------------------------------------------------------------------------
# exact seed search (K4): fixed-length seeds, ftab-seeded, no restart
# ---------------------------------------------------------------------------

def _seed_plain(half: FMHalf, seeds, valid, seed_len: int, K: int):
    B = seeds.shape[0]
    dev = seeds.device

    def step(top, bot, c):
        dead = (c >= 4) | ~(top < bot)
        ntop, nbot = _lf2(half, top, bot, torch.clamp(c, 0, 3))
        return torch.where(dead, 1, ntop), torch.where(dead, 0, nbot)

    if 0 < K <= seed_len:
        tail = seeds[:, seed_len - K:]
        has_n = (tail >= 4).any(dim=1)
        weights = 4 ** torch.arange(K - 1, -1, -1, dtype=i32, device=dev)
        key = (torch.clamp(tail, 0, 3) * weights).sum(dim=1)
        top0, bot0 = ftab_lookup_batch(half, key)
        ok = valid & ~has_n
        top = torch.where(ok, top0, 1)
        bot = torch.where(ok, bot0, 0)
        for q in range(seed_len - K - 1, -1, -1):
            top, bot = step(top, bot, seeds[:, q])
    else:
        top = torch.zeros(B, dtype=i32, device=dev)
        bot = torch.where(valid, half.nrows, 0).to(i32)
        for q in range(seed_len - 1, -1, -1):
            top, bot = step(top, bot, seeds[:, q])
    return top.to(i32), torch.maximum(top, bot).to(i32)


def seed_search_exact(half: FMHalf, seeds: torch.Tensor, valid: torch.Tensor,
                      seed_len: int, ftab_chars: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched exact seed search. seeds: (B, seed_len); valid: (B,) bool.
    Returns (top, bot); empty ranges have top == bot. With ftab_chars = K
    (0 < K <= seed_len) the last K chars are one ftab lookup (reference
    ftabLoHi, bt2_idx.h:1476) and seed_len - K LF steps follow."""
    seeds = seeds.to(i32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    if on_cpu(seeds, "fm_seed"):
        return _seed_plain(half, seeds, valid, seed_len, ftab_chars)
    dev = seeds.device
    _check_half(half, dev)
    check(half.ftab, "ftab", device=dev)
    B = seeds.shape[0]
    check(seeds, "seeds", shape=(B, seed_len))
    check(valid, "valid", dtype=torch.bool, shape=(B,), device=dev)
    out = torch.empty((2, B), dtype=i32, device=dev)
    _build.call("fm_search", "fm_seed",
                [P, I, P, I, I, P, P, P, I, I, I, P, P],
                *_fm_args(half), ptr(half.ftab), ptr(seeds), ptr(valid),
                B, seed_len, ftab_chars, ptr(out[0]), ptr(out[1]))
    return out[0], out[1]


def seed_search_offsets(half: FMHalf, reads: torch.Tensor, offs: torch.Tensor,
                        valid: torch.Tensor, seed_len: int,
                        ftab_chars: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extract seed windows on the device, then batch-search them.
    reads: (B, Lmax); offs/valid: (B, smax) window starts / validity.
    Returns (top, bot) each (B*smax,); windows holding N die in the
    search itself."""
    Lmax = reads.shape[1]
    idx = torch.clamp(offs.to(i32)[:, :, None]
                      + torch.arange(seed_len, dtype=i32, device=offs.device),
                      max=Lmax - 1).reshape(offs.shape[0], -1)
    seeds = reads.to(i32).gather(1, idx.long()).reshape(-1, seed_len)
    return seed_search_exact(half, seeds, valid.reshape(-1), seed_len,
                             ftab_chars)


# ---------------------------------------------------------------------------
# SA-offset resolution (K6): LF-walk to a marked row, then offs[rank]
# ---------------------------------------------------------------------------

def _mark_bits(half: FMHalf, block: torch.Tensor):
    """(B,) block ids → ((B, 128) int32 0/1 mark bits, (B,) rank cp)."""
    rows = half.mark_rows.index_select(0, block.long())
    sh = torch.arange(32, dtype=i32, device=block.device)
    bits = (rows[:, :4, None] >> sh) & 1
    return bits.reshape(-1, OCC_BLOCK), rows[:, 4]


def _resolve_plain(half: FMHalf, rows: torch.Tensor, period: int):
    B = rows.shape[0]
    dev = rows.device
    lane = torch.arange(OCC_BLOCK, dtype=i32, device=dev)[None, :]
    row = rows.clone()
    steps = torch.zeros(B, dtype=i32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(period):
        block = row // OCC_BLOCK
        pos = (row % OCC_BLOCK)[:, None]
        frows = _rows(half, block)
        c = _crumbs(frows[:, :8]).gather(1, pos.long())[:, 0]
        mbits, _ = _mark_bits(half, block)
        marked = mbits.gather(1, pos.long())[:, 0] == 1
        done = done | marked
        nrow = half.fchr.index_select(0, c.long()) + _occ_rows(half, row, c, frows)
        row = torch.where(done, row, nrow).to(i32)
        steps = torch.where(done, steps, steps + 1)
    block = row // OCC_BLOCK
    pos = row % OCC_BLOCK
    bits, mcp = _mark_bits(half, block)
    rank = mcp + (bits * (lane < pos[:, None])).sum(dim=1)
    return (half.offs.index_select(0, rank.long()) + steps).to(i32)


def sa_resolve(half: FMHalf, rows: torch.Tensor, period: int = 32
               ) -> torch.Tensor:
    """Batched BWT row → joined text offset. rows: (B,) int32."""
    rows = rows.to(i32).contiguous()
    if on_cpu(rows, "sa_resolve"):
        return _resolve_plain(half, rows, period)
    dev = rows.device
    _check_half(half, dev)
    check(half.mark_rows, "mark_rows", device=dev)
    check(half.offs, "offs", device=dev)
    B = rows.shape[0]
    out = torch.empty(B, dtype=i32, device=dev)
    _build.call("sa_resolve", "sa_resolve", [P, I, P, I, P, P, I, P, I, I, P],
                ptr(half.fm_blocks), half.fm_blocks.shape[0], ptr(half.fchr),
                half.z_off, ptr(half.mark_rows), ptr(half.offs),
                half.offs.shape[0], ptr(rows), B, period, ptr(out))
    return out
