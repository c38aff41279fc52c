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

Rows follow the index's row mode (index/fmindex.py): int32 tensors in the
small mode, int64 tensors holding uint32 values in the large mode, whose
plain versions compute in int64 and wrap to 32 bits where the JAX
package's uint32 ops wrap (`_wrap`), and whose kernels are the `_u32`
C entries, the same sources computing in uint32; int64 tensors of int64
values in the int64 mode past 2^32 rows, whose checkpoints come from the
second table `occ_cp64` (a row past the flat table reads as INT64_MIN
there, as jnp.take fills an int64 table), and whose kernels are the
`_i64` C entries, computing in int64.

The sharded index mode (dist/sharded.py, the JAX package's `shard_mesh`):
an index half whose fm_blocks, mark_rows and offs are `ShardedRows`
(index/fmindex.py ShardedFMHalf) reads each row from the shard that owns
it, and zeros where no shard does (`_take_sharded`, K12), inside the
plain versions and, on the card, inside the searches' own LF loops (the
`_sh` C entries, with `_sh_u32` twins). `take_sharded` is K12 alone
(csrc/take_sharded.cu): the plain window gather's word gather over
sharded tables (ops/ref.py); on the card the window gather's kernel reads
the shards itself (`ref_gather_aligned_sh`).
"""

import ctypes
from typing import NamedTuple, Tuple

import torch

from bowtie2_tpu_torch.constants import OCC_BLOCK
from bowtie2_tpu_torch.index.fmindex import FMHalf
from bowtie2_tpu_torch.ops import _build
from bowtie2_tpu_torch.ops._build import I, P, U, check, on_cpu, ptr

i32 = torch.int32
MASK32 = 0xFFFFFFFF
INT64_MIN = -(1 << 63)
LL = ctypes.c_longlong

# the mesh axis of the sharded index mode (dist/mesh.py Mesh.axis)
SHARD_AXIS = "shard"


class SweepResult(NamedTuple):
    top: torch.Tensor
    bot: torch.Tensor
    nedit: torch.Tensor   # lower bound on edits; 0 → [top,bot) are exact hits


# ---------------------------------------------------------------------------
# sharded tables (K12)
# ---------------------------------------------------------------------------

class ShardedRows(NamedTuple):
    """A table split by rows over S shards (the sharded index mode): shard
    s holds the global rows [s per, (s + 1) per) of the table padded with
    zero rows to S per, as its own tensor (int32 words, any trailing
    shape), on its own device. `addrs` holds the shards' addresses on the
    home device, the device whose kernels read the table; it is built
    once, and the shards live as long as it does."""
    shards: Tuple[torch.Tensor, ...]
    per: int
    addrs: torch.Tensor

    @property
    def S(self) -> int:
        return len(self.shards)

    @property
    def row_words(self) -> int:
        return self.shards[0][0].numel()


def shard_rows(table: torch.Tensor, devices, home) -> ShardedRows:
    """Split `table` (on any device) into len(devices) shards of its rows,
    padded with zero rows to a multiple of the count (the JAX package's
    _pad_to / _ceil_to, dist/sharded.py:71-80), shard s on devices[s] as a
    separate allocation, and their addresses on `home`."""
    S = len(devices)
    n = table.shape[0]
    per = -(-n // S)
    shards = []
    for s, dev in enumerate(devices):
        part = torch.zeros((per,) + tuple(table.shape[1:]), dtype=table.dtype,
                           device=dev)
        lo, hi = min(s * per, n), min((s + 1) * per, n)
        part[:hi - lo] = table[lo:hi].to(dev)
        shards.append(part)
    addrs = torch.tensor([t.data_ptr() for t in shards], dtype=torch.int64,
                         device=home)
    return ShardedRows(tuple(shards), per, addrs)


def _take_sharded(rows: ShardedRows, idx: torch.Tensor) -> torch.Tensor:
    """The plain K12, as the JAX op computes it (ops/fm.py:55): each shard
    gathers the indices it owns (clipped for the take, then masked to
    zeros) and the results are summed over the shards. The owner's row,
    or zeros where no shard owns the index; on idx's device, shape
    idx.shape + a row's shape. (The JAX op takes each shard's offset in
    int32; no int32 index reaches a wrap there, since the padded table
    has fewer than 2^31 rows: the offsets here are int64.)"""
    g = idx.long()
    out = None
    for s, t in enumerate(rows.shards):
        loc = g - s * rows.per
        inb = (loc >= 0) & (loc < rows.per)
        got = t.to(idx.device).index_select(
            0, torch.clamp(loc, 0, rows.per - 1).reshape(-1)).reshape(
            idx.shape + t.shape[1:])
        got = torch.where(inb.reshape(inb.shape + (1,) * (got.dim()
                                                          - inb.dim())),
                          got, 0)
        out = got if out is None else out + got
    return out


def take_sharded(rows: ShardedRows, idx: torch.Tensor) -> torch.Tensor:
    """Owner's row of each global index, or zeros where no shard owns it
    (K12). idx: int32 or int64, any shape. Returns int32 words of shape
    idx.shape + a row's shape, on idx's device; a CUDA index launches the
    kernel over the shards' address array, which must be on its card."""
    idx = idx.contiguous()
    if on_cpu(idx, "take_sharded"):
        return _take_sharded(rows, idx)
    dev = idx.device
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"take_sharded: int32 or int64 indices, not "
                        f"{idx.dtype}")
    check(rows.addrs, "shard addresses", dtype=torch.int64, device=dev)
    rw = rows.row_words
    out = torch.empty(tuple(idx.shape) + tuple(rows.shards[0].shape[1:]),
                      dtype=i32, device=dev)
    vec = 4 if rw % 4 == 0 and all(t.data_ptr() % 16 == 0
                                   for t in rows.shards) else 1
    _build.call("take_sharded", "take_sharded",
                [P, ctypes.c_longlong, I, I, I, P, I, ctypes.c_longlong, P],
                ptr(rows.addrs), rows.per, rows.S, rw, vec, ptr(idx),
                int(idx.dtype == torch.int64), idx.numel(), ptr(out))
    return out


def _sharded(half) -> bool:
    return isinstance(half.fm_blocks, ShardedRows)


# ---------------------------------------------------------------------------
# plain LF step (K2)
# ---------------------------------------------------------------------------

def _rows(half: FMHalf, block: torch.Tensor, table=None, fill=-1
          ) -> torch.Tensor:
    """Rows of `block` of fm_blocks (or of `table`) as jnp.take gives them:
    a negative block counts from the end, and rows outside the table read
    as `fill` (0xFFFFFFFF in fm_blocks' int32 bits; INT64_MIN in the int64
    occ_cp64). The JAX op reaches i = n + 1 when n + 1 is a multiple of
    128, and the searches that die take a LF step of a dead range, whose
    bot may be -1, and mask it off. A sharded half reads the owner's row,
    or zeros (_take_sharded). The block is the JAX op's: its int32
    image."""
    table = half.fm_blocks if table is None else table
    block = _block32(block)
    if _sharded(half):
        return _take_sharded(table, block)
    nb = table.shape[0]
    block = torch.where(block < 0, block + nb, block)
    rows = table.index_select(0, torch.clamp(block, 0, nb - 1).long())
    return torch.where(((block < 0) | (block >= nb))[:, None], fill, rows)


def _block32(block: torch.Tensor) -> torch.Tensor:
    """The int32 image of a block index (the JAX ops' astype(int32)); int32
    blocks as they are."""
    if block.dtype == torch.int64:
        return ((block + (1 << 31)) & MASK32) - (1 << 31)
    return block


def _cps(half: FMHalf, i: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(B, 4) occ checkpoints of row i's block in the row type: columns
    8:12 of its fm_blocks row `rows`, or in the int64 mode the block's
    occ_cp64 row."""
    if half.i64:
        return _rows(half, i // OCC_BLOCK, half.occ_cp64, INT64_MIN)
    return _val(half, rows[:, 8:12])


def _wrap(half: FMHalf, x: torch.Tensor) -> torch.Tensor:
    """A row-type result: x mod 2^32 in the large mode (JAX's uint32 ops
    wrap there), int32 in the small mode (whose int32 ops wrap), x itself
    in the int64 mode (int64 adds wrap alike)."""
    if half.i64:
        return x
    return x & MASK32 if half.large else x.to(i32)


def _val(half: FMHalf, t: torch.Tensor) -> torch.Tensor:
    """Values of a table stored as int32 bits (checkpoints, fchr, ftab,
    offs) in the row type: their uint32 value in the large mode; the
    int64 mode's tables hold their values."""
    return t.long() & MASK32 if half.large and not half.i64 else t


def _crumbs(words: torch.Tensor) -> torch.Tensor:
    """(B, 8) int32 (uint32 bits) → (B, 128) int32 2-bit crumbs."""
    sh = 2 * torch.arange(16, dtype=i32, device=words.device)
    return ((words[:, :, None] >> sh) & 3).reshape(words.shape[0], OCC_BLOCK)


def _occ_rows(half: FMHalf, i: torch.Tensor, c: torch.Tensor, rows):
    lane = torch.arange(OCC_BLOCK, dtype=i32, device=i.device)[None, :]
    pos = i % OCC_BLOCK
    crumbs = _crumbs(rows[:, :8])
    inb = ((crumbs == c[:, None]) & (lane < pos[:, None])).sum(dim=1)
    cp = _cps(half, i, rows).gather(1, c.long()[:, None])[:, 0]
    corr = ((c == 0) & (i > half.z_off)).to(i32)
    return _wrap(half, cp + inb - corr)


def occ_batch(half: FMHalf, i: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """#occurrences of per-state char c (0..3) in bwt[0:i). i, c: (B,)."""
    i = i.to(half.row_dtype)
    c = c.to(i32)
    return _occ_rows(half, i, c, _rows(half, i // OCC_BLOCK))


def lf_batch(half: FMHalf, i: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Batched LF mapping (reference mapLF). i, c: (B,)."""
    c = c.to(i32)
    return _wrap(half, _val(half, half.fchr.index_select(0, c.long()))
                 + occ_batch(half, i, c))


def ftab_lookup_batch(half: FMHalf, keys: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched ftab range lookup. keys: (B,) base-4 ints (first K chars)."""
    k = keys.long()
    return (_val(half, half.ftab.index_select(0, 2 * k + 1)),
            _val(half, half.ftab.index_select(0, 2 * k + 2)))


def _lf2(half, top, bot, cc):
    """One LF step of both range ends (the JAX ops concatenate them)."""
    both = lf_batch(half, torch.cat([top, bot]), torch.cat([cc, cc]))
    return both[:top.shape[0]], both[top.shape[0]:]


def _fm_args(half: FMHalf):
    """The table arguments of a search's C entry: (fm_blocks, nblocks) of
    a flat half, (shard addresses, per, S) of a sharded one, and in the
    int64 mode occ_cp64 (its table, or its shards' addresses); then fchr,
    z_off and the row count."""
    return _tab_args(half) + (ptr(half.fchr), half.z_off, half.nrows)


def _tab_args(half: FMHalf) -> tuple:
    fm = half.fm_blocks
    tab = (ptr(fm.addrs), fm.per, fm.S) if _sharded(half) else \
        (ptr(fm), fm.shape[0])
    if half.i64:
        cp = half.occ_cp64
        tab += (ptr(cp.addrs) if _sharded(half) else ptr(cp),)
    return tab


def _entry(half: FMHalf, name: str, argtypes, unsigned=(3, 4)):
    """The C entry of a kernel in the index's row mode, and its argument
    types: the `_u32` entry takes its row-valued scalars as unsigned, the
    `_i64` entry as 64-bit (z_off and the row count, the 4th and 5th
    arguments of the searches; z_off, the 4th, of sa_resolve). A sharded
    half's `_sh` entry takes its FM table as three arguments (addresses,
    per, S) where the flat entry takes two (fm_blocks, nblocks); the
    `_i64` entries take occ_cp64 (its table or its shards' addresses,
    sharded as fm_blocks is) right after them."""
    if _sharded(half):
        name += "_sh"
        argtypes = [P, I, I] + list(argtypes[2:])
        unsigned = tuple(k + 1 for k in unsigned)
    if not half.large:
        return name, argtypes
    if half.i64:
        k0 = 3 if _sharded(half) else 2
        argtypes = [LL if k in unsigned else t
                    for k, t in enumerate(argtypes)]
        return name + "_i64", argtypes[:k0] + [P] + argtypes[k0:]
    return name + "_u32", [U if k in unsigned else t
                           for k, t in enumerate(argtypes)]


def _check_half(half: FMHalf, dev) -> None:
    big = ("fm_blocks", "occ_cp64") if half.i64 else ("fm_blocks",)
    if _sharded(half):
        for name in big + ("mark_rows", "offs"):
            check(getattr(half, name).addrs, f"{name} shard addresses",
                  dtype=torch.int64, device=dev)
        if half.i64 and (half.occ_cp64.per, half.occ_cp64.S) != (
                half.fm_blocks.per, half.fm_blocks.S):
            raise ValueError("occ_cp64 is not sharded as fm_blocks is")
    else:
        check(half.fm_blocks, "fm_blocks", device=dev)
        if half.i64:
            check(half.occ_cp64, "occ_cp64", dtype=torch.int64,
                  shape=(half.fm_blocks.shape[0], 4), device=dev)
    check(half.fchr, "fchr", dtype=half.row_dtype if half.i64 else i32,
          shape=(5,), device=dev)
    # the mode's row space; the kernels count blocks in 32-bit ints
    bits = 38 if half.i64 else 32 if half.large else 31
    if half.nrows >= (1 << bits):
        raise ValueError(f"{half.nrows} rows do not fit the row mode")


# ---------------------------------------------------------------------------
# exact sweep (K3): backward search of the whole read, restart on empty
# ---------------------------------------------------------------------------

def _sweep_plain(half: FMHalf, rr: torch.Tensor) -> SweepResult:
    B, L = rr.shape
    top = torch.zeros(B, dtype=half.row_dtype, device=rr.device)
    bot = torch.full((B,), half.nrows, dtype=half.row_dtype, device=rr.device)
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
    out = torch.empty((2, B), dtype=half.row_dtype, device=dev)
    nedit = torch.empty(B, dtype=i32, device=dev)
    _build.call("fm_search", *_entry(half, "fm_sweep",
                                     [P, I, P, I, I, P, I, I, P, P, P]),
                *_fm_args(half), ptr(rr), B, L,
                ptr(out[0]), ptr(out[1]), ptr(nedit))
    return SweepResult(out[0], out[1], nedit)


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
    top = torch.zeros(B, dtype=half.row_dtype, device=rr.device)
    bot = torch.full((B,), half.nrows, dtype=half.row_dtype, device=rr.device)
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
    out = torch.empty((2, B), dtype=half.row_dtype, device=dev)
    _build.call("fm_search", *_entry(half, "fm_substring",
                                     [P, I, P, I, I, P, I, I, P, P]),
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
        top = torch.zeros(B, dtype=half.row_dtype, device=dev)
        bot = torch.where(valid, half.nrows, 0).to(half.row_dtype)
        for q in range(seed_len - 1, -1, -1):
            top, bot = step(top, bot, seeds[:, q])
    return top.to(half.row_dtype), \
        torch.maximum(top, bot).to(half.row_dtype)


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
    check(half.ftab, "ftab", dtype=half.row_dtype if half.i64 else i32,
          device=dev)
    B = seeds.shape[0]
    check(seeds, "seeds", shape=(B, seed_len))
    check(valid, "valid", dtype=torch.bool, shape=(B,), device=dev)
    out = torch.empty((2, B), dtype=half.row_dtype, device=dev)
    _build.call("fm_search", *_entry(half, "fm_seed",
                                     [P, I, P, I, I, P, P, P, I, I, I, P, P]),
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
    rows = _take_sharded(half.mark_rows, block) if _sharded(half) else \
        half.mark_rows.index_select(0, block.long())
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
        nrow = lf_row(half, row, c, frows)
        row = torch.where(done, row, nrow)
        steps = torch.where(done, steps, steps + 1)
    block = row // OCC_BLOCK
    pos = row % OCC_BLOCK
    bits, mcp = _mark_bits(half, block)
    rank = mcp + (bits * (lane < pos[:, None])).sum(dim=1)
    return _wrap(half, _val(half, _take_offs(half, rank)) + steps)


def _take_offs(half: FMHalf, rank: torch.Tensor) -> torch.Tensor:
    """offs[rank]: the owner's value, or 0, in the sharded mode."""
    if _sharded(half):
        return _take_sharded(half.offs, rank)
    return half.offs.index_select(0, rank.long())


def lf_row(half: FMHalf, row: torch.Tensor, c: torch.Tensor, frows
           ) -> torch.Tensor:
    """LF(row, c) over the row's already gathered FM rows (the SA walk's
    step, which reads the code c at the row from the same rows)."""
    return _wrap(half, _val(half, half.fchr.index_select(0, c.long()))
                 + _occ_rows(half, row, c, frows))


def sa_resolve(half: FMHalf, rows: torch.Tensor, period: int = 32
               ) -> torch.Tensor:
    """Batched BWT row → joined text offset. rows: (B,) of the row type."""
    # rows in the row type: int32, the uint32 value of each (int64 rows
    # wrap mod 2^32 as the JAX op's astype(uint32) does), or int64
    rows = (rows.long() if half.i64 else rows.long() & MASK32
            if half.large else rows.to(i32)).contiguous()
    if on_cpu(rows, "sa_resolve"):
        return _resolve_plain(half, rows, period)
    dev = rows.device
    _check_half(half, dev)
    B = rows.shape[0]
    out = torch.empty(B, dtype=half.row_dtype, device=dev)
    if _sharded(half):
        fmr, mk, of = half.fm_blocks, half.mark_rows, half.offs
        if (mk.per, mk.S) != (fmr.per, fmr.S):
            raise ValueError("mark_rows are not sharded as fm_blocks are")
        tabs = _tab_args(half) + (ptr(half.fchr), half.z_off,
                                  ptr(mk.addrs), ptr(of.addrs), of.per,
                                  of.S)
        name, types = _entry(half, "sa_resolve",
                             [P, I, P, I, P, P, I, I, P, I, I, P],
                             unsigned=(3,))
    else:
        check(half.mark_rows, "mark_rows", device=dev)
        check(half.offs, "offs", dtype=half.row_dtype if half.i64 else i32,
              device=dev)
        tabs = _tab_args(half) + (ptr(half.fchr), half.z_off,
                                  ptr(half.mark_rows), ptr(half.offs),
                                  half.offs.shape[0])
        name, types = _entry(half, "sa_resolve",
                             [P, I, P, I, P, P, I, P, I, I, P], unsigned=(3,))
    _build.call("sa_resolve", name, types, *tabs, ptr(rows), B, period,
                ptr(out))
    return out
