"""Reference-parity pseudo-random machinery.

Bit-exact Python port of the reference's per-read RNG contract:

  * RandomSource — the Numerical-Recipes LCG (random_source.h:33): two LCG
    steps per nextU32 (ret = (last>>16) ^ last'), nextU64 = two nextU32.
  * genRandSeed — the per-read seed hash over read codes, qual chars and
    name (pat.cpp:45), combined with the global --seed.
  * shuffle_portion — EList::shufflePortion (ds.h:804): left-shrinking
    swap shuffle, one nextSizeT draw per position.
  * select_by_score — AlnSinkWrap::selectByScore (aln_sink.cpp:1477):
    sort (score asc, index asc), reverse, then shuffle each equal-score
    streak; returns the full priority permutation.
  * select_alns_to_report — AlnSinkWrap::selectAlnsToReport
    (aln_sink.cpp:1640): one draw picks a random offset, take `num`
    consecutive entries wrapping (the -k / maxed -M sampling).
  * Random1toN draw accounting — random_util.h:32: a width-1 set gives
    its element without consuming the RNG; width-n (swaplist mode, which
    all alignment-path uses hit: `init(width, all)` passes
    withoutReplacement=True) consumes exactly one nextU32 per next().

The alignment path consumes this RNG at data-dependent points (EE fw/rc
ordering, Random1toN row selection, equal-score shuffles), so stream
parity for multi-mapping reads requires replaying the reference's
trajectory; pipeline/replay.py builds on these primitives.
"""

from typing import List, Sequence, Tuple

import numpy as np

M32 = 0xFFFFFFFF
A = 1664525
C = 1013904223


class RefRng:
    """random_source.h RandomSource (the #ifndef MERSENNE_TWISTER LCG)."""

    __slots__ = ("last", "last_off")

    def __init__(self, seed: int = 0):
        self.init(seed)

    def init(self, seed: int) -> None:
        self.last = seed & M32
        self.last_off = 30

    def next_u32(self) -> int:
        self.last = (A * self.last + C) & M32
        ret = self.last >> 16
        self.last = (A * self.last + C) & M32
        ret ^= self.last
        self.last_off = 0
        return ret & M32

    def next_u64(self) -> int:
        first = self.next_u32()
        return (first << 32) | self.next_u32()

    def next_size_t(self) -> int:
        # 64-bit platform: size_t is 8 bytes (random_source.h nextSizeT)
        return self.next_u64()

    def next_u32_range(self, lo: int, hi: int) -> int:
        ret = lo
        if hi > lo:
            ret += self.next_u32() % (hi - lo + 1)
        return ret

    def next_bool(self) -> bool:
        if self.last_off > 31:
            self.next_u32()
        ret = (self.last >> self.last_off) & 1
        self.last_off += 1
        return bool(ret)

    def next_u2(self) -> int:
        if self.last_off > 30:
            self.next_u32()
        ret = (self.last >> self.last_off) & 3
        self.last_off += 2
        return ret

    def next_float(self) -> float:
        """random_source.h:137 nextFloat: (float)nextU32()/(float)0xffffffff
        in FLOAT32 arithmetic (both casts), then promoted to double by the
        caller (RowSampler multiplies it into a double mass)."""
        return float(np.float32(np.float32(self.next_u32())
                                / np.float32(0xFFFFFFFF)))


def rotl32(x: int, n: int) -> int:
    x &= M32
    return ((x << n) | (x >> (32 - n))) & M32


def rng_name(rec) -> str:
    """The reference's Read.name is the WHOLE header line (pat.cpp:1147
    reads until newline), so per-read seeds hash any comment too."""
    c = getattr(rec, "comment", None)
    return rec.name if not c else f"{rec.name} {c}"


def gen_rand_seed(codes: Sequence[int], quals: Sequence[int], name: str,
                  seed: int = 0) -> int:
    """pat.cpp:45 genRandSeed.

    codes: read codes 0..4 (5' -> 3', fw orientation); quals: RAW qual
    chars (phred + 33); name: read name (hashing stops at '/')."""
    rseed = ((seed + 101) * 59 * 61 * 67 * 71 * 73 * 79 * 83) & M32
    for i, p in enumerate(codes):
        off = (i & 15) << 1
        rseed ^= (int(p) << off)
        rseed &= M32
    for i, p in enumerate(quals):
        off = (i & 3) << 3
        rseed ^= (int(p) << off)
        rseed &= M32
    for i, ch in enumerate(name):
        p = ord(ch)
        if p == ord("/"):
            break
        off = (i & 3) << 3
        rseed ^= (p << off)
        rseed &= M32
    return rseed & M32


def gen_rand_seeds_batch(fw: np.ndarray, quals: np.ndarray,
                         lens: np.ndarray, names: Sequence[str],
                         seed: int = 0) -> np.ndarray:
    """Vectorized genRandSeed over a padded batch.

    fw: (B, Lmax) codes 0..4 (padding ignored via lens); quals: (B, Lmax)
    phred values 0..; names: B read names. Returns (B,) uint32."""
    B, Lmax = fw.shape
    base = np.uint32((np.uint64(seed + 101) * 59 * 61 * 67 * 71 * 73 * 79
                      * 83) & np.uint64(M32))
    pos = np.arange(Lmax)
    live = pos[None, :] < lens[:, None]
    cseed = np.bitwise_xor.reduce(
        np.where(live, fw.astype(np.uint32) << ((pos & 15) << 1)[None, :],
                 0), axis=1)
    qraw = quals.astype(np.uint32) + 33
    qseed = np.bitwise_xor.reduce(
        np.where(live, qraw << ((pos & 3) << 3)[None, :], 0), axis=1)
    out = np.empty(B, np.uint32)
    for b in range(B):
        nseed = np.uint32(0)
        for i, ch in enumerate(names[b]):
            if ch == "/":
                break
            nseed ^= np.uint32(ord(ch) << ((i & 3) << 3) & M32)
        out[b] = base ^ cseed[b] ^ qseed[b] ^ nseed
    return out


def shuffle_portion(lst: List, begin: int, num: int, rnd: RefRng) -> None:
    """ds.h:804 EList::shufflePortion (in place)."""
    if num < 2:
        return
    left = num
    for i in range(begin, begin + num - 1):
        rndi = rnd.next_size_t() % left
        if rndi > 0:
            lst[i], lst[i + rndi] = lst[i + rndi], lst[i]
        left -= 1


def select_by_score(scores: Sequence[int], num: int, rnd: RefRng
                    ) -> List[int]:
    """aln_sink.cpp:1477 selectByScore: priority permutation of indices.

    scores[i] = alignment i's score (pair-sum for concordant pairs).
    Returns the first `num` original indices in priority order; the
    caller's representative is element 0."""
    sz = len(scores)
    num = min(num, sz)
    if sz == 0:
        return []
    buf = sorted(((int(scores[i]), i) for i in range(sz)))
    buf.reverse()           # score desc, index desc within equal scores
    streak = 0
    for i in range(1, sz):
        if buf[i][0] == buf[i - 1][0]:
            if streak == 0:
                streak = 1
            streak += 1
        else:
            if streak > 1:
                shuffle_portion(buf, i - streak, streak, rnd)
            streak = 0
    if streak > 1:
        shuffle_portion(buf, sz - streak, streak, rnd)
    return [buf[i][1] for i in range(num)]


def select_alns_to_report(sz: int, num: int, rnd: RefRng
                          ) -> Tuple[List[int], int]:
    """aln_sink.cpp:1640 selectAlnsToReport: `num` consecutive indices
    starting at a random offset (wrapping). Returns (selected, off)."""
    num = min(num, sz)
    if sz < 1:
        return [], 0
    if sz == 1:
        return [0], 0
    off = rnd.next_u32() % sz
    out = [(off + i) % sz for i in range(num)]
    return out, off


class Random1toN:
    """random_util.h:32 draw-accounting model, BOTH modes.

    Swap-list mode (width < 128 or withoutReplacement, i.e. -a): n == 1
    consumes nothing, otherwise every next() consumes one nextU32.
    Seen-list mode (width >= SWAPLIST_THRESH=128 without -a): rejection
    sampling (variable draws!) until the seen list reaches
    max(16, (size_t)(0.10f * n)) entries, then a one-time conversion to a
    swap-list over the remaining elements."""

    SWAPLIST_THRESH = 128
    CONVERSION_THRESH = 16
    CONVERSION_FRAC = float(np.float32(0.10))

    def __init__(self, n: int = 0, without_replacement: bool = True):
        self.init(n, without_replacement)

    def init(self, n: int, without_replacement: bool = True) -> None:
        self.n = n
        self.cur = 0
        self.lst: List[int] = []
        self.seen: List[int] = []
        self.swaplist = n < self.SWAPLIST_THRESH or without_replacement
        self.converted = False
        self.thresh = max(self.CONVERSION_THRESH,
                          int(self.CONVERSION_FRAC * n))

    def done(self) -> bool:
        return self.n > 0 and self.cur >= self.n

    def next(self, rnd: RefRng) -> int:
        if self.cur == 0 and not self.converted:
            if self.n == 1:
                self.cur = 1
                return 0
            if self.swaplist and not self.lst:
                self.lst = list(range(self.n))
        if self.swaplist:
            r = self.cur + (rnd.next_u32() % (self.n - self.cur))
            if r != self.cur:
                self.lst[self.cur], self.lst[r] = (self.lst[r],
                                                   self.lst[self.cur])
            ret = self.lst[self.cur]
            self.cur += 1
            return ret
        # seen-list mode: rejection-sample an unseen element
        while True:
            rn = rnd.next_u32() % self.n
            if rn not in self.seen:
                break
        self.seen.append(rn)
        self.cur += 1
        if len(self.seen) >= self.thresh and self.cur < self.n:
            # convert: swap-list over the not-yet-seen elements in order
            seen_sorted = sorted(self.seen)
            in_seen = set(seen_sorted)
            self.lst = [j for j in range(self.n) if j not in in_seen]
            self.seen = []
            self.cur = 0
            self.n = len(self.lst)
            self.converted = True
            self.swaplist = True
        return rn
