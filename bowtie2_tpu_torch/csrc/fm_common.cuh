// LF step over the fused [bwt8|occ4] index rows, shared by fm_search.cu
// (fm_lf2_pair, two lanes per pair of LFs: the sweep and the half-read
// search; fm_lf_range, both ends of a range in one thread: the seed search)
// and sa_resolve.cu (the row's words and their count, FmRow and
// fm_count_below). The seed and half-read searches count with
// fm_count_lean, which builds each word's mask with one funnel shift.
//
// Replaces: bowtie2_tpu/ops/fm.py occ_batch (+ _occ_rows, _crumbs, _fchr_at),
// which unpacks a row into 128 2-bit crumbs and compares/sums them on the
// TPU's vector unit. Here the count of crumbs equal to c below i mod 128 is
// XOR against c replicated in every crumb, a zero-crumb test and __popc,
// over the 8 bwt words of one 48-byte row (two 16-byte loads) and its
// checkpoint cp[c] (one 4-byte load).
//
// Semantics match the JAX op exactly, including its out-of-range block:
// jnp.take fills rows past the last block with 0xFFFFFFFF, which a query at
// i = n + 1 reaches when n + 1 is a multiple of 128.
//
// Row type R: int in the small mode (a joined text below 2^31 bp), uint32_t
// in the large mode (up to 2^32 - 1 rows, the JAX package's uint32 row
// space). Adds and subtracts are the same bits in both (mod 2^32, as the
// JAX ops wrap); what the type changes is every compare (i > z_off, the
// empty-range tests of the searches), the shift that finds a row's block,
// and the checkpoint of a row past the last block, read as -1 in the
// row type (0xFFFFFFFF). RowOut<R> is the type a kernel writes rows in:
// int, or int64 holding the uint32 value (the port's tensor API).
//
// R = long long is the int64 mode past 2^32 rows (bowtie2_tpu/ops/fm.py
// _occ_rows' occ_cp64 branch): the fused row's columns 8:12 hold only the
// checkpoints' low 32 bits, so each LF step reads the block's checkpoint
// from a second table, occ_cp64 (int64[nblocks, 4]; flat, or sharded as
// fm_blocks is, through its shards' addresses), passed to the kernels as
// `cp64` (their last argument) and unused by the other row types; its LF
// steps are fm_lf2_pair_i64 and fm_lf_range_i64, twins of the int and
// uint32_t ones, which keep their code. A row past the flat table's last
// block reads words 0xFFFFFFFF and checkpoint INT64_MIN (jnp.take's fill
// of an int64 table), and the LF sum wraps in int64 (lf_add).
//
// Row source: where a table's rows come from, a template argument beside
// R. FlatRows is one table, as above: a row past the end is clamped for
// the load and reads as 0xFFFFFFFF. ShardRows is the sharded index mode
// (bowtie2_tpu/ops/fm.py:55 _take_sharded, owner-computes plus a psum
// over the shard axis): S shards of `per` rows, shard s holding the global
// rows [s per, (s + 1) per), read through a device array of the shards'
// addresses (ShardTab); a row no shard holds (negative, or at S per or
// past it) reads as zeros, the psum of every shard's zeros, and its load
// goes to shard 0's row 0 (shard_row). The shards' padding rows are zeros
// too, so a row past the last block reads as zeros in the sharded mode
// whether a shard holds it or not, and its checkpoint as 0 where the flat
// table gives -1. The flat code is the one-table code as it was, so the
// flat kernels compile as before.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

template <typename R> struct RowOut { using T = int; };
template <> struct RowOut<uint32_t> { using T = long long; };
template <> struct RowOut<long long> { using T = long long; };

// whether the row type reads its checkpoints from occ_cp64
template <typename R> struct Cp64 { static constexpr bool ON = false; };
template <> struct Cp64<long long> { static constexpr bool ON = true; };

// a + b + c - d in int64, wrapping as the JAX ops' adds do (through
// unsigned arithmetic)
__device__ __forceinline__ long long lf_add(long long a, long long b,
                                            long long c, long long d) {
    return (long long)((unsigned long long)a + (unsigned long long)b
                       + (unsigned long long)c - (unsigned long long)d);
}

// the row sources, as template tags
struct FlatRows {
    static constexpr bool SHARDED = false;
    static constexpr uint32_t FILL = 0xFFFFFFFFu;
};

struct ShardRows {
    static constexpr bool SHARDED = true;
    static constexpr uint32_t FILL = 0u;
};

// A sharded table: the S shards' addresses on the card, `per` rows each.
struct ShardTab {
    const unsigned long long* __restrict__ p;
    int per, S;
};

// The address of row r of a sharded table of w words, and whether a shard
// holds it: its owner is r / per (a negative r is past every shard as
// unsigned); where none does, shard 0's row 0.
__device__ __forceinline__ const uint32_t* shard_row(const ShardTab& sh,
                                                     int r, int w,
                                                     bool& held) {
    const unsigned s = (unsigned)r / (unsigned)sh.per;
    held = s < (unsigned)sh.S;
    return reinterpret_cast<const uint32_t*>(__ldg(sh.p + (held ? s : 0u)))
           + (size_t)(held ? (unsigned)r - s * (unsigned)sh.per : 0u) * w;
}

struct FmRow {
    uint32_t w[8];
};

// The int64 mode's occ_cp64 row of a block: flat (clamped to the table),
// or its owner shard's (shard 0's row 0 where none holds it); `held` as
// shard_row's, the same for the block's fused row.
template <typename Src>
__device__ __forceinline__ const long long* cp64_row(const void* cp64,
                                                     const ShardTab& sh,
                                                     int nblocks, int block) {
    if constexpr (Src::SHARDED) {
        bool held;
        return reinterpret_cast<const long long*>(shard_row(
            ShardTab{(const unsigned long long*)cp64, sh.per, sh.S}, block,
            8, held));
    } else {
        return (const long long*)cp64 + (size_t)min(block, nblocks - 1) * 4;
    }
}

// The checkpoint cp[c] of a block from its occ_cp64 row (the int64
// mode), and the checkpoint of a block the source does not hold: INT64_MIN
// flat (jnp.take's fill of an int64 table), 0 sharded.
template <typename Src>
__device__ __forceinline__ long long load_cp(const void* cp64,
                                             const ShardTab& sh, int nblocks,
                                             int block, int c) {
    return __ldg(cp64_row<Src>(cp64, sh, nblocks, block) + c);
}

template <typename Src>
__device__ __forceinline__ long long cp_fill() {
    return Src::SHARDED ? 0LL : (-0x7FFFFFFFFFFFFFFFLL - 1);
}

// number of crumbs equal to c (0..3) among the first pos (0..128) of the row
__device__ __forceinline__ int fm_count_below(const FmRow& r, int c, int pos) {
    const uint32_t pat = (uint32_t)c * 0x55555555u;
    int cnt = 0;
    #pragma unroll
    for (int k = 0; k < 8; ++k) {
        int n = pos - 16 * k;
        n = n < 0 ? 0 : (n > 16 ? 16 : n);
        uint32_t x = r.w[k] ^ pat;
        uint32_t eq = ~(x | (x >> 1)) & 0x55555555u;
        uint32_t m = n >= 16 ? 0xFFFFFFFFu : ((1u << (2 * n)) - 1u);
        cnt += __popc(eq & m);
    }
    return cnt;
}

// fm_count_below with fewer instructions a word: the mask of crumbs below
// pos in word k, with the low bit of each crumb only, is 0x55555555 shifted
// right by 32 (k + 1) - 2 pos, clamped to 0..32, which also folds the
// 0x55555555 of the equality test into it.
__device__ __forceinline__ int fm_count_lean(const FmRow& r, int c, int pos) {
    const uint32_t pat = (uint32_t)c * 0x55555555u;
    int cnt = 0;
    #pragma unroll
    for (int k = 0; k < 8; ++k) {
        const uint32_t x = r.w[k] ^ pat;
        const uint32_t m = __funnelshift_rc(
            0x55555555u, 0u, (unsigned)max(32 * (k + 1) - 2 * pos, 0));
        cnt += __popc(~(x | (x >> 1)) & m);
    }
    return cnt;
}

// Cooperative LF step of both ends of a range, two consecutive lanes of a
// warp per search state (all lanes active): lane j = 0 takes row `top`,
// lane j = 1 row `bot`, each with the row's eight bwt words in two 16-byte
// loads and cp[c] in one, and adds fchr[c] (passed in registers) and the
// sentinel correction. One shuffle swaps the two counts, so both lanes
// return both results. A row the source does not hold reads as its FILL.
// LEAN counts with fm_count_lean (the half-read search), else with
// fm_count_below (the sweep).
template <bool LEAN, typename R, typename Src>
__device__ __forceinline__ void fm_lf2_pair(const uint32_t* __restrict__ fm,
                                            int nblocks, const ShardTab& sh,
                                            R fchr_c, R z_off, R top, R bot,
                                            int c, int j, R& ntop, R& nbot) {
    const R i = j == 0 ? top : bot;
    const int block = (int)(i >> 7);
    // load a real row always and fill after it: no branch around the load
    bool held = true;
    const uint32_t* row;
    if constexpr (Src::SHARDED)
        row = shard_row(sh, block, 12, held);
    else
        row = fm + (size_t)min(block, nblocks - 1) * 12;
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(row) + 1);
    FmRow r;
    r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
    r.w[4] = b.x; r.w[5] = b.y; r.w[6] = b.z; r.w[7] = b.w;
    R base = (R)__ldg(row + 8 + c);
    if (Src::SHARDED ? !held : block >= nblocks) {
        #pragma unroll
        for (int k = 0; k < 8; ++k) r.w[k] = Src::FILL;
        base = (R)Src::FILL;
    }
    const int pos = (int)(i & 127);
    const R cnt = (R)(LEAN ? fm_count_lean(r, c, pos)
                           : fm_count_below(r, c, pos)) + base + fchr_c
                  - (R)((c == 0 && i > z_off) ? 1 : 0);
    const R other = __shfl_xor_sync(0xFFFFFFFFu, cnt, 1);
    ntop = j == 0 ? cnt : other;
    nbot = j == 0 ? other : cnt;
}

// LF step of both ends of a range in one thread (the seed search): the top
// row's bwt words and cp[c], and, only when bot lies in another block, the
// bot row's, both issued before either count; words 4-7 of a row only for
// a position past 64 (up to it their crumbs count nothing). A row the
// source does not hold is reached only at i = n + 1 = 128 nblocks,
// position 0, where the words count nothing: only its checkpoint reads as
// the source's FILL (0xFFFFFFFF flat, 0 sharded).
template <typename R, typename Src>
__device__ __forceinline__ void fm_lf_range(const uint32_t* __restrict__ fm,
                                            int nblocks, const ShardTab& sh,
                                            R fchr_c, R z_off, int c, R& top,
                                            R& bot) {
    const int bt = (int)(top >> 7), bb = (int)(bot >> 7);
    const int pt = (int)(top & 127), pb = (int)(bot & 127);
    const bool same = bt == bb;
    bool ht = true, hb = true;
    const uint4 *rt, *rb;
    if constexpr (Src::SHARDED) {
        rt = reinterpret_cast<const uint4*>(shard_row(sh, bt, 12, ht));
        rb = reinterpret_cast<const uint4*>(shard_row(sh, bb, 12, hb));
    } else {
        rt = reinterpret_cast<const uint4*>(
            fm + (size_t)min(bt, nblocks - 1) * 12);
        rb = reinterpret_cast<const uint4*>(
            fm + (size_t)min(bb, nblocks - 1) * 12);
    }
    uint4 a0 = __ldg(rt), a1 = make_uint4(0, 0, 0, 0);
    if (max(pt, same ? pb : 0) > 64) a1 = __ldg(rt + 1);
    R cpt = (R)__ldg(reinterpret_cast<const uint32_t*>(rt) + 8 + c);
    uint4 b0 = a0, b1 = a1;
    R cpb = cpt;
    if (!same) {
        b0 = __ldg(rb);
        if (pb > 64) b1 = __ldg(rb + 1);
        cpb = (R)__ldg(reinterpret_cast<const uint32_t*>(rb) + 8 + c);
    }
    if (Src::SHARDED ? !ht : bt >= nblocks) cpt = (R)Src::FILL;
    if (Src::SHARDED ? !hb : bb >= nblocks) cpb = (R)Src::FILL;
    FmRow r, s;
    r.w[0] = a0.x; r.w[1] = a0.y; r.w[2] = a0.z; r.w[3] = a0.w;
    r.w[4] = a1.x; r.w[5] = a1.y; r.w[6] = a1.z; r.w[7] = a1.w;
    s.w[0] = b0.x; s.w[1] = b0.y; s.w[2] = b0.z; s.w[3] = b0.w;
    s.w[4] = b1.x; s.w[5] = b1.y; s.w[6] = b1.z; s.w[7] = b1.w;
    const R nt = fchr_c + cpt + (R)fm_count_lean(r, c, pt)
                 - (R)((c == 0 && top > z_off) ? 1 : 0);
    bot = fchr_c + cpb + (R)fm_count_lean(s, c, pb)
          - (R)((c == 0 && bot > z_off) ? 1 : 0);
    top = nt;
}

// The int64 mode's twins of the two LF steps above (R = long long): the
// same loads of the fused row's words, each checkpoint from the block's
// occ_cp64 row instead of columns 8:12, a block past the flat table
// filled with words 0xFFFFFFFF and checkpoint INT64_MIN (0 sharded), and
// the sums wrapped in int64 (lf_add).
template <bool LEAN, typename Src>
__device__ __forceinline__ void fm_lf2_pair_i64(
        const uint32_t* __restrict__ fm, int nblocks, const ShardTab& sh,
        const void* cp64, long long fchr_c, long long z_off, long long top,
        long long bot, int c, int j, long long& ntop, long long& nbot) {
    using R = long long;
    const R i = j == 0 ? top : bot;
    const int block = (int)(i >> 7);
    // load a real row always and fill after it: no branch around the load
    bool held = true;
    const uint32_t* row;
    if constexpr (Src::SHARDED)
        row = shard_row(sh, block, 12, held);
    else
        row = fm + (size_t)min(block, nblocks - 1) * 12;
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(row) + 1);
    FmRow r;
    r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
    r.w[4] = b.x; r.w[5] = b.y; r.w[6] = b.z; r.w[7] = b.w;
    R base = load_cp<Src>(cp64, sh, nblocks, block, c);
    if (Src::SHARDED ? !held : block >= nblocks) {
        #pragma unroll
        for (int k = 0; k < 8; ++k) r.w[k] = Src::FILL;
        base = cp_fill<Src>();
    }
    const int pos = (int)(i & 127);
    const R cnt = lf_add((R)(LEAN ? fm_count_lean(r, c, pos)
                                  : fm_count_below(r, c, pos)), base,
                         fchr_c, (R)((c == 0 && i > z_off) ? 1 : 0));
    const R other = __shfl_xor_sync(0xFFFFFFFFu, cnt, 1);
    ntop = j == 0 ? cnt : other;
    nbot = j == 0 ? other : cnt;
}

template <typename Src>
__device__ __forceinline__ void fm_lf_range_i64(
        const uint32_t* __restrict__ fm, int nblocks, const ShardTab& sh,
        const void* cp64, long long fchr_c, long long z_off, int c,
        long long& top, long long& bot) {
    using R = long long;
    const int bt = (int)(top >> 7), bb = (int)(bot >> 7);
    const int pt = (int)(top & 127), pb = (int)(bot & 127);
    const bool same = bt == bb;
    bool ht = true, hb = true;
    const uint4 *rt, *rb;
    if constexpr (Src::SHARDED) {
        rt = reinterpret_cast<const uint4*>(shard_row(sh, bt, 12, ht));
        rb = reinterpret_cast<const uint4*>(shard_row(sh, bb, 12, hb));
    } else {
        rt = reinterpret_cast<const uint4*>(
            fm + (size_t)min(bt, nblocks - 1) * 12);
        rb = reinterpret_cast<const uint4*>(
            fm + (size_t)min(bb, nblocks - 1) * 12);
    }
    uint4 a0 = __ldg(rt), a1 = make_uint4(0, 0, 0, 0);
    if (max(pt, same ? pb : 0) > 64) a1 = __ldg(rt + 1);
    R cpt = load_cp<Src>(cp64, sh, nblocks, bt, c);
    uint4 b0 = a0, b1 = a1;
    R cpb = cpt;
    if (!same) {
        b0 = __ldg(rb);
        if (pb > 64) b1 = __ldg(rb + 1);
        cpb = load_cp<Src>(cp64, sh, nblocks, bb, c);
    }
    if (Src::SHARDED ? !ht : bt >= nblocks) cpt = cp_fill<Src>();
    if (Src::SHARDED ? !hb : bb >= nblocks) cpb = cp_fill<Src>();
    FmRow r, s;
    r.w[0] = a0.x; r.w[1] = a0.y; r.w[2] = a0.z; r.w[3] = a0.w;
    r.w[4] = a1.x; r.w[5] = a1.y; r.w[6] = a1.z; r.w[7] = a1.w;
    s.w[0] = b0.x; s.w[1] = b0.y; s.w[2] = b0.z; s.w[3] = b0.w;
    s.w[4] = b1.x; s.w[5] = b1.y; s.w[6] = b1.z; s.w[7] = b1.w;
    const R nt = lf_add(fchr_c, cpt, (R)fm_count_lean(r, c, pt),
                        (R)((c == 0 && top > z_off) ? 1 : 0));
    bot = lf_add(fchr_c, cpb, (R)fm_count_lean(s, c, pb),
                 (R)((c == 0 && bot > z_off) ? 1 : 0));
    top = nt;
}
