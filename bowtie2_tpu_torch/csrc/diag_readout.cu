// Kernel K10 SE: the gapless readout of the single-end fused pipeline.
//
// Replaces: bowtie2_tpu/ops/sw.py:463 diag_readout, the read-out of the
// pure diagonal ending at a candidate's best DP cell (rows, lanes): one
// gather of the diagonal's window codes, elementwise compares and selects
// over whole (Bc, Lmax) arrays, three sums and an any over the read, and a
// second gather that puts each step's op byte in walk order, transposed to
// (Lmax, Bc). In the port's torch ops that is 22 kernels a call.
//
// What it computes, for candidate b and read position p < Lmax:
//   base = lanes - rows (the diagonal's start column), idx = base + p,
//   diag = wins[b, clip(idx, 0, Wf - 1)], or 5 where idx is outside
//   [0, Wf) (inwin is taken on the unclipped index);
//   is_n = read >= 4 | diag == 4, oob = diag >= 5,
//   eq = diag == read & !is_n & !oob;
//   over the live positions (p < lens): dscore, the sum of match_bonus
//   (eq), -n_pen (is_n, not oob) or -mm_penalty(qual) (the rest), where
//   not oob; n_mm, the count of (!eq & read < 4 & diag != 4) | is_n;
//   n_refn, the count of diag == 4; gapless_ok, no live position oob;
//   and the op byte of walk step s, which emits read position rows - s:
//   OP_M | clip(diag, 0, 5) << 2 | eq << 5 at position
//   clip(rows - s, 0, Lmax - 1), or OP_NONE once rows - s < 0.
// Every add and subtract wraps in int32 as the torch ops' do.
//
// Bound on the card: the bytes (reads at the positions below max(lens,
// rows + 1), the window codes the diagonal reads there, quals where a live
// position is a mismatch; the (Lmax, Bc) op bytes and five per-candidate
// outputs); a few integer operations a byte. Design: one pass over the
// positions gives both the sums and the op bytes, since walk step s emits
// position rows - s. A candidate takes 8 lanes, each 4 consecutive
// positions of a 32-position chunk: 16-byte loads of reads and quals (the
// quals with the reads: a load round that waited on the mismatches cost
// more than their bytes), the window codes as scalars at their unclipped
// index; four chunks' loads issued together. A warp holds four
// candidates, so a reduction is 3 shuffles and a ballot. The op bytes are
// the layout trap: walk step s of candidate b lands at s * Bc + b. Each
// lane writes its positions' bytes at their steps into a shared tile
// [steps][TB candidates] (a row of 9 words: the 8 lanes of a candidate, 4
// steps apart, fall in 8 banks), and the block stores each tile row as
// 16-byte words, TB contiguous bytes of a row of the output (byte stores
// where Bc is not a multiple of 16). Up to ST steps fit one tile; a longer
// read takes ST steps a tile, each tile's steps reading their run of
// positions again (the sums are taken in the first). Steps past rows are
// OP_NONE; where rows >= Lmax the steps up to rows - Lmax + 1 repeat
// position Lmax - 1's byte, and rows - s wraps as the torch op's does:
// the lane holding position Lmax - 1 writes that run, every other
// position one step. A block is 8 warps, TB = 32 candidates: Bc / 32
// blocks of 256 threads all fit on the card at once (8,192 candidates:
// 256 blocks, two an SM).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GL = 8;                 // lanes a candidate
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TB = THREADS / GL;      // candidates a block
constexpr int CHUNK = 4 * GL;         // positions a candidate's lanes take
constexpr int U = 4;                  // chunks whose loads go together
constexpr int ST = 256;               // walk steps a tile
constexpr int TBP = TB + 4;           // bytes a tile row (9 words)
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int OP_M = 0, OP_NONE = 3;

struct Score {
    int match_bonus, mm_min, mm_max, n_pen;
};

__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

// floor(x / 40) for any int x, as the torch op's floor division
__device__ __forceinline__ int floor40(int x) {
    return x >= 0 ? x / 40 : -((39 - x) / 40);
}

// the qual-scaled mismatch penalty (ops/sw.py mm_penalty_from_qual)
__device__ __forceinline__ int mm_penalty(int q, const Score& sc) {
    q = q > 40 ? 40 : q;
    return wadd(sc.mm_min,
                floor40((int)((unsigned)q * (unsigned)(sc.mm_max - sc.mm_min))));
}

// a candidate: its rows of reads and quals, its window, the diagonal's
// start column, its length and best row
struct Cand {
    const int* rd;
    const int* ql;
    const int* wn;
    int base, len, rows;
};

// v[0..3] = row[p .. p + 3], each below `end` (0 past it); VEC: one
// 16-byte load (rows of a multiple of 4 ints, p a multiple of 4)
template <bool VEC>
__device__ __forceinline__ void load4(const int* __restrict__ row, int p,
                                      int end, int v[4]) {
    if constexpr (VEC) {
        int4 x = make_int4(0, 0, 0, 0);
        if (p < end) x = __ldg(reinterpret_cast<const int4*>(row + p));
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
        #pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = p + i < end ? __ldg(row + p + i) : 0;
    }
}

// The walk steps [lo, hi] (empty where lo > hi) that emit position p:
// step s emits clip(rows - s, 0, Lmax - 1) where rows - s (wrapping in
// int32) is >= 0.
__device__ __forceinline__ void steps_of(int rows, int p, int Lmax,
                                         long long& lo, long long& hi) {
    if (rows >= 0) {
        hi = (long long)rows - p;
        lo = p == Lmax - 1 ? 0 : hi;
    } else if (p == Lmax - 1) {
        // rows - s wraps to >= Lmax - 1 for s > rows + 2^31
        lo = (long long)rows + (1LL << 31) + 1;
        hi = Lmax - 1;
    } else {
        lo = 1;
        hi = 0;
    }
}

// The positions [pa, pb] whose bytes steps [S0, S0 + n) take (pb = -1:
// none).
__device__ __forceinline__ void tile_positions(int rows, int S0, int n,
                                               int Lmax, int& pa, int& pb) {
    pa = 0;
    pb = -1;
    if (rows >= 0) {
        if (rows < S0) return;
        const long long last = (long long)S0 + n - 1;
        const long long top = rows < last ? rows : last;  // last step < 0
        pa = (int)((long long)rows - top < Lmax - 1 ? (long long)rows - top
                                                    : Lmax - 1);
        pb = (int)((long long)rows - S0 < Lmax - 1 ? (long long)rows - S0
                                                   : Lmax - 1);
    } else {
        long long lo, hi;
        steps_of(rows, Lmax - 1, Lmax, lo, hi);
        if (lo <= (long long)S0 + n - 1 && hi >= S0) pa = pb = Lmax - 1;
    }
}

// Positions [p0, pe) of candidate c (p0 a multiple of CHUNK), lane j of
// its 8: with `sums`, the sums over the live ones (below c.len); the op
// byte of each at its steps in [S0, S0 + n), into the tile column `col`.
template <bool VEC>
__device__ __forceinline__ void sweep(const Cand& c, int j, int p0, int pe,
                                      bool sums, int S0, int n, int Lmax,
                                      int Wf, const Score& sc,
                                      uint8_t* col, int& dscore, int& nmm,
                                      int& nrefn, bool& bad) {
    for (int P0 = p0; P0 < pe; P0 += U * CHUNK) {
        int r[U][4], d[U][4], q[U][4];
        #pragma unroll
        for (int u = 0; u < U; ++u) {
            const int p = P0 + u * CHUNK + 4 * j;
            load4<VEC>(c.rd, p, pe, r[u]);
            load4<VEC>(c.ql, p, sums ? pe : 0, q[u]);
            #pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int idx = wadd(c.base, p + i);
                d[u][i] = p + i < pe && idx >= 0 && idx < Wf
                          ? __ldg(c.wn + idx) : 5;
            }
        }
        #pragma unroll
        for (int u = 0; u < U; ++u) {
            #pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int p = P0 + u * CHUNK + 4 * j + i;
                if (p >= pe) continue;
                const int rr = r[u][i], dd = d[u][i];
                const bool is_n = rr >= 4 || dd == 4, oob = dd >= 5;
                const bool eq = dd == rr && rr < 4;
                if (sums && p < c.len) {
                    if (oob) bad = true;
                    else if (eq) dscore = wadd(dscore, sc.match_bonus);
                    else if (is_n) dscore = wadd(dscore, -sc.n_pen);
                    else dscore = wadd(dscore, -mm_penalty(q[u][i], sc));
                    nmm += ((!eq && rr < 4 && dd != 4) || is_n) ? 1 : 0;
                    nrefn += dd == 4 ? 1 : 0;
                }
                const int fc = dd < 0 ? 0 : (dd > 5 ? 5 : dd);
                const uint8_t byte =
                    (uint8_t)(OP_M | (fc << 2) | ((eq ? 1 : 0) << 5));
                if (c.rows >= 0) {
                    const int s = c.rows - p - S0;
                    if ((unsigned)s < (unsigned)n) col[s * TBP] = byte;
                }
                if (p == Lmax - 1 && (c.rows >= Lmax || c.rows < 0)) {
                    long long lo, hi;
                    steps_of(c.rows, p, Lmax, lo, hi);
                    lo = lo > S0 ? lo : S0;
                    hi = hi < (long long)S0 + n - 1 ? hi
                                                    : (long long)S0 + n - 1;
                    for (long long s = lo; s <= hi; ++s)
                        col[(int)(s - S0) * TBP] = byte;
                }
            }
        }
    }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
readout_kernel(const int* __restrict__ reads, const int* __restrict__ quals,
               const int* __restrict__ wins, const int* __restrict__ rows,
               const int* __restrict__ lanes, const int* __restrict__ lens,
               int Bc, int Lmax, int Wf, Score sc, uint8_t* __restrict__ ops,
               int* __restrict__ dscore_out, int* __restrict__ nmm_out,
               int* __restrict__ nrefn_out, int* __restrict__ base_out,
               uint8_t* __restrict__ ok_out) {
    __shared__ __align__(16) uint8_t tile[ST * TBP];
    const int lane = threadIdx.x & 31, j = lane & (GL - 1);
    const int cl = threadIdx.x / GL;          // the candidate in the block
    const int b0 = blockIdx.x * TB, b = b0 + cl;
    const int nb = Bc - b0 < TB ? Bc - b0 : TB;
    const bool live = b < Bc;
    Cand c{nullptr, nullptr, nullptr, 0, 0, -1};
    if (live) {
        c.rows = __ldg(rows + b);
        c.base = wadd(__ldg(lanes + b), -c.rows);
        c.len = __ldg(lens + b);
        c.rd = reads + (size_t)b * Lmax;
        c.ql = quals + (size_t)b * Lmax;
        c.wn = wins + (size_t)b * Wf;
    }
    uint32_t* t32 = reinterpret_cast<uint32_t*>(tile);
    for (int S0 = 0; S0 < Lmax; S0 += ST) {
        const int n = Lmax - S0 < ST ? Lmax - S0 : ST;
        for (int i = threadIdx.x; i < n * (TBP / 4); i += THREADS)
            t32[i] = 0x01010101u * OP_NONE;
        __syncthreads();
        int dscore = 0, nmm = 0, nrefn = 0;
        bool bad = false;
        if (live) {
            int pa, pb;
            tile_positions(c.rows, S0, n, Lmax, pa, pb);
            if (S0 == 0) {
                // every live position for the sums, and this tile's bytes
                const int lv = c.len < Lmax ? c.len : Lmax;
                sweep<VEC>(c, j, 0, lv > pb + 1 ? lv : pb + 1, true, S0, n,
                           Lmax, Wf, sc, tile + cl, dscore, nmm, nrefn, bad);
            } else if (pb >= 0) {
                sweep<VEC>(c, j, pa & ~(CHUNK - 1), pb + 1, false, S0, n,
                           Lmax, Wf, sc, tile + cl, dscore, nmm, nrefn, bad);
            }
        }
        if (S0 == 0) {
            // the candidate's 8 lanes are aligned lanes of one warp
            #pragma unroll
            for (int o = GL / 2; o > 0; o >>= 1) {
                dscore = wadd(dscore, __shfl_xor_sync(FULL, dscore, o));
                nmm += __shfl_xor_sync(FULL, nmm, o);
                nrefn += __shfl_xor_sync(FULL, nrefn, o);
            }
            const unsigned anybad =
                (__ballot_sync(FULL, bad) >> (lane & ~(GL - 1))) & 0xFFu;
            if (live && j == 0) {
                dscore_out[b] = dscore;
                nmm_out[b] = nmm;
                nrefn_out[b] = nrefn;
                base_out[b] = c.base;
                ok_out[b] = anybad ? 0 : 1;
            }
        }
        __syncthreads();
        if ((Bc & 15) == 0) {
            // nb is a multiple of 16: 16-byte words, a row's TB bytes
            for (int i = threadIdx.x; i < n * (TB / 16); i += THREADS) {
                const int r = i / (TB / 16), h = i % (TB / 16);
                if (16 * h < nb) {
                    const uint32_t* src = t32 + r * (TBP / 4) + 4 * h;
                    *reinterpret_cast<uint4*>(
                        ops + (size_t)(S0 + r) * Bc + b0 + 16 * h) =
                        make_uint4(src[0], src[1], src[2], src[3]);
                }
            }
        } else {
            for (int i = threadIdx.x; i < n * TB; i += THREADS) {
                const int r = i / TB, k = i % TB;
                if (k < nb)
                    ops[(size_t)(S0 + r) * Bc + b0 + k] = tile[r * TBP + k];
            }
        }
        __syncthreads();
    }
}

}  // namespace

// ops (Lmax, Bc) uint8; dscore, n_mm, n_refn, base (Bc,) int32; ok (Bc,)
// bytes 0/1. reads, quals (Bc, Lmax), wins (Bc, Wf), rows, lanes, lens
// (Bc,): int32.
extern "C" int diag_readout(const void* reads, const void* quals,
                            const void* wins, const void* rows,
                            const void* lanes, const void* lens, int Bc,
                            int Lmax, int Wf, int match_bonus, int mm_min,
                            int mm_max, int n_pen, void* ops, void* dscore,
                            void* nmm, void* nrefn, void* base, void* ok,
                            void* stream) {
    if (Lmax <= 0 || Wf <= 0) return (int)cudaErrorInvalidValue;
    if (Bc > 0) {
        const unsigned grid = (unsigned)((Bc + TB - 1) / TB);
        const Score sc{match_bonus, mm_min, mm_max, n_pen};
        cudaStream_t st = (cudaStream_t)stream;
        // 16-byte loads of reads and quals where every row is 16-byte
        // aligned
        if (Lmax % 4 == 0 && (uintptr_t)reads % 16 == 0 &&
            (uintptr_t)quals % 16 == 0)
            readout_kernel<true><<<grid, THREADS, 0, st>>>(
                (const int*)reads, (const int*)quals, (const int*)wins,
                (const int*)rows, (const int*)lanes, (const int*)lens, Bc,
                Lmax, Wf, sc, (uint8_t*)ops, (int*)dscore, (int*)nmm,
                (int*)nrefn, (int*)base, (uint8_t*)ok);
        else
            readout_kernel<false><<<grid, THREADS, 0, st>>>(
                (const int*)reads, (const int*)quals, (const int*)wins,
                (const int*)rows, (const int*)lanes, (const int*)lens, Bc,
                Lmax, Wf, sc, (uint8_t*)ops, (int*)dscore, (int*)nmm,
                (int*)nrefn, (int*)base, (uint8_t*)ok);
    }
    return (int)cudaGetLastError();
}
