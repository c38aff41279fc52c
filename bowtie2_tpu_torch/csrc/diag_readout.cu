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
// Bound on the card: the bytes (reads, quals and the Lmax window codes a
// candidate touches in, the (Lmax, Bc) op bytes and five per-candidate
// words out); a few integer operations a byte. Design: a block takes TB
// candidates, a warp one candidate at a time, its lanes on consecutive
// read positions, so every load is a contiguous run of a row. The sums
// take one pass over the positions and a warp reduction. The op bytes are
// the layout trap: walk step s of candidate b lands at s * Bc + b, so a
// warp that writes one candidate's steps stores bytes Bc apart. Instead
// each warp writes its candidates' bytes for SCH steps into a shared
// tile [SCH steps][TB candidates], and the block then stores the tile a
// step row at a time: TB consecutive bytes of a row of the output.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 32;            // candidates a block
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int SCH = 32;           // walk steps a tile (one a lane)
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
    return wadd(sc.mm_min, floor40(q * (sc.mm_max - sc.mm_min)));
}

// the diagonal's code at read position p of a candidate whose diagonal
// starts at window column base
__device__ __forceinline__ int diag_at(const int* __restrict__ win, int Wf,
                                       int base, int p) {
    const int idx = wadd(base, p);
    if (idx < 0 || idx >= Wf) return 5;
    return __ldg(win + idx);
}

__global__ void __launch_bounds__(THREADS)
readout_kernel(const int* __restrict__ reads, const int* __restrict__ quals,
               const int* __restrict__ wins, const int* __restrict__ rows,
               const int* __restrict__ lanes, const int* __restrict__ lens,
               int Bc, int Lmax, int Wf, Score sc, uint8_t* __restrict__ ops,
               int* __restrict__ dscore_out, int* __restrict__ nmm_out,
               int* __restrict__ nrefn_out, int* __restrict__ base_out,
               uint8_t* __restrict__ ok_out) {
    __shared__ uint8_t tile[SCH][TB + 4];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b0 = blockIdx.x * TB;

    // the sums, a warp a candidate
    for (int k = w; k < TB && b0 + k < Bc; k += WARPS) {
        const int b = b0 + k;
        const int base = wadd(__ldg(lanes + b), -__ldg(rows + b));
        const int len = __ldg(lens + b);
        const int* rd = reads + (size_t)b * Lmax;
        const int* ql = quals + (size_t)b * Lmax;
        const int* wn = wins + (size_t)b * Wf;
        int dscore = 0, nmm = 0, nrefn = 0;
        bool bad = false;
        for (int p = lane; p < Lmax && p < len; p += 32) {
            const int d = diag_at(wn, Wf, base, p);
            const int r = __ldg(rd + p);
            const bool is_n = r >= 4 || d == 4, oob = d >= 5;
            const bool eq = d == r && !is_n && !oob;
            if (oob) {
                bad = true;
            } else {
                const int sub = eq ? sc.match_bonus
                                   : (is_n ? -sc.n_pen
                                           : -mm_penalty(__ldg(ql + p), sc));
                dscore = wadd(dscore, sub);
            }
            nmm += ((!eq && r < 4 && d != 4) || is_n) ? 1 : 0;
            nrefn += d == 4 ? 1 : 0;
        }
        #pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            dscore = wadd(dscore, __shfl_xor_sync(FULL, dscore, o));
            nmm += __shfl_xor_sync(FULL, nmm, o);
            nrefn += __shfl_xor_sync(FULL, nrefn, o);
        }
        bad = __any_sync(FULL, bad);
        if (lane == 0) {
            dscore_out[b] = dscore;
            nmm_out[b] = nmm;
            nrefn_out[b] = nrefn;
            base_out[b] = base;
            ok_out[b] = bad ? 0 : 1;
        }
    }

    // the op bytes, SCH walk steps at a time through the shared tile
    for (int s0 = 0; s0 < Lmax; s0 += SCH) {
        const int s = s0 + lane;
        for (int k = w; k < TB; k += WARPS) {
            const int b = b0 + k;
            int byte = OP_NONE;
            if (b < Bc && s < Lmax) {
                const int rev = wadd(__ldg(rows + b), -s);
                if (rev >= 0) {
                    const int p = rev < Lmax ? rev : Lmax - 1;
                    const int base = wadd(__ldg(lanes + b), -__ldg(rows + b));
                    const int d = diag_at(wins + (size_t)b * Wf, Wf, base, p);
                    const int r = __ldg(reads + (size_t)b * Lmax + p);
                    const bool eq = d == r && r < 4 && d < 4;
                    const int fc = d < 0 ? 0 : (d > 5 ? 5 : d);
                    byte = OP_M | (fc << 2) | ((eq ? 1 : 0) << 5);
                }
            }
            tile[lane][k] = (uint8_t)byte;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < SCH * TB; i += THREADS) {
            const int r = i / TB, c = i % TB;
            if (s0 + r < Lmax && b0 + c < Bc)
                ops[(size_t)(s0 + r) * Bc + b0 + c] = tile[r][c];
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
    if (Bc > 0)
        readout_kernel<<<(Bc + TB - 1) / TB, THREADS, 0,
                         (cudaStream_t)stream>>>(
            (const int*)reads, (const int*)quals, (const int*)wins,
            (const int*)rows, (const int*)lanes, (const int*)lens, Bc, Lmax,
            Wf, Score{match_bonus, mm_min, mm_max, n_pen}, (uint8_t*)ops,
            (int*)dscore, (int*)nmm, (int*)nrefn, (int*)base, (uint8_t*)ok);
    return (int)cudaGetLastError();
}
