// Kernel C: rectangle affine-gap DP (read rows x reference-window columns).
//
// Replaces: bowtie2_tpu/ops/sw.py:144 sw_banded (track_origin=False), the DP
// on the main path, a lax.scan over read rows of (B, W) vector ops with a
// Kogge-Stone prefix max per row; and its Pallas counterpart
// bowtie2_tpu/ops/pallas_sw.py:145 sw_pallas (same recurrence, one problem
// tile per grid step, H/E carried in VMEM).
//
// Design: one block row of threads per problem; thread t owns the 8*WPT
// consecutive columns of its WPT packed direction words, so H and E of its
// columns live in registers for the whole row loop. Per row:
//   * the diagonal move needs H(i-1) of the column left of the thread: a
//     warp shuffle, or shared memory at a warp edge;
//   * the read-gap state F is an exclusive prefix max over columns (the
//     "lazy-F" identity of sw.py): in-thread over its cells, then a warp
//     shuffle scan, then the warp totals through shared memory;
//   * each thread stores its packed 4-bit direction words, coalesced.
// The best cell is tracked per thread as the lexicographic max of
// (score, row, column) over the rows that count (every active row in local
// mode, row len-1 end to end), which equals sw_banded's per-row
// "rightmost max column, later row on ties" rule; one reduction at the end.
//
// Bound on the card: the direction store (Lmax x B x W/2 bytes) against a
// few dozen integer operations per cell; the row loop is serial per problem,
// so enough problems must be in flight (several per block at short widths).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF = -(1 << 29);
constexpr int H_DIAG = 0, H_E = 1, H_F = 2, H_START = 3;
constexpr unsigned FULL = 0xFFFFFFFFu;

struct SwParams {
    int match_bonus, n_pen, rdo, rde, rfo, rfe, gbar, local;
};

__device__ __forceinline__ long long better(long long a, long long b) {
    return a > b ? a : b;
}

template <int WPT>
__global__ void sw_kernel(const int* __restrict__ reads,
                          const int* __restrict__ mmpen,
                          const int* __restrict__ lens,
                          const int* __restrict__ refwins,
                          const int* __restrict__ rect_cols,
                          const int* __restrict__ col_lo, int B, int Lmax,
                          int W, int Wp, SwParams p, int* out_score,
                          int* out_row, int* out_lane, int* dirs) {
    constexpr int CPT = 8 * WPT;
    extern __shared__ int smem[];
    const int t = threadIdx.x, y = threadIdx.y;
    const int lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
    int* s_wtot = smem + y * 4 * nwarps;     // warp F-prefix totals
    int* s_hnof = s_wtot + nwarps;           // lane 31's last h_noF
    int* s_hlast = s_hnof + nwarps;          // lane 31's last H (prev row)
    long long* s_best = reinterpret_cast<long long*>(smem + blockDim.y * 4 * nwarps) + y * nwarps;

    const int b = blockIdx.x * blockDim.y + y;
    const bool live = b < B;
    const int bb = live ? b : B - 1;         // idle rows mirror a real one
    const int len = lens[bb];
    const int lo = col_lo ? col_lo[bb] : 0;
    const int hi = lo + rect_cols[bb];
    const int c0 = t * CPT;
    const int rgo = p.rdo + p.rde, fgo = p.rfo + p.rfe;

    int refc[CPT], h[CPT], e[CPT];
    #pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int col = c0 + k;
        int r = 5;
        if (col < W && col >= lo && col < hi) r = __ldg(refwins + (size_t)bb * W + col);
        refc[k] = r;
        h[k] = 0;                            // free start on row -1
        e[k] = NEG_INF;
    }
    long long best = LLONG_MIN;              // packed (score, row, col)
    if (lane == 31) s_hlast[warp] = 0;
    __syncthreads();

    for (int i = 0; i < Lmax; ++i) {
        const int rc = __ldg(reads + (size_t)bb * Lmax + i);
        const int qp = __ldg(mmpen + (size_t)bb * Lmax + i);
        const bool active = i < len;
        const bool bar = p.gbar > 0 && (i < p.gbar || i >= len - p.gbar);
        const bool counts = p.local ? active : (i == len - 1);

        int hl = __shfl_up_sync(FULL, h[CPT - 1], 1);
        if (lane == 0) hl = warp == 0 ? NEG_INF : s_hlast[warp - 1];

        int hn[CPT], en[CPT];
        unsigned bits[CPT];
        int agg = NEG_INF;
        #pragma unroll
        for (int k = 0; k < CPT; ++k) {
            const int r = refc[k];
            const bool oob = r >= 5;
            const bool is_n = rc >= 4 || r == 4;
            const bool eq = r == rc && !is_n && !oob;
            int sub = eq ? p.match_bonus : ((is_n && !oob) ? -p.n_pen : -qp);
            if (oob) sub = NEG_INF / 2;
            const int e_open = h[k] - fgo, e_ext = e[k] - p.rfe;
            int ec = e_open > e_ext ? e_open : e_ext;
            if (oob) ec = NEG_INF;
            const bool e_from_ext = e_ext > e_open;
            if (bar) ec = NEG_INF;
            const int hd = (k == 0 ? hl : h[k - 1]) + sub;
            hn[k] = hd > ec ? hd : ec;
            bits[k] = (ec > hd ? H_E : H_DIAG) | (e_from_ext ? 4u : 0u);
            en[k] = ec;
            const int fa = hn[k] - rgo + p.rde + (c0 + k) * p.rde;
            agg = agg > fa ? agg : fa;
        }

        // exclusive prefix max of f_arg across threads (NEG_INF included)
        int v = agg;
        #pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int n = __shfl_up_sync(FULL, v, o);
            if (lane >= o) v = v > n ? v : n;
        }
        int ex = __shfl_up_sync(FULL, v, 1);
        int hnl = __shfl_up_sync(FULL, hn[CPT - 1], 1);
        if (lane == 31) {
            s_wtot[warp] = v;
            s_hnof[warp] = hn[CPT - 1];
        }
        __syncthreads();
        if (lane == 0) {
            ex = NEG_INF;
            hnl = warp == 0 ? NEG_INF : s_hnof[warp - 1];
        }
        for (int w2 = 0; w2 < warp; ++w2) ex = ex > s_wtot[w2] ? ex : s_wtot[w2];

        int run = ex > NEG_INF ? ex : NEG_INF;
        unsigned words[WPT];
        #pragma unroll
        for (int w = 0; w < WPT; ++w) words[w] = 0u;
        int hc_arr[CPT];
        #pragma unroll
        for (int k = 0; k < CPT; ++k) {
            const int col = c0 + k;
            const int fp = run;
            const int fa = hn[k] - rgo + p.rde + col * p.rde;
            run = run > fa ? run : fa;
            int fc = fp - col * p.rde;
            const int fo = (k == 0 ? hnl : hn[k - 1]) - rgo;
            const bool f_from_ext = fc > fo;
            if (bar) fc = NEG_INF;
            int hc = hn[k] > fc ? hn[k] : fc;
            int src = fc > hn[k] ? H_F : (int)(bits[k] & 3u);
            if (p.local) {
                const bool clamp = hc < 0 || (hc == 0 && src == H_DIAG);
                if (hc < 0) hc = 0;
                if (clamp) src = H_START;
            }
            if (hc < NEG_INF) hc = NEG_INF;
            hc_arr[k] = hc;
            if (col < W) {
                const unsigned d = (unsigned)src | (bits[k] & 4u) | (f_from_ext ? 8u : 0u);
                words[k >> 3] |= d << (4 * (k & 7));
                if (counts) {
                    const long long key = (long long)hc * 4294967296LL
                                          + (long long)((i << 16) | col);
                    best = better(best, key);
                }
            }
        }
        if (live) {
            #pragma unroll
            for (int w = 0; w < WPT; ++w) {
                const int gw = t * WPT + w;
                if (gw < Wp) dirs[((size_t)i * B + b) * Wp + gw] = (int)words[w];
            }
        }
        if (active) {
            #pragma unroll
            for (int k = 0; k < CPT; ++k) {
                h[k] = hc_arr[k];
                e[k] = en[k];
            }
        }
        if (lane == 31) s_hlast[warp] = h[CPT - 1];
        __syncthreads();
    }

    // (score, row, col) lexicographic max over the problem's threads
    #pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        best = better(best, __shfl_xor_sync(FULL, best, o));
    if (lane == 0) s_best[warp] = best;
    __syncthreads();
    if (t == 0 && live) {
        for (int w2 = 1; w2 < nwarps; ++w2) best = better(best, s_best[w2]);
        if (best == LLONG_MIN) {
            out_score[b] = NEG_INF;
            out_row[b] = 0;
            out_lane[b] = 0;
        } else {
            const long long low = best & 0xFFFFFFFFLL;
            out_score[b] = (int)((best - low) / 4294967296LL);
            out_row[b] = (int)(low >> 16);
            out_lane[b] = (int)(low & 0xFFFF);
        }
    }
}

}  // namespace

// B problems; reads/mmpen (B, Lmax), refwins (B, W), lens/rect_cols/col_lo
// (B,) int32 (col_lo may be null: rect columns start at 0); dirs (Lmax, B,
// Wp) int32 with Wp = ceil(W / 8).
extern "C" int sw_rect(const void* reads, const void* mmpen, const void* lens,
                       const void* refwins, const void* rect_cols,
                       const void* col_lo, int B, int Lmax, int W,
                       int match_bonus, int n_pen, int rdo, int rde, int rfo,
                       int rfe, int gbar, int local, void* score, void* row,
                       void* lane, void* dirs, void* stream) {
    if (B <= 0) return (int)cudaGetLastError();
    const int Wp = (W + 7) / 8;
    const int wpt = Wp <= 1024 ? 1 : 2;
    // the packed best key holds row and column in 16 bits each
    if (Wp > 2048 || Lmax > 32767) return (int)cudaErrorInvalidValue;
    const int nthr_used = (Wp + wpt - 1) / wpt;
    const int nthr = (nthr_used + 31) / 32 * 32;
    const int ppb = nthr >= 128 ? 1 : 128 / nthr;   // problems per block
    const int nwarps = nthr / 32;
    const size_t smem = (size_t)ppb * nwarps * (4 * sizeof(int) + sizeof(long long));
    const dim3 block(nthr, ppb);
    const dim3 grid((B + ppb - 1) / ppb);
    const SwParams p{match_bonus, n_pen, rdo, rde, rfo, rfe, gbar, local};
    cudaStream_t s = (cudaStream_t)stream;
    if (wpt == 1)
        sw_kernel<1><<<grid, block, smem, s>>>(
            (const int*)reads, (const int*)mmpen, (const int*)lens,
            (const int*)refwins, (const int*)rect_cols, (const int*)col_lo, B,
            Lmax, W, Wp, p, (int*)score, (int*)row, (int*)lane, (int*)dirs);
    else
        sw_kernel<2><<<grid, block, smem, s>>>(
            (const int*)reads, (const int*)mmpen, (const int*)lens,
            (const int*)refwins, (const int*)rect_cols, (const int*)col_lo, B,
            Lmax, W, Wp, p, (int*)score, (int*)row, (int*)lane, (int*)dirs);
    return (int)cudaGetLastError();
}
