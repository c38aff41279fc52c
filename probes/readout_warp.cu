// A probe, not part of the port: K10 SE (csrc/diag_readout.cu) with a
// warp a candidate, for probes/readout.py to time beside the port's
// design. The function, the C entry and its arguments are the port's:
//
// The port's kernel replaces bowtie2_tpu/ops/sw.py:463 diag_readout, the
// read-out of the pure diagonal ending at a candidate's best DP cell
// (rows, lanes): one gather of the diagonal's window codes, elementwise
// compares and selects over whole (Bc, Lmax) arrays, three sums and an any
// over the read, and a second gather that puts each step's op byte in walk
// order, transposed to (Lmax, Bc).
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
// Design: the port's single pass (walk step s emits position rows - s,
// the op bytes staged in a shared tile [steps][TB candidates] and stored
// as rows), but a candidate takes a warp, each lane 4 positions a round
// at stride 32, as scalar loads of reads, quals and window codes; a block
// takes 8 candidates, so its rows leave as 8-byte words where Bc % 8 == 0
// (byte stores otherwise).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GL = 32;                // lanes a candidate
constexpr int TB = 8;                 // candidates a block
constexpr int THREADS = GL * TB;
constexpr int K = 128 / GL;           // positions a lane takes at once
constexpr int BATCH = K * GL;         // 128 positions a candidate at once
constexpr int ST = 256;               // walk steps a tile
constexpr int TBP = TB + 4;           // bytes a tile row (an odd word count)
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int OP_M = 0, OP_NONE = 3;

struct Score {
    int match_bonus, mm_min, mm_max, n_pen;
};

__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int floor40(int x) {
    return x >= 0 ? x / 40 : -((39 - x) / 40);
}

__device__ __forceinline__ int mm_penalty(int q, const Score& sc) {
    q = q > 40 ? 40 : q;
    return wadd(sc.mm_min,
                floor40((int)((unsigned)q * (unsigned)(sc.mm_max - sc.mm_min))));
}

struct Cand {
    const int* rd;
    const int* ql;
    const int* wn;
    int base, len, rows;
};

__device__ __forceinline__ void steps_of(int rows, int p, int Lmax,
                                         long long& lo, long long& hi) {
    if (rows >= 0) {
        hi = (long long)rows - p;
        lo = p == Lmax - 1 ? 0 : hi;
    } else if (p == Lmax - 1) {
        lo = (long long)rows + (1LL << 31) + 1;
        hi = Lmax - 1;
    } else {
        lo = 1;
        hi = 0;
    }
}

__device__ __forceinline__ void tile_positions(int rows, int S0, int n,
                                               int Lmax, int& pa, int& pb) {
    pa = 0;
    pb = -1;
    if (rows >= 0) {
        if (rows < S0) return;
        const long long last = (long long)S0 + n - 1;
        const long long top = rows < last ? rows : last;
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

__device__ __forceinline__ void sweep(const Cand& c, int j, int p0, int pe,
                                      bool sums, int S0, int n, int Lmax,
                                      int Wf, const Score& sc,
                                      uint8_t* col, int& dscore, int& nmm,
                                      int& nrefn, bool& bad) {
    for (int P0 = p0; P0 < pe; P0 += BATCH) {
        int r[K], d[K], q[K];
        #pragma unroll
        for (int i = 0; i < K; ++i) {
            const int p = P0 + j + GL * i;
            const int idx = wadd(c.base, p);
            r[i] = p < pe ? __ldg(c.rd + p) : 0;
            d[i] = p < pe && idx >= 0 && idx < Wf ? __ldg(c.wn + idx) : 5;
            q[i] = sums && p < pe && p < c.len ? __ldg(c.ql + p) : 0;
        }
        #pragma unroll
        for (int i = 0; i < K; ++i) {
            const int p = P0 + j + GL * i;
            if (p >= pe) continue;
            const int rr = r[i], dd = d[i];
            const bool is_n = rr >= 4 || dd == 4, oob = dd >= 5;
            const bool eq = dd == rr && rr < 4;
            if (sums && p < c.len) {
                if (oob) bad = true;
                else if (eq) dscore = wadd(dscore, sc.match_bonus);
                else if (is_n) dscore = wadd(dscore, -sc.n_pen);
                else dscore = wadd(dscore, -mm_penalty(q[i], sc));
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
                hi = hi < (long long)S0 + n - 1 ? hi : (long long)S0 + n - 1;
                for (long long s = lo; s <= hi; ++s)
                    col[(int)(s - S0) * TBP] = byte;
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS)
readout_kernel(const int* __restrict__ reads, const int* __restrict__ quals,
               const int* __restrict__ wins, const int* __restrict__ rows,
               const int* __restrict__ lanes, const int* __restrict__ lens,
               int Bc, int Lmax, int Wf, Score sc, uint8_t* __restrict__ ops,
               int* __restrict__ dscore_out, int* __restrict__ nmm_out,
               int* __restrict__ nrefn_out, int* __restrict__ base_out,
               uint8_t* __restrict__ ok_out) {
    __shared__ __align__(16) uint8_t tile[ST * TBP];
    const int j = threadIdx.x & 31;      // the lane
    const int cl = threadIdx.x / GL;
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
                const int lv = c.len < Lmax ? c.len : Lmax;
                sweep(c, j, 0, lv > pb + 1 ? lv : pb + 1, true, S0, n, Lmax,
                      Wf, sc, tile + cl, dscore, nmm, nrefn, bad);
            } else if (pb >= 0) {
                sweep(c, j, pa - pa % GL, pb + 1, false, S0, n, Lmax, Wf, sc,
                      tile + cl, dscore, nmm, nrefn, bad);
            }
        }
        if (S0 == 0) {
            #pragma unroll
            for (int o = GL / 2; o > 0; o >>= 1) {
                dscore = wadd(dscore, __shfl_xor_sync(FULL, dscore, o));
                nmm += __shfl_xor_sync(FULL, nmm, o);
                nrefn += __shfl_xor_sync(FULL, nrefn, o);
            }
            const bool anybad = __ballot_sync(FULL, bad) != 0u;
            if (live && j == 0) {
                dscore_out[b] = dscore;
                nmm_out[b] = nmm;
                nrefn_out[b] = nrefn;
                base_out[b] = c.base;
                ok_out[b] = anybad ? 0 : 1;
            }
        }
        __syncthreads();
        if ((Bc & 7) == 0) {
            for (int i = threadIdx.x; i < n; i += THREADS) {
                const uint32_t* src = t32 + i * (TBP / 4);
                *reinterpret_cast<uint2*>(ops + (size_t)(S0 + i) * Bc + b0) =
                    make_uint2(src[0], src[1]);
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
