// LF step over the fused [bwt8|occ4] index rows, shared by fm_search.cu
// and sa_resolve.cu.
//
// Replaces: bowtie2_tpu/ops/fm.py occ_batch (+ _occ_rows, _crumbs, _fchr_at),
// which unpacks a row into 128 2-bit crumbs and compares/sums them on the
// TPU's vector unit. Here the count of crumbs equal to c below i mod 128 is
// XOR against c replicated in every crumb, a zero-crumb test and __popc,
// over the 8 words of one 48-byte row (three 16-byte loads).
//
// Semantics match the JAX op exactly, including its out-of-range block:
// jnp.take fills rows past the last block with 0xFFFFFFFF, which a query at
// i = n + 1 reaches when n + 1 is a multiple of 128.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

struct FmRow {
    uint32_t w[8];
    uint32_t cp[4];
};

__device__ __forceinline__ FmRow fm_load_row(const uint32_t* __restrict__ fm,
                                             int nblocks, int block) {
    FmRow r;
    if (block >= nblocks) {
        #pragma unroll
        for (int k = 0; k < 8; ++k) r.w[k] = 0xFFFFFFFFu;
        #pragma unroll
        for (int k = 0; k < 4; ++k) r.cp[k] = 0xFFFFFFFFu;
        return r;
    }
    const uint4* p = reinterpret_cast<const uint4*>(fm + (size_t)block * 12);
    uint4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
    r.w[4] = b.x; r.w[5] = b.y; r.w[6] = b.z; r.w[7] = b.w;
    r.cp[0] = c.x; r.cp[1] = c.y; r.cp[2] = c.z; r.cp[3] = c.w;
    return r;
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

// LF(i, c) = fchr[c] + Occ(c, i) with the sentinel-row correction
__device__ __forceinline__ int fm_lf_row(const FmRow& r, const int* fchr,
                                         int z_off, int i, int c) {
    const int corr = (c == 0 && i > z_off) ? 1 : 0;
    return __ldg(fchr + c) + (int)r.cp[c] + fm_count_below(r, c, i & 127) - corr;
}

__device__ __forceinline__ int fm_lf(const uint32_t* __restrict__ fm,
                                     int nblocks, const int* fchr, int z_off,
                                     int i, int c) {
    FmRow r = fm_load_row(fm, nblocks, i >> 7);
    return fm_lf_row(r, fchr, z_off, i, c);
}
