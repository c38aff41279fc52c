// Kernel K7: the reference-window gather, 2-bit words to codes 0..5.
//
// Replaces: bowtie2_tpu/ops/ref.py:94 gather_windows_aligned (the fused
// paths) and :42 gather_windows (the host, overflow, mate-rescue and
// long-read paths), each a word gather, an unpack of every word into 16
// crumbs (and of every N word into 32 bits), a realignment gather in the
// unaligned form, and three selects, over whole (B, width) arrays.
//
// A window's code at global position p is the crumb p mod 16 of the
// reference word p >> 4, 4 where the N bit p mod 32 of the N word p >> 5 is
// set, and 5 outside the window's reference [lo, hi) (and, in the aligned
// form, left of its start). Positions are int32, or int64 in the large
// index mode (template P); they wrap in P as the JAX ops' do, and `>>` and
// `& ~31` round toward -inf, so col_shift stays in [0, 32).
//
// Word sources: the flat tables, with each word index clipped to its own
// table ([0, n - 1], as the JAX ops' take), or, in the aligned form, the
// sharded index mode's word tables (fm_common.cuh ShardTab, one word a
// row), not clipped: a word no shard owns reads as 0, as the JAX mode's
// owner-computes psum gives it (ops/fm.py:55 _take_sharded).
//
// Aligned form: a row starts at starts & ~31, so its 16-code groups are
// whole reference words and its 32-code groups whole N words. One thread a
// 16-code group: one reference word, the matching half of an N word, 16
// codes written as four 16-byte stores. Unaligned form: a window starts at
// `starts` itself; one thread a code, its words read through the cache
// (neighbouring threads share them), over a 64-bit index with a
// grid-stride loop, since the long-read path asks for B x width past 2^31.
// The unaligned form keeps the JAX op's word arithmetic: the word index is
// max(starts, -2^24) >> 4 plus the code's offset from it, clipped to the
// table, and the N word index that >> 1 (an offset below 0, only for
// starts under -2^24, reads the first gathered word: those positions lie
// outside any reference and are code 5).
//
// Bound on the card: the bytes, the codes written as int32 (16 output
// bytes for every 4 bits read); a gather has no reuse for TMA or wgmma.
#include "fm_common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename P> struct Unsigned;
template <> struct Unsigned<int> { using T = unsigned; };
template <> struct Unsigned<long long> { using T = unsigned long long; };

// a + b in P with the wrap of the JAX ops' adds
template <typename P>
__device__ __forceinline__ P wrap_add(P a, long long b) {
    using U = typename Unsigned<P>::T;
    return (P)((U)a + (U)b);
}

__device__ __forceinline__ uint32_t flat_word(const uint32_t* t, long long n,
                                              long long i) {
    i = i < 0 ? 0 : (i >= n ? n - 1 : i);
    return __ldg(t + i);
}

// a word of a sharded table, 0 where no shard owns it
__device__ __forceinline__ uint32_t shard_word(const ShardTab& sh,
                                               long long i) {
    if (i < 0 || i >= (long long)sh.per * sh.S) return 0u;
    bool held;
    const uint32_t* p = shard_row(sh, (int)i, 1, held);
    return held ? __ldg(p) : 0u;
}

struct Words {
    const uint32_t* w;      // flat: the tables and their lengths
    const uint32_t* nw;
    long long n, nn;
    ShardTab ws, ns;        // sharded
};

template <bool SH>
__device__ __forceinline__ uint32_t ref_word(const Words& t, long long i) {
    if constexpr (SH) return shard_word(t.ws, i);
    else return flat_word(t.w, t.n, i);
}

template <bool SH>
__device__ __forceinline__ uint32_t n_word(const Words& t, long long i) {
    if constexpr (SH) return shard_word(t.ns, i);
    else return flat_word(t.nw, t.nn, i);
}

template <typename P, bool SH>
__global__ void __launch_bounds__(THREADS)
aligned_kernel(Words t, const P* __restrict__ starts,
               const P* __restrict__ lo, const P* __restrict__ hi,
               long long B, int Wa, int* __restrict__ out,
               int* __restrict__ col_shift) {
    const int groups = Wa / 16;
    const long long total = B * groups;
    for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
         g < total; g += (long long)gridDim.x * THREADS) {
        const long long b = g / groups;
        const int k = (int)(g - b * groups);
        const P s = __ldg(starts + b);
        const P a = s & ~(P)31;
        if (k == 0) col_shift[b] = (int)(s - a);
        const uint32_t w = ref_word<SH>(t, (long long)(a >> 4) + k);
        const uint32_t nb = n_word<SH>(t, (long long)(a >> 5) + (k >> 1))
                            >> (16 * (k & 1));
        const P l = __ldg(lo + b), h = __ldg(hi + b);
        const P p0 = wrap_add(a, 16 * k);
        int c[16];
        #pragma unroll
        for (int i = 0; i < 16; ++i) {
            const P p = wrap_add(p0, i);
            const int code = ((nb >> i) & 1u) ? 4 : (int)((w >> (2 * i)) & 3u);
            c[i] = (p < l || p >= h || p < s) ? 5 : code;
        }
        int4* o = reinterpret_cast<int4*>(out + b * Wa + 16 * k);
        #pragma unroll
        for (int q = 0; q < 4; ++q)
            o[q] = make_int4(c[4 * q], c[4 * q + 1], c[4 * q + 2],
                             c[4 * q + 3]);
    }
}

template <typename P>
__global__ void __launch_bounds__(THREADS)
unaligned_kernel(Words t, const P* __restrict__ starts,
                 const P* __restrict__ lo, const P* __restrict__ hi,
                 long long B, long long width, int* __restrict__ out) {
    const long long total = B * width;
    for (long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
         g < total; g += (long long)gridDim.x * THREADS) {
        const long long b = g / width;
        const long long j = g - b * width;
        const P s = __ldg(starts + b);
        const long long s64 = (long long)s;
        const long long wst = (s64 < -(1LL << 24) ? -(1LL << 24) : s64) >> 4;
        long long sel = s64 - (wst << 4) + j;
        sel = sel < 0 ? 0 : sel;
        const uint32_t w = flat_word(t.w, t.n, wst + (sel >> 4));
        const long long nst = wst >> 1;
        long long nsel = s64 - (nst << 5) + j;
        nsel = nsel < 0 ? 0 : nsel;
        const uint32_t nw = flat_word(t.nw, t.nn, nst + (nsel >> 5));
        const P p = wrap_add(s, j);
        const int code = ((nw >> (nsel & 31)) & 1u)
                         ? 4 : (int)((w >> (2 * (sel & 15))) & 3u);
        out[g] = (p < __ldg(lo + b) || p >= __ldg(hi + b)) ? 5 : code;
    }
}

unsigned grid_of(long long threads) {
    // a grid-stride loop past this many blocks (a few waves of the card)
    const long long blocks = (threads + THREADS - 1) / THREADS;
    return (unsigned)(blocks < (1LL << 20) ? blocks : (1LL << 20));
}

template <typename P, bool SH>
int launch_aligned(const Words& t, const void* starts, const void* lo,
                   const void* hi, long long B, int Wa, void* out,
                   void* shift, void* stream) {
    if (Wa <= 0 || Wa % 32 != 0) return (int)cudaErrorInvalidValue;
    if (B <= 0) return (int)cudaGetLastError();
    aligned_kernel<P, SH><<<grid_of(B * (Wa / 16)), THREADS, 0,
                            (cudaStream_t)stream>>>(
        t, (const P*)starts, (const P*)lo, (const P*)hi, B, Wa, (int*)out,
        (int*)shift);
    return (int)cudaGetLastError();
}

}  // namespace

// win[b, :] (B x Wa int32 codes) and col_shift[b] of the aligned form over
// the flat tables (words: n_words int32 words of 2-bit codes; nwords:
// n_nwords N-bit words); starts, lo, hi: B positions, int64 when pos64 is
// set, else int32. Wa: a multiple of 32.
extern "C" int ref_gather_aligned(const void* words, long long n_words,
                                  const void* nwords, long long n_nwords,
                                  const void* starts, const void* lo,
                                  const void* hi, int pos64, long long B,
                                  int Wa, void* out, void* shift,
                                  void* stream) {
    if (n_words <= 0 || n_nwords <= 0) return (int)cudaErrorInvalidValue;
    Words t{(const uint32_t*)words, (const uint32_t*)nwords, n_words,
            n_nwords, {}, {}};
    return pos64 ? launch_aligned<long long, false>(t, starts, lo, hi, B, Wa,
                                                    out, shift, stream)
                 : launch_aligned<int, false>(t, starts, lo, hi, B, Wa, out,
                                              shift, stream);
}

// The same over sharded word tables: wshards / nshards, the device arrays
// of the S (nS) shards' addresses, per (nper) words each.
extern "C" int ref_gather_aligned_sh(const void* wshards, int per, int S,
                                     const void* nshards, int nper, int nS,
                                     const void* starts, const void* lo,
                                     const void* hi, int pos64, long long B,
                                     int Wa, void* out, void* shift,
                                     void* stream) {
    if (per <= 0 || S <= 0 || nper <= 0 || nS <= 0)
        return (int)cudaErrorInvalidValue;
    Words t{nullptr, nullptr, 0, 0,
            {(const unsigned long long*)wshards, per, S},
            {(const unsigned long long*)nshards, nper, nS}};
    return pos64 ? launch_aligned<long long, true>(t, starts, lo, hi, B, Wa,
                                                   out, shift, stream)
                 : launch_aligned<int, true>(t, starts, lo, hi, B, Wa, out,
                                             shift, stream);
}

// out[b, :] (B x width int32 codes), the unaligned form over the flat
// tables.
extern "C" int ref_gather(const void* words, long long n_words,
                          const void* nwords, long long n_nwords,
                          const void* starts, const void* lo, const void* hi,
                          int pos64, long long B, long long width, void* out,
                          void* stream) {
    if (n_words <= 0 || n_nwords <= 0 || width < 0)
        return (int)cudaErrorInvalidValue;
    if (B <= 0 || width == 0) return (int)cudaGetLastError();
    Words t{(const uint32_t*)words, (const uint32_t*)nwords, n_words,
            n_nwords, {}, {}};
    const unsigned grid = grid_of(B * width);
    if (pos64)
        unaligned_kernel<long long><<<grid, THREADS, 0,
                                      (cudaStream_t)stream>>>(
            t, (const long long*)starts, (const long long*)lo,
            (const long long*)hi, B, width, (int*)out);
    else
        unaligned_kernel<int><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            t, (const int*)starts, (const int*)lo, (const int*)hi, B, width,
            (int*)out);
    return (int)cudaGetLastError();
}
