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
// codes written as four 16-byte stores.
//
// Unaligned form: a window starts at `starts` itself. It keeps the JAX op's
// word arithmetic: the word index is max(starts, -2^24) >> 4 plus the
// code's offset from it, clipped to the table, and the N word index that
// >> 1. So code j of a window reads position e = max(starts + j, -2^24)
// (unwrapped): crumb e mod 16 of word e >> 4, N bit e mod 32 of word e >> 5
// (codes below -2^24 all read -2^24, its crumb 0 and N bit 0).
//
// Bound on the card: the bytes, the codes written as int32 (16 output
// bytes for every 4 bits read); a gather has no reuse for TMA or wgmma.
// The unaligned form, one thread a code, would be bound by instructions (an
// emulated 64-bit division, two word loads and a 4-byte store a code); so
// a thread owns 16 consecutive codes of the flat B x width output: one
// division for 16 codes, and its codes form one row piece, or two where
// they cross into the next row (more below width 16), the two pieces'
// loads issued together so that a thread waits on memory once.
// A piece of up to 16 codes spans at most two reference words and two N
// words, loaded once; its crumbs, N bits and in-bounds bits come out of
// them as three bit fields by funnel shifts, so a code costs a few bit
// tests and selects. A block is 128 threads: a call of a few hundred
// windows, as the host and mate-rescue paths make, is latency-bound, and
// smaller blocks spread it over more SMs. A warp's 512 codes are one run
// of 2 KB: its threads' 64-byte pieces go through shared memory (a
// swizzle keeps both sides free of bank conflicts), and the warp stores
// the run as four 512-byte rows of 16-byte stores, where each thread's own
// four stores would leave every row a pattern of half sectors and run the
// store at half the rate.
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

constexpr int CHUNK = 16;            // codes a thread of the unaligned form
constexpr int U_THREADS = 128;       // threads a block of the unaligned form

// the k low bits set, k in [0, 32]
__device__ __forceinline__ uint32_t low_bits(int k) {
    return k >= 32 ? 0xFFFFFFFFu : (1u << k) - 1u;
}

// Codes j .. j + 15 of window b (fewer are used at a row's end) as bit
// fields from bit 0: the crumbs (two bits a code), the N bits and the
// in-bounds bits.
struct Piece {
    uint32_t crumbs, nbits, inb;
};

template <typename P>
__device__ __forceinline__ Piece row_piece(const Words& t,
                                           const P* __restrict__ starts,
                                           const P* __restrict__ lo,
                                           const P* __restrict__ hi,
                                           long long b, long long j) {
    using U = typename Unsigned<P>::T;
    const P s = __ldg(starts + b), l = __ldg(lo + b), h = __ldg(hi + b);
    const long long q = (long long)s + j;
    const long long e = q < -(1LL << 24) ? -(1LL << 24) : q;
    const long long wi = e >> 4, ni = e >> 5;
    Piece pc;
    pc.crumbs = __funnelshift_r(flat_word(t.w, t.n, wi),
                                flat_word(t.w, t.n, wi + 1),
                                2 * (int)(e & 15));
    pc.nbits = __funnelshift_r(flat_word(t.nw, t.nn, ni),
                               flat_word(t.nw, t.nn, ni + 1), (int)(e & 31));
    if (e != q) {
        // the first d codes read position -2^24, the rest follow from it
        const long long dd = e - q;
        const int d = dd > 16 ? 16 : (int)dd;
        const uint32_t cr = (pc.crumbs & 3u) * 0x55555555u;
        const uint32_t nr = (pc.nbits & 1u) ? 0xFFFFFFFFu : 0u;
        pc.crumbs = d == 16 ? cr
                            : (pc.crumbs << (2 * d)) | (cr & low_bits(2 * d));
        pc.nbits = d == 16 ? nr : (pc.nbits << d) | (nr & low_bits(d));
    }
    // code i is in bounds where (p_i - lo) mod 2^bits < hi - lo, p_i =
    // s + j + i wrapping in P: the codes before a + i wraps to 0, and those
    // from there (w = -a, when below 16)
    const U a = (U)s + (U)j - (U)l;
    const U R = h > l ? (U)h - (U)l : (U)0;
    const U R16 = R < (U)16 ? R : (U)16;
    pc.inb = a < R ? low_bits((int)(R - a < (U)16 ? R - a : (U)16)) : 0u;
    const U w = (U)0 - a;
    if (a != 0 && w < (U)16) {
        const int end = (int)(w + R16);
        pc.inb |= low_bits(end < 16 ? end : 16) & ~low_bits((int)w);
    }
    return pc;
}

template <typename P>
__global__ void __launch_bounds__(U_THREADS)
unaligned_kernel(Words t, const P* __restrict__ starts,
                 const P* __restrict__ lo, const P* __restrict__ hi,
                 unsigned long long B, unsigned long long width,
                 int* __restrict__ out) {
    using G = unsigned long long;              // the flat index
    __shared__ int4 stage[U_THREADS / 32][32 * 4];  // a warp's 512 codes
    const G total = B * width;
    for (G g = ((G)blockIdx.x * U_THREADS + threadIdx.x) * CHUNK;
         g < total; g += (G)gridDim.x * U_THREADS * CHUNK) {
        const int n = total - g < (G)CHUNK ? (int)(total - g) : CHUNK;
        G b = g / width, j = g - b * width;
        uint32_t crumbs = 0, nbits = 0, inb = 0;
        if (width >= (G)CHUNK) {
            // row b from j, and row b + 1 from 0 where the codes cross
            const G left = width - j;
            const int len = left < (G)n ? (int)left : n;
            const bool two = len < n;
            const Piece p0 = row_piece<P>(t, starts, lo, hi, (long long)b,
                                          (long long)j);
            Piece p1{0u, 0u, 0u};
            if (two)
                p1 = row_piece<P>(t, starts, lo, hi, (long long)(b + 1), 0);
            crumbs = (p0.crumbs & low_bits(2 * len))
                     | (two ? p1.crumbs << (2 * len) : 0u);
            nbits = (p0.nbits & low_bits(len)) | (two ? p1.nbits << len : 0u);
            inb = (p0.inb & low_bits(len)) | (two ? p1.inb << len : 0u);
        } else {
            for (int done = 0; done < n; ++b, j = 0) {
                const G left = width - j;
                const int len = left < (G)(n - done) ? (int)left : n - done;
                const Piece pc = row_piece<P>(t, starts, lo, hi,
                                              (long long)b, (long long)j);
                crumbs |= (pc.crumbs & low_bits(2 * len)) << (2 * done);
                nbits |= (pc.nbits & low_bits(len)) << done;
                inb |= (pc.inb & low_bits(len)) << done;
                done += len;
            }
        }
        int c[CHUNK];
        #pragma unroll
        for (int i = 0; i < CHUNK; ++i)
            c[i] = !((inb >> i) & 1u) ? 5
                   : ((nbits >> i) & 1u) ? 4
                   : (int)((crumbs >> (2 * i)) & 3u);
        // a whole warp's run through shared memory: thread t's 16-byte
        // store q at slot 4 t + (q + t / 2) mod 4, read back as the run's
        // 16-byte piece 32 q + t
        const int lane = threadIdx.x & 31;
        const G wbase = g - (G)(CHUNK * lane);
        if (wbase + 32 * CHUNK <= total) {
            int4* st = stage[threadIdx.x >> 5];
            #pragma unroll
            for (int q = 0; q < 4; ++q)
                st[4 * lane + ((q + (lane >> 1)) & 3)] = make_int4(
                    c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]);
            __syncwarp();
            int4* o = reinterpret_cast<int4*>(out + wbase);
            #pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int m = 32 * q + lane, ch = m >> 2;
                o[m] = st[4 * ch + (((m & 3) + (ch >> 1)) & 3)];
            }
            __syncwarp();
        } else if (n == CHUNK) {
            int4* o = reinterpret_cast<int4*>(out + g);
            #pragma unroll
            for (int q = 0; q < 4; ++q)
                o[q] = make_int4(c[4 * q], c[4 * q + 1], c[4 * q + 2],
                                 c[4 * q + 3]);
        } else {
            #pragma unroll
            for (int i = 0; i < CHUNK; ++i)
                if (i < n) out[g + i] = c[i];
        }
    }
}

unsigned grid_of(long long threads, int per = THREADS) {
    // a grid-stride loop past this many blocks (a few waves of the card)
    const long long blocks = (threads + per - 1) / per;
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
    const long long total = B * width;
    const unsigned grid = grid_of((total + CHUNK - 1) / CHUNK, U_THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    using u64 = unsigned long long;
    if (pos64)
        unaligned_kernel<long long><<<grid, U_THREADS, 0, st>>>(
            t, (const long long*)starts, (const long long*)lo,
            (const long long*)hi, (u64)B, (u64)width, (int*)out);
    else
        unaligned_kernel<int><<<grid, U_THREADS, 0, st>>>(
            t, (const int*)starts, (const int*)lo, (const int*)hi, (u64)B,
            (u64)width, (int*)out);
    return (int)cudaGetLastError();
}
