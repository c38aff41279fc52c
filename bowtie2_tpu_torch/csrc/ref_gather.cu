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
// sharded index mode's word tables (a device array of the S shards'
// addresses, per words each), not clipped: a word no shard owns reads as
// 0, as the JAX mode's owner-computes psum gives it (ops/fm.py:55
// _take_sharded).
//
// Aligned form: a row starts at starts & ~31, so its 16-code groups are
// whole reference words and its 32-code groups whole N words. A thread
// takes one 16-code group of the flat B x (Wa / 16) groups: one reference
// word, the matching half of an N word, and its in-bounds bits as one bit
// field (lo is raised to starts, so one range test about the P wrap covers
// both). Wa is a multiple of 16, so a warp's 32 groups are one contiguous
// 2-KB run of the output: each lane takes the bit fields of group
// 8 q + lane / 4 by two shuffles and writes its quarter as 16-byte piece
// 32 q + lane of the run, so each of the warp's four stores is one 512-byte
// row (a thread's own four 16-byte stores would leave each a 64-byte
// stride). The group's row is one multiply and shift (a reciprocal of
// Wa / 16 computed on the host; a call holds at most 2^31 groups, 128 GiB
// of output), and in the sharded form a word's shard the same (a
// reciprocal of the words a shard), so a thread waits on memory for its
// row's start and then for its two words. Blocks
// of 128 threads, as the unaligned form: a call of a few hundred windows
// spreads over more SMs.
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
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;         // threads a block, both forms
constexpr unsigned FULL = 0xFFFFFFFFu;

template <typename P> struct Unsigned;
template <> struct Unsigned<int> { using T = unsigned; };
template <> struct Unsigned<long long> { using T = unsigned long long; };

// n / d for 0 <= n < 2^31 as a multiply and a shift: mul = ceil(2^(31 +
// l) / d) with l = ceil(log2 d), shr = l - 1 (d = 1: n itself)
struct Div {
    unsigned d, mul, shr;
};

Div make_div(unsigned d) {
    if (d <= 1) return Div{1u, 0u, 0u};
    unsigned l = 0;
    while ((1ull << l) < d) ++l;
    return Div{d, (unsigned)(((1ull << (31 + l)) + d - 1) / d), l - 1};
}

__device__ __forceinline__ unsigned div_of(const Div& v, unsigned n) {
    return v.d == 1u ? n : __umulhi(n, v.mul) >> v.shr;
}

// a word table split over shards: the device array of their addresses,
// per words each, n = per * S words in all
struct Shards {
    const unsigned long long* __restrict__ p;
    long long n;
    unsigned per;
    Div div;
};

// the flat tables and their lengths (the unaligned form's argument)
struct Flat {
    const uint32_t* w;
    const uint32_t* nw;
    long long n, nn;
};

struct Words {
    Flat f;                 // flat
    Shards ws, ns;          // sharded
};

__device__ __forceinline__ uint32_t flat_word(const uint32_t* t, long long n,
                                              long long i) {
    i = i < 0 ? 0 : (i >= n ? n - 1 : i);
    return __ldg(t + i);
}

// a word of a sharded table, 0 where no shard owns it
__device__ __forceinline__ uint32_t shard_word(const Shards& sh,
                                               long long i) {
    if (i < 0 || i >= sh.n) return 0u;
    const unsigned s = div_of(sh.div, (unsigned)i);
    const uint32_t* base =
        reinterpret_cast<const uint32_t*>(__ldg(sh.p + s));
    return __ldg(base + ((unsigned)i - s * sh.per));
}

template <bool SH>
__device__ __forceinline__ uint32_t ref_word(const Words& t, long long i) {
    if constexpr (SH) return shard_word(t.ws, i);
    else return flat_word(t.f.w, t.f.n, i);
}

template <bool SH>
__device__ __forceinline__ uint32_t n_word(const Words& t, long long i) {
    if constexpr (SH) return shard_word(t.ns, i);
    else return flat_word(t.f.nw, t.f.nn, i);
}

// the k low bits set, k in [0, 32]
__device__ __forceinline__ uint32_t low_bits(int k) {
    return k >= 32 ? 0xFFFFFFFFu : (1u << k) - 1u;
}

// The in-bounds bits of 16 consecutive positions p_i = m + x + i (wrapping
// in U's width) of a range [m, m + R): bit i is set where (x + i) mod
// 2^bits < R, i.e. the positions before x + i wraps to 0 and those from
// there (w = -x, when below 16).
template <typename U>
__device__ __forceinline__ uint32_t in_bits16(U x, U R) {
    uint32_t inb = x < R ? low_bits((int)(R - x < (U)16 ? R - x : (U)16))
                         : 0u;
    const U w = (U)0 - x;
    if (x != 0 && w < (U)16) {
        const int end = (int)(w + (R < (U)16 ? R : (U)16));
        inb |= low_bits(end < 16 ? end : 16) & ~low_bits((int)w);
    }
    return inb;
}

template <typename P, bool SH>
__global__ void __launch_bounds__(THREADS)
aligned_kernel(Words t, const P* __restrict__ starts,
               const P* __restrict__ lo, const P* __restrict__ hi,
               unsigned total, int groups, Div gdiv,
               int* __restrict__ out, int* __restrict__ col_shift) {
    using U = typename Unsigned<P>::T;
    const int lane = threadIdx.x & 31;
    // g0, the warp's first group, is the same in every lane: the loop and
    // the shuffles run over the full warp (total <= 2^31 and the grid's
    // threads <= 2^27, so g0 never wraps)
    for (unsigned g0 = blockIdx.x * THREADS + (threadIdx.x & ~31u);
         g0 < total; g0 += gridDim.x * THREADS) {
        const unsigned g = g0 + lane;
        // group g's crumbs, and its N bits (low half) and in-bounds bits
        // (high half)
        uint32_t crumbs = 0u, bits = 0u;
        if (g < total) {
            const unsigned b = div_of(gdiv, g);
            const int k = (int)(g - b * (unsigned)groups);
            const P s = __ldg(starts + b), l = __ldg(lo + b),
                    h = __ldg(hi + b);
            const P a = s & ~(P)31;
            if (k == 0) col_shift[b] = (int)(s - a);
            crumbs = ref_word<SH>(t, (long long)(a >> 4) + k);
            const uint32_t nw = n_word<SH>(t, (long long)(a >> 5) + (k >> 1));
            // code i (position p = a + 16 k + i, wrapping in P) is in
            // bounds where l <= p < h and p >= s: p in [m, h), m = max(l, s)
            const P m = l > s ? l : s;
            const U R = h > m ? (U)h - (U)m : (U)0;
            const U x = (U)a + (U)(16 * k) - (U)m;
            bits = ((nw >> (16 * (k & 1))) & 0xFFFFu) | (in_bits16<U>(x, R)
                                                         << 16);
        }
        // 16-byte piece 32 q + lane of the warp's run: quarter lane % 4 of
        // its group 8 q + lane / 4
        int4* o = reinterpret_cast<int4*>(out) + 4 * (size_t)g0;
        #pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int src = 8 * q + (lane >> 2);
            const uint32_t cr = __shfl_sync(FULL, crumbs, src);
            const uint32_t bt = __shfl_sync(FULL, bits, src);
            if (g0 + src < total) {
                const int i0 = 4 * (lane & 3);
                int c[4];
                #pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int j = i0 + i;
                    c[i] = !((bt >> (16 + j)) & 1u) ? 5
                           : ((bt >> j) & 1u) ? 4
                           : (int)((cr >> (2 * j)) & 3u);
                }
                o[32 * q + lane] = make_int4(c[0], c[1], c[2], c[3]);
            }
        }
    }
}

constexpr int CHUNK = 16;            // codes a thread of the unaligned form

// Codes j .. j + 15 of window b (fewer are used at a row's end) as bit
// fields from bit 0: the crumbs (two bits a code), the N bits and the
// in-bounds bits.
struct Piece {
    uint32_t crumbs, nbits, inb;
};

template <typename P>
__device__ __forceinline__ Piece row_piece(const Flat& t,
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
    // s + j + i wrapping in P
    pc.inb = in_bits16<U>((U)s + (U)j - (U)l,
                          h > l ? (U)h - (U)l : (U)0);
    return pc;
}

template <typename P>
__global__ void __launch_bounds__(THREADS)
unaligned_kernel(Flat t, const P* __restrict__ starts,
                 const P* __restrict__ lo, const P* __restrict__ hi,
                 unsigned long long B, unsigned long long width,
                 int* __restrict__ out) {
    using G = unsigned long long;              // the flat index
    __shared__ int4 stage[THREADS / 32][32 * 4];  // a warp's 512 codes
    const G total = B * width;
    for (G g = ((G)blockIdx.x * THREADS + threadIdx.x) * CHUNK;
         g < total; g += (G)gridDim.x * THREADS * CHUNK) {
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
    const int groups = Wa / 16;
    // the row reciprocal's range: 2^31 groups are 128 GiB of output
    if (B > (1LL << 31) / groups) return (int)cudaErrorInvalidValue;
    const long long total = B * groups;
    aligned_kernel<P, SH><<<grid_of(total), THREADS, 0,
                            (cudaStream_t)stream>>>(
        t, (const P*)starts, (const P*)lo, (const P*)hi, (unsigned)total,
        groups, make_div((unsigned)groups), (int*)out, (int*)shift);
    return (int)cudaGetLastError();
}

// a sharded table's description; false where its words pass 2^31 (the
// shard lookup's range)
bool shards_of(const void* addrs, int per, int S, Shards& sh) {
    if (per <= 0 || S <= 0 || (long long)per * S > (1LL << 31)) return false;
    sh = Shards{(const unsigned long long*)addrs, (long long)per * S,
                (unsigned)per, make_div((unsigned)per)};
    return true;
}

}  // namespace

// win[b, :] (B x Wa int32 codes) and col_shift[b] of the aligned form over
// the flat tables (words: n_words int32 words of 2-bit codes; nwords:
// n_nwords N-bit words); starts, lo, hi: B positions, int64 when pos64 is
// set, else int32. Wa: a multiple of 32; B x Wa / 16 at most 2^31.
extern "C" int ref_gather_aligned(const void* words, long long n_words,
                                  const void* nwords, long long n_nwords,
                                  const void* starts, const void* lo,
                                  const void* hi, int pos64, long long B,
                                  int Wa, void* out, void* shift,
                                  void* stream) {
    if (n_words <= 0 || n_nwords <= 0) return (int)cudaErrorInvalidValue;
    Words t{{(const uint32_t*)words, (const uint32_t*)nwords, n_words,
             n_nwords}, {}, {}};
    return pos64 ? launch_aligned<long long, false>(t, starts, lo, hi, B, Wa,
                                                    out, shift, stream)
                 : launch_aligned<int, false>(t, starts, lo, hi, B, Wa, out,
                                              shift, stream);
}

// The same over sharded word tables: wshards / nshards, the device arrays
// of the S (nS) shards' addresses, per (nper) words each, at most 2^31
// words a table.
extern "C" int ref_gather_aligned_sh(const void* wshards, int per, int S,
                                     const void* nshards, int nper, int nS,
                                     const void* starts, const void* lo,
                                     const void* hi, int pos64, long long B,
                                     int Wa, void* out, void* shift,
                                     void* stream) {
    Words t{{nullptr, nullptr, 0, 0}, {}, {}};
    if (!shards_of(wshards, per, S, t.ws) ||
        !shards_of(nshards, nper, nS, t.ns))
        return (int)cudaErrorInvalidValue;
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
    Flat t{(const uint32_t*)words, (const uint32_t*)nwords, n_words,
           n_nwords};
    const long long total = B * width;
    const unsigned grid = grid_of((total + CHUNK - 1) / CHUNK, THREADS);
    cudaStream_t st = (cudaStream_t)stream;
    using u64 = unsigned long long;
    if (pos64)
        unaligned_kernel<long long><<<grid, THREADS, 0, st>>>(
            t, (const long long*)starts, (const long long*)lo,
            (const long long*)hi, (u64)B, (u64)width, (int*)out);
    else
        unaligned_kernel<int><<<grid, THREADS, 0, st>>>(
            t, (const int*)starts, (const int*)lo, (const int*)hi, (u64)B,
            (u64)width, (int*)out);
    return (int)cudaGetLastError();
}
