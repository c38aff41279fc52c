// Kernel A: batched backward FM-index searches.
//
// Replaces (bowtie2_tpu/ops/fm.py):
//   exact_sweep_rr      :215  whole-read sweep with restart + edit count
//   substring_search_rr :275  half-read search, an empty range kills it
//   seed_search_exact   :335  ftab-seeded fixed-length seed search
// each a lax.scan over the pattern columns with one batched row gather per
// LF step. Here the whole column loop runs inside the kernel: top and bot
// advance together.
//
// Bound on the card: latency of dependent 48-byte row loads (every step
// needs the row of the previous step's result). The index of a 5-Mbp genome
// is ~1.9 MB of fm_blocks, resident in the 50 MB L2, so the loads are L2
// hits, and the time is the step count times one L2 round trip plus the
// count, unless too few warps are in flight to overlap the states.
//
// The sweep (sweep_kernel) puts two lanes on each state: one takes the top
// row and one the bot row of every LF step, each with two 16-byte loads
// and one 4-byte count, and one shuffle swaps the results (fm_lf2_pair).
// When top and bot share a block, the two lanes ask for the same bytes in
// one warp load, which the memory system serves once. The block's
// patterns are staged in shared memory as bytes with coalesced loads, 128
// columns at a time, so no pattern load sits on the chain; a step that no
// state of the warp searches (the code-5 tail of shorter reads) costs no
// row load; fchr lives in registers. Groups of four and eight lanes
// (fewer words to count a lane, one and two more shuffles on the chain)
// ran slower on the main path's first call (PERF.md).
//
// The half-read and seed searches are bound less by the chain than by the
// card's throughput: one block alone takes a third (seeds) to two thirds
// (halves) of the full call. So both stage their patterns with
// 16-byte loads of the block's contiguous codes (no division or byte load
// a code) and count crumbs with fm_count_lean (one funnel shift a word's
// mask).
//
// The half-read search (substring_kernel) takes the sweep's design: two
// lanes a state over fm_lf2_pair, fchr in registers, and a step that no
// live state of the warp takes (code 5, or every state of the warp dead)
// costs no row load. A state dies on an N or an empty range instead of
// restarting.
//
// The seed search (seed_kernel) keeps one thread a seed, since its seeds
// are short (22 codes, 12 LF steps after the ftab start on the main path)
// and many. Each seed is held in registers as 2-bit codes in a 64-bit word
// with an N mask, so the ftab key and the N test of the tail cost no load
// and the ftab lookup is the first access on the chain. A LF step of both
// ends loads one row when top and bot share a block, most live steps once
// the ftab has narrowed the range, and both rows' loads together otherwise
// (fm_lf_range). A dead seed stops. At most 64 registers keep the main
// path's 1,024 blocks in one wave.
//
// Each kernel is a template on the row type R (fm_common.cuh): int for the
// small mode (fm_sweep, fm_substring, fm_seed), uint32_t for the large
// mode's uint32 row space (the `_u32` entries), which writes its rows as
// int64, and long long for the int64 mode past 2^32 rows (the `_i64`
// entries), whose LF steps read each checkpoint from occ_cp64 beside the
// fused row; and on the row source: one flat fm_blocks table, or the sharded
// index mode's shards (the `_sh` entries, each LF step finding its row's
// owner shard by a divide and its address in the shards' address array).
// Launch shapes, staging and shared memory are the same in all six.
#include "fm_common.cuh"

namespace {

constexpr int SWEEP_THREADS = 128;
constexpr int SWEEP_STATES = SWEEP_THREADS / 2;   // two lanes a state
constexpr int SWEEP_CHUNK = 128;            // pattern columns staged at once
// words per staged pattern: +1 so the states of a warp hit distinct banks
constexpr int SWEEP_STRIDE = SWEEP_CHUNK / 4 + 1;

template <typename R, typename Src>
__global__ void __launch_bounds__(SWEEP_THREADS)
sweep_kernel(const uint32_t* __restrict__ fm, int nblocks,
             const ShardTab sh,
             const R* __restrict__ fchr, R z_off, R nrows,
             const int* __restrict__ rr, int B, int L,
             typename RowOut<R>::T* top_out, typename RowOut<R>::T* bot_out,
             int* nedit_out, const void* __restrict__ cp64) {
    __shared__ uint32_t pat[SWEEP_STATES * SWEEP_STRIDE];
    const int t = threadIdx.x;
    const int g = t >> 1, j = t & 1;
    const int b0 = blockIdx.x * SWEEP_STATES;
    const R f0 = __ldg(fchr), f1 = __ldg(fchr + 1), f2 = __ldg(fchr + 2),
            f3 = __ldg(fchr + 3);
    R top = 0, bot = nrows;
    int nedit = 0;
    for (int p0 = 0; p0 < L; p0 += SWEEP_CHUNK) {
        const int n = min(SWEEP_CHUNK, L - p0);
        __syncthreads();                     // the previous chunk is used
        unsigned char* pb = reinterpret_cast<unsigned char*>(pat);
        for (int idx = t; idx < SWEEP_STATES * SWEEP_CHUNK;
             idx += SWEEP_THREADS) {
            const int s = idx / SWEEP_CHUNK, q = idx % SWEEP_CHUNK;
            int c = 5;                       // past the pattern or the batch
            if (q < n && b0 + s < B) {
                c = __ldg(rr + (size_t)(b0 + s) * L + p0 + q);
                c = c < 0 ? 0 : (c > 5 ? 5 : c);
            }
            pb[s * SWEEP_STRIDE * 4 + q] = (unsigned char)c;
        }
        __syncthreads();
        for (int q = 0; q < n; q += 4) {
            const uint32_t cw = pat[g * SWEEP_STRIDE + q / 4];
            #pragma unroll
            for (int u = 0; u < 4; ++u) {
                if (q + u >= n) break;       // the same for the whole block
                const int c = (cw >> (8 * u)) & 0xFF;
                // all lanes of the warp take part in the shuffles, or none
                if (__any_sync(0xFFFFFFFFu, c < 4)) {
                    const int cc = c < 4 ? c : 0;
                    const R fc = cc == 0 ? f0 : (cc == 1 ? f1
                                               : (cc == 2 ? f2 : f3));
                    R nt, nb;
                    if constexpr (Cp64<R>::ON)
                        fm_lf2_pair_i64<false, Src>(fm, nblocks, sh, cp64,
                                                    fc, z_off, top, bot, cc,
                                                    j, nt, nb);
                    else
                        fm_lf2_pair<false, R, Src>(fm, nblocks, sh, fc,
                                                   z_off, top, bot, cc, j,
                                                   nt, nb);
                    if (c < 4) {
                        const bool empty = nt >= nb;
                        top = empty ? 0 : nt;
                        bot = empty ? nrows : nb;
                        nedit += empty ? 1 : 0;
                    }
                }
                if (c == 4) {                // N: restart, count an edit
                    top = 0;
                    bot = nrows;
                    ++nedit;
                }
            }
        }
    }
    const int b = b0 + g;
    if (j == 0 && b < B) {
        top_out[b] = top;
        bot_out[b] = bot;
        nedit_out[b] = nedit;
    }
}

// A code clamped to 0..HI as the plain versions read it: below 0 is an A;
// HI is an N for the seed search, a skipped step for the half-read search.
template <int HI>
__device__ __forceinline__ uint32_t code_byte(int c) {
    return (uint32_t)(c < 0 ? 0 : (c > HI ? HI : c));
}

// The codes of columns [p0, p0 + n) of the block's states (row s of `src`
// is state b0 + s), as bytes at pb[s * n + q], for states below B. When
// the columns are whole rows, the block's codes are one contiguous run:
// 16-byte loads of consecutive codes by consecutive threads, UNROLL of
// them in flight a thread, four codes packed into one 4-byte store.
// Otherwise (a chunk of longer rows, or a run not 16-byte aligned) one code
// a load.
template <int THREADS, int HI>
__device__ __forceinline__ void stage_rows(uint32_t* pat,
                                           const int* __restrict__ src,
                                           int B, int L, int b0, int states,
                                           int p0, int n) {
    constexpr int UNROLL = 4;
    unsigned char* pb = reinterpret_cast<unsigned char*>(pat);
    const int total = min(states, B - b0) * n;
    const int* s0 = src + (size_t)b0 * L + p0;
    if (n == L && (reinterpret_cast<uintptr_t>(s0) & 15) == 0) {
        const int4* v = reinterpret_cast<const int4*>(s0);
        const int n4 = total >> 2;
        for (int base = threadIdx.x; base < n4; base += UNROLL * THREADS) {
            int4 x[UNROLL];
            #pragma unroll
            for (int k = 0; k < UNROLL; ++k)
                if (base + k * THREADS < n4) x[k] = __ldg(v + base + k * THREADS);
            #pragma unroll
            for (int k = 0; k < UNROLL; ++k)
                if (base + k * THREADS < n4)
                    pat[base + k * THREADS] =
                        code_byte<HI>(x[k].x) | code_byte<HI>(x[k].y) << 8
                        | code_byte<HI>(x[k].z) << 16
                        | code_byte<HI>(x[k].w) << 24;
        }
        const int r = 4 * n4 + threadIdx.x;        // the last total mod 4
        if (r < total) pb[r] = (unsigned char)code_byte<HI>(__ldg(s0 + r));
        return;
    }
    for (int idx = threadIdx.x; idx < total; idx += THREADS) {
        const int st = idx / n;
        pb[idx] = (unsigned char)code_byte<HI>(
            __ldg(s0 + (size_t)st * L + idx - st * n));
    }
}

// the four staged codes at byte offset off (any alignment)
__device__ __forceinline__ uint32_t codes4(const uint32_t* pat, int off) {
    const uint32_t* w = pat + (off >> 2);
    return __funnelshift_r(w[0], w[1], 8 * (off & 3));
}

template <typename R, typename Src>
__global__ void __launch_bounds__(SWEEP_THREADS)
substring_kernel(const uint32_t* __restrict__ fm, int nblocks,
                 const ShardTab sh,
                 const R* __restrict__ fchr, R z_off, R nrows,
                 const int* __restrict__ rr, int B, int L,
                 typename RowOut<R>::T* top_out,
                 typename RowOut<R>::T* bot_out,
                 const void* __restrict__ cp64) {
    // + 2 words: codes4 reads a word past a pattern's last code
    __shared__ uint32_t pat[SWEEP_STATES * SWEEP_CHUNK / 4 + 2];
    const int t = threadIdx.x;
    const int g = t >> 1, j = t & 1;
    const int b0 = blockIdx.x * SWEEP_STATES, b = b0 + g;
    const R f0 = __ldg(fchr), f1 = __ldg(fchr + 1), f2 = __ldg(fchr + 2),
            f3 = __ldg(fchr + 3);
    // a state past the batch starts dead and never steps
    R top = b < B ? 0 : 1, bot = b < B ? nrows : 0;
    for (int p0 = 0; p0 < L; p0 += SWEEP_CHUNK) {
        const int n = min(SWEEP_CHUNK, L - p0);
        __syncthreads();                     // the previous chunk is used
        stage_rows<SWEEP_THREADS, 5>(pat, rr, B, L, b0, SWEEP_STATES, p0, n);
        __syncthreads();
        for (int q = 0; q < n; q += 4) {
            const uint32_t cw = codes4(pat, g * n + q);
            #pragma unroll
            for (int u = 0; u < 4; ++u) {
                if (q + u >= n) break;       // the same for the whole block
                const int c = (cw >> (8 * u)) & 0xFF;
                const bool step = c < 4 && top < bot;
                // all lanes of the warp take part in the shuffles, or none
                if (__any_sync(0xFFFFFFFFu, step)) {
                    const int cc = c < 4 ? c : 0;
                    const R fc = cc == 0 ? f0 : (cc == 1 ? f1
                                               : (cc == 2 ? f2 : f3));
                    // a state that does not step loads row 0 (a dead
                    // range's bot may be -1)
                    R nt, nb;
                    if constexpr (Cp64<R>::ON)
                        fm_lf2_pair_i64<true, Src>(fm, nblocks, sh, cp64, fc,
                                                   z_off, step ? top : (R)0,
                                                   step ? bot : (R)0, cc, j,
                                                   nt, nb);
                    else
                        fm_lf2_pair<true, R, Src>(fm, nblocks, sh, fc, z_off,
                                                  step ? top : (R)0,
                                                  step ? bot : (R)0, cc, j,
                                                  nt, nb);
                    if (step) {
                        top = nt;
                        bot = nb;
                    }
                }
                if (c < 5 && !step) {        // an N, or an empty range: dead
                    top = 1;
                    bot = 0;
                }
            }
        }
    }
    if (j == 0 && b < B) {
        top_out[b] = top;
        bot_out[b] = bot > top ? bot : top;
    }
}

constexpr int SEED_THREADS = 128;           // one thread a seed
constexpr int SEED_CHUNK = 32;              // codes a 64-bit word holds
// blocks an SM must hold: at most 64 registers a thread, so that the main
// path's 1,024 blocks of seeds run in one wave on 132 SMs
constexpr int SEED_MIN_BLOCKS = 8;

template <typename R, typename Src>
__global__ void __launch_bounds__(SEED_THREADS, SEED_MIN_BLOCKS)
seed_kernel(const uint32_t* __restrict__ fm, int nblocks,
            const ShardTab sh,
            const R* __restrict__ fchr, R z_off, R nrows,
            const R* __restrict__ ftab, const int* __restrict__ seeds,
            const unsigned char* __restrict__ valid, int B, int L, int K,
            typename RowOut<R>::T* top_out, typename RowOut<R>::T* bot_out,
            const void* __restrict__ cp64) {
    // + 2 words: codes4 reads a word past a seed's last code
    __shared__ uint32_t pat[SEED_THREADS * SEED_CHUNK / 4 + 2];
    const int t = threadIdx.x;
    const int b0 = blockIdx.x * SEED_THREADS, b = b0 + t;
    const R f0 = __ldg(fchr), f1 = __ldg(fchr + 1), f2 = __ldg(fchr + 2),
            f3 = __ldg(fchr + 3);
    const bool ok0 = b < B && valid[b] != 0;
    R top = 0, bot = ok0 ? nrows : (R)0;
    bool live = b < B;
    // chunks of up to 32 columns from the right end: the LF steps run right
    // to left, and the ftab tail (K <= 32, checked at the launch) lies in
    // the first chunk
    for (int end = L; end > 0; end -= SEED_CHUNK) {
        const int p0 = max(end - SEED_CHUNK, 0), n = end - p0;
        // every thread stages; stop once no seed of the block steps on
        if (!__syncthreads_or(live)) break;
        stage_rows<SEED_THREADS, 4>(pat, seeds, B, L, b0, SEED_THREADS, p0,
                                    n);
        __syncthreads();
        // this seed's codes: column p0 + i at bits 2i of w, its N at bit i
        // of nm (bytes past n are the next seed's, masked off)
        uint64_t w = 0;
        uint32_t nm = 0;
        #pragma unroll
        for (int k = 0; k < SEED_CHUNK / 4; ++k) {
            if (4 * k >= n) break;
            const uint32_t x = codes4(pat, t * n + 4 * k);
            uint32_t lo = x & 0x03030303u;
            lo = (lo | (lo >> 6)) & 0x000F000Fu;
            lo = (lo | (lo >> 12)) & 0xFFu;
            uint32_t hn = (x >> 2) & 0x01010101u;
            hn |= hn >> 7;
            hn = (hn | (hn >> 14)) & 0xFu;
            w |= (uint64_t)lo << (8 * k);
            nm |= hn << (4 * k);
        }
        if (n < SEED_CHUNK) nm &= (1u << n) - 1u;
        int q = n - 1;
        if (end == L && K > 0 && K <= L) {
            // the last K codes are one ftab lookup; the first weighs 4^(K-1)
            uint32_t key = 0;
            for (int i = n - K; i < n; ++i)
                key = key * 4 + (uint32_t)((w >> (2 * i)) & 3u);
            const bool ok = ok0 && (nm >> (n - K)) == 0;
            top = ok ? __ldg(ftab + 2 * (size_t)key + 1) : 1;
            bot = ok ? __ldg(ftab + 2 * (size_t)key + 2) : 0;
            q = n - K - 1;
        }
        for (; live && q >= 0; --q) {                // right to left
            if (((nm >> q) & 1u) || top >= bot) {    // dead: stop
                top = 1;
                bot = 0;
                live = false;
            } else {
                const int c = (int)(w >> (2 * q)) & 3;
                const R fc = c == 0 ? f0 : (c == 1 ? f1 : (c == 2 ? f2 : f3));
                if constexpr (Cp64<R>::ON)
                    fm_lf_range_i64<Src>(fm, nblocks, sh, cp64, fc, z_off, c,
                                         top, bot);
                else
                    fm_lf_range<R, Src>(fm, nblocks, sh, fc, z_off, c, top,
                                        bot);
            }
        }
    }
    if (b < B) {
        top_out[b] = top;
        bot_out[b] = bot > top ? bot : top;
    }
}

// the launches, one per kernel, row type and row source: (fm, nblocks) a
// flat table, or (shard addresses, rows a shard) and S shards, which the
// kernels take as a ShardTab (unused by the flat kernels)
ShardTab tab(const void* shards, int per, int S) {
    return ShardTab{(const unsigned long long*)shards, per, S};
}

template <typename R, typename Src>
int launch_sweep(const void* fm, int nblocks, int S, const void* cp64,
                 const void* fchr, R z_off, R nrows, const void* rr, int B,
                 int L, void* top, void* bot, void* nedit, void* stream) {
    using O = typename RowOut<R>::T;
    if (B > 0)
        sweep_kernel<R, Src><<<(B + SWEEP_STATES - 1) / SWEEP_STATES,
                               SWEEP_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)fm, nblocks, tab(fm, nblocks, S),
            (const R*)fchr, z_off, nrows, (const int*)rr, B, L, (O*)top,
            (O*)bot, (int*)nedit, cp64);
    return (int)cudaGetLastError();
}

template <typename R, typename Src>
int launch_substring(const void* fm, int nblocks, int S, const void* cp64,
                     const void* fchr, R z_off, R nrows, const void* rr,
                     int B, int L, void* top, void* bot, void* stream) {
    using O = typename RowOut<R>::T;
    if (B > 0)
        substring_kernel<R, Src><<<(B + SWEEP_STATES - 1) / SWEEP_STATES,
                                   SWEEP_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)fm, nblocks, tab(fm, nblocks, S),
            (const R*)fchr, z_off, nrows, (const int*)rr, B, L, (O*)top,
            (O*)bot, cp64);
    return (int)cudaGetLastError();
}

template <typename R, typename Src>
int launch_seed(const void* fm, int nblocks, int S, const void* cp64,
                const void* fchr, R z_off, R nrows, const void* ftab,
                const void* seeds, const void* valid, int B, int L, int K,
                void* top, void* bot, void* stream) {
    using O = typename RowOut<R>::T;
    // a ftab key of more than 32 codes would not lie in the first chunk
    // (and no ftab has one: keys are 4^K entries with K <= 15)
    if (K > SEED_CHUNK && K <= L) return (int)cudaErrorInvalidValue;
    if (B > 0)
        seed_kernel<R, Src><<<(B + SEED_THREADS - 1) / SEED_THREADS,
                              SEED_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)fm, nblocks, tab(fm, nblocks, S),
            (const R*)fchr, z_off, nrows, (const R*)ftab, (const int*)seeds,
            (const unsigned char*)valid, B, L, K, (O*)top, (O*)bot, cp64);
    return (int)cudaGetLastError();
}

}  // namespace

// The C entries: fm_<search> over one flat table (fm, nblocks), and
// fm_<search>_sh over a sharded one (shards: S device addresses of `per`
// fm_blocks rows each); each with a `_u32` twin in the large row mode and
// an `_i64` twin in the int64 row mode, which takes occ_cp64 (the table,
// or its S shards' addresses, `per` rows each) after the FM table.
extern "C" int fm_sweep(const void* fm, int nblocks, const void* fchr,
                        int z_off, int nrows, const void* rr, int B, int L,
                        void* top, void* bot, void* nedit, void* stream) {
    return launch_sweep<int, FlatRows>(fm, nblocks, 1, nullptr, fchr, z_off,
                                       nrows, rr, B, L, top, bot, nedit,
                                       stream);
}

extern "C" int fm_sweep_u32(const void* fm, int nblocks, const void* fchr,
                            unsigned z_off, unsigned nrows, const void* rr,
                            int B, int L, void* top, void* bot, void* nedit,
                            void* stream) {
    return launch_sweep<uint32_t, FlatRows>(fm, nblocks, 1, nullptr, fchr,
                                            z_off, nrows, rr, B, L, top, bot,
                                            nedit, stream);
}

extern "C" int fm_sweep_sh(const void* shards, int per, int S,
                           const void* fchr, int z_off, int nrows,
                           const void* rr, int B, int L, void* top, void* bot,
                           void* nedit, void* stream) {
    return launch_sweep<int, ShardRows>(shards, per, S, nullptr, fchr, z_off,
                                        nrows, rr, B, L, top, bot, nedit,
                                        stream);
}

extern "C" int fm_sweep_sh_u32(const void* shards, int per, int S,
                               const void* fchr, unsigned z_off,
                               unsigned nrows, const void* rr, int B, int L,
                               void* top, void* bot, void* nedit,
                               void* stream) {
    return launch_sweep<uint32_t, ShardRows>(shards, per, S, nullptr, fchr,
                                             z_off, nrows, rr, B, L, top, bot,
                                             nedit, stream);
}

extern "C" int fm_substring(const void* fm, int nblocks, const void* fchr,
                            int z_off, int nrows, const void* rr, int B, int L,
                            void* top, void* bot, void* stream) {
    return launch_substring<int, FlatRows>(fm, nblocks, 1, nullptr, fchr,
                                           z_off, nrows, rr, B, L, top, bot,
                                           stream);
}

extern "C" int fm_substring_u32(const void* fm, int nblocks, const void* fchr,
                                unsigned z_off, unsigned nrows,
                                const void* rr, int B, int L, void* top,
                                void* bot, void* stream) {
    return launch_substring<uint32_t, FlatRows>(fm, nblocks, 1, nullptr, fchr,
                                                z_off, nrows, rr, B, L, top,
                                                bot, stream);
}

extern "C" int fm_substring_sh(const void* shards, int per, int S,
                               const void* fchr, int z_off, int nrows,
                               const void* rr, int B, int L, void* top,
                               void* bot, void* stream) {
    return launch_substring<int, ShardRows>(shards, per, S, nullptr, fchr,
                                            z_off, nrows, rr, B, L, top, bot,
                                            stream);
}

extern "C" int fm_substring_sh_u32(const void* shards, int per, int S,
                                   const void* fchr, unsigned z_off,
                                   unsigned nrows, const void* rr, int B,
                                   int L, void* top, void* bot,
                                   void* stream) {
    return launch_substring<uint32_t, ShardRows>(shards, per, S, nullptr, fchr,
                                                 z_off, nrows, rr, B, L, top,
                                                 bot, stream);
}

extern "C" int fm_seed(const void* fm, int nblocks, const void* fchr,
                       int z_off, int nrows, const void* ftab,
                       const void* seeds, const void* valid, int B, int L,
                       int K, void* top, void* bot, void* stream) {
    return launch_seed<int, FlatRows>(fm, nblocks, 1, nullptr, fchr, z_off,
                                      nrows, ftab, seeds, valid, B, L, K, top,
                                      bot, stream);
}

extern "C" int fm_seed_u32(const void* fm, int nblocks, const void* fchr,
                           unsigned z_off, unsigned nrows, const void* ftab,
                           const void* seeds, const void* valid, int B,
                           int L, int K, void* top, void* bot, void* stream) {
    return launch_seed<uint32_t, FlatRows>(fm, nblocks, 1, nullptr, fchr,
                                           z_off, nrows, ftab, seeds, valid, B,
                                           L, K, top, bot, stream);
}

extern "C" int fm_seed_sh(const void* shards, int per, int S,
                          const void* fchr, int z_off, int nrows,
                          const void* ftab, const void* seeds,
                          const void* valid, int B, int L, int K, void* top,
                          void* bot, void* stream) {
    return launch_seed<int, ShardRows>(shards, per, S, nullptr, fchr, z_off,
                                       nrows, ftab, seeds, valid, B, L, K, top,
                                       bot, stream);
}

extern "C" int fm_seed_sh_u32(const void* shards, int per, int S,
                              const void* fchr, unsigned z_off,
                              unsigned nrows, const void* ftab,
                              const void* seeds, const void* valid, int B,
                              int L, int K, void* top, void* bot,
                              void* stream) {
    return launch_seed<uint32_t, ShardRows>(shards, per, S, nullptr, fchr,
                                            z_off, nrows, ftab, seeds, valid,
                                            B, L, K, top, bot, stream);
}

extern "C" int fm_sweep_i64(const void* fm, int nblocks, const void* cp64,
                            const void* fchr, long long z_off,
                            long long nrows, const void* rr, int B, int L,
                            void* top, void* bot, void* nedit, void* stream) {
    return launch_sweep<long long, FlatRows>(fm, nblocks, 1, cp64, fchr, z_off,
                                             nrows, rr, B, L, top, bot, nedit,
                                             stream);
}

extern "C" int fm_sweep_sh_i64(const void* shards, int per, int S,
                               const void* cp64, const void* fchr,
                               long long z_off, long long nrows,
                               const void* rr, int B, int L, void* top,
                               void* bot, void* nedit, void* stream) {
    return launch_sweep<long long, ShardRows>(shards, per, S, cp64, fchr,
                                              z_off, nrows, rr, B, L, top, bot,
                                              nedit, stream);
}

extern "C" int fm_substring_i64(const void* fm, int nblocks, const void* cp64,
                                const void* fchr, long long z_off,
                                long long nrows, const void* rr, int B, int L,
                                void* top, void* bot, void* stream) {
    return launch_substring<long long, FlatRows>(fm, nblocks, 1, cp64, fchr,
                                                 z_off, nrows, rr, B, L, top,
                                                 bot, stream);
}

extern "C" int fm_substring_sh_i64(const void* shards, int per, int S,
                                   const void* cp64, const void* fchr,
                                   long long z_off, long long nrows,
                                   const void* rr, int B, int L, void* top,
                                   void* bot, void* stream) {
    return launch_substring<long long, ShardRows>(shards, per, S, cp64, fchr,
                                                  z_off, nrows, rr, B, L, top,
                                                  bot, stream);
}

extern "C" int fm_seed_i64(const void* fm, int nblocks, const void* cp64,
                           const void* fchr, long long z_off, long long nrows,
                           const void* ftab, const void* seeds,
                           const void* valid, int B, int L, int K, void* top,
                           void* bot, void* stream) {
    return launch_seed<long long, FlatRows>(fm, nblocks, 1, cp64, fchr, z_off,
                                            nrows, ftab, seeds, valid, B, L, K,
                                            top, bot, stream);
}

extern "C" int fm_seed_sh_i64(const void* shards, int per, int S,
                              const void* cp64, const void* fchr,
                              long long z_off, long long nrows,
                              const void* ftab, const void* seeds,
                              const void* valid, int B, int L, int K,
                              void* top, void* bot, void* stream) {
    return launch_seed<long long, ShardRows>(shards, per, S, cp64, fchr, z_off,
                                             nrows, ftab, seeds, valid, B, L,
                                             K, top, bot, stream);
}
