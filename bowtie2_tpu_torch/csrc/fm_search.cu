// Kernel A: batched backward FM-index searches, one thread per search state.
//
// Replaces (bowtie2_tpu/ops/fm.py):
//   exact_sweep_rr      :215  whole-read sweep with restart + edit count
//   substring_search_rr :275  half-read search, an empty range kills it
//   seed_search_exact   :335  ftab-seeded fixed-length seed search
// each a lax.scan over the pattern columns with one batched row gather per
// LF step. Here the whole column loop runs inside the thread: top and bot
// advance together, and a dead or restarted state skips its row loads.
//
// Bound on the card: latency of dependent 48-byte row loads (every step
// needs the row of the previous step's result). The index of a 5-Mbp genome
// is ~1.9 MB of fm_blocks, resident in the 50 MB L2, so the loads are L2
// hits; thousands of independent threads in flight hide that latency.
// Pattern characters are read with a stride of Lmax per thread (not
// coalesced); they are 4 bytes per step against 96 bytes of index rows.
#include "fm_common.cuh"

namespace {

__global__ void sweep_kernel(const uint32_t* __restrict__ fm, int nblocks,
                             const int* __restrict__ fchr, int z_off,
                             int nrows, const int* __restrict__ rr, int B,
                             int L, int* top_out, int* bot_out,
                             int* nedit_out) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int* s = rr + (size_t)b * L;
    int top = 0, bot = nrows, nedit = 0;
    for (int p = 0; p < L; ++p) {
        const int c = __ldg(s + p);
        if (c >= 5) continue;                        // inactive step
        bool empty = c >= 4;
        if (!empty) {
            const int nt = fm_lf(fm, nblocks, fchr, z_off, top, c);
            const int nb = fm_lf(fm, nblocks, fchr, z_off, bot, c);
            empty = nt >= nb;
            top = nt;
            bot = nb;
        }
        if (empty) {                                 // restart, count an edit
            top = 0;
            bot = nrows;
            ++nedit;
        }
    }
    top_out[b] = top;
    bot_out[b] = bot;
    nedit_out[b] = nedit;
}

__global__ void substring_kernel(const uint32_t* __restrict__ fm, int nblocks,
                                 const int* __restrict__ fchr, int z_off,
                                 int nrows, const int* __restrict__ rr, int B,
                                 int L, int* top_out, int* bot_out) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int* s = rr + (size_t)b * L;
    int top = 0, bot = nrows;
    for (int p = 0; p < L; ++p) {
        const int c = __ldg(s + p);
        if (c >= 5) continue;
        if (c >= 4 || top >= bot) {                  // dead
            top = 1;
            bot = 0;
        } else {
            const int nt = fm_lf(fm, nblocks, fchr, z_off, top, c);
            bot = fm_lf(fm, nblocks, fchr, z_off, bot, c);
            top = nt;
        }
    }
    top_out[b] = top;
    bot_out[b] = bot > top ? bot : top;
}

__global__ void seed_kernel(const uint32_t* __restrict__ fm, int nblocks,
                            const int* __restrict__ fchr, int z_off, int nrows,
                            const int* __restrict__ ftab,
                            const int* __restrict__ seeds,
                            const unsigned char* __restrict__ valid, int B,
                            int L, int K, int* top_out, int* bot_out) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int* s = seeds + (size_t)b * L;
    const bool ok0 = valid[b] != 0;
    int top, bot, q;
    if (K > 0 && K <= L) {
        // last K chars resolved by one ftab lookup (first char weighs 4^(K-1))
        int key = 0;
        bool has_n = false;
        for (int k = L - K; k < L; ++k) {
            const int c = __ldg(s + k);
            has_n |= c >= 4;
            key = key * 4 + (c < 0 ? 0 : (c > 3 ? 3 : c));
        }
        const bool ok = ok0 && !has_n;
        top = ok ? __ldg(ftab + 2 * key + 1) : 1;
        bot = ok ? __ldg(ftab + 2 * key + 2) : 0;
        q = L - K - 1;
    } else {
        top = 0;
        bot = ok0 ? nrows : 0;
        q = L - 1;
    }
    for (; q >= 0; --q) {                            // right to left
        const int c = __ldg(s + q);
        if (c >= 4 || top >= bot) {
            top = 1;
            bot = 0;
        } else {
            const int nt = fm_lf(fm, nblocks, fchr, z_off, top, c);
            bot = fm_lf(fm, nblocks, fchr, z_off, bot, c);
            top = nt;
        }
    }
    top_out[b] = top;
    bot_out[b] = bot > top ? bot : top;
}

constexpr int kThreads = 128;

inline int grid(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int fm_sweep(const void* fm, int nblocks, const void* fchr,
                        int z_off, int nrows, const void* rr, int B, int L,
                        void* top, void* bot, void* nedit, void* stream) {
    if (B > 0)
        sweep_kernel<<<grid(B), kThreads, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)fm, nblocks, (const int*)fchr, z_off, nrows,
            (const int*)rr, B, L, (int*)top, (int*)bot, (int*)nedit);
    return (int)cudaGetLastError();
}

extern "C" int fm_substring(const void* fm, int nblocks, const void* fchr,
                            int z_off, int nrows, const void* rr, int B, int L,
                            void* top, void* bot, void* stream) {
    if (B > 0)
        substring_kernel<<<grid(B), kThreads, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)fm, nblocks, (const int*)fchr, z_off, nrows,
            (const int*)rr, B, L, (int*)top, (int*)bot);
    return (int)cudaGetLastError();
}

extern "C" int fm_seed(const void* fm, int nblocks, const void* fchr,
                       int z_off, int nrows, const void* ftab,
                       const void* seeds, const void* valid, int B, int L,
                       int K, void* top, void* bot, void* stream) {
    if (B > 0)
        seed_kernel<<<grid(B), kThreads, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)fm, nblocks, (const int*)fchr, z_off, nrows,
            (const int*)ftab, (const int*)seeds, (const unsigned char*)valid,
            B, L, K, (int*)top, (int*)bot);
    return (int)cudaGetLastError();
}
