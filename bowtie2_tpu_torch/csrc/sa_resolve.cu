// Kernel B: BWT row -> joined text offset, one thread per row.
//
// Replaces: bowtie2_tpu/ops/fm.py:408 sa_resolve, a fixed-length lax.scan of
// 2^off_rate LF steps with two row gathers per step (the [bwt8|occ4] row and
// the [mark4|rankcp] row) over the whole batch, done or not.
// Here each thread walks left with LF until its row carries a mark bit
// (marks sit at text positions that are multiples of 2^off_rate, so at most
// period - 1 steps), then ranks the marked row with one popcount and reads
// offs[rank]. Finished threads stop loading.
//
// Bound on the card: latency of the dependent row loads (at most `period`
// steps of 48 + 20 bytes, L2-resident for genomes of a few Mbp).
#include "fm_common.cuh"

namespace {

__global__ void resolve_kernel(const uint32_t* __restrict__ fm, int nblocks,
                               const int* __restrict__ fchr, int z_off,
                               const uint32_t* __restrict__ marks,
                               const int* __restrict__ offs, int n_offs,
                               const int* __restrict__ rows, int B, int period,
                               int* out) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    int row = rows[b];
    int steps = 0;
    for (int s = 0; s < period; ++s) {
        const int block = row >> 7, pos = row & 127;
        const uint32_t mw = __ldg(marks + (size_t)block * 5 + (pos >> 5));
        if ((mw >> (pos & 31)) & 1u) break;          // marked: done
        const FmRow r = fm_load_row(fm, nblocks, block);
        const int c = (int)((r.w[pos >> 4] >> (2 * (pos & 15))) & 3u);
        row = fm_lf_row(r, fchr, z_off, row, c);
        ++steps;
    }
    const int block = row >> 7, pos = row & 127;
    const uint32_t* m = marks + (size_t)block * 5;
    int rank = (int)__ldg(m + 4);
    #pragma unroll
    for (int k = 0; k < 4; ++k) {
        int n = pos - 32 * k;
        n = n < 0 ? 0 : (n > 32 ? 32 : n);
        const uint32_t mask = n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1u);
        rank += __popc(__ldg(m + k) & mask);
    }
    rank = rank < 0 ? 0 : (rank >= n_offs ? n_offs - 1 : rank);
    out[b] = __ldg(offs + rank) + steps;
}

}  // namespace

extern "C" int sa_resolve(const void* fm, int nblocks, const void* fchr,
                          int z_off, const void* marks, const void* offs,
                          int n_offs, const void* rows, int B, int period,
                          void* out, void* stream) {
    if (B > 0)
        resolve_kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)fm, nblocks, (const int*)fchr, z_off,
            (const uint32_t*)marks, (const int*)offs, n_offs,
            (const int*)rows, B, period, (int*)out);
    return (int)cudaGetLastError();
}
