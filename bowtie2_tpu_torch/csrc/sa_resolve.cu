// Kernel B: BWT row -> joined text offset, one thread a row.
//
// Replaces: bowtie2_tpu/ops/fm.py:408 sa_resolve, a fixed-length lax.scan of
// 2^off_rate LF steps with two row gathers per step (the [bwt8|occ4] row and
// the [mark4|rankcp] row) over the whole batch, done or not.
// Each thread walks left with LF until its row carries a mark bit (marks
// sit at text positions that are multiples of 2^off_rate, so at most
// period - 1 steps), then ranks the marked row with popcounts and reads
// offs[rank].
//
// Bound on the card: each step is a scattered load of the two index tables
// (L2-resident for genomes of a few Mbp: 48 + 20 bytes a block) whose
// address depends on the step before, so a step costs the L2 latency and
// its arithmetic, and a warp lasts as long as its longest walk. The main
// path's first call is latency-bound: most of its rows are the empty
// slots' row 0, marked at once, so each warp waits on a few long walks.
// Loading the mark word, branching on it, then loading the FM row and then
// fchr[c] costs three latencies a step. Here fchr lives in registers, the
// mark word and the whole FM row are issued together, one latency a step
// (the FM row of the step that finds the mark is loaded for nothing), and
// a step has no branch but its exit test.
#include "fm_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int pick4(int c, int a0, int a1, int a2, int a3) {
    return c == 0 ? a0 : (c == 1 ? a1 : (c == 2 ? a2 : a3));
}

// LF(row, code at pos), with every select branch-free
__device__ __forceinline__ int lf_step(const uint4& a, const uint4& b,
                                       const uint4& cp, int row, int pos,
                                       int z_off, int f0, int f1, int f2,
                                       int f3) {
    const uint4 v = (pos & 64) ? b : a;
    const uint32_t word = (pos & 32) ? ((pos & 16) ? v.w : v.z)
                                     : ((pos & 16) ? v.y : v.x);
    const int c = (int)((word >> (2 * (pos & 15))) & 3u);
    FmRow r;
    r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
    r.w[4] = b.x; r.w[5] = b.y; r.w[6] = b.z; r.w[7] = b.w;
    return pick4(c, f0, f1, f2, f3)
           + pick4(c, (int)cp.x, (int)cp.y, (int)cp.z, (int)cp.w)
           + fm_count_below(r, c, pos) - ((c == 0 && row > z_off) ? 1 : 0);
}

__global__ void __launch_bounds__(THREADS)
resolve_kernel(const uint32_t* __restrict__ fm, int nblocks,
               const int* __restrict__ fchr, int z_off,
               const uint32_t* __restrict__ marks,
               const int* __restrict__ offs, int n_offs,
               const int* __restrict__ rows, int B, int period, int* out) {
    const int t = blockIdx.x * THREADS + threadIdx.x;
    if (t >= B) return;
    const int f0 = __ldg(fchr), f1 = __ldg(fchr + 1), f2 = __ldg(fchr + 2),
              f3 = __ldg(fchr + 3);
    int row = __ldg(rows + t), steps = 0;
    int block = min(row >> 7, nblocks - 1), pos = row & 127;
    for (;;) {
        const uint32_t mw = __ldg(marks + (size_t)block * 5 + (pos >> 5));
        // the FM row: words 0-3, words 4-7 and the checkpoints
        const uint4* fr =
            reinterpret_cast<const uint4*>(fm + (size_t)block * 12);
        const uint4 a = __ldg(fr), b = __ldg(fr + 1), cp = __ldg(fr + 2);
        // the loads stay above the test that would use neither
        asm volatile("" : "+r"(steps) : : "memory");
        if (((mw >> (pos & 31)) & 1u) || steps == period) break;
        row = lf_step(a, b, cp, row, pos, z_off, f0, f1, f2, f3);
        ++steps;
        block = min(row >> 7, nblocks - 1);
        pos = row & 127;
    }
    // rank: the marked rows of the block before pos
    const uint32_t* m = marks + (size_t)block * 5;
    int rank = (int)__ldg(m + 4);
    #pragma unroll
    for (int k = 0; k < 4; ++k) {
        int n = pos - 32 * k;
        n = n < 0 ? 0 : (n > 32 ? 32 : n);
        const uint32_t mask = n >= 32 ? FULL : ((1u << n) - 1u);
        rank += __popc(__ldg(m + k) & mask);
    }
    rank = rank < 0 ? 0 : (rank >= n_offs ? n_offs - 1 : rank);
    out[t] = __ldg(offs + rank) + steps;
}

}  // namespace

extern "C" int sa_resolve(const void* fm, int nblocks, const void* fchr,
                          int z_off, const void* marks, const void* offs,
                          int n_offs, const void* rows, int B, int period,
                          void* out, void* stream) {
    if (B > 0)
        resolve_kernel<<<(B + THREADS - 1) / THREADS, THREADS, 0,
                         (cudaStream_t)stream>>>(
            (const uint32_t*)fm, nblocks, (const int*)fchr, z_off,
            (const uint32_t*)marks, (const int*)offs, n_offs,
            (const int*)rows, B, period, (int*)out);
    return (int)cudaGetLastError();
}
