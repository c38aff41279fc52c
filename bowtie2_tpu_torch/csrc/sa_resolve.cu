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
//
// A template on the row type R (fm_common.cuh): int in the small mode
// (sa_resolve), uint32_t in the large mode (sa_resolve_u32: rows are read
// and offsets written as int64 holding uint32 values, offs[rank] + steps
// wraps mod 2^32 as the JAX op's uint32 add does), long long in the int64
// mode (sa_resolve_i64: int64 rows and offs, each step's checkpoints two
// 16-byte loads of the block's occ_cp64 row, issued with the others). The
// mark-rank checkpoint stays int in every mode, as the builder and the JAX
// op keep it (int32: up to 2^31 - 1 marked rows, any table at the default
// off_rate).
//
// And a template on the row source (fm_common.cuh): flat tables
// (sa_resolve, sa_resolve_u32), or the sharded index mode's shards of the
// FM rows, the mark rows and offs (sa_resolve_sh, sa_resolve_sh_u32),
// where a row or rank no shard holds reads as zeros.
#include "fm_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xFFFFFFFFu;

template <typename T>
__device__ __forceinline__ T pick4(int c, T a0, T a1, T a2, T a3) {
    return c == 0 ? a0 : (c == 1 ? a1 : (c == 2 ? a2 : a3));
}

// LF(row, code at pos), with every select branch-free
template <typename R>
__device__ __forceinline__ R lf_step(const uint4& a, const uint4& b,
                                     const uint4& cp, R row, int pos,
                                     R z_off, R f0, R f1, R f2, R f3) {
    const uint4 v = (pos & 64) ? b : a;
    const uint32_t word = (pos & 32) ? ((pos & 16) ? v.w : v.z)
                                     : ((pos & 16) ? v.y : v.x);
    const int c = (int)((word >> (2 * (pos & 15))) & 3u);
    FmRow r;
    r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
    r.w[4] = b.x; r.w[5] = b.y; r.w[6] = b.z; r.w[7] = b.w;
    return pick4(c, f0, f1, f2, f3)
           + pick4(c, (R)cp.x, (R)cp.y, (R)cp.z, (R)cp.w)
           + (R)fm_count_below(r, c, pos)
           - (R)((c == 0 && row > z_off) ? 1 : 0);
}

// lf_step of the int64 mode: the checkpoints from the block's occ_cp64 row
// (two 16-byte loads), the sum wrapped in int64
__device__ __forceinline__ long long lf_step_i64(
        const uint4& a, const uint4& b, const longlong2& c01,
        const longlong2& c23, long long row, int pos, long long z_off,
        long long f0, long long f1, long long f2, long long f3) {
    const uint4 v = (pos & 64) ? b : a;
    const uint32_t word = (pos & 32) ? ((pos & 16) ? v.w : v.z)
                                     : ((pos & 16) ? v.y : v.x);
    const int c = (int)((word >> (2 * (pos & 15))) & 3u);
    FmRow r;
    r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
    r.w[4] = b.x; r.w[5] = b.y; r.w[6] = b.z; r.w[7] = b.w;
    return lf_add(pick4(c, f0, f1, f2, f3),
                  pick4(c, c01.x, c01.y, c23.x, c23.y),
                  (long long)fm_count_below(r, c, pos),
                  (long long)((c == 0 && row > z_off) ? 1 : 0));
}

template <typename R, typename Src>
__global__ void __launch_bounds__(THREADS)
resolve_kernel(const uint32_t* __restrict__ fm, int nblocks,
               const R* __restrict__ fchr, R z_off,
               const uint32_t* __restrict__ marks,
               const R* __restrict__ offs, int n_offs, const ShardTab fsh,
               const ShardTab msh, const ShardTab osh,
               const typename RowOut<R>::T* __restrict__ rows, int B,
               int period, typename RowOut<R>::T* out,
               const void* __restrict__ cp64) {
    const int t = blockIdx.x * THREADS + threadIdx.x;
    if (t >= B) return;
    const R f0 = __ldg(fchr), f1 = __ldg(fchr + 1), f2 = __ldg(fchr + 2),
            f3 = __ldg(fchr + 3);
    R row = (R)__ldg(rows + t);
    int steps = 0;
    int block, pos = (int)(row & 127);
    // the mark rows lie as the FM rows do (one a block; sharded, over the
    // same shards): one owner serves both tables
    bool held = true;
    if constexpr (Src::SHARDED)
        block = (int)(row >> 7);
    else
        block = min((int)(row >> 7), nblocks - 1);
    for (;;) {
        const uint32_t *mr, *fw;
        const longlong2* cw = nullptr;   // the int64 mode's occ_cp64 row
        if constexpr (Src::SHARDED) {
            const unsigned s = (unsigned)block / (unsigned)fsh.per;
            held = s < (unsigned)fsh.S;
            const unsigned q = held ? s : 0u;
            const size_t r = held ? (unsigned)block - s * (unsigned)fsh.per
                                  : 0u;
            mr = reinterpret_cast<const uint32_t*>(__ldg(msh.p + q)) + r * 5;
            fw = reinterpret_cast<const uint32_t*>(__ldg(fsh.p + q)) + r * 12;
            if constexpr (Cp64<R>::ON)
                cw = reinterpret_cast<const longlong2*>(__ldg(
                    (const unsigned long long*)cp64 + q)) + r * 2;
        } else {
            mr = marks + (size_t)block * 5;
            fw = fm + (size_t)block * 12;
            if constexpr (Cp64<R>::ON)
                cw = (const longlong2*)cp64 + (size_t)block * 2;
        }
        uint32_t mw = __ldg(mr + (pos >> 5));
        // the FM row: words 0-3, words 4-7 and the checkpoints
        const uint4* fr = reinterpret_cast<const uint4*>(fw);
        uint4 a = __ldg(fr), b = __ldg(fr + 1), cp = __ldg(fr + 2);
        longlong2 c01, c23;
        if constexpr (Cp64<R>::ON) {
            c01 = __ldg(cw);
            c23 = __ldg(cw + 1);
        }
        if (Src::SHARDED && !held) {     // no shard holds it: zeros
            mw = 0;
            a = b = cp = make_uint4(0, 0, 0, 0);
            if constexpr (Cp64<R>::ON)
                c01 = c23 = make_longlong2(0, 0);
        }
        // the loads stay above the test that would use neither
        asm volatile("" : "+r"(steps) : : "memory");
        if (((mw >> (pos & 31)) & 1u) || steps == period) break;
        if constexpr (Cp64<R>::ON)
            row = lf_step_i64(a, b, c01, c23, row, pos, z_off, f0, f1, f2,
                              f3);
        else
            row = lf_step<R>(a, b, cp, row, pos, z_off, f0, f1, f2, f3);
        ++steps;
        if constexpr (Src::SHARDED)
            block = (int)(row >> 7);
        else
            block = min((int)(row >> 7), nblocks - 1);
        pos = (int)(row & 127);
    }
    // rank: the marked rows of the block before pos
    const uint32_t* m;
    if constexpr (Src::SHARDED)
        m = shard_row(msh, block, 5, held);
    else
        m = marks + (size_t)block * 5;
    int rank = held ? (int)__ldg(m + 4) : 0;
    #pragma unroll
    for (int k = 0; k < 4; ++k) {
        int n = pos - 32 * k;
        n = n < 0 ? 0 : (n > 32 ? 32 : n);
        const uint32_t mask = n >= 32 ? FULL : ((1u << n) - 1u);
        rank += held ? __popc(__ldg(m + k) & mask) : 0;
    }
    // offs[rank]: flat, clamped to the table; sharded, 0 where no shard
    // holds the rank
    R off;
    if constexpr (Src::SHARDED) {
        if constexpr (Cp64<R>::ON) {    // two 32-bit words an offset
            const uint32_t* o = shard_row(osh, rank, 2, held);
            off = held ? __ldg(reinterpret_cast<const long long*>(o)) : 0LL;
        } else {
            const uint32_t* o = shard_row(osh, rank, 1, held);
            off = held ? (R)__ldg(o) : (R)0;
        }
    } else {
        rank = rank < 0 ? 0 : (rank >= n_offs ? n_offs - 1 : rank);
        off = __ldg(offs + rank);
    }
    out[t] = (R)(off + (R)steps);
}

// the sharded tables of a launch (unused by the flat kernel)
ShardTab tab(const void* shards, int per, int S) {
    return ShardTab{(const unsigned long long*)shards, per, S};
}

template <typename R, typename Src>
int launch_resolve(const void* fm, int nblocks, int S, const void* cp64,
                   const void* fchr, R z_off, const void* marks,
                   const void* offs, int n_offs, int S_off, const void* rows,
                   int B, int period, void* out, void* stream) {
    using O = typename RowOut<R>::T;
    if (B > 0)
        resolve_kernel<R, Src><<<(B + THREADS - 1) / THREADS, THREADS, 0,
                                 (cudaStream_t)stream>>>(
            (const uint32_t*)fm, nblocks, (const R*)fchr, z_off,
            (const uint32_t*)marks, (const R*)offs, n_offs,
            tab(fm, nblocks, S), tab(marks, nblocks, S),
            tab(offs, n_offs, S_off), (const O*)rows, B, period, (O*)out,
            cp64);
    return (int)cudaGetLastError();
}

}  // namespace

// The C entries: sa_resolve over flat tables; sa_resolve_sh over the
// sharded index mode's shards (fm_blocks and mark_rows: S addresses of
// per_blk rows each; offs: S_off addresses of per_off values each); each
// with a `_u32` twin in the large row mode and an `_i64` twin in the
// int64 row mode, which takes occ_cp64 (the table, or S addresses of its
// shards, sharded as fm_blocks is) after the FM table.
extern "C" int sa_resolve(const void* fm, int nblocks, const void* fchr,
                          int z_off, const void* marks, const void* offs,
                          int n_offs, const void* rows, int B, int period,
                          void* out, void* stream) {
    return launch_resolve<int, FlatRows>(fm, nblocks, 1, nullptr, fchr, z_off,
                                         marks, offs, n_offs, 1, rows, B,
                                         period, out, stream);
}

extern "C" int sa_resolve_u32(const void* fm, int nblocks, const void* fchr,
                              unsigned z_off, const void* marks,
                              const void* offs, int n_offs, const void* rows,
                              int B, int period, void* out, void* stream) {
    return launch_resolve<uint32_t, FlatRows>(fm, nblocks, 1, nullptr, fchr,
                                              z_off, marks, offs, n_offs, 1,
                                              rows, B, period, out, stream);
}

extern "C" int sa_resolve_sh(const void* fm, int per_blk, int S,
                             const void* fchr, int z_off, const void* marks,
                             const void* offs, int per_off, int S_off,
                             const void* rows, int B, int period, void* out,
                             void* stream) {
    return launch_resolve<int, ShardRows>(fm, per_blk, S, nullptr, fchr, z_off,
                                          marks, offs, per_off, S_off, rows, B,
                                          period, out, stream);
}

extern "C" int sa_resolve_sh_u32(const void* fm, int per_blk, int S,
                                 const void* fchr, unsigned z_off,
                                 const void* marks, const void* offs,
                                 int per_off, int S_off, const void* rows,
                                 int B, int period, void* out, void* stream) {
    return launch_resolve<uint32_t, ShardRows>(fm, per_blk, S, nullptr, fchr,
                                               z_off, marks, offs, per_off,
                                               S_off, rows, B, period, out,
                                               stream);
}

extern "C" int sa_resolve_i64(const void* fm, int nblocks, const void* cp64,
                              const void* fchr, long long z_off,
                              const void* marks, const void* offs, int n_offs,
                              const void* rows, int B, int period, void* out,
                              void* stream) {
    return launch_resolve<long long, FlatRows>(fm, nblocks, 1, cp64, fchr,
                                               z_off, marks, offs, n_offs, 1,
                                               rows, B, period, out, stream);
}

extern "C" int sa_resolve_sh_i64(const void* fm, int per_blk, int S,
                                 const void* cp64, const void* fchr,
                                 long long z_off, const void* marks,
                                 const void* offs, int per_off, int S_off,
                                 const void* rows, int B, int period,
                                 void* out, void* stream) {
    return launch_resolve<long long, ShardRows>(fm, per_blk, S, cp64, fchr,
                                                z_off, marks, offs, per_off,
                                                S_off, rows, B, period, out,
                                                stream);
}
