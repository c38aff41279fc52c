// Kernel D: direction-matrix walk of the chosen DP candidates, one thread
// per candidate.
//
// Replaces: bowtie2_tpu/ops/sw.py:365 backtrace, a lax.scan of S steps over
// all Bc candidates that gathers one packed direction word, one read char,
// one penalty and one window char per candidate per step.
// Here each thread runs its S steps alone and writes the packed op byte of
// step s at ops[s, c] (neighbouring threads, neighbouring bytes), then the
// seven per-candidate fields (read start, window start, XM, XO, XG, XN,
// recomputed score).
//
// Bound on the card: latency of the dependent direction-word loads (each
// step's cell depends on the previous step's move); the op store is
// S x Bc bytes, coalesced.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int H_DIAG = 0, H_E = 1, H_F = 2, H_START = 3;
constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_NONE = 3;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void bt_kernel(const int* __restrict__ dirs, int Lmax, int Bdir,
                          int Wp, const int* __restrict__ sel,
                          const int* __restrict__ rows,
                          const int* __restrict__ lanes,
                          const int* __restrict__ reads,
                          const int* __restrict__ mmpen,
                          const int* __restrict__ refwins, int Bc, int W,
                          int S, int match_bonus, int n_pen, int rdo, int rde,
                          int rfo, int rfe, unsigned char* ops, int* fields) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= Bc) return;
    const int lane_sel = sel[c];
    const int* rd = reads + (size_t)c * Lmax;
    const int* mp = mmpen + (size_t)c * Lmax;
    const int* rw = refwins + (size_t)c * W;
    int i = rows[c], j = lanes[c], mode = 0;
    bool done = false;
    int nmm = 0, ngo = 0, ngc = 0, nrefn = 0, score = 0, refmin = 1 << 30;
    for (int s = 0; s < S; ++s) {
        const int ic = clampi(i, 0, Lmax - 1), jc = clampi(j, 0, W - 1);
        const int word = __ldg(dirs + ((size_t)ic * Bdir + lane_sel) * Wp + (jc >> 3));
        const int d = (word >> (4 * (jc & 7))) & 15;
        const int src = d & 3;
        const int rc = __ldg(rd + ic), qp = __ldg(mp + ic), fc = __ldg(rw + jc);

        const bool done_now = done || (mode == 0 && src == H_START) || i < 0;
        const bool em = !done_now && mode == 0 && src == H_DIAG;
        const bool ei = !done_now && ((mode == 0 && src == H_E) || mode == 1);
        const bool ed = !done_now && ((mode == 0 && src == H_F) || mode == 2);
        const bool is_n = rc >= 4 || fc == 4;
        const bool ismatch = em && rc == fc && !is_n && fc < 4;
        const int m_sc = ismatch ? match_bonus : (is_n ? -n_pen : -qp);
        const bool e_ext = (d & 4) != 0, f_ext = (d & 8) != 0;
        const bool i_open = ei && !e_ext, d_open = ed && !f_ext;

        score += (em ? m_sc : 0) - (ei ? rfe : 0) - (i_open ? rfo : 0)
                 - (ed ? rde : 0) - (d_open ? rdo : 0);
        nmm += (em && !ismatch && rc < 4 && fc != 4) + (em && is_n);
        nrefn += em && fc == 4;
        ngo += i_open + d_open;
        ngc += ei + ed;
        if ((em || ed) && j < refmin) refmin = j;

        const int op = em ? OP_M : (ei ? OP_I : (ed ? OP_D : OP_NONE));
        ops[(size_t)s * Bc + c] =
            (unsigned char)(op | (clampi(fc, 0, 5) << 2) | ((int)ismatch << 5));

        if (!done_now) {
            if (em || ei) --i;
            if (em || ed) --j;
            mode = (ei && e_ext) ? 1 : ((ed && f_ext) ? 2 : 0);
        }
        done = done_now || i < 0;
    }
    fields[0 * Bc + c] = i + 1;                          // read_start
    fields[1 * Bc + c] = refmin == (1 << 30) ? 0 : refmin;  // ref_start_win
    fields[2 * Bc + c] = nmm;
    fields[3 * Bc + c] = ngo;
    fields[4 * Bc + c] = ngc;
    fields[5 * Bc + c] = nrefn;
    fields[6 * Bc + c] = score;
}

}  // namespace

// dirs (Lmax, Bdir, Wp) from sw_rect; sel/rows/lanes (Bc,); reads/mmpen
// (Bc, Lmax); refwins (Bc, W); ops (S, Bc) uint8; fields (7, Bc) int32.
extern "C" int backtrace(const void* dirs, int Lmax, int Bdir, int Wp,
                         const void* sel, const void* rows, const void* lanes,
                         const void* reads, const void* mmpen,
                         const void* refwins, int Bc, int W, int S,
                         int match_bonus, int n_pen, int rdo, int rde, int rfo,
                         int rfe, void* ops, void* fields, void* stream) {
    if (Bc > 0)
        bt_kernel<<<(Bc + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
            (const int*)dirs, Lmax, Bdir, Wp, (const int*)sel,
            (const int*)rows, (const int*)lanes, (const int*)reads,
            (const int*)mmpen, (const int*)refwins, Bc, W, S, match_bonus,
            n_pen, rdo, rde, rfo, rfe, (unsigned char*)ops, (int*)fields);
    return (int)cudaGetLastError();
}
