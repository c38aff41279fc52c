// Kernel D: direction-matrix walk of the chosen DP candidates, one warp a
// walk, eight walks a block.
//
// Replaces: bowtie2_tpu/ops/sw.py:365 backtrace, a lax.scan of S steps over
// all Bc candidates that gathers one packed direction word, one read char,
// one penalty and one window char per candidate per step. The output is
// the same: the packed op byte of step s at ops[s, c], then the seven
// per-candidate fields (read start, window start, XM, XO, XG, XN,
// recomputed score).
//
// Bound on the card: the walk is a chain. Each step's cell is known only
// after the previous step's move, so a step costs one load latency plus
// its arithmetic, S steps in a row; the bytes (one word a walked step, the
// op bytes) take a few microseconds at most. One thread a walk with every
// step's load in device memory takes about 500 clocks a step, runs on 16
// of the 132 SMs at the main path's 2048 walks, and, as the scan does,
// runs all S steps whether the walk is done or not. Here:
// - one warp walks one candidate, so 2048 walks fill every SM;
// - the warp stages R rows of the walk's direction cells in shared memory,
//   one byte a cell, 64 cells a row centred on the diagonal through the
//   cell it stages from (row k holds columns jt - k - 32 .. jt - k + 31),
//   with the read codes and penalties of those rows and the window codes
//   of those columns. The words come in with all loads in flight at once
//   and are unpacked by a funnel shift and two mask spreads;
// - a step is then one shared-memory byte load and a few integer ops in a
//   loop with one exit test: the move is op = mode ? mode : (cell & 3),
//   and the next cell's index is the last one plus 64 for M (next row,
//   same band position), 65 for I (next row, one position right) or -1
//   for D (one position left). The loop leaves after 32 steps (to score
//   them), at the end, at a clamped row or column (j < 0), or at the edge
//   of the stage; a walk that leaves the staged rows or the band restages
//   from the cell it reached, so every shape and every path is exact, only
//   slower where gaps or wide drift are many;
// - each lane keeps one of the last 32 steps, and the warp then scores
//   those 32 steps at once (op byte, score, XM, XO, XG, XN, leftmost
//   column), off the chain;
// - the loop ends when the walk is done: every step after it emits the
//   same byte, OP_NONE and the window code at the frozen column;
// - the op bytes of a block's eight walks collect in shared memory and go
//   out row by row (eight neighbouring bytes a row), the seven fields too;
//   a walk of more than CAP steps writes the bytes past CAP directly.
// A call of more walks than LANE_WAVES waves of this kernel is bound by
// its instructions (32 lanes a walk) rather than by the chain, and takes
// bt_lane_kernel instead: one thread a walk, stopping at done, with the
// cell PF steps down the diagonal prefetched into L1.
// Semantics are the plain version's: i clamped to [0, Lmax) and j to
// [0, W) for every load, j free to go below 0, the walk done at i < 0 or
// at an H_START cell in mode 0, and cut at S steps.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_NONE = 3;

constexpr int NW = 8;       // walks (warps) a block
constexpr int R = 64;       // staged rows
constexpr int BAND = 64;    // staged cells a row
constexpr int HALF = 32;    // of them, left of the diagonal
constexpr int FCW = R - 1 + BAND + 1;  // staged window columns (all rows)
constexpr int CAP = 256;    // op bytes a walk keeps in shared memory
// calls of more walks than LANE_WAVES waves of the warp kernel take the
// lane kernel: on an H100 the two cost the same near 4.6 waves (about
// 9,700 walks of 100-bp reads)
constexpr int LANE_WAVES = 4;
// the lane kernel prefetches the cell, read code, penalty and window code
// this many diagonal steps ahead (of 4, 8, 16 and 32, 4 was the fastest
// on an H100 at the main path's 16,384 walks of 100-bp reads)
constexpr int PF = 4;

struct Stage {
    uint32_t cells[R * BAND / 4];   // one byte a cell, row k at k * BAND
    int rc[R];
    int qp[R];
    int fc[FCW];
};

struct BtArgs {
    const int* dirs;
    int Lmax, Bdir, Wp;
    const int* sel;
    const int* rows;
    const int* lanes;
    const int* reads;
    const int* mmpen;
    const int* refwins;
    int Bc, W, S;
    int mb, n_pen, rdo, rde, rfo, rfe;
    unsigned char* ops;
    int* fields;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
    asm volatile("prefetch.global.L1 [%0];" : : "l"(p));
}

// one cell byte at a 32-bit shared address (kept in a register by the
// caller, so the address is not recomputed from the thread index a step)
__device__ __forceinline__ int lds_u8(uint32_t addr) {
    uint32_t v;
    asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
    return (int)v;
}

__global__ void __launch_bounds__(NW * 32, 2) bt_kernel(BtArgs a) {
    __shared__ Stage st[NW];
    __shared__ unsigned char obuf[NW][CAP];
    __shared__ int s_done[NW];
    __shared__ int s_tail[NW];
    __shared__ int s_fields[7][NW];

    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int c = blockIdx.x * NW + w;
    Stage& sm = st[w];

    if (c < a.Bc) {
        const int Lmax = a.Lmax, W = a.W;
        const int* dsel = a.dirs + (size_t)a.sel[c] * a.Wp;
        const size_t rstride = (size_t)a.Bdir * a.Wp;
        const int* rd = a.reads + (size_t)c * Lmax;
        const int* mp = a.mmpen + (size_t)c * Lmax;
        const int* rw = a.refwins + (size_t)c * W;
        uint32_t cbase = (uint32_t)__cvta_generic_to_shared(sm.cells);
        asm volatile("" : "+r"(cbase));

        int i = a.rows[c], j = a.lanes[c], mode = 0;
        int s = 0, n = 0;                 // steps taken; not yet scored
        int itop = 0, jt = 0, c0 = 0;     // the staged region
        bool staged = false;
        int ri = 0, rj = 0, rop = 0, rdd = 0;   // this lane's kept step
        int score = 0, nmm = 0, ngo = 0, ngc = 0, nrefn = 0;
        int refmin = 1 << 30;

        // score the cnt kept steps s0 .. s0 + cnt - 1 (lane t has s0 + t)
        auto score_steps = [&](int s0, int cnt) {
            if (lane >= cnt) return;
            const int k = itop - min(ri, Lmax - 1);
            const int rc = sm.rc[k], qp = sm.qp[k];
            const int fc = sm.fc[clampi(rj, 0, W - 1) - c0];
            const bool em = rop == OP_M, ei = rop == OP_I, ed = rop == OP_D;
            const bool is_n = rc >= 4 || fc == 4;
            const bool ismatch = em && rc == fc && !is_n && fc < 4;
            const int m_sc = ismatch ? a.mb : (is_n ? -a.n_pen : -qp);
            const bool i_open = ei && !(rdd & 4), d_open = ed && !(rdd & 8);
            score += (em ? m_sc : 0) - (ei ? a.rfe : 0) - (i_open ? a.rfo : 0)
                     - (ed ? a.rde : 0) - (d_open ? a.rdo : 0);
            nmm += (em && !ismatch && rc < 4 && fc != 4) + (em && is_n);
            nrefn += em && fc == 4;
            ngo += i_open + d_open;
            ngc += ei + ed;
            if ((em || ed) && rj < refmin) refmin = rj;
            const unsigned char byte = (unsigned char)(
                rop | (clampi(fc, 0, 5) << 2) | ((int)ismatch << 5));
            const int sx = s0 + lane;
            if (sx < CAP)
                obuf[w][sx] = byte;
            else
                a.ops[(size_t)sx * a.Bc + c] = byte;
        };

        // stage rows ic - k (k < R), cells jc - k - HALF + x (x < BAND):
        // the 9 words a row's cells span come in one a lane (lanes 0-8 of
        // each half-warp, two rows a pass), all loads first; each lane
        // then takes 4 cells of its row by shuffle and funnel shift
        auto stage = [&](int ic, int jc) {
            itop = ic;
            jt = jc;
            c0 = jc - (R - 1) - HALF;
            const int m = lane & 15;
            uint32_t wv[R / 2];
            #pragma unroll
            for (int t = 0; t < R / 2; ++t) {
                const int k = 2 * t + (lane >> 4), r = ic - k;
                const int wd = ((jc - k - HALF) >> 3) + m;
                wv[t] = (m < 9 && r >= 0 && (unsigned)wd < (unsigned)a.Wp)
                        ? (uint32_t)__ldg(dsel + r * rstride + wd) : 0u;
            }
            int vr[R / 32], vq[R / 32], vf[FCW / 32];
            #pragma unroll
            for (int t = 0; t < R / 32; ++t) {
                const int r = ic - (t * 32 + lane);
                vr[t] = r >= 0 ? __ldg(rd + r) : 0;
                vq[t] = r >= 0 ? __ldg(mp + r) : 0;
            }
            #pragma unroll
            for (int t = 0; t < FCW / 32; ++t) {
                const int col = c0 + t * 32 + lane;
                vf[t] = (unsigned)col < (unsigned)W ? __ldg(rw + col) : 0;
            }
            __syncwarp();
            #pragma unroll
            for (int t = 0; t < R / 2; ++t) {
                const int k = 2 * t + (lane >> 4);
                const int g = jc - k - HALF + 4 * m;      // first cell's column
                const int q = (g >> 3) - ((jc - k - HALF) >> 3);   // 0 .. 8
                const int src = (lane & 16) + q;
                const uint32_t lo = __shfl_sync(0xFFFFFFFFu, wv[t], src);
                const uint32_t hi = __shfl_sync(0xFFFFFFFFu, wv[t],
                                                min(src + 1, 31));
                uint32_t y = __funnelshift_r(lo, hi, 4 * (g & 7)) & 0xFFFFu;
                y = (y | (y << 8)) & 0x00FF00FFu;
                y = (y | (y << 4)) & 0x0F0F0F0Fu;
                sm.cells[k * (BAND / 4) + m] = y;
            }
            #pragma unroll
            for (int t = 0; t < R / 32; ++t) {
                sm.rc[t * 32 + lane] = vr[t];
                sm.qp[t * 32 + lane] = vq[t];
            }
            #pragma unroll
            for (int t = 0; t < FCW / 32; ++t) sm.fc[t * 32 + lane] = vf[t];
            __syncwarp();
        };

        // the walk: every lane holds the same state. (k, x) is the cell in
        // the stage (row itop - k, band position x), idx = k * BAND + x;
        // `fast` says the shortcut update of the last step holds
        // The inner loop is the chain: one byte load, the move, the kept
        // step, one exit test. Everything else (locating the cell when a
        // row or column was clamped, restaging, scoring 32 kept steps, the
        // end) is in the outer loop.
        int op = 0;
        while (s < a.S && i >= 0) {
            const int ic = min(i, Lmax - 1), jc = clampi(j, 0, W - 1);
            int k = itop - ic, x = jc - jt + k + HALF;
            if (!staged || (unsigned)k >= (unsigned)R ||
                (unsigned)x >= (unsigned)BAND) {
                if (n) score_steps(s - n, n);
                n = 0;
                stage(ic, jc);
                staged = true;
                k = 0;
                x = HALF;
            }
            int idx = k * BAND + x;
            // steps this pass may take: up to 32 kept steps and S in all;
            // while the cell is not clamped (i < Lmax, j >= 0 and j < W,
            // which the moves keep once true, bar j >= 0) and stays in the
            // stage's rows (i > i_floor) and band (0 <= x < BAND)
            int left = min(32 - n, a.S - s);
            const bool unclamped = i < Lmax && (unsigned)j < (unsigned)W;
            const int i_floor = max(itop - R, -1);
            bool more;
            do {
                const int d = lds_u8(cbase + idx);
                op = mode ? mode : (d & 3);   // OP_NONE: mode 0, H_START
                const bool go = op != OP_NONE;
                if (go && lane == n) {
                    ri = i;
                    rj = j;
                    rop = op;
                    rdd = d;
                }
                const int mi = op < 2, mj = !(op & 1);   // 0 for OP_NONE
                i -= mi;
                j -= mj;
                x += mi - mj;
                idx += (BAND + 1) * mi - mj;
                // the E or F extension bit of the move taken keeps its mode
                mode = op & -((d >> (op + 1)) & 1);
                n += go;
                s += go;
                --left;
                more = go && left > 0 && unclamped && i > i_floor && j >= 0 &&
                       (unsigned)x < (unsigned)BAND;
            } while (more);
            if (op == OP_NONE) break;
            if (n == 32) {
                score_steps(s - 32, 32);
                n = 0;
            }
        }
        if (n) score_steps(s - n, n);

        #pragma unroll
        for (int off = 16; off; off >>= 1) {
            score += __shfl_xor_sync(0xFFFFFFFFu, score, off);
            nmm += __shfl_xor_sync(0xFFFFFFFFu, nmm, off);
            ngo += __shfl_xor_sync(0xFFFFFFFFu, ngo, off);
            ngc += __shfl_xor_sync(0xFFFFFFFFu, ngc, off);
            nrefn += __shfl_xor_sync(0xFFFFFFFFu, nrefn, off);
            refmin = min(refmin, __shfl_xor_sync(0xFFFFFFFFu, refmin, off));
        }
        if (lane == 0) {
            // every step from s on is done: OP_NONE at the frozen column
            const int jc = clampi(j, 0, W - 1);
            const int fx = jc - c0;
            const int fc = staged && (unsigned)fx < (unsigned)FCW
                           ? sm.fc[fx] : __ldg(rw + jc);
            s_done[w] = s;
            s_tail[w] = OP_NONE | (clampi(fc, 0, 5) << 2);
            s_fields[0][w] = i + 1;                            // read_start
            s_fields[1][w] = refmin == (1 << 30) ? 0 : refmin;  // ref_start_win
            s_fields[2][w] = nmm;
            s_fields[3][w] = ngo;
            s_fields[4][w] = ngc;
            s_fields[5][w] = nrefn;
            s_fields[6][w] = score;
        }
    }
    __syncthreads();

    // the block's op bytes, row by row: walk ww's byte of step sx
    const int cb = blockIdx.x * NW;
    const int nv = min(NW, a.Bc - cb);
    for (int t = threadIdx.x; t < a.S * NW; t += NW * 32) {
        const int sx = t / NW, ww = t % NW;
        if (ww >= nv) continue;
        if (sx >= s_done[ww])
            a.ops[(size_t)sx * a.Bc + cb + ww] = (unsigned char)s_tail[ww];
        else if (sx < CAP)
            a.ops[(size_t)sx * a.Bc + cb + ww] = obuf[ww][sx];
    }
    if (threadIdx.x < 7 * NW) {
        const int f = threadIdx.x / NW, ww = threadIdx.x % NW;
        if (ww < nv) a.fields[(size_t)f * a.Bc + cb + ww] = s_fields[f][ww];
    }
}

// The same walk, one thread a walk, for calls of more walks than the warp
// kernel runs in LANE_WAVES waves: there the warp kernel's cost is its
// instructions (32 lanes a walk), and one lane a walk, whose step loads
// are all issued together and whose op bytes go out 32 walks to a store,
// runs the same steps in far fewer. It stops at done too. Each step
// prefetches the loads of the cell PF steps down the diagonal, where the
// walk goes while it matches, so they come from L1 when it gets there.
__global__ void __launch_bounds__(128) bt_lane_kernel(BtArgs a) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= a.Bc) return;
    const int Lmax = a.Lmax, W = a.W;
    const int* dsel = a.dirs + (size_t)a.sel[c] * a.Wp;
    const size_t rstride = (size_t)a.Bdir * a.Wp;
    const int* rd = a.reads + (size_t)c * Lmax;
    const int* mp = a.mmpen + (size_t)c * Lmax;
    const int* rw = a.refwins + (size_t)c * W;
    int i = a.rows[c], j = a.lanes[c], mode = 0;
    int nmm = 0, ngo = 0, ngc = 0, nrefn = 0, score = 0, refmin = 1 << 30;
    int s = 0;
    for (; s < a.S; ++s) {
        const int ic = clampi(i, 0, Lmax - 1), jc = clampi(j, 0, W - 1);
        const int ip = clampi(i - PF, 0, Lmax - 1), jp = clampi(j - PF, 0, W - 1);
        prefetch_l1(dsel + ip * rstride + (jp >> 3));
        prefetch_l1(rd + ip);
        prefetch_l1(mp + ip);
        prefetch_l1(rw + jp);
        const int d = (__ldg(dsel + ic * rstride + (jc >> 3)) >> (4 * (jc & 7))) & 15;
        const int rc = __ldg(rd + ic), qp = __ldg(mp + ic), fc = __ldg(rw + jc);
        const int op = mode ? mode : (d & 3);
        if (op == OP_NONE || i < 0) break;
        const bool em = op == OP_M, ei = op == OP_I, ed = op == OP_D;
        const bool is_n = rc >= 4 || fc == 4;
        const bool ismatch = em && rc == fc && !is_n && fc < 4;
        const int m_sc = ismatch ? a.mb : (is_n ? -a.n_pen : -qp);
        const bool i_open = ei && !(d & 4), d_open = ed && !(d & 8);
        score += (em ? m_sc : 0) - (ei ? a.rfe : 0) - (i_open ? a.rfo : 0)
                 - (ed ? a.rde : 0) - (d_open ? a.rdo : 0);
        nmm += (em && !ismatch && rc < 4 && fc != 4) + (em && is_n);
        nrefn += em && fc == 4;
        ngo += i_open + d_open;
        ngc += ei + ed;
        if ((em || ed) && j < refmin) refmin = j;
        a.ops[(size_t)s * a.Bc + c] = (unsigned char)(
            op | (clampi(fc, 0, 5) << 2) | ((int)ismatch << 5));
        i -= op < 2;
        j -= !(op & 1);
        mode = op & -((d >> (op + 1)) & 1);
    }
    // every step from s on is done: OP_NONE at the frozen column
    const unsigned char tail = (unsigned char)(
        OP_NONE | (clampi(__ldg(rw + clampi(j, 0, W - 1)), 0, 5) << 2));
    for (; s < a.S; ++s) a.ops[(size_t)s * a.Bc + c] = tail;
    a.fields[0 * a.Bc + c] = i + 1;
    a.fields[1 * a.Bc + c] = refmin == (1 << 30) ? 0 : refmin;
    a.fields[2 * a.Bc + c] = nmm;
    a.fields[3 * a.Bc + c] = ngo;
    a.fields[4 * a.Bc + c] = ngc;
    a.fields[5 * a.Bc + c] = nrefn;
    a.fields[6 * a.Bc + c] = score;
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
    if (Bc > 0) {
        BtArgs a{(const int*)dirs, Lmax, Bdir, Wp, (const int*)sel,
                 (const int*)rows, (const int*)lanes, (const int*)reads,
                 (const int*)mmpen, (const int*)refwins, Bc, W, S,
                 match_bonus, n_pen, rdo, rde, rfo, rfe,
                 (unsigned char*)ops, (int*)fields};
        // walks the warp kernel runs at once on the current device: two
        // blocks an SM (__launch_bounds__)
        int dev = 0, sms = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (Bc <= LANE_WAVES * sms * 2 * NW)
            bt_kernel<<<(Bc + NW - 1) / NW, NW * 32, 0,
                        (cudaStream_t)stream>>>(a);
        else
            bt_lane_kernel<<<(Bc + 127) / 128, 128, 0,
                             (cudaStream_t)stream>>>(a);
    }
    return (int)cudaGetLastError();
}
