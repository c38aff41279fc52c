// Kernel K11: the band-coordinate affine-gap DP (`sw_diag`) and its
// direction walk (`bt_diag`), for reads longer than the rectangle buckets.
//
// Replaces: bowtie2_tpu/ops/sw.py:655 sw_banded_diag, a lax.scan over read
// rows of (B, BW) vector ops, and :765 backtrace_diag, a lax.scan of S steps
// over the chosen candidates. Cell (i, d) is read row i against window
// column i + d, d in [0, BW), BW = 2G + 1 <= 63: the diagonal move keeps d,
// E (ref gap) reads the previous row's d + 1, F (read gap) the same row's
// d - 1 through the rectangle DP's lazy-F exclusive prefix max. The
// direction words are (Lmax, B, Wp) int32, Wp = ceil(BW / 8), 4 bits a cell
// (bits 0-1 the H source, bit 2 E from extension, bit 3 F from extension),
// so a 1-Mbp read keeps 32 MB of them.
//
// sw_diag, one warp a problem, the whole row loop inside the kernel. Bound
// on the card: the chain of rows. A row depends on the one before it
// through H and E, and inside the row through the F scan, so a problem
// takes Lmax rows of latency one after the other; the bytes (a direction
// byte a lane a row, a code, a penalty and one new window code a row) and
// the ~12 operations a cell are far below the card's rates. What the
// design does about it:
//   * lane k holds band cells 2k and 2k+1 in registers for the whole loop
//     (BW <= 63 <= 64 cells): no shared memory and no barrier, and the
//     F scan is one in-thread step and five shuffle levels;
//   * E of cell 2k is the lane's own cell 2k+1 of the previous row, E of
//     cell 2k+1 one shuffle from lane k+1; cells past BW hold NEG_INF;
//   * the band's window codes shift left by one cell a row the same way,
//     so one new code enters a row (column i + BW - 1, at lane G's first
//     cell); the read code, penalty and entering code of 32 rows come in
//     one coalesced load a lane, one chunk ahead, and each row takes its
//     three by shuffle;
//   * lane k writes byte k of the row (cell 2k in the low nibble, 2k+1 in
//     the high one): the little-endian image of the Wp words, one 32-byte
//     store a row; nibbles past BW are 0;
//   * the best cell: end to end it is row len-1's maximum, rightmost band
//     column on ties, one warp reduction at that row. In local mode the
//     reference takes, over active rows in order, the row maximum whenever
//     it is >= the best so far (rightmost column within a row). Let M be
//     the largest H over active cells. Every row holding M is taken (the
//     best so far never exceeds M) and no later row without M is (its
//     maximum is below the best, which is M from the first M-row on), so
//     the result is M at the last active row that holds M, in its
//     rightmost column holding M: the lexicographic maximum of (H, row,
//     column) over active cells. Each lane therefore keeps its own
//     running (H, row << 6 | column) with >= (rows and, within a row,
//     columns come in increasing order) and the warp reduces once at the
//     end. diag_cases' tie cases (tandem repeats, tied F runs) hold it.
// Rows past a read's end are part of dirs: they are computed from the held
// H and E with that row's code and window columns, and written.
//
// bt_diag, one warp a walk. The walk's row only goes down or stays (M and
// I go to row i-1, D stays in row i) and its band column stays in [0, BW),
// so the warp stages 64 rows at a time in shared memory by cp.async: each
// row's Wp direction words, read code and penalty, and the window codes of
// those rows' band columns; the next 64 rows load while the walk runs
// through the current ones (two stages a warp). Every lane holds the same
// walk state and takes the same steps from shared memory (broadcast
// loads); a step is the chain: one shared load, the move, the next index.
// Lane s mod 32 keeps the op byte of step s, and the warp stores 32 steps'
// bytes at once into the (S, Bc) layout, stores nothing waits on. After the
// walk is done, every step emits OP_NONE over the window code at the frozen
// cell, written by all lanes. The field arithmetic is backtrace.cu's (K9).
//
// Every index into dirs, ops, reads, mmpen and refwins is 64-bit: at Lmax
// = 2^20 and 1,024 problems dirs alone holds 2^33 words.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF = -(1 << 29);
constexpr int H_DIAG = 0, H_E = 1, H_F = 2, H_START = 3;
constexpr int OP_M = 0, OP_I = 1, OP_D = 2, OP_NONE = 3;
constexpr unsigned FULL = 0xFFFFFFFFu;
// column code: reference base r (0..3) is r + BASE, an N its fixed
// substitution score -n_pen, a column outside the reference OOB
constexpr int BASE = 1 << 24;
constexpr int OOB = NEG_INF / 2;

struct SwParams {
    int match_bonus, n_pen, rdo, rde, rfo, rfe, gbar;
};

struct DiagArgs {
    const int* reads;
    const int* mmpen;
    const int* lens;
    const int* refwins;
    int B, Lmax, W, BW, Wp;
    int* score;
    int* row;
    int* lane;
    int* dirs;
};

__device__ __forceinline__ int col_code(int r, int n_pen) {
    return r >= 5 ? OOB : (r == 4 ? -n_pen : r + BASE);
}

// rows [r0, r0 + 32), one a lane: the read code, the penalty and the code
// of the window column that enters the band at that row (i + BW - 1)
struct Chunk {
    int rc, qp, nc;
};

__device__ __forceinline__ Chunk load_chunk(const int* rd, const int* mp,
                                            const int* win, int Lmax, int W,
                                            int BW, int r0, int lane,
                                            int n_pen) {
    const int r = r0 + lane;
    Chunk c{4, 0, OOB};
    if (r < Lmax) {
        c.rc = __ldg(rd + r);
        c.qp = __ldg(mp + r);
    }
    const long long col = (long long)r + BW - 1;
    if (col < W) c.nc = col_code(__ldg(win + col), n_pen);
    return c;
}

// inclusive prefix max over the warp's lanes
__device__ __forceinline__ int warp_scan_max(int v) {
    #pragma unroll
    for (int o = 1; o < 32; o <<= 1) v = max(v, __shfl_up_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ long long warp_max_key(long long key) {
    #pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const long long other = __shfl_xor_sync(FULL, key, o);
        key = other > key ? other : key;
    }
    return key;
}

// (score, row << 6 | band column) as one ordered key
__device__ __forceinline__ long long cell_key(int h, int pos) {
    return (long long)h * 4294967296LL + pos;
}

// One warp per problem; warps never wait for each other.
template <bool LOCAL>
__global__ void __launch_bounds__(128) sw_diag_kernel(DiagArgs a, SwParams p) {
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (b >= a.B) return;                    // the whole warp leaves
    const int BW = a.BW, Lmax = a.Lmax;
    const int G = BW >> 1;                   // lane G's first cell is BW - 1
    const int* rd = a.reads + (size_t)b * Lmax;
    const int* mp = a.mmpen + (size_t)b * Lmax;
    const int* win = a.refwins + (size_t)b * a.W;
    const int len = a.lens[b];
    const int d0 = 2 * lane, d1 = d0 + 1;
    const bool v0 = d0 < BW, v1 = d1 < BW;
    const int rgo = p.rdo + p.rde, fgo = p.rfo + p.rfe;
    // the F scan in the plain version's offset form: cell d carries
    // H_noF(d) - rgo + rde + d * rde
    const int off0 = p.rde - rgo + d0 * p.rde, off1 = off0 + p.rde;

    // row 0's band covers window columns 0 .. BW - 1
    int c0 = v0 ? col_code(__ldg(win + d0), p.n_pen) : OOB;
    int c1 = v1 ? col_code(__ldg(win + d1), p.n_pen) : OOB;
    int h0 = v0 ? 0 : NEG_INF, h1 = v1 ? 0 : NEG_INF;   // free start
    int e0 = NEG_INF, e1 = NEG_INF;
    int best = INT_MIN, best_pos = 0;        // local: this lane's best cell
    long long e2e_key = LLONG_MIN;
    Chunk cur = load_chunk(rd, mp, win, Lmax, a.W, BW, 0, lane, p.n_pen);
    Chunk next = load_chunk(rd, mp, win, Lmax, a.W, BW, 32, lane, p.n_pen);
    unsigned char* out = reinterpret_cast<unsigned char*>(a.dirs)
                         + (size_t)b * a.Wp * 4 + lane;
    const size_t row_stride = (size_t)a.B * a.Wp * 4;   // bytes
    const bool writer = lane < 4 * a.Wp;

    for (int i = 0; i < Lmax; ++i) {
        if (i > 0 && (i & 31) == 0) {
            cur = next;
            next = load_chunk(rd, mp, win, Lmax, a.W, BW, i + 32, lane,
                              p.n_pen);
        }
        const int rc = __shfl_sync(FULL, cur.rc, i & 31);
        const int qp = __shfl_sync(FULL, cur.qp, i & 31);
        const int nc = __shfl_sync(FULL, cur.nc, i & 31);
        if (i > 0) {                         // the band moves one column
            const int right = __shfl_down_sync(FULL, c0, 1);
            c0 = lane == G ? nc : c1;
            c1 = right;
        }
        const int rcn = rc >= 4 ? -1 : rc + BASE;   // an N matches nothing
        const int mmv = rc >= 4 ? -p.n_pen : -qp;
        const bool active = i < len;
        const bool bar = p.gbar > 0 && (i < p.gbar || i >= len - p.gbar);

        // E: the previous row's cell d + 1 (cell 2k+1's from lane k+1)
        const int hu = __shfl_down_sync(FULL, h0, 1);
        const int eu = __shfl_down_sync(FULL, e0, 1);
        bool ge0, ge1;
        int ec0 = __vibmax_s32(h1 - fgo, e1 - p.rfe, &ge0);
        int ec1 = __vibmax_s32(hu - fgo, eu - p.rfe, &ge1);
        const bool x0 = !ge0, x1 = !ge1;     // e_ext > e_open
        if (bar || c0 == OOB) ec0 = NEG_INF;
        if (bar || c1 == OOB) ec1 = NEG_INF;

        // diagonal: the previous row's same cell
        int s0 = c0 == rcn ? p.match_bonus : mmv;
        int s1 = c1 == rcn ? p.match_bonus : mmv;
        s0 = c0 < BASE ? c0 : s0;
        s1 = c1 < BASE ? c1 : s1;
        bool dg0, dg1;                       // h_diag >= e: not from E
        const int hn0 = __vibmax_s32(h0 + s0, ec0, &dg0);
        const int hn1 = __vibmax_s32(h1 + s1, ec1, &dg1);

        // F: exclusive prefix max over the band, floored at NEG_INF
        const int fa0 = hn0 + off0;
        const int incl = warp_scan_max(max(fa0, hn1 + off1));
        int ex = __shfl_up_sync(FULL, incl, 1);
        int hnl = __shfl_up_sync(FULL, hn1, 1);
        if (lane == 0) {
            ex = NEG_INF;
            hnl = NEG_INF;
        }
        const int f0r = max(ex, NEG_INF) - d0 * p.rde;
        const int f1r = max(max(ex, fa0), NEG_INF) - d1 * p.rde;
        const bool fx0 = f0r > hnl - rgo;    // F carried > F opened
        const bool fx1 = f1r > hn0 - rgo;
        bool nf0, nf1;                       // H_noF >= F: not from F
        int hc0 = __vibmax_s32(hn0, bar ? NEG_INF : f0r, &nf0);
        int hc1 = __vibmax_s32(hn1, bar ? NEG_INF : f1r, &nf1);
        int src0 = nf0 ? (dg0 ? H_DIAG : H_E) : H_F;
        int src1 = nf1 ? (dg1 ? H_DIAG : H_E) : H_F;
        if (LOCAL) {
            if (hc0 < 0 || (hc0 == 0 && src0 == H_DIAG)) src0 = H_START;
            if (hc1 < 0 || (hc1 == 0 && src1 == H_DIAG)) src1 = H_START;
            hc0 = max(hc0, 0);
            hc1 = max(hc1, 0);
        } else {
            hc0 = max(hc0, NEG_INF);
            hc1 = max(hc1, NEG_INF);
        }

        const unsigned nib0 = v0 ? (unsigned)src0 | (x0 ? 4u : 0u)
                                   | (fx0 ? 8u : 0u) : 0u;
        const unsigned nib1 = v1 ? (unsigned)src1 | (x1 ? 4u : 0u)
                                   | (fx1 ? 8u : 0u) : 0u;
        if (writer) out[i * row_stride] = (unsigned char)(nib0 | (nib1 << 4));

        if (LOCAL) {
            if (active) {
                if (v0 && hc0 >= best) {
                    best = hc0;
                    best_pos = (i << 6) | d0;
                }
                if (v1 && hc1 >= best) {
                    best = hc1;
                    best_pos = (i << 6) | d1;
                }
            }
        } else if (i == len - 1) {           // the same for the whole warp
            const long long k0 = v0 ? cell_key(hc0, (i << 6) | d0) : LLONG_MIN;
            const long long k1 = v1 ? cell_key(hc1, (i << 6) | d1) : LLONG_MIN;
            e2e_key = warp_max_key(k0 > k1 ? k0 : k1);
        }
        if (active) {
            h0 = v0 ? hc0 : NEG_INF;
            h1 = v1 ? hc1 : NEG_INF;
            e0 = v0 ? ec0 : NEG_INF;
            e1 = v1 ? ec1 : NEG_INF;
        }
    }
    const long long key = LOCAL
        ? warp_max_key(best == INT_MIN ? LLONG_MIN : cell_key(best, best_pos))
        : e2e_key;
    if (lane == 0) {
        if (key == LLONG_MIN) {              // no cell was taken
            a.score[b] = NEG_INF;
            a.row[b] = 0;
            a.lane[b] = 0;
        } else {
            const long long low = key & 0xFFFFFFFFLL;
            a.score[b] = (int)((key - low) / 4294967296LL);
            a.row[b] = (int)(low >> 6);
            a.lane[b] = (int)(low & 63);
        }
    }
}

// ---------------------------------------------------------------------------
// the walk
// ---------------------------------------------------------------------------

constexpr int NW = 4;       // walks (warps) a block
constexpr int R = 64;       // rows a stage
constexpr int FCW = 128;    // window codes a stage: rows T-63..T, cells < 64

struct Stage {
    int dirs[R * 8];        // row T - k's words at k * 8
    int rc[R];              // row T - k's read code and penalty at k
    int qp[R];
    int fc[FCW];            // window column T - 63 + x at x (clamped)
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
    int Bc, W, S, BW;
    int mb, n_pen, rdo, rde, rfo, rfe;
    unsigned char* ops;
    int* fields;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 : : "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" : : : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" : : "n"(N) : "memory");
}

// rows T - k (k < R, row >= 0) and window columns T - (R-1) + x into st,
// as one group of asynchronous copies; rows below 0 are never read
__device__ __forceinline__ void stage(Stage& st, int T, const int* dsel,
                                      size_t rstride, int Wp, const int* rd,
                                      const int* mp, const int* rw, int W,
                                      int lane) {
    for (int t = lane; t < R * 8; t += 32) {
        const int k = t >> 3, w = t & 7, r = T - k;
        if (w < Wp && r >= 0) cp_async4(&st.dirs[t], dsel + (size_t)r * rstride + w);
    }
    for (int k = lane; k < R; k += 32) {
        const int r = T - k;
        if (r >= 0) {
            cp_async4(&st.rc[k], rd + r);
            cp_async4(&st.qp[k], mp + r);
        }
    }
    for (int x = lane; x < FCW; x += 32)
        cp_async4(&st.fc[x], rw + clampi(T - (R - 1) + x, 0, W - 1));
    cp_async_commit();
}

__global__ void __launch_bounds__(NW * 32) bt_diag_kernel(BtArgs a) {
    __shared__ Stage st[NW][2];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int c = blockIdx.x * NW + w;
    if (c >= a.Bc) return;                   // the whole warp leaves
    const int Lmax = a.Lmax, W = a.W, BW = a.BW, S = a.S;
    const int* dsel = a.dirs + (size_t)a.sel[c] * a.Wp;
    const size_t rstride = (size_t)a.Bdir * a.Wp;
    const int* rd = a.reads + (size_t)c * Lmax;
    const int* mp = a.mmpen + (size_t)c * Lmax;
    const int* rw = a.refwins + (size_t)c * W;

    int i = a.rows[c], d = a.lanes[c], mode = 0, s = 0;
    int score = 0, nmm = 0, ngo = 0, ngc = 0, nrefn = 0, refmin = 1 << 30;
    unsigned char kept = 0;                  // the op byte of step s - s%32 + lane
    int buf = 0, T = 0;
    if (i >= 0 && d >= 0 && d < BW) {
        T = min(i, Lmax - 1);
        stage(st[w][0], T, dsel, rstride, a.Wp, rd, mp, rw, W, lane);
        stage(st[w][1], T - R, dsel, rstride, a.Wp, rd, mp, rw, W, lane);
        cp_async_wait<1>();
        __syncwarp();
    }
    while (s < S) {
        // done: row below 0, or the band column left the band
        if (i < 0 || d < 0 || d >= BW) break;
        const int ic = min(i, Lmax - 1);
        if (ic < T - (R - 1)) {              // the next stage, prefetched
            cp_async_wait<0>();
            __syncwarp();
            T -= R;
            buf ^= 1;
            stage(st[w][buf ^ 1], T - R, dsel, rstride, a.Wp, rd, mp, rw, W,
                  lane);
        }
        const Stage& sg = st[w][buf];
        const int k = T - ic;
        const int dd = (sg.dirs[k * 8 + (d >> 3)] >> (4 * (d & 7))) & 15;
        const int src = dd & 3;
        if (mode == 0 && src == H_START) break;
        const int op = mode ? mode : src;    // H_DIAG/H_E/H_F = OP_M/I/D
        const int rc = sg.rc[k], qp = sg.qp[k];
        const int j = ic + d;                // rect column
        const int fc = sg.fc[j - (T - (R - 1))];
        const bool em = op == OP_M, ei = op == OP_I, ed = op == OP_D;
        const bool is_n = rc >= 4 || fc == 4;
        const bool ismatch = em && rc == fc && !is_n && fc < 4;
        const int m_sc = ismatch ? a.mb : (is_n ? -a.n_pen : -qp);
        const bool i_open = ei && !(dd & 4), d_open = ed && !(dd & 8);
        score += (em ? m_sc : 0) - (ei ? a.rfe : 0) - (i_open ? a.rfo : 0)
                 - (ed ? a.rde : 0) - (d_open ? a.rdo : 0);
        nmm += (em && !ismatch && rc < 4 && fc != 4) + (em && is_n);
        nrefn += em && fc == 4;
        ngo += i_open + d_open;
        ngc += ei + ed;
        if ((em || ed) && j < refmin) refmin = j;
        if (lane == (s & 31))
            kept = (unsigned char)(op | (clampi(fc, 0, 5) << 2)
                                   | ((int)ismatch << 5));
        ++s;
        if ((s & 31) == 0)
            a.ops[(size_t)(s - 32 + lane) * a.Bc + c] = kept;
        // band moves: M -> (i-1, d); I -> (i-1, d+1); D -> (i, d-1); the
        // E or F extension bit of the move taken keeps its mode
        i -= op < 2;
        d += (op == OP_I) - (op == OP_D);
        mode = op & -((dd >> (op + 1)) & 1);
    }
    if (lane < (s & 31))
        a.ops[(size_t)((s & ~31) + lane) * a.Bc + c] = kept;
    // every step from s on is done: OP_NONE over the window code at the
    // frozen cell (row and band column clamped as every load clamps them)
    const int jf = clampi(i, 0, Lmax - 1) + clampi(d, 0, BW - 1);
    const unsigned char tail = (unsigned char)(
        OP_NONE | (clampi(__ldg(rw + clampi(jf, 0, W - 1)), 0, 5) << 2));
    for (int t = s + lane; t < S; t += 32)
        a.ops[(size_t)t * a.Bc + c] = tail;
    if (lane == 0) {
        a.fields[0 * (size_t)a.Bc + c] = i + 1;                  // read_start
        a.fields[1 * (size_t)a.Bc + c] = refmin == (1 << 30) ? 0 : refmin;
        a.fields[2 * (size_t)a.Bc + c] = nmm;
        a.fields[3 * (size_t)a.Bc + c] = ngo;
        a.fields[4 * (size_t)a.Bc + c] = ngc;
        a.fields[5 * (size_t)a.Bc + c] = nrefn;
        a.fields[6 * (size_t)a.Bc + c] = score;
    }
    cp_async_wait<0>();                      // no copy outlives the warp
}

}  // namespace

// B problems; reads/mmpen (B, Lmax), refwins (B, W) with W >= Lmax + 2 *
// band, lens (B,) int32; score/row/lane (B,) int32 (lane: band column);
// dirs (Lmax, B, ceil((2 * band + 1) / 8)) int32. band <= 31.
extern "C" int sw_diag(const void* reads, const void* mmpen, const void* lens,
                       const void* refwins, int B, int Lmax, int W, int band,
                       int match_bonus, int n_pen, int rdo, int rde, int rfo,
                       int rfe, int gbar, int local, void* score, void* row,
                       void* lane, void* dirs, void* stream) {
    const int BW = 2 * band + 1;
    if (band < 0 || band > 31 || (long long)W < (long long)Lmax + BW - 1 ||
        Lmax >= (1 << 25) || n_pen <= -BASE || n_pen >= BASE)
        return (int)cudaErrorInvalidValue;
    if (B > 0 && Lmax > 0) {
        const DiagArgs a{(const int*)reads, (const int*)mmpen,
                         (const int*)lens, (const int*)refwins, B, Lmax, W,
                         BW, (BW + 7) / 8, (int*)score, (int*)row,
                         (int*)lane, (int*)dirs};
        const SwParams p{match_bonus, n_pen, rdo, rde, rfo, rfe, gbar};
        const int per_block = 4;
        const dim3 grid((B + per_block - 1) / per_block);
        cudaStream_t s = (cudaStream_t)stream;
        if (local)
            sw_diag_kernel<true><<<grid, 32 * per_block, 0, s>>>(a, p);
        else
            sw_diag_kernel<false><<<grid, 32 * per_block, 0, s>>>(a, p);
    }
    return (int)cudaGetLastError();
}

// dirs (Lmax, Bdir, Wp) from sw_diag; sel/rows/lanes (Bc,) (lanes: band
// columns); reads/mmpen (Bc, Lmax); refwins (Bc, W); ops (S, Bc) uint8;
// fields (7, Bc) int32.
extern "C" int bt_diag(const void* dirs, int Lmax, int Bdir, int Wp,
                       const void* sel, const void* rows, const void* lanes,
                       const void* reads, const void* mmpen,
                       const void* refwins, int Bc, int W, int S, int band,
                       int match_bonus, int n_pen, int rdo, int rde, int rfo,
                       int rfe, void* ops, void* fields, void* stream) {
    const int BW = 2 * band + 1;
    if (band < 0 || band > 31 || Wp * 8 < BW || Wp > 8 || W < 1 || Lmax < 1)
        return (int)cudaErrorInvalidValue;
    if (Bc > 0) {
        const BtArgs a{(const int*)dirs, Lmax, Bdir, Wp, (const int*)sel,
                       (const int*)rows, (const int*)lanes,
                       (const int*)reads, (const int*)mmpen,
                       (const int*)refwins, Bc, W, S, BW, match_bonus,
                       n_pen, rdo, rde, rfo, rfe, (unsigned char*)ops,
                       (int*)fields};
        bt_diag_kernel<<<(Bc + NW - 1) / NW, NW * 32, 0,
                         (cudaStream_t)stream>>>(a);
    }
    return (int)cudaGetLastError();
}
