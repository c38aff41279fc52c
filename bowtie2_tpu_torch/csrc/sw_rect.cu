// Kernel C: rectangle affine-gap DP (read rows x reference-window columns).
//
// Replaces: bowtie2_tpu/ops/sw.py:144 sw_banded, the DP on the main path, a
// lax.scan over read rows of (B, W) vector ops with a Kogge-Stone prefix max
// per row; and its Pallas counterpart bowtie2_tpu/ops/pallas_sw.py:145
// sw_pallas (same recurrence, one problem tile per grid step, H/E carried
// in VMEM). Two C entries: `sw_rect` (track_origin=False) and
// `sw_rect_origin` (track_origin=True, the paired-end path), one template
// flag (ORIGIN) apart.
//
// What the entries compute (ops/sw.py SWResult). Of the B problems only
// the first n_live run: n_live is a count the kernel reads on the card (a
// 0-d tensor, so the fused pipelines, which compact their live lanes to
// the front, stay free of host syncs) or a host count, to which the grid
// shrinks. A lane at or past n_live gets the fill of a problem without a
// cell (score NEG_INF, row, lane and origin 0) and no direction words.
// A live lane runs its rows 0..len-1 and no further: no walk starts past
// row len-1 (end to end the best cell is on that row, and in local mode a
// row past the read is inactive), so the direction rows at or past len
// are left unwritten, unspecified as a dead lane's words are. The score,
// row, lane, origin and rows below len equal the plain version's.
//
// Layout: thread t owns the 8*WPT consecutive columns of its WPT packed
// direction words, so H, E and the column codes of its cells live in
// registers for the whole row loop. Per row and thread:
//   pass 1: substitution, E = max(H - open, E - extend) and H without F for
//           each cell; the thread's running F carry (max of F - extend and
//           H - open, column by column) is its share of the row's F scan;
//   scan:   an exclusive prefix max of those carries over the row's threads
//           (warp shuffles; across warps through shared memory);
//   pass 2: F cell by cell from the carry that enters the thread, H, the
//           local-mode clamp and the 4-bit direction of each cell, packed
//           into the thread's words and stored coalesced.
// Tie rules are the plain version's: `ec > hd` gives H_E, `F > H_noF` gives
// H_F, `e_ext > e_open` and `F carried > F opened` set the extension bits.
//
// Bound on the card: instruction issue, not bytes. The dirs store is len x
// B x W/2 bytes, against a row loop of some 390 SASS instructions for a
// lane's 8 cells (`cuobjdump -sass` of the built library): the two passes
// plus the scan, the row's read code and the store. The row loop is a
// serial chain per problem, so many problems run at once. The recurrence
// uses Hopper's DPX intrinsics: __vibmax_s32 gives max(a, b) and a >= b,
// whose negation is each strict tie rule above, and __viaddmax_s32 the F
// carry; nvcc emits VIADDMNMX / VIMNMX3 from plain max() too, which timed
// slightly slower on the main path's large calls. What the design does
// about the issue rate:
//   * a window of at most 256 (WPT 1) or 512 (WPT 2) columns is one warp:
//     no shared memory and no barrier, and every warp runs on its own;
//   * the read code and mismatch penalty of 32 rows come in one coalesced
//     load a lane, one chunk ahead, and each row takes its pair by shuffle;
//   * the best cell is a 32-bit (score, position) per thread, updated once
//     per counting row from the thread's row maximum; the 64-bit key is
//     built only for the final reduction;
//   * wider windows (long reads, mate-rescue windows past 512 columns, up
//     to 2048 words) take the multi-warp kernel, with the same cell code
//     and two barriers a row.
//
// Origin tracking (ORIGIN): each cell also carries the rect column of the
// first reference character its best path consumed (-1: none yet), o for H
// and oe for E, as two int16 halves of one register (columns and col + 1
// stay below 16385), under the direction bits' tie rules: the diagonal
// consumes column j (origin j when none yet), E consumes none, and an F run
// from column k consumes k+1..j first, so F's origin is the payload of its
// prefix max, the later column winning ties (sw.py
// `_prefix_max_payload_excl`). Pass 2 recomputes each cell's origin without
// F from the previous row's o/oe rather than keeping it from pass 1, so the
// variant costs one register a cell. The local clamp resets the origin to
// -1. The best cell's origin rides beside the thread's best key.
//
// The origin warp kernel (Wp <= 64) is the row-scan kernel above. A
// skewed wavefront (lane l on row s - l, F carried lane to lane, as
// sw_diag.cu) was exact but slower on an H100: its step's two passes cost
// more clocks than the scan's row, over more steps than rows (PERF.md).
//
// The block kernel with ORIGIN (one block a problem) has a body of its
// own, `block_origin<S, LOCAL>`, S the block's threads rounded up to 128,
// 256, 512 or 1024; each thread holds one word (8 cells). Up to 512
// threads (`sw_block_origin_reg_kernel`) the cells live in registers, at
// most 128 a thread (four blocks of 128 threads an SM). At 1024 threads
// (`sw_block_origin_kernel`) a thread has 64 registers, which the cells
// (four values each), the scan's state and the row loop's own outgrew
// (104 and 500 bytes of spill loads at 8 and 16 cells a thread): there
// every cell's window code (a byte), E, o/oe and H (which holds H without
// F between the passes) sit in shared memory, and a window past 1024
// words takes its rows in two parts, one after the other (13 bytes a
// column: at most 208 KB). A constant stride S between a thread's cells
// keeps each cell's address one base and an immediate offset. The two
// kernels are apart because ptxas spills this body under
// __launch_bounds__(1024, 1) and not under __launch_bounds__(1024).
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NEG_INF = -(1 << 29);
constexpr int H_DIAG = 0, H_E = 1, H_F = 2, H_START = 3;
constexpr unsigned FULL = 0xFFFFFFFFu;
// column code: reference base r (0..3) inside the rectangle is r + BASE;
// an N inside it is its fixed substitution score -n_pen; a column outside
// the rectangle or the reference (code >= 5) is OOB
constexpr int BASE = 1 << 24;
constexpr int OOB = NEG_INF / 2;
// the warp kernels' warps a block
constexpr int WARPS = 4;

// one cell's origin state: o in the low half, oe in the high half, int16
__device__ __forceinline__ int o_lo(unsigned pk) { return (int)(short)(pk & 0xFFFFu); }
__device__ __forceinline__ int o_hi(unsigned pk) { return (int)pk >> 16; }
__device__ __forceinline__ unsigned o_pack(int o, int oe) {
    return ((unsigned)oe << 16) | ((unsigned)o & 0xFFFFu);
}

struct SwParams {
    int match_bonus, n_pen, rdo, rde, rfo, rfe, gbar;
};

struct Problem {
    const int* reads;      // this problem's row of reads / mmpen
    const int* mmpen;
    int len, Lmax;
};

// the read code and penalty of rows [r0, r0 + 32): one per lane
struct RowChunk {
    int rc, qp;
};

__device__ __forceinline__ RowChunk load_chunk(const Problem& pr, int r0,
                                               int lane) {
    const int r = r0 + lane;
    RowChunk c{4, 0};
    if (r < pr.Lmax) {
        c.rc = __ldg(pr.reads + r);
        c.qp = __ldg(pr.mmpen + r);
    }
    return c;
}

__device__ __forceinline__ int col_code(int r, int n_pen) {
    return r >= 5 ? OOB : (r == 4 ? -n_pen : r + BASE);
}

// a window column's code, 5 outside the rectangle or the window
__device__ __forceinline__ int win_code(const int* __restrict__ win, int W,
                                        int col, int lo, int hi) {
    return (col < W && col >= lo && col < hi) ? __ldg(win + col) : 5;
}

template <int CPT>
__device__ __forceinline__ void load_codes(int (&code)[CPT],
                                           const int* __restrict__ win, int W,
                                           int c0, int lo, int hi, int n_pen) {
    #pragma unroll
    for (int k = 0; k < CPT; ++k)
        code[k] = col_code(win_code(win, W, c0 + k, lo, hi), n_pen);
}

// per-row state shared by the passes
struct Row {
    int rcn, mmv;          // read code as a column code (never matches if
                           // N), and the mismatch score of the row
    bool active, bar;
};

__device__ __forceinline__ Row make_row(int rc, int qp, bool active, int i,
                                        int len, const SwParams& p) {
    Row row;
    row.rcn = rc >= 4 ? -1 : rc + BASE;
    row.mmv = rc >= 4 ? -p.n_pen : -qp;
    row.active = active;
    row.bar = p.gbar > 0 && (i < p.gbar || i >= len - p.gbar);
    return row;
}

// where the passes find a cell's column code, E and origins: the thread's
// registers, or (the block kernel with ORIGIN) shared memory, cell k of
// thread t at k * S + t: a constant stride, so that each cell's
// address is one base and an immediate offset (a stride known only at run
// time made the compiler hold each cell's address in a register)
template <int CPT>
struct RegCells {
    const int (&code)[CPT];
    int (&e)[CPT];
    unsigned (&o)[CPT];        // ORIGIN only
    int (&hv)[CPT];            // H of the last row
    int (&h_nof)[CPT];         // the row's H without F, pass 1 to pass 2
    __device__ __forceinline__ int col(int k) const { return code[k]; }
    __device__ __forceinline__ int h(int k) const { return hv[k]; }
    __device__ __forceinline__ void set_h(int k, int v) const { hv[k] = v; }
    __device__ __forceinline__ int hn(int k) const { return h_nof[k]; }
    __device__ __forceinline__ void set_hn(int k, int v) const {
        h_nof[k] = v;
    }
    __device__ __forceinline__ int get_e(int k) const { return e[k]; }
    __device__ __forceinline__ void set_e(int k, int v) const { e[k] = v; }
    __device__ __forceinline__ unsigned og(int k) const { return o[k]; }
    __device__ __forceinline__ void set_og(int k, unsigned v) const {
        o[k] = v;
    }
};

// H and H without F share a cell's word: pass 1 reads H(k) before it
// writes H_noF(k) and keeps H(k) for cell k + 1, pass 2 reads H_noF(k)
// before it writes H(k)
template <int S>
struct SmemCells {
    const signed char* code;   // window codes 0..5
    int* e;
    unsigned* o;
    int* hh;
    int n_pen;
    __device__ __forceinline__ int h(int k) const {
        return hh[k * S];
    }
    __device__ __forceinline__ void set_h(int k, int v) const {
        hh[k * S] = v;
    }
    __device__ __forceinline__ int hn(int k) const {
        return hh[k * S];
    }
    __device__ __forceinline__ void set_hn(int k, int v) const {
        hh[k * S] = v;
    }
    __device__ __forceinline__ int col(int k) const {
        return col_code(code[k * S], n_pen);
    }
    __device__ __forceinline__ int get_e(int k) const {
        return e[k * S];
    }
    __device__ __forceinline__ void set_e(int k, int v) const {
        e[k * S] = v;
    }
    __device__ __forceinline__ unsigned og(int k) const {
        return o[k * S];
    }
    __device__ __forceinline__ void set_og(int k, unsigned v) const {
        o[k * S] = v;
    }
};

// pass 1: H without F (cells.hn), the E-source and E-extension bit masks, the new
// E (kept only on an active row) and the thread's F carry out of its last
// column, F_out = max_k (hn[k] - rgo - (CPT-1-k) * rde); with ORIGIN also
// the carry's payload (cpay), the origin a gap run from the carry's column
// starts from, later columns winning ties. cells.og holds the previous
// row's origins, ol the origin of the column left of the thread's first.
template <int CPT, bool ORIGIN, class Cells>
__device__ __forceinline__ int pass1(const Cells& cells, unsigned& m_e,
                                     unsigned& m_x, int hl,
                                     const Row& row, const SwParams& p,
                                     int rgo, int fgo, int ol, int c0,
                                     int& cpay) {
    int carry = 2 * NEG_INF, h_left = hl;
    cpay = -1;
    m_e = 0u;
    m_x = 0u;
    #pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int c = cells.col(k);
        int s = c == row.rcn ? p.match_bonus : row.mmv;
        s = c < BASE ? c : s;
        const int hk = cells.h(k);
        const int hd = h_left + s;
        h_left = hk;
        bool open_ge, diag_ge;
        int ec = __vibmax_s32(hk - fgo, cells.get_e(k) - p.rfe, &open_ge);
        m_x |= (open_ge ? 0u : 1u) << k;     // e_ext > e_open
        if (c == OOB || row.bar) ec = NEG_INF;
        const int hnk = __vibmax_s32(hd, ec, &diag_ge);
        cells.set_hn(k, hnk);
        m_e |= (diag_ge ? 0u : 1u) << k;     // ec > hd
        if (row.active) cells.set_e(k, ec);
        if constexpr (ORIGIN) {
            const unsigned ogk = cells.og(k);
            const int op = o_lo(ogk);
            const int left = k == 0 ? ol : o_lo(cells.og(k - 1));
            const int od = left < 0 ? c0 + k : left;
            const int oen = open_ge ? op : o_hi(ogk);
            const int onf = diag_ge ? od : oen;
            bool ge;
            carry = __vibmax_s32(hnk - rgo, carry - p.rde, &ge);
            cpay = ge ? (onf < 0 ? c0 + k + 1 : onf) : cpay;
        } else {
            carry = __viaddmax_s32(carry, -p.rde, hnk - rgo);
        }
    }
    return carry;
}

// pass 2: F from f_in (F at the thread's first column) and fo0 (F opened
// from the column left of it), then H, the source and the packed words;
// H is kept only on an active row. With ORIGIN, pin is f_in's payload and
// cells.og the origins, updated on an active row.
template <int CPT, int WPT, bool LOCAL, bool ORIGIN, class Cells>
__device__ __forceinline__ void pass2(const Cells& cells, unsigned m_e,
                                      unsigned m_x, int f_in, int fo0,
                                      unsigned (&words)[WPT],
                                      const Row& row, const SwParams& p,
                                      int rgo, int ol, int c0, int pin) {
    #pragma unroll
    for (int w = 0; w < WPT; ++w) words[w] = 0u;
    int f = f_in, fo = fo0, hn_prev = 0;
    int pf = pin, prev_op = ol, prev_fix = -1;
    #pragma unroll
    for (int k = 0; k < CPT; ++k) {
        bool f_ext;
        if (k == 0) {
            f_ext = f > fo;
        } else {
            bool open_ge;
            fo = hn_prev - rgo;
            f = __vibmax_s32(fo, f - p.rde, &open_ge);
            f_ext = !open_ge;                // F carried > F opened
            if constexpr (ORIGIN) pf = open_ge ? prev_fix : pf;
        }
        const int fm = row.bar ? NEG_INF : f;
        bool nof_ge;
        hn_prev = cells.hn(k);
        int hc = __vibmax_s32(hn_prev, fm, &nof_ge);
        int src = nof_ge ? (int)((m_e >> k) & 1u) : H_F;   // F > H_noF
        bool clamp = false;
        if (LOCAL) {
            clamp = hc < 0 || (hc == 0 && src == H_DIAG);
            if (clamp) src = H_START;
            hc = max(hc, 0);
        } else {
            hc = max(hc, NEG_INF);
        }
        if constexpr (ORIGIN) {
            const unsigned ogk = cells.og(k);
            const int op = o_lo(ogk);
            const int od = prev_op < 0 ? c0 + k : prev_op;
            const int oen = ((m_x >> k) & 1u) ? o_hi(ogk) : op;
            const int onf = ((m_e >> k) & 1u) ? oen : od;
            const int oc = clamp ? -1 : (nof_ge ? onf : pf);
            prev_op = op;
            prev_fix = onf < 0 ? c0 + k + 1 : onf;
            if (row.active) cells.set_og(k, o_pack(oc, oen));
        }
        const unsigned d = (unsigned)src | (((m_x >> k) & 1u) << 2)
                           | (f_ext ? 8u : 0u);
        words[k >> 3] |= d << (4 * (k & 7));
        if (row.active) cells.set_h(k, hc);
    }
}

// the thread's best cell on a counting row (every column < W), rightmost
// column on ties; later rows win ties against earlier ones; with ORIGIN
// the cell's origin goes to best_o
template <int CPT, bool ORIGIN, class Cells>
__device__ __forceinline__ void track_best(const Cells& cells, int c0, int W,
                                           int i, int& best, int& best_pos,
                                           int& best_o) {
    int m = INT_MIN, mk = 0, mo = 0;
    #pragma unroll
    for (int k = 0; k < CPT; ++k)
        if (c0 + k < W && cells.h(k) >= m) {
            m = cells.h(k);
            mk = k;
            if constexpr (ORIGIN) mo = o_lo(cells.og(k));
        }
    if (m != INT_MIN && m >= best) {
        best = m;
        best_pos = (i << 16) | (c0 + mk);
        if constexpr (ORIGIN) best_o = mo;
    }
}

// cells of packed word gw at columns >= W stay 0, as in the plain version
__device__ __forceinline__ unsigned word_mask(int gw, int W) {
    const int n = W - 8 * gw;
    return n >= 8 ? 0xFFFFFFFFu : (n <= 0 ? 0u : (1u << (4 * n)) - 1u);
}

__device__ __forceinline__ long long best_key(int best, int best_pos) {
    return best == INT_MIN ? LLONG_MIN
                           : (long long)best * 4294967296LL + best_pos;
}

__device__ __forceinline__ long long warp_max_key(long long key) {
    #pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const long long other = __shfl_xor_sync(FULL, key, o);
        key = other > key ? other : key;
    }
    return key;
}

__device__ __forceinline__ void write_best(long long key, int b, int* score,
                                           int* row, int* lane) {
    if (key == LLONG_MIN) {
        score[b] = NEG_INF;
        row[b] = 0;
        lane[b] = 0;
    } else {
        const long long low = key & 0xFFFFFFFFLL;
        score[b] = (int)((key - low) / 4294967296LL);
        row[b] = (int)(low >> 16);
        lane[b] = (int)(low & 0xFFFF);
    }
}

// inclusive prefix max over the warp's lanes (a lane below the offset
// gets its own value back from the shuffle)
__device__ __forceinline__ int warp_scan_max(int v) {
    #pragma unroll
    for (int o = 1; o < 32; o <<= 1) v = max(v, __shfl_up_sync(FULL, v, o));
    return v;
}

// the same with a payload: an earlier lane's pair replaces the lane's own
// only when its value is strictly larger (later lanes keep ties)
__device__ __forceinline__ int warp_scan_max_pay(int v, int& pay) {
    #pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int vo = __shfl_up_sync(FULL, v, o);
        const int po = __shfl_up_sync(FULL, pay, o);
        bool ge;
        v = __vibmax_s32(v, vo, &ge);
        pay = ge ? pay : po;
    }
    return v;
}

struct Args {
    const int* reads;
    const int* mmpen;
    const int* lens;
    const int* refwins;
    const int* rect_cols;
    const int* col_lo;
    const int* n_live;     // the live count on the card, or null
    int B, n_run;          // problems; the grid's (the live count if null)
    int Lmax, W, Wp;
    int* score;
    int* row;
    int* lane;
    int* dirs;
    int* origin;           // (B,) with ORIGIN, else null
};

// the live lanes, [0, n); every thread of the grid first writes the fill
// of its share of the dead lanes [n, B)
template <bool ORIGIN>
__device__ __forceinline__ int live_lanes(const Args& a) {
    const int n = a.n_live ? min(max(*a.n_live, 0), a.n_run) : a.n_run;
    const int stride = gridDim.x * blockDim.x;
    for (int x = n + blockIdx.x * blockDim.x + threadIdx.x; x < a.B;
         x += stride) {
        write_best(LLONG_MIN, x, a.score, a.row, a.lane);
        if constexpr (ORIGIN) a.origin[x] = 0;
    }
    return n;
}

// One warp per problem (Wp <= 32 * WPT); warps never wait for each other.
template <int WPT, bool LOCAL, bool ORIGIN>
__global__ void __launch_bounds__(32 * WARPS)
sw_warp_kernel(Args a, SwParams p) {
    constexpr int CPT = 8 * WPT;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (b >= live_lanes<ORIGIN>(a)) return;  // the whole warp leaves
    const Problem pr{a.reads + (size_t)b * a.Lmax, a.mmpen + (size_t)b * a.Lmax,
                     a.lens[b], a.Lmax};
    const int len = min(pr.len, a.Lmax);
    const int lo = a.col_lo ? a.col_lo[b] : 0;
    const int hi = lo + a.rect_cols[b];
    const int c0 = lane * CPT;
    const int rgo = p.rdo + p.rde, fgo = p.rfo + p.rfe;

    int code[CPT], h[CPT], e[CPT];
    unsigned og[CPT];                        // ORIGIN only
    load_codes<CPT>(code, a.refwins + (size_t)b * a.W, a.W, c0, lo, hi, p.n_pen);
    #pragma unroll
    for (int k = 0; k < CPT; ++k) {
        h[k] = 0;                            // free start on row -1
        e[k] = NEG_INF;
        if constexpr (ORIGIN) og[k] = o_pack(-1, -1);
    }
    int hn[CPT];
    const RegCells<CPT> cells{code, e, og, h, hn};
    int best = INT_MIN, best_pos = 0, best_o = 0;
    unsigned words[WPT], wmask[WPT];
    #pragma unroll
    for (int w = 0; w < WPT; ++w) wmask[w] = word_mask(lane * WPT + w, a.W);
    RowChunk cur = load_chunk(pr, 0, lane), next = load_chunk(pr, 32, lane);
    int* out = a.dirs + (size_t)b * a.Wp + lane * WPT;
    const size_t row_stride = (size_t)a.B * a.Wp;

    for (int i = 0; i < len; ++i) {
        if (i > 0 && (i & 31) == 0) {
            cur = next;
            next = load_chunk(pr, i + 32, lane);
        }
        const Row row = make_row(__shfl_sync(FULL, cur.rc, i & 31),
                                 __shfl_sync(FULL, cur.qp, i & 31), true, i,
                                 pr.len, p);
        int hl = __shfl_up_sync(FULL, h[CPT - 1], 1);
        if (lane == 0) hl = NEG_INF;
        int ol = -1;
        if constexpr (ORIGIN) {
            ol = __shfl_up_sync(FULL, o_lo(og[CPT - 1]), 1);
            if (lane == 0) ol = -1;
        }
        unsigned m_e, m_x;
        int cpay;
        const int carry = pass1<CPT, ORIGIN>(cells, m_e, m_x, hl, row, p,
                                             rgo, fgo, ol, c0, cpay);
        // exclusive prefix max over lanes, in the plain version's
        // column-offset form: F(c0) = max(NEG_INF, max fa) - c0 * rde
        int f_in, hnl, pin = -1;
        if constexpr (ORIGIN) {
            const int v = warp_scan_max_pay(carry + (c0 + CPT) * p.rde, cpay);
            int ex = __shfl_up_sync(FULL, v, 1);
            int pex = __shfl_up_sync(FULL, cpay, 1);
            hnl = __shfl_up_sync(FULL, hn[CPT - 1], 1);
            if (lane == 0) {                 // nothing before column 0
                ex = 2 * NEG_INF;
                pex = -1;
                hnl = NEG_INF;
            }
            // the NEG_INF floor stands before every column: it keeps its
            // payload -1 only where no column reaches it
            pin = ex >= NEG_INF ? pex : -1;
            f_in = max(ex, NEG_INF) - c0 * p.rde;
        } else {
            const int v = warp_scan_max(carry + (c0 + CPT) * p.rde);
            int ex = __shfl_up_sync(FULL, v, 1);
            hnl = __shfl_up_sync(FULL, hn[CPT - 1], 1);
            if (lane == 0) {
                ex = NEG_INF;
                hnl = NEG_INF;
            }
            f_in = max(ex, NEG_INF) - c0 * p.rde;
        }
        pass2<CPT, WPT, LOCAL, ORIGIN>(cells, m_e, m_x, f_in, hnl - rgo,
                                       words, row, p, rgo, ol, c0, pin);
        if (LOCAL || i == pr.len - 1)
            track_best<CPT, ORIGIN>(cells, c0, a.W, i, best, best_pos,
                                    best_o);
        #pragma unroll
        for (int w = 0; w < WPT; ++w)
            if (lane * WPT + w < a.Wp)
                out[i * row_stride + w] = (int)(words[w] & wmask[w]);
    }
    const long long mine = best_key(best, best_pos);
    const long long key = warp_max_key(mine);
    if (lane == 0) write_best(key, b, a.score, a.row, a.lane);
    if constexpr (ORIGIN) {
        // best positions differ between lanes: one lane holds the key
        if (key == LLONG_MIN ? lane == 0 : mine == key)
            a.origin[b] = key == LLONG_MIN ? 0 : best_o;
    }
}

// One block per problem for wide windows (Wp > 64): warp totals of the F
// scan, the last H_noF and the last H of each warp pass through shared
// memory, with two barriers a row.
template <int WPT, bool LOCAL>
__global__ void __launch_bounds__(1024)
sw_block_kernel(Args a, SwParams p) {
    constexpr int CPT = 8 * WPT;
    extern __shared__ long long smem[];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int nwarps = blockDim.x >> 5;
    long long* s_best = smem;                // warp best keys
    int* s_wtot = reinterpret_cast<int*>(s_best + nwarps);  // F-carry totals
    int* s_hnof = s_wtot + nwarps;           // lane 31's last H_noF
    int* s_hlast = s_hnof + nwarps;          // lane 31's last H (prev row)

    const int b = blockIdx.x;
    if (b >= live_lanes<false>(a)) return;   // the whole block leaves
    const Problem pr{a.reads + (size_t)b * a.Lmax, a.mmpen + (size_t)b * a.Lmax,
                     a.lens[b], a.Lmax};
    const int len = min(pr.len, a.Lmax);
    const int lo = a.col_lo ? a.col_lo[b] : 0;
    const int hi = lo + a.rect_cols[b];
    const int c0 = t * CPT;
    const int rgo = p.rdo + p.rde, fgo = p.rfo + p.rfe;

    int code[CPT], h[CPT], e[CPT], hn[CPT];
    unsigned og[CPT];                        // unused (no origins)
    load_codes<CPT>(code, a.refwins + (size_t)b * a.W, a.W, c0, lo, hi, p.n_pen);
    #pragma unroll
    for (int k = 0; k < CPT; ++k) {
        h[k] = 0;
        e[k] = NEG_INF;
    }
    const RegCells<CPT> cells{code, e, og, h, hn};
    int best = INT_MIN, best_pos = 0, best_o = 0;
    unsigned words[WPT], wmask[WPT];
    #pragma unroll
    for (int w = 0; w < WPT; ++w) wmask[w] = word_mask(t * WPT + w, a.W);
    RowChunk cur = load_chunk(pr, 0, lane), next = load_chunk(pr, 32, lane);
    int* out = a.dirs + (size_t)b * a.Wp + t * WPT;
    const size_t row_stride = (size_t)a.B * a.Wp;
    if (lane == 31) s_hlast[warp] = 0;

    for (int i = 0; i < len; ++i) {
        if (i > 0 && (i & 31) == 0) {
            cur = next;
            next = load_chunk(pr, i + 32, lane);
        }
        const Row row = make_row(__shfl_sync(FULL, cur.rc, i & 31),
                                 __shfl_sync(FULL, cur.qp, i & 31), true, i,
                                 pr.len, p);
        __syncthreads();                     // s_hlast of row i-1 written
        int hl = __shfl_up_sync(FULL, h[CPT - 1], 1);
        if (lane == 0) hl = warp == 0 ? NEG_INF : s_hlast[warp - 1];
        unsigned m_e, m_x;
        int cpay;
        const int carry = pass1<CPT, false>(cells, m_e, m_x, hl, row, p, rgo,
                                            fgo, -1, c0, cpay);
        const int v = warp_scan_max(carry + (c0 + CPT) * p.rde);
        int ex = __shfl_up_sync(FULL, v, 1);
        int hnl = __shfl_up_sync(FULL, hn[CPT - 1], 1);
        if (lane == 31) {
            s_wtot[warp] = v;
            s_hnof[warp] = hn[CPT - 1];
        }
        __syncthreads();
        if (lane == 0) {
            ex = NEG_INF;
            hnl = warp == 0 ? NEG_INF : s_hnof[warp - 1];
        }
        for (int w2 = 0; w2 < warp; ++w2) ex = max(ex, s_wtot[w2]);
        const int f_in = max(ex, NEG_INF) - c0 * p.rde;
        pass2<CPT, WPT, LOCAL, false>(cells, m_e, m_x, f_in, hnl - rgo, words,
                                      row, p, rgo, -1, c0, -1);
        if (LOCAL || i == pr.len - 1)
            track_best<CPT, false>(cells, c0, a.W, i, best, best_pos, best_o);
        if (lane == 31) s_hlast[warp] = h[CPT - 1];
        #pragma unroll
        for (int w = 0; w < WPT; ++w)
            if (t * WPT + w < a.Wp)
                out[i * row_stride + w] = (int)(words[w] & wmask[w]);
    }
    const long long key = warp_max_key(best_key(best, best_pos));
    if (lane == 0) s_best[warp] = key;
    __syncthreads();
    if (t == 0) {
        long long k = s_best[0];
        for (int w2 = 1; w2 < nwarps; ++w2) k = s_best[w2] > k ? s_best[w2] : k;
        write_best(k, b, a.score, a.row, a.lane);
    }
}

// The shared memory of block_origin, in ints: per warp its best
// key (two), F-carry total and payload, last H_noF, best origin, and per
// part and warp its last H and o; the links into the second part (BOUND);
// each thread's best cell; past 512 threads also every cell's E, o/oe and
// H (with H_noF) and, as bytes, its window code, cell k of thread t at
// k * S + t (8 cells a thread and part).
constexpr int BOUND = 8;
constexpr int REG_CELLS_MAX = 512;          // threads with cells in registers

__host__ __device__ constexpr size_t origin_smem(int nwarps, int parts,
                                                 int S) {
    const size_t cells = S <= REG_CELLS_MAX ? 0 : (size_t)S * 8 * parts;
    return sizeof(int) * ((size_t)nwarps * (2 + 4 + 2 * 2) + BOUND
                          + (size_t)S * 3 + cells * 3)
        + cells;
}

// One block per problem for wide windows with ORIGIN (Wp > 64; see the
// header): one word (8 cells) a thread, in registers up to 512 threads and
// in shared memory past them. A window past 1024 words runs each row in
// two parts, the second part's words after the first's: the second
// part's first thread takes from the first part's last column what a
// warp's first lane takes from the warp before it (H and o on the row
// before, H_noF on this row), and its F scan starts from the first part's
// F total, the earliest term.
template <int S, bool LOCAL>
__device__ __forceinline__ void block_origin(const Args& a,
                                             const SwParams& p) {
    constexpr int CPT = 8;
    constexpr bool REG = S <= REG_CELLS_MAX;    // one part, cells in registers
    constexpr int CS = REG ? 0 : S;             // the cells' shared stride
    enum { B_H, B_O, B_HN, B_F, B_FP };     // BOUND slots
    extern __shared__ long long smem[];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int nthr = blockDim.x, nwarps = nthr >> 5;
    const int parts = (a.Wp + nthr - 1) / nthr;
    long long* s_best = smem;                // warp best keys
    int* s_wtot = reinterpret_cast<int*>(s_best + nwarps);  // F-carry totals
    int* s_wpay = s_wtot + nwarps;           // their payloads
    int* s_hnof = s_wpay + nwarps;           // lane 31's last H_noF
    int* s_borg = s_hnof + nwarps;           // warp best origins
    int* s_hlast = s_borg + nwarps;          // per part: lane 31's last H
    int* s_olast = s_hlast + 2 * nwarps;     // per part: lane 31's last o
    int* s_bound = s_olast + 2 * nwarps;
    int* s_tbest = s_bound + BOUND;          // best, position, origin
    int* s_e = s_tbest + 3 * S;
    unsigned* s_og = reinterpret_cast<unsigned*>(s_e + 8 * parts * CS);
    int* s_hh = reinterpret_cast<int*>(s_og + 8 * parts * CS);
    signed char* s_code = reinterpret_cast<signed char*>(s_hh + 8 * parts * CS);
    int r_code[CPT], r_e[CPT], r_h[CPT], r_hn[CPT];   // REG only
    unsigned r_og[CPT];

    const int b = blockIdx.x;
    if (b >= live_lanes<true>(a)) return;    // the whole block leaves
    const int* reads = a.reads + (size_t)b * a.Lmax;
    const int* mmpen = a.mmpen + (size_t)b * a.Lmax;
    const int len0 = a.lens[b];
    const int len = min(len0, a.Lmax);
    const int rgo = p.rdo + p.rde, fgo = p.rfo + p.rfe;
    {
        const int lo = a.col_lo ? a.col_lo[b] : 0;
        const int hi = lo + a.rect_cols[b];
        const int* win = a.refwins + (size_t)b * a.W;
        if constexpr (REG) {
            load_codes<CPT>(r_code, win, a.W, t * CPT, lo, hi, p.n_pen);
            #pragma unroll
            for (int k = 0; k < CPT; ++k) {
                r_e[k] = NEG_INF;
                r_og[k] = o_pack(-1, -1);
                r_h[k] = 0;                  // free start on row -1
            }
        } else {
            for (int k = 0; k < 8 * parts; ++k) {
                const int col = ((k >> 3) * nthr + t) * CPT + (k & 7);
                s_code[k * S + t] = (signed char)win_code(win, a.W, col, lo,
                                                          hi);
                s_e[k * S + t] = NEG_INF;
                s_og[k * S + t] = o_pack(-1, -1);
                s_hh[k * S + t] = 0;         // free start on row -1
            }
        }
        s_tbest[t] = INT_MIN;
        s_tbest[S + t] = 0;
        s_tbest[2 * S + t] = 0;
        if (lane == 31)
            for (int q = 0; q < parts; ++q) {
                s_hlast[q * nwarps + warp] = 0;
                s_olast[q * nwarps + warp] = -1;
            }
    }
    unsigned words[1];

    for (int i = 0; i < len; ++i) {
        // the row's code and penalty: one address for every thread
        const Row row = make_row(__ldg(reads + i), __ldg(mmpen + i), true, i,
                                 len0, p);
        #pragma unroll 1
        for (int q = 0; q < parts; ++q) {
            const int vt = q * nthr + t;     // the thread's word
            const int c0 = vt * CPT;
            const auto cells = [&] {
                if constexpr (REG)
                    return RegCells<CPT>{r_code, r_e, r_og, r_h, r_hn};
                else
                    return SmemCells<S>{s_code + 8 * q * S + t,
                                        s_e + 8 * q * S + t,
                                        s_og + 8 * q * S + t,
                                        s_hh + 8 * q * S + t, p.n_pen};
            }();
            __syncthreads();                 // the links of the last part
            int hl = __shfl_up_sync(FULL, cells.h(CPT - 1), 1);
            int ol = __shfl_up_sync(FULL, o_lo(cells.og(CPT - 1)), 1);
            if (lane == 0) {
                hl = warp > 0 ? s_hlast[q * nwarps + warp - 1]
                              : (q == 0 ? NEG_INF : s_bound[B_H]);
                ol = warp > 0 ? s_olast[q * nwarps + warp - 1]
                              : (q == 0 ? -1 : s_bound[B_O]);
            }
            unsigned m_e, m_x;
            int cpay;
            const int carry = pass1<CPT, true>(cells, m_e, m_x, hl, row, p,
                                               rgo, fgo, ol, c0, cpay);
            const int v = warp_scan_max_pay(carry + (c0 + CPT) * p.rde, cpay);
            int ex = __shfl_up_sync(FULL, v, 1);
            int pex = __shfl_up_sync(FULL, cpay, 1);
            const int hn_last = cells.hn(CPT - 1);
            int hnl = __shfl_up_sync(FULL, hn_last, 1);
            if (lane == 31) {
                s_wtot[warp] = v;
                s_wpay[warp] = cpay;
                s_hnof[warp] = hn_last;
            }
            __syncthreads();
            if (lane == 0) {
                ex = 2 * NEG_INF;
                pex = -1;
                hnl = warp > 0 ? s_hnof[warp - 1]
                               : (q == 0 ? NEG_INF : s_bound[B_HN]);
            }
            // the earlier part's total first, then earlier warps (a later
            // one keeps ties), then the lanes before this one in its warp
            int wv = q == 0 ? 2 * NEG_INF : s_bound[B_F];
            int wp = q == 0 ? -1 : s_bound[B_FP];
            for (int w2 = 0; w2 < warp; ++w2) {
                bool ge;
                wv = __vibmax_s32(s_wtot[w2], wv, &ge);
                wp = ge ? s_wpay[w2] : wp;
            }
            bool ge;
            ex = __vibmax_s32(ex, wv, &ge);
            pex = ge ? pex : wp;
            const int pin = ex >= NEG_INF ? pex : -1;
            const int f_in = max(ex, NEG_INF) - c0 * p.rde;
            pass2<CPT, 1, LOCAL, true>(cells, m_e, m_x, f_in, hnl - rgo, words,
                                       row, p, rgo, ol, c0, pin);
            if (LOCAL || i == len0 - 1) {
                int best = s_tbest[t], best_pos = s_tbest[S + t];
                int best_o = s_tbest[2 * S + t];
                track_best<CPT, true>(cells, c0, a.W, i, best, best_pos,
                                      best_o);
                s_tbest[t] = best;
                s_tbest[S + t] = best_pos;
                s_tbest[2 * S + t] = best_o;
            }
            if (lane == 31) {
                if (q == 0 && warp == nwarps - 1 && parts > 1) {
                    // the links into the second part: H and o of this
                    // column on the row before (not yet overwritten), its
                    // H_noF, and the first part's F total, this lane's
                    // inclusive scan over every earlier warp's
                    bool own;
                    s_bound[B_H] = s_hlast[warp];
                    s_bound[B_O] = s_olast[warp];
                    s_bound[B_HN] = hn_last;
                    s_bound[B_F] = __vibmax_s32(v, wv, &own);
                    s_bound[B_FP] = own ? cpay : wp;
                }
                s_hlast[q * nwarps + warp] = cells.h(CPT - 1);
                s_olast[q * nwarps + warp] = o_lo(cells.og(CPT - 1));
            }
            if (vt < a.Wp)
                a.dirs[((size_t)i * a.B + b) * a.Wp + vt] =
                    (int)(words[0] & word_mask(vt, a.W));
        }
    }
    const int best = s_tbest[t], best_pos = s_tbest[S + t];
    const long long mine = best_key(best, best_pos);
    const long long key = warp_max_key(mine);
    if (lane == 0) s_best[warp] = key;
    if (key == LLONG_MIN ? lane == 0 : mine == key)
        s_borg[warp] = key == LLONG_MIN ? 0 : s_tbest[2 * S + t];
    __syncthreads();
    if (t == 0) {
        long long k = s_best[0];
        int kw = 0;
        for (int w2 = 1; w2 < nwarps; ++w2)
            if (s_best[w2] > k) {
                k = s_best[w2];
                kw = w2;
            }
        write_best(k, b, a.score, a.row, a.lane);
        a.origin[b] = s_borg[kw];
    }
}

// up to 512 threads: the cells in registers, at most 128 a thread
template <int S, bool LOCAL>
__global__ void __launch_bounds__(S, REG_CELLS_MAX / S)
sw_block_origin_reg_kernel(Args a, SwParams p) {
    block_origin<S, LOCAL>(a, p);
}

// 1024 threads: the cells in shared memory
template <bool LOCAL>
__global__ void __launch_bounds__(1024)
sw_block_origin_kernel(Args a, SwParams p) {
    block_origin<1024, LOCAL>(a, p);
}

template <typename K>
cudaError_t launch_smem(K kern, const Args& a, const SwParams& p, int nthr,
                        size_t smem, cudaStream_t s) {
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kern<<<std::max(a.n_run, 1), nthr, smem, s>>>(a, p);
    return cudaGetLastError();
}

template <int S, bool LOCAL>
cudaError_t launch_block_origin(const Args& a, const SwParams& p, int nthr,
                                cudaStream_t s) {
    const size_t smem = origin_smem(nthr / 32, (a.Wp + nthr - 1) / nthr, S);
    if constexpr (S <= REG_CELLS_MAX)
        return launch_smem(sw_block_origin_reg_kernel<S, LOCAL>, a, p, nthr,
                           smem, s);
    else
        return launch_smem(sw_block_origin_kernel<LOCAL>, a, p, nthr, smem,
                           s);
}

template <bool LOCAL, bool ORIGIN>
cudaError_t launch(const Args& a, const SwParams& p, cudaStream_t s,
                   int* kernel) {
    *kernel = a.Wp <= 64 ? 0 : 1;
    if (a.Wp <= 64) {                        // one warp per problem
        const dim3 grid((std::max(a.n_run, 1) + WARPS - 1) / WARPS);
        const dim3 block(32 * WARPS);
        if (a.Wp <= 32)
            sw_warp_kernel<1, LOCAL, ORIGIN><<<grid, block, 0, s>>>(a, p);
        else
            sw_warp_kernel<2, LOCAL, ORIGIN><<<grid, block, 0, s>>>(a, p);
        return cudaGetLastError();
    }
    // one block per problem
    if constexpr (ORIGIN) {
        const int nthr = std::min(1024, (a.Wp + 31) / 32 * 32);
        if (nthr <= 128) return launch_block_origin<128, LOCAL>(a, p, nthr, s);
        if (nthr <= 256) return launch_block_origin<256, LOCAL>(a, p, nthr, s);
        if (nthr <= 512) return launch_block_origin<512, LOCAL>(a, p, nthr, s);
        return launch_block_origin<1024, LOCAL>(a, p, nthr, s);
    }
    const int wpt = a.Wp <= 1024 ? 1 : 2;
    const int nthr = ((a.Wp + wpt - 1) / wpt + 31) / 32 * 32;
    const size_t smem = nthr / 32 * (sizeof(long long) + 3 * sizeof(int));
    return wpt == 1 ? launch_smem(sw_block_kernel<1, LOCAL>, a, p, nthr, smem, s)
                    : launch_smem(sw_block_kernel<2, LOCAL>, a, p, nthr, smem, s);
}

template <bool ORIGIN>
int run(const void* reads, const void* mmpen, const void* lens,
        const void* refwins, const void* rect_cols, const void* col_lo,
        const void* n_live, int B, int n_run, int Lmax, int W, int match_bonus,
        int n_pen, int rdo, int rde, int rfo, int rfe, int gbar, int local,
        void* score, void* row, void* lane, void* dirs, void* origin,
        int* kernel, void* stream) {
    *kernel = -1;
    if (B <= 0) return (int)cudaGetLastError();
    const int Wp = (W + 7) / 8;
    // the best key holds row and column in 16 bits each, and the origins
    // are int16 (W <= 16384); the column codes keep -n_pen apart from the
    // base codes
    if (Wp > 2048 || Lmax > 32767 || n_pen <= -BASE || n_pen >= BASE
        || n_run < 0 || n_run > B)
        return (int)cudaErrorInvalidValue;
    const Args a{(const int*)reads, (const int*)mmpen, (const int*)lens,
                 (const int*)refwins, (const int*)rect_cols,
                 (const int*)col_lo, (const int*)n_live, B, n_run, Lmax, W,
                 Wp, (int*)score, (int*)row, (int*)lane, (int*)dirs,
                 (int*)origin};
    const SwParams p{match_bonus, n_pen, rdo, rde, rfo, rfe, gbar};
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(local ? launch<true, ORIGIN>(a, p, s, kernel)
                       : launch<false, ORIGIN>(a, p, s, kernel));
}

}  // namespace

// B problems; reads/mmpen (B, Lmax), refwins (B, W), lens/rect_cols/col_lo
// (B,) int32 (col_lo may be null: rect columns start at 0); dirs (Lmax, B,
// Wp) int32 with Wp = ceil(W / 8). n_live (a 0-d int32 on the card, or
// null) and n_run: the live problems are the first min(*n_live, n_run), or
// the first n_run without n_live; the grid covers n_run problems. See the
// header for what a dead problem and the rows past a read's end hold.
// *kernel (host memory) gets the kernel launched: 0 one warp a problem,
// 1 one block a problem, -1 none (B = 0).
extern "C" int sw_rect(const void* reads, const void* mmpen, const void* lens,
                       const void* refwins, const void* rect_cols,
                       const void* col_lo, const void* n_live, int B,
                       int n_run, int Lmax, int W, int match_bonus, int n_pen,
                       int rdo, int rde, int rfo, int rfe, int gbar, int local,
                       void* score, void* row, void* lane, void* dirs,
                       int* kernel, void* stream) {
    return run<false>(reads, mmpen, lens, refwins, rect_cols, col_lo, n_live,
                      B, n_run, Lmax, W, match_bonus, n_pen, rdo, rde, rfo,
                      rfe, gbar, local, score, row, lane, dirs, nullptr,
                      kernel, stream);
}

// The same DP with origin tracking: origin (B,) int32 gets the rect column
// of the first reference character of each best path.
extern "C" int sw_rect_origin(const void* reads, const void* mmpen,
                              const void* lens, const void* refwins,
                              const void* rect_cols, const void* col_lo,
                              const void* n_live, int B, int n_run, int Lmax,
                              int W, int match_bonus, int n_pen, int rdo,
                              int rde, int rfo, int rfe, int gbar, int local,
                              void* score, void* row, void* lane, void* dirs,
                              void* origin, int* kernel, void* stream) {
    return run<true>(reads, mmpen, lens, refwins, rect_cols, col_lo, n_live,
                     B, n_run, Lmax, W, match_bonus, n_pen, rdo, rde, rfo,
                     rfe, gbar, local, score, row, lane, dirs, origin, kernel,
                     stream);
}
