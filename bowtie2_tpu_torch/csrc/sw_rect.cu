// Kernel C: rectangle affine-gap DP (read rows x reference-window columns).
//
// Replaces: bowtie2_tpu/ops/sw.py:144 sw_banded, the DP on the main path, a
// lax.scan over read rows of (B, W) vector ops with a Kogge-Stone prefix max
// per row; and its Pallas counterpart bowtie2_tpu/ops/pallas_sw.py:145
// sw_pallas (same recurrence, one problem tile per grid step, H/E carried
// in VMEM). Two C entries: `sw_rect` (track_origin=False) and
// `sw_rect_origin` (track_origin=True, the paired-end path), one template
// flag (ORIGIN) apart; with the flag off the kernels are the same code.
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
// Bound on the card: instruction issue, not bytes. The dirs store is Lmax x
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
//   * a row past the read's end whose (read code, penalty) equal the row
//     before it repeats that row's words: H and E no longer change there;
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
// `_prefix_max_payload_excl`). The scan carries (value, payload) pairs; the
// DPX predicate of __vibmax_s32 gives the `>` test of the payload select.
// Pass 2 recomputes each cell's origin without F from the previous row's
// o/oe rather than keeping it from pass 1, so the variant costs one
// register a cell. The local clamp resets the origin to -1; inactive rows
// keep o and oe, so the repeated rows past a read's end stay valid. The
// best cell's origin rides beside the thread's best key.
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

template <int CPT>
__device__ __forceinline__ void load_codes(int (&code)[CPT],
                                           const int* __restrict__ win, int W,
                                           int c0, int lo, int hi, int n_pen) {
    #pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int col = c0 + k;
        int r = 5;
        if (col < W && col >= lo && col < hi) r = __ldg(win + col);
        code[k] = r >= 5 ? OOB : (r == 4 ? -n_pen : r + BASE);
    }
}

// per-row state shared by the passes
struct Row {
    int rcn, mmv;          // read code as a column code (never matches if
                           // N), and the mismatch score of the row
    bool active, bar;
};

// pass 1: H without F (hn), the E-source and E-extension bit masks, the new
// E (kept only on an active row) and the thread's F carry out of its last
// column, F_out = max_k (hn[k] - rgo - (CPT-1-k) * rde); with ORIGIN also
// the carry's payload (cpay), the origin a gap run from the carry's column
// starts from, later columns winning ties. og holds the previous row's
// origins, ol the origin of the column left of the thread's first.
template <int CPT, bool ORIGIN>
__device__ __forceinline__ int pass1(const int (&code)[CPT], const int (&h)[CPT],
                                     int (&e)[CPT], int (&hn)[CPT],
                                     unsigned& m_e, unsigned& m_x, int hl,
                                     const Row& row, const SwParams& p,
                                     int rgo, int fgo,
                                     const unsigned (&og)[CPT], int ol, int c0,
                                     int& cpay) {
    int carry = 2 * NEG_INF;
    cpay = -1;
    m_e = 0u;
    m_x = 0u;
    #pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int c = code[k];
        int s = c == row.rcn ? p.match_bonus : row.mmv;
        s = c < BASE ? c : s;
        const int hd = (k == 0 ? hl : h[k - 1]) + s;
        bool open_ge, diag_ge;
        int ec = __vibmax_s32(h[k] - fgo, e[k] - p.rfe, &open_ge);
        m_x |= (open_ge ? 0u : 1u) << k;     // e_ext > e_open
        if (c == OOB || row.bar) ec = NEG_INF;
        hn[k] = __vibmax_s32(hd, ec, &diag_ge);
        m_e |= (diag_ge ? 0u : 1u) << k;     // ec > hd
        if (row.active) e[k] = ec;
        if constexpr (ORIGIN) {
            const int op = o_lo(og[k]);
            const int left = k == 0 ? ol : o_lo(og[k - 1]);
            const int od = left < 0 ? c0 + k : left;
            const int oen = open_ge ? op : o_hi(og[k]);
            const int onf = diag_ge ? od : oen;
            bool ge;
            carry = __vibmax_s32(hn[k] - rgo, carry - p.rde, &ge);
            cpay = ge ? (onf < 0 ? c0 + k + 1 : onf) : cpay;
        } else {
            carry = __viaddmax_s32(carry, -p.rde, hn[k] - rgo);
        }
    }
    return carry;
}

// pass 2: F from f_in (F at the thread's first column) and fo0 (F opened
// from the column left of it), then H, the source and the packed words;
// H is kept only on an active row. With ORIGIN, pin is f_in's payload and
// og the origins, updated on an active row.
template <int CPT, int WPT, bool LOCAL, bool ORIGIN>
__device__ __forceinline__ void pass2(const int (&hn)[CPT], unsigned m_e,
                                      unsigned m_x, int f_in, int fo0,
                                      int (&h)[CPT], unsigned (&words)[WPT],
                                      const Row& row, const SwParams& p,
                                      int rgo, unsigned (&og)[CPT], int ol,
                                      int c0, int pin) {
    #pragma unroll
    for (int w = 0; w < WPT; ++w) words[w] = 0u;
    int f = f_in, fo = fo0;
    int pf = pin, prev_op = ol, prev_fix = -1;
    #pragma unroll
    for (int k = 0; k < CPT; ++k) {
        bool f_ext;
        if (k == 0) {
            f_ext = f > fo;
        } else {
            bool open_ge;
            fo = hn[k - 1] - rgo;
            f = __vibmax_s32(fo, f - p.rde, &open_ge);
            f_ext = !open_ge;                // F carried > F opened
            if constexpr (ORIGIN) pf = open_ge ? prev_fix : pf;
        }
        const int fm = row.bar ? NEG_INF : f;
        bool nof_ge;
        int hc = __vibmax_s32(hn[k], fm, &nof_ge);
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
            const int op = o_lo(og[k]);
            const int od = prev_op < 0 ? c0 + k : prev_op;
            const int oen = ((m_x >> k) & 1u) ? o_hi(og[k]) : op;
            const int onf = ((m_e >> k) & 1u) ? oen : od;
            const int oc = clamp ? -1 : (nof_ge ? onf : pf);
            prev_op = op;
            prev_fix = onf < 0 ? c0 + k + 1 : onf;
            if (row.active) og[k] = o_pack(oc, oen);
        }
        const unsigned d = (unsigned)src | (((m_x >> k) & 1u) << 2)
                           | (f_ext ? 8u : 0u);
        words[k >> 3] |= d << (4 * (k & 7));
        if (row.active) h[k] = hc;
    }
}

// the thread's best cell on a counting row (every column < W), rightmost
// column on ties; later rows win ties against earlier ones; with ORIGIN
// the cell's origin goes to best_o
template <int CPT, bool ORIGIN>
__device__ __forceinline__ void track_best(const int (&h)[CPT], int c0, int W,
                                           int i, int& best, int& best_pos,
                                           const unsigned (&og)[CPT],
                                           int& best_o) {
    int m = INT_MIN, mk = 0, mo = 0;
    #pragma unroll
    for (int k = 0; k < CPT; ++k)
        if (c0 + k < W && h[k] >= m) {
            m = h[k];
            mk = k;
            if constexpr (ORIGIN) mo = o_lo(og[k]);
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
    int B, Lmax, W, Wp;
    int* score;
    int* row;
    int* lane;
    int* dirs;
    int* origin;           // (B,) with ORIGIN, else null
};

// One warp per problem (Wp <= 32 * WPT); warps never wait for each other.
template <int WPT, bool LOCAL, bool ORIGIN>
__global__ void __launch_bounds__(128)
sw_warp_kernel(Args a, SwParams p) {
    constexpr int CPT = 8 * WPT;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (b >= a.B) return;                    // the whole warp leaves
    const Problem pr{a.reads + (size_t)b * a.Lmax, a.mmpen + (size_t)b * a.Lmax,
                     a.lens[b], a.Lmax};
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
    int best = INT_MIN, best_pos = 0, best_o = 0;
    unsigned words[WPT], wmask[WPT];
    #pragma unroll
    for (int w = 0; w < WPT; ++w) wmask[w] = word_mask(lane * WPT + w, a.W);
    int prev_rcn = 0, prev_mmv = 0;
    RowChunk cur = load_chunk(pr, 0, lane), next = load_chunk(pr, 32, lane);
    int* out = a.dirs + (size_t)b * a.Wp + lane * WPT;
    const size_t row_stride = (size_t)a.B * a.Wp;

    for (int i = 0; i < a.Lmax; ++i) {
        if (i > 0 && (i & 31) == 0) {
            cur = next;
            next = load_chunk(pr, i + 32, lane);
        }
        const int rc = __shfl_sync(FULL, cur.rc, i & 31);
        const int qp = __shfl_sync(FULL, cur.qp, i & 31);
        Row row;
        row.rcn = rc >= 4 ? -1 : rc + BASE;
        row.mmv = rc >= 4 ? -p.n_pen : -qp;
        if (!(i > 0 && i > pr.len && row.rcn == prev_rcn
              && row.mmv == prev_mmv)) {
            row.active = i < pr.len;
            row.bar = p.gbar > 0 && (i < p.gbar || i >= pr.len - p.gbar);
            int hl = __shfl_up_sync(FULL, h[CPT - 1], 1);
            if (lane == 0) hl = NEG_INF;
            int ol = -1;
            if constexpr (ORIGIN) {
                ol = __shfl_up_sync(FULL, o_lo(og[CPT - 1]), 1);
                if (lane == 0) ol = -1;
            }
            int hn[CPT];
            unsigned m_e, m_x;
            int cpay;
            const int carry = pass1<CPT, ORIGIN>(code, h, e, hn, m_e, m_x, hl,
                                                 row, p, rgo, fgo, og, ol, c0,
                                                 cpay);
            // exclusive prefix max over lanes, in the plain version's
            // column-offset form: F(c0) = max(NEG_INF, max fa) - c0 * rde
            int f_in, hnl, pin = -1;
            if constexpr (ORIGIN) {
                const int v = warp_scan_max_pay(carry + (c0 + CPT) * p.rde,
                                                cpay);
                int ex = __shfl_up_sync(FULL, v, 1);
                int pex = __shfl_up_sync(FULL, cpay, 1);
                hnl = __shfl_up_sync(FULL, hn[CPT - 1], 1);
                if (lane == 0) {             // nothing before column 0
                    ex = 2 * NEG_INF;
                    pex = -1;
                    hnl = NEG_INF;
                }
                // the NEG_INF floor stands before every column: it keeps
                // its payload -1 only where no column reaches it
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
            pass2<CPT, WPT, LOCAL, ORIGIN>(hn, m_e, m_x, f_in, hnl - rgo, h,
                                           words, row, p, rgo, og, ol, c0,
                                           pin);
            if (LOCAL ? row.active : i == pr.len - 1)
                track_best<CPT, ORIGIN>(h, c0, a.W, i, best, best_pos, og,
                                        best_o);
            prev_rcn = row.rcn;
            prev_mmv = row.mmv;
        }
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
// memory, with two barriers a row; with ORIGIN also the scan totals'
// payloads and the last origin of each warp.
template <int WPT, bool LOCAL, bool ORIGIN>
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
    int* s_wpay = s_hlast + nwarps;          // ORIGIN: F-carry payloads
    int* s_olast = s_wpay + nwarps;          // ORIGIN: lane 31's last o
    int* s_borg = s_olast + nwarps;          // ORIGIN: warp best origins

    const int b = blockIdx.x;
    const Problem pr{a.reads + (size_t)b * a.Lmax, a.mmpen + (size_t)b * a.Lmax,
                     a.lens[b], a.Lmax};
    const int lo = a.col_lo ? a.col_lo[b] : 0;
    const int hi = lo + a.rect_cols[b];
    const int c0 = t * CPT;
    const int rgo = p.rdo + p.rde, fgo = p.rfo + p.rfe;

    int code[CPT], h[CPT], e[CPT];
    unsigned og[CPT];                        // ORIGIN only
    load_codes<CPT>(code, a.refwins + (size_t)b * a.W, a.W, c0, lo, hi, p.n_pen);
    #pragma unroll
    for (int k = 0; k < CPT; ++k) {
        h[k] = 0;
        e[k] = NEG_INF;
        if constexpr (ORIGIN) og[k] = o_pack(-1, -1);
    }
    int best = INT_MIN, best_pos = 0, best_o = 0;
    unsigned words[WPT], wmask[WPT];
    #pragma unroll
    for (int w = 0; w < WPT; ++w) wmask[w] = word_mask(t * WPT + w, a.W);
    int prev_rcn = 0, prev_mmv = 0;
    RowChunk cur = load_chunk(pr, 0, lane), next = load_chunk(pr, 32, lane);
    int* out = a.dirs + (size_t)b * a.Wp + t * WPT;
    const size_t row_stride = (size_t)a.B * a.Wp;
    if (lane == 31) {
        s_hlast[warp] = 0;
        if constexpr (ORIGIN) s_olast[warp] = -1;
    }

    for (int i = 0; i < a.Lmax; ++i) {
        if (i > 0 && (i & 31) == 0) {
            cur = next;
            next = load_chunk(pr, i + 32, lane);
        }
        const int rc = __shfl_sync(FULL, cur.rc, i & 31);
        const int qp = __shfl_sync(FULL, cur.qp, i & 31);
        Row row;
        row.rcn = rc >= 4 ? -1 : rc + BASE;
        row.mmv = rc >= 4 ? -p.n_pen : -qp;
        // the same for every thread of the block: all skip or none
        if (!(i > 0 && i > pr.len && row.rcn == prev_rcn
              && row.mmv == prev_mmv)) {
            row.active = i < pr.len;
            row.bar = p.gbar > 0 && (i < p.gbar || i >= pr.len - p.gbar);
            __syncthreads();                 // s_hlast of row i-1 written
            int hl = __shfl_up_sync(FULL, h[CPT - 1], 1);
            if (lane == 0) hl = warp == 0 ? NEG_INF : s_hlast[warp - 1];
            int ol = -1;
            if constexpr (ORIGIN) {
                ol = __shfl_up_sync(FULL, o_lo(og[CPT - 1]), 1);
                if (lane == 0) ol = warp == 0 ? -1 : s_olast[warp - 1];
            }
            int hn[CPT];
            unsigned m_e, m_x;
            int cpay;
            const int carry = pass1<CPT, ORIGIN>(code, h, e, hn, m_e, m_x, hl,
                                                 row, p, rgo, fgo, og, ol, c0,
                                                 cpay);
            int v, pex = -1;
            if constexpr (ORIGIN)
                v = warp_scan_max_pay(carry + (c0 + CPT) * p.rde, cpay);
            else
                v = warp_scan_max(carry + (c0 + CPT) * p.rde);
            int ex = __shfl_up_sync(FULL, v, 1);
            int hnl = __shfl_up_sync(FULL, hn[CPT - 1], 1);
            if constexpr (ORIGIN) pex = __shfl_up_sync(FULL, cpay, 1);
            if (lane == 31) {
                s_wtot[warp] = v;
                s_hnof[warp] = hn[CPT - 1];
                if constexpr (ORIGIN) s_wpay[warp] = cpay;
            }
            __syncthreads();
            if (lane == 0) {
                ex = ORIGIN ? 2 * NEG_INF : NEG_INF;
                pex = -1;
                hnl = warp == 0 ? NEG_INF : s_hnof[warp - 1];
            }
            int f_in, pin = -1;
            if constexpr (ORIGIN) {
                // earlier warps first (a later warp keeps ties), then the
                // lanes before this one in its own warp, which are later
                int wv = 2 * NEG_INF, wp = -1;
                for (int w2 = 0; w2 < warp; ++w2) {
                    bool ge;
                    wv = __vibmax_s32(s_wtot[w2], wv, &ge);
                    wp = ge ? s_wpay[w2] : wp;
                }
                bool ge;
                ex = __vibmax_s32(ex, wv, &ge);
                pex = ge ? pex : wp;
                pin = ex >= NEG_INF ? pex : -1;
            } else {
                for (int w2 = 0; w2 < warp; ++w2) ex = max(ex, s_wtot[w2]);
            }
            f_in = max(ex, NEG_INF) - c0 * p.rde;
            pass2<CPT, WPT, LOCAL, ORIGIN>(hn, m_e, m_x, f_in, hnl - rgo, h,
                                           words, row, p, rgo, og, ol, c0,
                                           pin);
            if (LOCAL ? row.active : i == pr.len - 1)
                track_best<CPT, ORIGIN>(h, c0, a.W, i, best, best_pos, og,
                                        best_o);
            if (lane == 31) {
                s_hlast[warp] = h[CPT - 1];
                if constexpr (ORIGIN) s_olast[warp] = o_lo(og[CPT - 1]);
            }
            prev_rcn = row.rcn;
            prev_mmv = row.mmv;
        }
        #pragma unroll
        for (int w = 0; w < WPT; ++w)
            if (t * WPT + w < a.Wp)
                out[i * row_stride + w] = (int)(words[w] & wmask[w]);
    }
    const long long mine = best_key(best, best_pos);
    const long long key = warp_max_key(mine);
    if (lane == 0) s_best[warp] = key;
    if constexpr (ORIGIN) {
        if (key == LLONG_MIN ? lane == 0 : mine == key)
            s_borg[warp] = key == LLONG_MIN ? 0 : best_o;
    }
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
        if constexpr (ORIGIN) a.origin[b] = s_borg[kw];
    }
}

template <bool LOCAL, bool ORIGIN>
cudaError_t launch(const Args& a, const SwParams& p, cudaStream_t s,
                   int* kernel) {
    *kernel = a.Wp <= 64 ? 0 : 1;
    if (a.Wp <= 64) {                        // one warp per problem
        const int per_block = 4;
        const dim3 grid((a.B + per_block - 1) / per_block);
        if (a.Wp <= 32)
            sw_warp_kernel<1, LOCAL, ORIGIN><<<grid, 32 * per_block, 0, s>>>(a, p);
        else
            sw_warp_kernel<2, LOCAL, ORIGIN><<<grid, 32 * per_block, 0, s>>>(a, p);
    } else {                                 // one block per problem
        const int wpt = a.Wp <= 1024 ? 1 : 2;
        const int nthr = ((a.Wp + wpt - 1) / wpt + 31) / 32 * 32;
        const int nwarps = nthr / 32;
        const size_t smem = nwarps * (sizeof(long long)
                                      + (ORIGIN ? 6 : 3) * sizeof(int));
        if (wpt == 1)
            sw_block_kernel<1, LOCAL, ORIGIN><<<a.B, nthr, smem, s>>>(a, p);
        else
            sw_block_kernel<2, LOCAL, ORIGIN><<<a.B, nthr, smem, s>>>(a, p);
    }
    return cudaGetLastError();
}

template <bool ORIGIN>
int run(const void* reads, const void* mmpen, const void* lens,
        const void* refwins, const void* rect_cols, const void* col_lo, int B,
        int Lmax, int W, int match_bonus, int n_pen, int rdo, int rde, int rfo,
        int rfe, int gbar, int local, void* score, void* row, void* lane,
        void* dirs, void* origin, int* kernel, void* stream) {
    *kernel = -1;
    if (B <= 0) return (int)cudaGetLastError();
    const int Wp = (W + 7) / 8;
    // the best key holds row and column in 16 bits each, and the origins
    // are int16 (W <= 16384); the column codes keep -n_pen apart from the
    // base codes
    if (Wp > 2048 || Lmax > 32767 || n_pen <= -BASE || n_pen >= BASE)
        return (int)cudaErrorInvalidValue;
    const Args a{(const int*)reads, (const int*)mmpen, (const int*)lens,
                 (const int*)refwins, (const int*)rect_cols,
                 (const int*)col_lo, B, Lmax, W, Wp,
                 (int*)score, (int*)row, (int*)lane, (int*)dirs, (int*)origin};
    const SwParams p{match_bonus, n_pen, rdo, rde, rfo, rfe, gbar};
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(local ? launch<true, ORIGIN>(a, p, s, kernel)
                       : launch<false, ORIGIN>(a, p, s, kernel));
}

}  // namespace

// B problems; reads/mmpen (B, Lmax), refwins (B, W), lens/rect_cols/col_lo
// (B,) int32 (col_lo may be null: rect columns start at 0); dirs (Lmax, B,
// Wp) int32 with Wp = ceil(W / 8). *kernel (host memory) gets the kernel
// launched: 0 one warp a problem, 1 one block a problem, -1 none (B = 0).
extern "C" int sw_rect(const void* reads, const void* mmpen, const void* lens,
                       const void* refwins, const void* rect_cols,
                       const void* col_lo, int B, int Lmax, int W,
                       int match_bonus, int n_pen, int rdo, int rde, int rfo,
                       int rfe, int gbar, int local, void* score, void* row,
                       void* lane, void* dirs, int* kernel, void* stream) {
    return run<false>(reads, mmpen, lens, refwins, rect_cols, col_lo, B, Lmax,
                      W, match_bonus, n_pen, rdo, rde, rfo, rfe, gbar, local,
                      score, row, lane, dirs, nullptr, kernel, stream);
}

// The same DP with origin tracking: origin (B,) int32 gets the rect column
// of the first reference character of each best path.
extern "C" int sw_rect_origin(const void* reads, const void* mmpen,
                              const void* lens, const void* refwins,
                              const void* rect_cols, const void* col_lo, int B,
                              int Lmax, int W, int match_bonus, int n_pen,
                              int rdo, int rde, int rfo, int rfe, int gbar,
                              int local, void* score, void* row, void* lane,
                              void* dirs, void* origin, int* kernel,
                              void* stream) {
    return run<true>(reads, mmpen, lens, refwins, rect_cols, col_lo, B, Lmax,
                     W, match_bonus, n_pen, rdo, rde, rfo, rfe, gbar, local,
                     score, row, lane, dirs, origin, kernel, stream);
}
