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
// sw_diag: a skewed wavefront, two problems a warp, one pair a block.
// Bound on the card: the chain of steps of one warp. The bytes (a
// direction byte a cell pair, a code and a penalty a row) and the ~12
// operations a cell are far below the card's rates, and a batch of long
// reads holds a few hundred problems, fewer warps than the card has
// schedulers, so each chain warp runs alone on its scheduler and a step's
// issue and dependency stalls are what count: some 80-100 instructions a
// step in the SASS (two cells and their bookkeeping), about 157 clocks a
// step, i.e. ~314 clocks a row of each problem on an H100 (chip_smoke.py
// phase 12; the earlier design, one warp a problem with a five-level
// shuffle scan for F, ~667). What the design does:
//   * lane k holds band cells 2k and 2k+1 (BW <= 63 <= 64 cells) and
//     computes row i of problem A at step t = 2i + k, of problem B at
//     2i + k + 1. Cell (i, d) needs (i-1, d) and (i-1, d+1) (diagonal, E)
//     and (i, d-1) (F): every input of a step was made the step before,
//     by the lane itself, by lane k-1 (F of cell 2k, row i) or by lane k+1
//     (E of cell 2k+1, from cell 2k+2 of row i-1). Lane k works on A at
//     steps of one parity and on B at the other, so every lane works every
//     step and a warp advances both problems one row every two steps;
//   * F is not scanned: it is carried across lanes, one shuffle a step,
//     as F(i, d) = max(Hn(i, d-1) - rgo, F(i, d-1) - rde) with F(i, 0) =
//     NEG_INF, Hn being H before F, the gap barrier and the local clamp.
//     Unrolled, this is max(NEG_INF - d*rde, max over d' < d of Hn(d') -
//     rgo - (d-d'-1)*rde), term for term the exclusive prefix max of the
//     scan form (lazy-F): the same integers, so the same maxima; the
//     extension bit is F(d-1) - rde > Hn(d-1) - rgo, the strict compare of
//     the same two values the scan form compares (F(d) > Hn(d-1) - rgo),
//     so ties give the same bit; cell 0's bit is NEG_INF > NEG_INF - rgo
//     as there. The barrier masks F only where it meets H, after the bit,
//     as the scan form masks the scanned F. Lane k sends lane k+1 the F of
//     cell 2k+2 as max(Hn(2k+1) - rgo, Hn(2k) - rgo - rde, F(2k) - 2rde),
//     and lane k-1 the E of cell 2k-1 written so that only the received F
//     lies on the chain; what the neighbours need is computed and sent
//     first, and the rest of the step runs in the shuffles' shadow;
//   * the step keeps its flags as integers (0/4/8, the nibble's bits):
//     held as booleans, they outnumber the predicate registers and the
//     compiler parks them in bits of one register, a serial chain of some
//     20 instructions a step; cells past the band are capped at NEG_INF
//     (cap0/cap1) rather than selected; blocks of 32 steps whose rows all
//     lie inside both reads and outside the gap barrier take a body
//     without those tests;
//   * the read codes, penalties and window codes of both problems are
//     staged in shared-memory rings (128 rows, 256 columns) by the warp, a
//     chunk of 16 rows every 32 steps, loaded one chunk ahead into
//     registers; each step loads the next row's codes of its slot (one new
//     window code a row: cell 2k's column is the row before's cell 2k+1's)
//     and makes its substitution scores and E masks off the chain. A
//     lane's direction byte of row i (cell 2k in the low nibble) goes to a
//     64-row ring, and every 32 steps the 16 rows that every lane has
//     passed go out as whole Wp-word rows, the pair's two problems side by
//     side (nibbles past BW are 0);
//   * rows past a read's end hold H and E frozen, so each is a function of
//     the frozen state and its own codes. The loop stops at the pair's
//     longer read (the shorter one's rows up to there ride along, as its
//     lanes would otherwise idle); the rows from there to Lmax are
//     computed after it by both warps of the block, a row a thread, 32
//     rows of each problem at a time: their codes staged in shared memory,
//     the frozen H and E of each cell held as one int2, all 64 cells
//     without a branch, F carried cell by cell. The tail is a separate
//     (not inlined) function, so its registers stay out of the chain's;
//   * the best cell: end to end it is row len-1's maximum, rightmost band
//     column on ties, and H froze at that row, so it is read from the held
//     H after the loop and the warp reduces once. In local mode the
//     reference takes, over active rows in order, the row maximum whenever
//     it is >= the best so far (rightmost column within a row). Let M be
//     the largest H over active cells. Every row holding M is taken (the
//     best so far never exceeds M) and no later row without M is (its
//     maximum is below the best, which is M from the first M-row on), so
//     the result is M at the last active row that holds M, in its
//     rightmost column holding M: the lexicographic maximum of (H, row,
//     column) over active cells. Each lane keeps its own running (H, row
//     << 6 | column) with >= (its rows, and within a row its two columns,
//     come in increasing order; a cell past the band is NEG_INF, below
//     every cell in it) and the warp reduces once at the end. diag_cases'
//     tie cases (tandem repeats, tied F runs) hold it.
//
// bt_diag: one warp a walk, speculating a run across the lanes. Bound on
// the card: an iteration's chain (the run's shared loads, the ballot,
// every lane's op byte stored to its own row of the (S, Bc) layout) and
// the stage copies, about 1,200 clocks an iteration of 32 steps, ~39
// clocks a step on an H100 (chip_smoke.py phase 12). The long reads'
// walks are almost all M runs thousands of steps long (a substitution is
// still an H_DIAG source), which the earlier design took one step at a time,
// all 32 lanes on the same step, ~385 clocks a step. Here, in mode 0 lane
// j reads the cell j steps ahead along the diagonal (i - j, d) and tests
// H_DIAG; in an I run (mode 1) (i - j, d + j) and bit 2; in a D run (mode
// 2) (i, d - j) and bit 3. A ballot finds the first lane whose step breaks
// the run, leaves the band, reaches row -1 or step S; the lanes before it
// commit their steps at once (each stores its op byte and adds its score,
// mismatch, N and refmin terms to its own partials, reduced once at the
// end), and the breaking step runs as the single step of the earlier design
// (K9's field arithmetic). A walk takes about 32 steps an iteration, so it
// crosses rows 32 at a time: the rows' direction words, read codes and
// penalties, and the window codes of their band, sit in a ring of four
// 256-row stages (48 KB a walk, dynamic shared memory) filled by 4-byte
// cp.async three stages ahead of the walk; a stage's buffer is refilled
// once the walk has left its rows, and the walk waits only for the stage
// holding the lowest row its 32-lane window can reach. The words of row r
// lie at [w][(r + 4w) mod 1024], so the 32 rows of a run's window, and
// the 4 rows x 8 words of one copy instruction, fall in 32 banks. After
// the walk is done, every step emits OP_NONE over the window code at the
// frozen cell, written by all lanes.
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

// ---------------------------------------------------------------------------
// the band DP
// ---------------------------------------------------------------------------

constexpr int DW = 2;          // warps a block: the pair's chain, a helper
constexpr int RROWS = 128;     // ring of staged rows (code, penalty)
constexpr int RCOLS = 256;     // ring of staged window columns
constexpr int DROWS = 64;      // ring of direction bytes
constexpr int STEPS = 32;      // steps a block of the loop (16 rows each)
constexpr int CHUNK = 16;      // rows (and columns) staged a block
constexpr int TROWS = 16 * DW;  // rows of a tail group, each problem

struct __align__(16) DiagSmem {
    int2 rinfo[RROWS][2];      // row r & 127, problem: (code key, mismatch)
    int ccode[RCOLS][2];       // column c & 255, problem: column code
    unsigned char dring[DROWS][2][32];   // row & 63, problem, lane: byte
    int2 ff[64][2];            // cell d's frozen H, and E from cell d + 1
                               // (before its mask) * 2 + its extension bit
    int tw[TROWS + 64][2];     // a tail group's column codes (from row r0)
    int2 tr[TROWS][2];         // and its rows' (code key, mismatch score)
};

// the penalties and the band as the chain uses them
struct Pen {
    int mb, n_pen, rgo, rde, fgo, rfe, gbar, BW;
};

// one problem's state in one lane: its two band cells, and the next row's
// substitution scores and E masks (made from codes loaded a step ahead)
struct Slot {
    int len;                   // the read's length
    int lenc;                  // rows it updates: len within [0, Lchain]
    unsigned bspan;            // rows i with (unsigned)(i - gbar) < bspan
                               // have no gap barrier
    int h0, h1, e0, e1;        // H and E after the last active row
    int best, best_pos;        // local: the lane's best cell so far
    int s0, s1;                // next row: substitution scores
    int ob0, ob1;              // next row: 1 where the column is OOB
    int w1;                    // next row: cell 2k+1's column code
    const int2* rp;            // this problem's column of the rings
    const int* cp;
    unsigned char* dp;         // this lane's byte of this problem's rows
};

// what a lane keeps for the whole loop
struct Lane {
    int k, d0;
    int cap0, cap1;            // H of a cell past the band is NEG_INF
    int ccap0, ccap1;          // and its column code OOB (below all others)
    unsigned bmask;            // the byte's nibbles inside the band
    int f0x;                   // the extension bit of cell 0's F
};

// x through an asm the compiler cannot re-run or fold: a value made once
// before the loop stays in its register instead of being re-derived (or
// re-read from the constant bank) every step
__device__ __forceinline__ int opaque(int x) {
    int y;
    asm volatile("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
    return y;
}

__device__ __forceinline__ void stage_row(DiagSmem& sm, int r, int p, int rc,
                                          int qp, int n_pen) {
    sm.rinfo[r & (RROWS - 1)][p] = make_int2(rc >= 4 ? -1 : rc + BASE,
                                             rc >= 4 ? -n_pen : -qp);
}

// the next row's scores and masks of slot s from its codes: c0 is the
// column code of cell 2k (the row before's cell 2k+1), wn cell 2k+1's
__device__ __forceinline__ void next_codes(const Pen& q, const Lane& L,
                                           Slot& s, int2 ri, int c0raw,
                                           int wn) {
    const int c0 = min(c0raw, L.ccap0);
    const int c1 = min(wn, L.ccap1);
    const int t0 = c0 == ri.x ? q.mb : ri.y;
    const int t1 = c1 == ri.x ? q.mb : ri.y;
    s.s0 = c0 < BASE ? c0 : t0;
    s.s1 = c1 < BASE ? c1 : t1;
    s.ob0 = c0 == OOB;
    s.ob1 = c1 == OOB;
    s.w1 = wn;
}

// One step of lane k on row i of its problem in slot s. fv/fb come in as
// F of cell 2k and its extension bit from lane k-1's last step (lane 0
// takes NEG_INF and the bit the scan form gives cell 0, f0x), ev/eb as E
// of cell 2k+1 before its mask and its bit from lane k+1's; they go out
// as this lane's values for its neighbours' next step. What the
// neighbours need is computed and sent first; the rest of the step (the
// direction byte, the best cell, the state, the next row's codes) runs
// while the shuffles are in flight. Flags are kept as integers (0/4/8 for
// the nibble's bits): a step holds more of them than the card has
// predicate registers.
template <bool LOCAL, bool FAST>
__device__ __forceinline__ void chain_step(const Pen& q, const Lane& L,
                                           Slot& s, int i, int& fv, int& fb,
                                           int& ev, int& eb) {
    constexpr int FLOOR = LOCAL ? 0 : NEG_INF;
    // FAST: every row of the block is active and outside the gap barrier
    const bool active = FAST || (unsigned)i < (unsigned)s.lenc;
    const bool bar = !FAST && (unsigned)(i - q.gbar) >= s.bspan;
    const int f0 = L.k ? fv : NEG_INF;
    const int fx0 = L.k ? fb : L.f0x;
    const int x1 = eb;

    // cell 2k: E from this lane's cell 2k+1 of the previous row
    const int eo0 = s.h1 - q.fgo, ee0 = s.e1 - q.rfe;
    const int ec0 = (bar || s.ob0) ? NEG_INF : max(eo0, ee0);
    const int hd0 = s.h0 + s.s0;
    const int hn0 = max(hd0, ec0);
    const int f0m = bar ? NEG_INF : f0;
    const int hu0 = max(hn0, f0m);
    const int hc0 = min(max(hu0, FLOOR), L.cap0);
    // cell 2k+1: E from lane k+1 (cell 2k+2 of the previous row), F from
    // cell 2k
    const int ec1 = (bar || s.ob1) ? NEG_INF : ev;
    const int hd1 = s.h1 + s.s1;
    const int hn1 = max(hd1, ec1);
    const int f1 = max(hn0 - q.rgo, f0 - q.rde);

    // out first: lane k+1's F of cell 2k+2, max(Hn(2k+1) - rgo, F(2k+1) -
    // rde), unrolled once so that only the received F is on the chain;
    // lane k-1's E of cell 2k-1 at row i + 1, max(H - fgo, E - rfe) of
    // cell 2k after this row, where an updated H - fgo is max(max(Hn,
    // FLOOR) - fgo, F - fgo), so again only the received F is on the
    // chain (a cell past the band sends to a cell past the band)
    const int h0n = active ? hc0 : s.h0;
    const int e0n = active ? ec0 : s.e0;
    const int fo = max(max(hn1 - q.rgo, hn0 - q.rgo - q.rde),
                       f0 - 2 * q.rde);
    const int eo = active
        ? max(max(max(hn0, FLOOR) - q.fgo, ec0 - q.rfe), f0m - q.fgo)
        : max(s.h0 - q.fgo, s.e0 - q.rfe);
    fv = __shfl_up_sync(FULL, fo, 1);
    ev = __shfl_down_sync(FULL, eo, 1);
    fb = __shfl_up_sync(FULL, f1 - q.rde > hn1 - q.rgo ? 8 : 0, 1);
    eb = __shfl_down_sync(FULL, e0n - q.rfe > h0n - q.fgo ? 4 : 0, 1);

    // the rest of the step: first the next row's codes (their loads go
    // ahead of this step's store)
    const int2 rn = s.rp[((i + 1) & (RROWS - 1)) * 2];
    const int wn = s.cp[((i + 2 + L.d0) & (RCOLS - 1)) * 2];
    const int fx1 = f0 - q.rde > hn0 - q.rgo ? 8 : 0;
    const int hu1 = max(hn1, bar ? NEG_INF : f1);
    const int hc1 = min(max(hu1, FLOOR), L.cap1);
    int src0 = hn0 < f0m ? H_F : (hd0 < ec0 ? H_E : H_DIAG);
    int src1 = hu1 > hn1 ? H_F : (hd1 < ec1 ? H_E : H_DIAG);
    if (LOCAL) {
        src0 = (hu0 < 0 || (hu0 == 0 && src0 == H_DIAG)) ? H_START : src0;
        src1 = (hu1 < 0 || (hu1 == 0 && src1 == H_DIAG)) ? H_START : src1;
    }
    const int nib0 = src0 | (ee0 > eo0 ? 4 : 0) | fx0;
    const int nib1 = src1 | x1 | fx1;
    // every lane stores every step: a row outside [0, Lchain) lands on a
    // ring row that is written again or already out before it is read
    s.dp[(i & (DROWS - 1)) * 64] =
        (unsigned char)((unsigned)(nib0 | (nib1 << 4)) & L.bmask);
    if (LOCAL) {
        // a cell past the band is NEG_INF, below every cell inside it
        if (active && hc0 >= s.best) {
            s.best = hc0;
            s.best_pos = (i << 6) | L.d0;
        }
        if (active && hc1 >= s.best) {
            s.best = hc1;
            s.best_pos = (i << 6) | (L.d0 + 1);
        }
    }
    if (active) {
        s.h0 = h0n;
        s.h1 = hc1;
        s.e0 = e0n;
        s.e1 = ec1;
    }
    // row i + 1: cell 2k's column is this row's cell 2k+1's
    next_codes(q, L, s, rn, s.w1, wn);
}

// A row past both reads' ends, row r0 + x of problem p (b): H and E are
// the frozen ones in sm.ff, the codes staged in sm.tw / sm.tr, and F runs
// cell by cell in this thread. All 64 cells run without a branch; the
// nibbles of cells past the band are masked off (their F only reaches
// cells further out). BAR: the call has a gap barrier, which every such
// row is inside (it lies past len - gbar).
template <bool LOCAL, bool BAR>
__device__ __forceinline__ void tail_row(const DiagArgs& a, const Pen& q,
                                         const DiagSmem& sm, int b, int p,
                                         int r0, int x) {
    const int2 ri = sm.tr[x][p];
    unsigned wd[8];
    #pragma unroll
    for (int w = 0; w < 8; ++w) wd[w] = 0u;
    int f = NEG_INF;
    unsigned fx = NEG_INF > NEG_INF - q.rgo ? 8u : 0u;
    #pragma unroll
    for (int d = 0; d < 64; ++d) {
        const int c = sm.tw[x + d][p];
        const int2 hf = sm.ff[d][p];
        int sc = c == ri.x ? q.mb : ri.y;
        sc = c < BASE ? c : sc;
        const int hd = hf.x + sc;
        const int e = (BAR || c == OOB) ? NEG_INF : hf.y >> 1;
        const int hn = max(hd, e);
        const int hu = BAR ? hn : max(hn, f);
        int src = hu > hn ? H_F : (hd < e ? H_E : H_DIAG);
        if (LOCAL && (hu < 0 || (hu == 0 && src == H_DIAG))) src = H_START;
        wd[d >> 3] |= ((unsigned)src | ((unsigned)hf.y & 1u) << 2 | fx)
                      << (4 * (d & 7));
        fx = f - q.rde > hn - q.rgo ? 8u : 0u;
        f = max(hn - q.rgo, f - q.rde);
    }
    const int r = r0 + x;
    int* out = a.dirs + ((size_t)r * a.B + b) * a.Wp;
    #pragma unroll
    for (int w = 0; w < 8; ++w) {
        const int n = min(max(q.BW - 8 * w, 0), 8);   // cells in the band
        if (w < a.Wp)
            out[w] = (int)(wd[w] & (n == 8 ? 0xFFFFFFFFu : (1u << (4 * n)) - 1u));
    }
}

// The rows [Lchain, Lmax) of both problems, TROWS of each at a time: the
// group's codes are staged by the block, then each thread takes a row.
template <bool LOCAL, bool BAR>
__device__ __noinline__ void tail_rows(const DiagArgs& a, const Pen& q,
                                          DiagSmem& sm, int bA, int bB,
                                          bool hasB, int Lchain) {
    const int t = threadIdx.x;
    const int p = t & 1, x = t >> 1;
    const int b = p ? bB : bA;
    const int* rd = a.reads + (size_t)b * a.Lmax;
    const int* mp = a.mmpen + (size_t)b * a.Lmax;
    const int* win = a.refwins + (size_t)b * a.W;
    for (int r0 = Lchain; r0 < a.Lmax; r0 += TROWS) {
        __syncthreads();                     // the last group is done
        for (int c = x; c < TROWS + 64; c += TROWS) {
            const int col = r0 + c;
            sm.tw[c][p] = col_code(col < a.W ? __ldg(win + col) : 5, q.n_pen);
        }
        {
            const int r = r0 + x;
            const int rc = r < a.Lmax ? __ldg(rd + r) : 4;
            const int qp = r < a.Lmax ? __ldg(mp + r) : 0;
            sm.tr[x][p] = make_int2(rc >= 4 ? -1 : rc + BASE,
                                    rc >= 4 ? -q.n_pen : -qp);
        }
        __syncthreads();
        if (r0 + x < a.Lmax && (p == 0 || hasB))
            tail_row<LOCAL, BAR>(a, q, sm, b, p, r0, x);
    }
}

// One pair of problems (2 * blockIdx.x and the next) a block: warp 0 runs
// the skewed chain over rows [0, Lchain), both warps the rows after it.
template <bool LOCAL>
__global__ void __launch_bounds__(DW * 32, 1) sw_diag_kernel(DiagArgs a,
                                                          SwParams sp) {
    __shared__ DiagSmem sm;
    const int k = threadIdx.x & 31;
    const int bA = 2 * blockIdx.x;
    const bool hasB = bA + 1 < a.B;
    const int bB = hasB ? bA + 1 : bA;       // a lone problem runs twice
    const int Lmax = a.Lmax;
    const int lenA = a.lens[bA], lenB = a.lens[bB];
    const int Lchain = min(max(max(lenA, lenB), 0), Lmax);
    const Pen q{sp.match_bonus, sp.n_pen, sp.rdo + sp.rde, sp.rde,
                sp.rfo + sp.rfe, sp.rfe, sp.gbar, a.BW};
    const bool f0x = NEG_INF > NEG_INF - q.rgo;

    if (threadIdx.x < 32) {
        // the staging lane's problem is its parity (chunks are 2 x 16)
        const int ps = k & 1;
        const int bs = ps ? bB : bA;
        const int* rd = a.reads + (size_t)bs * Lmax;
        const int* mp = a.mmpen + (size_t)bs * Lmax;
        const int* win = a.refwins + (size_t)bs * a.W;
        for (int r = k >> 1; r < 4 * CHUNK; r += 16)
            stage_row(sm, r, ps, r < Lmax ? __ldg(rd + r) : 4,
                      r < Lmax ? __ldg(mp + r) : 0, q.n_pen);
        for (int c = k >> 1; c < 8 * CHUNK; c += 16)
            sm.ccode[c][ps] = col_code(c < a.W ? __ldg(win + c) : 5,
                                       q.n_pen);
        __syncwarp();
        // the lane's constants and the penalties, kept in registers
        const bool v0 = 2 * k < q.BW, v1 = 2 * k + 1 < q.BW;
        Lane L;
        L.k = opaque(k);
        L.d0 = opaque(2 * k);
        L.cap0 = opaque(v0 ? INT_MAX : NEG_INF);
        L.cap1 = opaque(v1 ? INT_MAX : NEG_INF);
        L.ccap0 = opaque(v0 ? INT_MAX : OOB);
        L.ccap1 = opaque(v1 ? INT_MAX : OOB);
        L.bmask = (unsigned)opaque(v1 ? 0xFF : (v0 ? 0x0F : 0));
        L.f0x = opaque(f0x ? 8 : 0);
        const Pen qc{opaque(q.mb), q.n_pen, opaque(q.rgo), opaque(q.rde),
                     opaque(q.fgo), opaque(q.rfe), opaque(q.gbar), q.BW};
        // slot 0 works at even steps on problem k & 1, slot 1 at odd ones;
        // slot j's first row is (j - k) >> 1 (below 0 until its turn)
        Slot sl[2];
        #pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int p = (k & 1) ^ j;
            const int len = p ? lenB : lenA;
            sl[j].len = len;
            sl[j].lenc = min(max(len, 0), Lchain);
            sl[j].bspan = q.gbar > 0 ? (unsigned)max(len - 2 * q.gbar, 0)
                                     : 0x7FFFFFFFu;
            sl[j].h0 = v0 ? 0 : NEG_INF;         // row -1: a free start
            sl[j].h1 = v1 ? 0 : NEG_INF;
            sl[j].e0 = NEG_INF;
            sl[j].e1 = NEG_INF;
            sl[j].best = INT_MIN;
            sl[j].best_pos = 0;
            sl[j].rp = &sm.rinfo[0][p];
            sl[j].cp = &sm.ccode[0][p];
            sl[j].dp = &sm.dring[0][p][k];
            const int i0 = (j - k) >> 1;
            next_codes(qc, L, sl[j], sl[j].rp[(i0 & (RROWS - 1)) * 2],
                       sl[j].cp[((i0 + 2 * k) & (RCOLS - 1)) * 2],
                       sl[j].cp[((i0 + 2 * k + 1) & (RCOLS - 1)) * 2]);
        }
        int fv = NEG_INF, fb = L.f0x;
        int ev = max(sl[0].h0 - q.fgo, sl[0].e0 - q.rfe);
        int eb = sl[0].e0 - q.rfe > sl[0].h0 - q.fgo ? 4 : 0;
        ev = __shfl_down_sync(FULL, ev, 1);
        eb = __shfl_down_sync(FULL, eb, 1);

        const size_t rowB = (size_t)a.B * a.Wp;      // words a dirs row
        const int lmin = min(min(lenA, lenB), Lchain);
        const int nblk = Lchain > 0 ? (Lchain + CHUNK - 1) / CHUNK + 1 : 0;
        // chunk m (m >= 1): rows [48 + 16m, 64 + 16m) and window columns
        // [112 + 16m, 128 + 16m), loaded a block ahead, stored at block m
        int pr = 4 * CHUNK + (k >> 1);
        int pc = 8 * CHUNK + (k >> 1);
        int n_rc = pr < Lmax ? __ldg(rd + pr) : 4;
        int n_qp = pr < Lmax ? __ldg(mp + pr) : 0;
        int n_w = pc < a.W ? __ldg(win + pc) : 5;
        for (int m = 0; m < nblk; ++m) {
            if (m > 0) {
                stage_row(sm, pr, ps, n_rc, n_qp, q.n_pen);
                sm.ccode[pc & (RCOLS - 1)][ps] = col_code(n_w, q.n_pen);
                __syncwarp();
                pr += CHUNK;
                pc += CHUNK;
                n_rc = pr < Lmax ? __ldg(rd + pr) : 4;
                n_qp = pr < Lmax ? __ldg(mp + pr) : 0;
                n_w = pc < a.W ? __ldg(win + pc) : 5;
            }
            const int t0 = STEPS * m;
            const int i0 = (t0 - k) >> 1, i1 = (t0 + 1 - k) >> 1;
            // the block's rows are [16m - 16, 16m + 16)
            if (CHUNK * m - CHUNK >= q.gbar &&
                CHUNK * m + CHUNK <= lmin - q.gbar) {
                #pragma unroll 4
                for (int j = 0; j < STEPS / 2; ++j) {
                    chain_step<LOCAL, true>(qc, L, sl[0], i0 + j, fv, fb, ev,
                                            eb);
                    chain_step<LOCAL, true>(qc, L, sl[1], i1 + j, fv, fb, ev,
                                            eb);
                }
            } else {
                #pragma unroll 4
                for (int j = 0; j < STEPS / 2; ++j) {
                    chain_step<LOCAL, false>(qc, L, sl[0], i0 + j, fv, fb, ev,
                                             eb);
                    chain_step<LOCAL, false>(qc, L, sl[1], i1 + j, fv, fb, ev,
                                             eb);
                }
            }
            __syncwarp();
            // rows [16(m-1), 16m) are done in both problems: out whole
            if (m > 0) {
                #pragma unroll
                for (int it = 0; it < 8; ++it) {
                    const int x = it * 32 + k;
                    const int r = CHUNK * (m - 1) + (x >> 4);
                    const int p = (x >> 3) & 1, w = x & 7;
                    if (r < Lchain && w < a.Wp && (p == 0 || hasB))
                        a.dirs[(size_t)r * rowB + (size_t)(bA + p) * a.Wp + w]
                            = reinterpret_cast<const int*>(
                                sm.dring[r & (DROWS - 1)][p])[w];
                }
            }
        }

        // the best cells: slot j holds problem (k & 1) ^ j. End to end,
        // H froze at row len - 1, so the held H is that row's
        long long kk[2];
        #pragma unroll
        for (int j = 0; j < 2; ++j) {
            if (LOCAL) {
                kk[j] = sl[j].best == INT_MIN
                    ? LLONG_MIN : cell_key(sl[j].best, sl[j].best_pos);
            } else {
                const int r = sl[j].len - 1;
                const bool take = r >= 0 && r < Lchain;
                const long long k0 = take && v0
                    ? cell_key(sl[j].h0, (r << 6) | (2 * k)) : LLONG_MIN;
                const long long k1 = take && v1
                    ? cell_key(sl[j].h1, (r << 6) | (2 * k + 1)) : LLONG_MIN;
                kk[j] = k0 > k1 ? k0 : k1;
            }
        }
        const long long keyA = warp_max_key(k & 1 ? kk[1] : kk[0]);
        const long long keyB = warp_max_key(k & 1 ? kk[0] : kk[1]);
        if (k < 2 && (k == 0 || hasB)) {
            const long long key = k ? keyB : keyA;
            const int b = bA + k;
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
        // the frozen state for the rows past Lchain: cell 2k takes E from
        // this lane's cell 2k+1, cell 2k+1 from cell 2k+2 (lane k+1's
        // cell 0 of the same problem, in its other slot; NEG_INF past 63)
        #pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int p = (k & 1) ^ j;
            int hu = __shfl_down_sync(FULL, sl[j ^ 1].h0, 1);
            int eu = __shfl_down_sync(FULL, sl[j ^ 1].e0, 1);
            hu = k < 31 ? hu : NEG_INF;
            eu = k < 31 ? eu : NEG_INF;
            const int h1 = sl[j].h1, e1 = sl[j].e1;
            sm.ff[2 * k][p] = make_int2(
                sl[j].h0, max(h1 - q.fgo, e1 - q.rfe) * 2
                          + (e1 - q.rfe > h1 - q.fgo));
            sm.ff[2 * k + 1][p] = make_int2(
                h1, max(hu - q.fgo, eu - q.rfe) * 2 + (eu - q.rfe > hu - q.fgo));
        }
    }
    if (q.gbar > 0)
        tail_rows<LOCAL, true>(a, q, sm, bA, bB, hasB, Lchain);
    else
        tail_rows<LOCAL, false>(a, q, sm, bA, bB, hasB, Lchain);
}

// ---------------------------------------------------------------------------
// the walk
// ---------------------------------------------------------------------------

constexpr int NW = 2;               // walks (warps) a block
constexpr int BR = 256;             // rows a stage
constexpr int BNS = 4;              // stages a walk
constexpr int BRING = BR * BNS;     // rows the ring holds
constexpr int BFRING = 2 * BRING;   // window columns the ring holds

struct BtSmem {
    int dirs[8][BRING];     // word w of row r at [w][(r + 4w) & (BRING-1)]
    int rc[BRING];          // row r's read code and penalty at r & (BRING-1)
    int qp[BRING];
    int fc[BFRING];         // window column c's code at c & (BFRING-1)
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

// the direction nibble of band cell d in row r (both already clamped)
__device__ __forceinline__ int bt_cell(const BtSmem& sm, int r, int d) {
    const int w = d >> 3;
    return (sm.dirs[w][(r + 4 * w) & (BRING - 1)] >> (4 * (d & 7))) & 15;
}

// Stage q: rows [T0 - (q+1)BR + 1, T0 - q BR] at or above 0, their read
// codes and penalties and the window columns of the same numbers (stage 0
// also the 64 above T0, which its rows' band reaches), as one group of
// asynchronous copies.
__device__ __forceinline__ void bt_stage(BtSmem& sm, int q, int T0,
                                         const int* dsel, size_t rstride,
                                         int Wp, const int* rd, const int* mp,
                                         const int* rw, int W, int lane) {
    const int lo = T0 - (q + 1) * BR + 1;
    for (int t = lane; t < BR * 8; t += 32) {
        const int r = lo + (t >> 3), w = t & 7;
        if (w < Wp && r >= 0)
            cp_async4(&sm.dirs[w][(r + 4 * w) & (BRING - 1)],
                      dsel + (size_t)r * rstride + w);
    }
    for (int x = lane; x < BR; x += 32) {
        const int r = lo + x;
        if (r >= 0) {
            cp_async4(&sm.rc[r & (BRING - 1)], rd + r);
            cp_async4(&sm.qp[r & (BRING - 1)], mp + r);
        }
    }
    const int ncol = q == 0 ? BR + 64 : BR;
    for (int x = lane; x < ncol; x += 32) {
        const int col = lo + x;
        if (col >= 0)
            cp_async4(&sm.fc[col & (BFRING - 1)], rw + clampi(col, 0, W - 1));
    }
    cp_async_commit();
}

__global__ void __launch_bounds__(NW * 32) bt_diag_kernel(BtArgs a) {
    extern __shared__ __align__(16) unsigned char bt_smem[];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    BtSmem& sm = reinterpret_cast<BtSmem*>(bt_smem)[w];
    const int c = blockIdx.x * NW + w;
    if (c >= a.Bc) return;                   // the whole warp leaves
    const int Lmax = a.Lmax, W = a.W, BW = a.BW, S = a.S;
    const size_t Bc = (size_t)a.Bc;
    const int* dsel = a.dirs + (size_t)a.sel[c] * a.Wp;
    const size_t rstride = (size_t)a.Bdir * a.Wp;
    const int* rd = a.reads + (size_t)c * Lmax;
    const int* mp = a.mmpen + (size_t)c * Lmax;
    const int* rw = a.refwins + (size_t)c * W;
    unsigned char* ops = a.ops + c;

    int i = a.rows[c], d = a.lanes[c], mode = 0, s = 0;
    // the single steps' terms (the same in every lane) and this lane's
    // terms of the steps it committed in runs
    int score = 0, nmm = 0, ngo = 0, ngc = 0, nrefn = 0, refmin = 1 << 30;
    int l_score = 0, l_nmm = 0, l_ngc = 0, l_nrefn = 0, l_refmin = 1 << 30;
    const int T0 = min(i, Lmax - 1);
    int issued = 0, ready = 0;
    if (i >= 0 && d >= 0 && d < BW)
        for (; issued < BNS && T0 - issued * BR >= 0; ++issued)
            bt_stage(sm, issued, T0, dsel, rstride, a.Wp, rd, mp, rw, W,
                     lane);
    for (;;) {
        // done: step S, a row below 0, or the band column left the band
        if (s >= S || i < 0 || d < 0 || d >= BW) break;
        const int ic = min(i, Lmax - 1);
        // refill the buffers of stages the walk has left
        while (T0 - issued * BR >= 0 &&
               ic < T0 - (issued - BNS + 1) * BR + 1) {
            __syncwarp();
            bt_stage(sm, issued, T0, dsel, rstride, a.Wp, rd, mp, rw, W,
                     lane);
            ++issued;
        }
        // wait for the stage of the lowest row the window can reach
        const int need = (T0 - max(ic - 31, 0)) / BR;
        if (need >= ready) {
            // groups complete in order: stage `need` is done once at
            // most the issued - 1 - need groups after it are in flight
            const int pend = issued - 1 - need;
            if (pend <= 0) cp_async_wait<0>();
            else if (pend == 1) cp_async_wait<1>();
            else if (pend == 2) cp_async_wait<2>();
            else cp_async_wait<BNS - 1>();
            ready = need + 1;
            __syncwarp();
        }

        // the run: lane j takes the j-th step from here if every step
        // before it went on in the same mode
        int rr, dl;
        bool ok;
        if (mode == 0) {                     // M: (i - j, d), src H_DIAG
            rr = i - lane;
            dl = d;
            ok = rr >= 0 && (bt_cell(sm, min(rr, Lmax - 1), dl) & 3) == H_DIAG;
        } else if (mode == 1) {              // I: (i - j, d + j), bit 2
            rr = i - lane;
            dl = d + lane;
            ok = rr >= 0 && dl < BW &&
                 (bt_cell(sm, min(rr, Lmax - 1), min(dl, 63)) & 4);
        } else {                             // D: (i, d - j), bit 3
            rr = i;
            dl = d - lane;
            ok = dl >= 0 && (bt_cell(sm, ic, max(dl, 0)) & 8);
        }
        ok = ok && s + lane < S;
        const unsigned brk = __ballot_sync(FULL, !ok);
        const int f = brk ? __ffs(brk) - 1 : 32;
        if (lane < f) {
            const int rcl = min(rr, Lmax - 1);
            const int col = rcl + dl;
            const int fc = sm.fc[col & (BFRING - 1)];
            unsigned char byte;
            if (mode == 0) {
                const int rc = sm.rc[rcl & (BRING - 1)];
                const int qp = sm.qp[rcl & (BRING - 1)];
                const bool is_n = rc >= 4 || fc == 4;
                const bool ismatch = rc == fc && !is_n && fc < 4;
                l_score += ismatch ? a.mb : (is_n ? -a.n_pen : -qp);
                l_nmm += (!ismatch && rc < 4 && fc != 4) + is_n;
                l_nrefn += fc == 4;
                l_refmin = min(l_refmin, col);
                byte = (unsigned char)(OP_M | (clampi(fc, 0, 5) << 2)
                                       | ((int)ismatch << 5));
            } else {
                l_score -= mode == 1 ? a.rfe : a.rde;
                l_ngc += 1;
                if (mode == 2) l_refmin = min(l_refmin, col);
                byte = (unsigned char)(mode | (clampi(fc, 0, 5) << 2));
            }
            ops[(size_t)(s + lane) * Bc] = byte;
        }
        s += f;
        if (mode < 2) i -= f;
        if (mode == 1) d += f;
        if (mode == 2) d -= f;
        if (f == 32) continue;

        // the step that broke the run, as one step
        if (s >= S || i < 0 || d < 0 || d >= BW) break;
        const int ir = min(i, Lmax - 1);
        const int dd = bt_cell(sm, ir, d);
        const int src = dd & 3;
        if (mode == 0 && src == H_START) break;
        const int op = mode ? mode : src;    // H_DIAG/H_E/H_F = OP_M/I/D
        const int rc = sm.rc[ir & (BRING - 1)], qp = sm.qp[ir & (BRING - 1)];
        const int j = ir + d;                // rect column
        const int fc = sm.fc[j & (BFRING - 1)];
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
        if (lane == 0)
            ops[(size_t)s * Bc] = (unsigned char)(
                op | (clampi(fc, 0, 5) << 2) | ((int)ismatch << 5));
        ++s;
        // band moves: M -> (i-1, d); I -> (i-1, d+1); D -> (i, d-1); the
        // E or F extension bit of the move taken keeps its mode
        i -= op < 2;
        d += (op == OP_I) - (op == OP_D);
        mode = op & -((dd >> (op + 1)) & 1);
    }
    #pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        l_score += __shfl_xor_sync(FULL, l_score, o);
        l_nmm += __shfl_xor_sync(FULL, l_nmm, o);
        l_ngc += __shfl_xor_sync(FULL, l_ngc, o);
        l_nrefn += __shfl_xor_sync(FULL, l_nrefn, o);
        l_refmin = min(l_refmin, __shfl_xor_sync(FULL, l_refmin, o));
    }
    refmin = min(refmin, l_refmin);
    // every step from s on is done: OP_NONE over the window code at the
    // frozen cell (row and band column clamped as every load clamps them)
    const int jf = clampi(i, 0, Lmax - 1) + clampi(d, 0, BW - 1);
    const unsigned char tail = (unsigned char)(
        OP_NONE | (clampi(__ldg(rw + clampi(jf, 0, W - 1)), 0, 5) << 2));
    for (int t = s + lane; t < S; t += 32)
        ops[(size_t)t * Bc] = tail;
    if (lane == 0) {
        a.fields[0 * Bc + c] = i + 1;                            // read_start
        a.fields[1 * Bc + c] = refmin == (1 << 30) ? 0 : refmin;
        a.fields[2 * Bc + c] = nmm + l_nmm;
        a.fields[3 * Bc + c] = ngo;
        a.fields[4 * Bc + c] = ngc + l_ngc;
        a.fields[5 * Bc + c] = nrefn + l_nrefn;
        a.fields[6 * Bc + c] = score + l_score;
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
        const dim3 grid((B + 1) / 2);
        cudaStream_t s = (cudaStream_t)stream;
        if (local)
            sw_diag_kernel<true><<<grid, DW * 32, 0, s>>>(a, p);
        else
            sw_diag_kernel<false><<<grid, DW * 32, 0, s>>>(a, p);
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
        const int smem = NW * (int)sizeof(BtSmem);
        const cudaError_t e = cudaFuncSetAttribute(
            bt_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return (int)e;
        const BtArgs a{(const int*)dirs, Lmax, Bdir, Wp, (const int*)sel,
                       (const int*)rows, (const int*)lanes,
                       (const int*)reads, (const int*)mmpen,
                       (const int*)refwins, Bc, W, S, BW, match_bonus,
                       n_pen, rdo, rde, rfo, rfe, (unsigned char*)ops,
                       (int*)fields};
        bt_diag_kernel<<<(Bc + NW - 1) / NW, NW * 32, smem,
                         (cudaStream_t)stream>>>(a);
    }
    return (int)cudaGetLastError();
}
