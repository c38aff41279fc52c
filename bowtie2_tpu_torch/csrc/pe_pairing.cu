// Kernel K10 PE: the device half of the paired-end pairing, a pair to a
// group of TT lanes (TT = 16: two pairs a warp; TT = 32: one).
//
// Replaces: bowtie2_tpu/ops/fused.py:721 _pe_pairing with
// bowtie2_tpu/pipeline/pe.py:170 pe_classify_jnp, about 30 XLA ops over
// (pairs, T, T) masks: slot dedupe and ranking per read, the concordant
// cross-products under the pairing policy, the zero-seed-round suppression
// and the -D fail-streak fast flags (hostneed), the best and second
// concordant combination by a packed (score sum, rank, rank) key, and each
// read's two ranked heads.
//
// A group takes pair p, reads p (mate 1) and Bp + p (mate 2), T <= TT
// slots each: lane j holds slot j of both reads (slots j >= T dead). What
// the JAX op computes over a (T, T) mask a lane computes over a loop of the
// other read's slots; what it reduces over a read's slots is a ballot or a
// reduction over the group's lanes. The combinations (i, k) live on lane
// i, a bit k of its masks. Ties break as the JAX ops' argmax and argmin do,
// on the first index: a lane keeps its first best in (key, k) order, and
// the group's maximum key then least flat index i T + k (T the true slot
// count) picks the pair's. The second best combination masks only the
// best's index, with KMIN, which then still competes at its own index, as
// in the JAX op.
//
// Integers wrap as in the JAX op: extents are int32, or int64 in the large
// index mode (template P), and their differences wrap in P; the score sum
// and the packed key wrap in int32 (the caller keeps the key's range
// within int32 for every combination it keeps). Positions are written
// wrapped to int32, as the JAX op's int32 casts write them.
//
// Bound on the card: a few hundred bytes a pair in, 100 out, so the bytes
// bound is far below the work, the pair's chain of loops over slots and of
// reductions over them, a few thousand cycles of latency. Brought by
// shuffles, four to six a loop step, the other slot's fields would cost a
// warp several hundred shuffles; and a warp intrinsic over 16 lanes costs
// several times its latency over 32 (a reduction about 235 cycles against
// 47, a ballot 175 against 28). So:
// - TT is a template (16 for T <= 16, the PE main path's slot count, else
//   32): a pair takes TT lanes, and at T <= 16 a warp runs two pairs. Every
//   warp intrinsic runs on all 32 lanes and each half takes its own part of
//   the result (Group), so a half-warp past the last pair runs beside the
//   other with no slots.
// - Each slot's fields are staged once in shared memory as a record (Rec),
//   so a loop step reads the other slot's fields with broadcast loads. Each
//   loop visits only the slots that can matter, as the union of the warp's
//   two pairs (one path for the warp), without branches in its body: the
//   valid slots (the dedupe of both reads in one loop), the mate-2
//   representatives (concordance), the mate-2 slots some lane keeps (the
//   best two combinations, in one pass).
// - Reductions over a pair are redux.sync (__reduce_*_sync): one packed add
//   gives a read's three slot counts, one OR a read's heads by rank, and a
//   max, a ballot and a shuffle the first argmax.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int KMIN = -2147483647;     // -(1 << 31) + 1
constexpr int READ_FIELDS = 10;
constexpr int PAIR_FIELDS = 15;

template <typename P> struct Unsigned;
template <> struct Unsigned<int> { using T = unsigned; };
template <> struct Unsigned<long long> { using T = unsigned long long; };

template <typename P>
__device__ __forceinline__ P sub1(P a, P b) {     // a - b + 1, wrapping
    using U = typename Unsigned<P>::T;
    return (P)((U)a - (U)b + (U)1);
}

__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

struct Pairing {
    int policy;        // 0 ff, 1 rr, 2 fr, 3 rf
    int minins, maxins;
    int olap_ok, contain_ok, dove_ok;
    int limit;         // the -D fail-streak limit, -1 for none
    int shift;         // the key's rank field width
};

struct In {
    const int* aok; const int* score; const int* orient; const int* rid;
    const void* lo; const void* hi;
    const uint8_t* occ; const uint8_t* exact; const uint8_t* half;
    const int* mmug; const int* cpos;
    const int* ee_read; const int* seed_nz; const int* inst_read;
    const uint8_t* filtered;
};

// pe_classify (pipeline/pe.py) with expand-to-fit, reduced to what the
// pairing reads of it: whether the combination is not PE_DISCORD (bitwise
// operators: the loops that call it stay free of branches)
template <typename P>
__device__ __forceinline__ bool concordant(const Pairing& pr, P lo1, P hi1,
                                           bool fw1, P lo2, P hi2,
                                           bool fw2) {
    const P len1 = sub1(hi1, lo1), len2 = sub1(hi2, lo2);
    P mx = len1 > len2 ? len1 : len2;
    mx = mx < (P)pr.maxins ? (P)pr.maxins : mx;
    const P mn = (P)(pr.minins > 1 ? pr.minins : 1);
    const bool compat = (pr.policy <= 1) ? (fw1 == fw2) : (fw1 != fw2);
    const bool one_left = (pr.policy & 1) ? !fw1 : fw1;
    const P frag = sub1(hi1 > hi2 ? hi1 : hi2, lo1 < lo2 ? lo1 : lo2);
    const bool contain = ((lo1 >= lo2) & (hi1 <= hi2)) |
                         ((lo2 >= lo1) & (hi2 <= hi1));
    const bool olap = contain | ((lo1 <= lo2) & (lo2 <= hi1)) |
                      ((lo1 <= hi2) & (hi2 <= hi1));
    const bool wrong = !olap & (one_left ? lo2 < lo1 : lo1 < lo2);
    const bool dove = one_left ? (hi1 > hi2) | (lo2 < lo1)
                               : (hi2 > hi1) | (lo1 < lo2);
    return compat & (frag <= mx) & (frag >= mn) & !wrong &
           (pr.olap_ok | !olap) & (pr.contain_ok | !contain) &
           (pr.dove_ok | !dove);
}

// one read's slot j, in a lane's registers
template <typename P>
struct Slot {
    bool a;            // a valid alignment
    bool occ, exact, half;
    int s, o, r, cp, mm;
    P lo, hi;
};

// a slot's fields as the other lanes read them, in shared memory
template <typename P>
struct alignas(16) Rec {
    P lo, hi;
    int s, o, r, cp;
    int rank;          // its rank, where it is a representative
};

// slot j of a read (row) of T slots, where j < Tp (T, or 0 in a group
// without a pair)
template <typename P>
__device__ __forceinline__ Slot<P> load_slot(const In& in, long long row,
                                             int j, int T, int Tp) {
    Slot<P> x{};
    if (j < Tp) {
        const long long i = row * T + j;
        x.a = __ldg(in.aok + i) != 0;
        x.s = __ldg(in.score + i);
        x.o = __ldg(in.orient + i);
        x.r = __ldg(in.rid + i);
        x.cp = __ldg(in.cpos + i);
        x.mm = __ldg(in.mmug + i);
        x.occ = __ldg(in.occ + i) != 0;
        x.exact = __ldg(in.exact + i) != 0;
        x.half = __ldg(in.half + i) != 0;
        x.lo = __ldg((const P*)in.lo + i);
        x.hi = __ldg((const P*)in.hi + i);
    }
    return x;
}

// the lanes of one pair: the warp (TT = 32) or a half of it (TT = 16).
// Every warp intrinsic runs on all 32 lanes (mask FULL; a mask of 16 lanes
// costs several times the latency on this card) and each half unpacks its
// own result: a ballot's half, or a reduction of values each shifted into
// its half's 16 bits (OR, and sums that stay below 2^16), or, for the
// maximum, one reduction a half. A loop over slots that a mask names runs
// over both halves' union (`both`), so the warp runs it as one.
struct Bits {
    unsigned mine;     // the group's slots
    unsigned both;     // the union with the other group of the warp
};

template <int TT>
struct Group {
    static constexpr unsigned BITS = TT == 32 ? FULL : 0xFFFFu;
    int base;          // its first lane
    __device__ __forceinline__ Group() : base((threadIdx.x & 31) & ~(TT - 1)) {}
    // the group's bits of a full-warp value, and both groups' union
    __device__ __forceinline__ Bits bits(unsigned r) const {
        return {(r >> base) & BITS, TT == 32 ? r : (r | r >> 16) & BITS};
    }
    // a predicate of every lane as a bit of its slot
    __device__ __forceinline__ Bits ballot(bool p) const {
        return bits(__ballot_sync(FULL, p));
    }
    // the OR and the sum over the group, of values (and sums) below 2^TT
    __device__ __forceinline__ Bits any(unsigned x) const {
        return bits(__reduce_or_sync(FULL, x << base));
    }
    __device__ __forceinline__ unsigned sum(unsigned x) const {
        return (__reduce_add_sync(FULL, x << base) >> base) & BITS;
    }
    __device__ __forceinline__ int max(int x) const {
        if constexpr (TT == 32) {
            return __reduce_max_sync(FULL, x);
        } else {
            const int m0 = __reduce_max_sync(FULL, base ? INT_MIN : x);
            const int m1 = __reduce_max_sync(FULL, base ? x : INT_MIN);
            return base ? m1 : m0;
        }
    }
    // x of the group's lane for slot k
    __device__ __forceinline__ int at(int x, int k) const {
        return __shfl_sync(FULL, x, base + k);
    }
};

// dedupe by (orient, end): a valid slot loses to a valid slot of the same
// key of higher score, or of equal score and lower index. A read's slots
// ahead of slot j and the same-key ones among them, as slot bits, one
// other slot y (slot k) at a time; the representatives' rank is the number
// of representatives ahead (the rank of another slot is never read)
struct Ahead {
    unsigned ahead = 0, beaten = 0;
};

template <typename P>
__device__ __forceinline__ void dedupe_step(Ahead& d, const Rec<P>& y,
                                            bool valid, const Slot<P>& x,
                                            int k, int j) {
    const bool bet = valid & ((y.s > x.s) | ((y.s == x.s) & (k < j)));
    d.ahead |= (unsigned)bet << k;
    d.beaten |= (unsigned)(bet & (y.o == x.o) & (y.hi == x.hi)) << k;
}

// a read's -D fast flags under the pair's suppression, from one packed
// sum of its exact, half and seed hits over its slots
struct ReadFlags {
    bool att;          // this slot attempted
    bool head;         // this slot a head (an attempted representative)
    bool hostneed;     // not fast, or a suppressed read with half hits
};

template <typename P, int TT>
__device__ __forceinline__ ReadFlags read_flags(const Slot<P>& x, bool rep,
                                                bool supp, int limit,
                                                const Group<TT>& g) {
    constexpr int F = TT == 32 ? 8 : 5;   // a count's bits (TT < 2^F)
    const bool half_ok = x.half && (!supp || x.mm <= 1);
    ReadFlags f;
    f.att = x.occ && (!supp || x.exact || half_ok);
    f.head = rep && f.att;
    const unsigned n = g.sum((unsigned)(x.occ && x.exact)
                             | (unsigned)(x.occ && half_ok && !x.exact) << F
                             | (unsigned)(x.occ && !x.exact && !x.half)
                               << (2 * F));
    const int nex = n & ((1 << F) - 1), nhf = (n >> F) & ((1 << F) - 1);
    const int nsd = n >> (2 * F);
    const bool fast = limit < 0 ||
        (nex <= limit && nhf <= limit && (supp || nsd <= limit));
    f.hostneed = !fast || (supp && nhf > 0);
    return f;
}

// a read's two ranked heads: argmin of (rank, slot) over its slots, a
// slot that is no head at a rank past every slot, and the second with the
// first masked so at its own slot. The heads' ranks are distinct, so the
// first is the head of least rank and the second the next, or slot 0 where
// there is none (every other key is a masked one, the least slot 0's);
// fields as the JAX op lists them
template <typename P, int TT>
__device__ __forceinline__ void write_heads(const Rec<P>* R, int rank,
                                            bool head, bool real, int j,
                                            long long row, long long B,
                                            const Group<TT>& g,
                                            int* __restrict__ rf) {
    const unsigned ranks = g.any(head ? 1u << rank : 0u).mine;
    const int nh = __popc(ranks);
    const int r1 = __ffs((int)ranks) - 1;
    const int r2 = __ffs((int)(ranks & (ranks - 1))) - 1;
    const unsigned at1 = g.ballot(head && rank == r1).mine;
    const unsigned at2 = g.ballot(head && rank == r2).mine;
    if (real && j == 0) {
        const Rec<P>& x = R[nh >= 1 ? __ffs((int)at1) - 1 : 0];
        const Rec<P>& y = R[nh >= 2 ? __ffs((int)at2) - 1 : 0];
        const int v[READ_FIELDS] = {
            x.cp, x.o, (int)x.lo, (int)x.hi, x.s, nh >= 1,
            y.cp, y.s, nh >= 2, nh};
        #pragma unroll
        for (int q = 0; q < READ_FIELDS; ++q) rf[q * B + row] = v[q];
    }
}

// a combination of the pair: its key and flat index i T + k, ordered as
// argmax's first index (the larger key, then the smaller index)
struct Combo {
    int key, flat;
};

__device__ __forceinline__ bool before(Combo a, Combo b) {
    return (a.key > b.key) | ((a.key == b.key) & (a.flat < b.flat));
}

// the first of the group's combinations, one a lane: the largest key's
// least index is the lowest lane's holding that key; `lane`, that lane
template <int TT>
__device__ __forceinline__ Combo argmax(const Group<TT>& g, Combo c,
                                        int& lane) {
    const int top = g.max(c.key);
    lane = __ffs((int)g.ballot(c.key == top).mine) - 1;
    return {top, g.at(c.flat, lane)};
}

// The best and the second combination of the pair over its T x T ones,
// keyed (S1 + S2 << 2 shift) - (rank1 << shift) - rank2 where kept, KMIN
// elsewhere: argmax, then argmax with the best's key masked to KMIN at its
// own index. Lane i holds the combinations (i, k): the kept ones (bits of
// `keep`, visited over `any`, the warp's union of keep), whose best two it
// finds in one pass, and the KMIN ones, of which the first stands for all.
// `b1` and `s1`: the two combinations' mate-1 slots.
template <typename P, int TT>
__device__ __forceinline__ void best_two(const Rec<P>* R2, int s1,
                                         int rank1, unsigned keep,
                                         unsigned any, unsigned live,
                                         int sh, int j, int T,
                                         const Group<TT>& g, Combo& best,
                                         int& b1, Combo& second, int& b2) {
    constexpr Combo NONE{INT_MIN, INT_MAX};
    Combo top = NONE, next = NONE;
    for (unsigned m = any; m; m &= m - 1) {
        const int k = __ffs((int)m) - 1;
        const Combo c{(int)(((unsigned)wadd(s1, R2[k].s) << (2 * sh))
                            - ((unsigned)rank1 << sh)
                            - (unsigned)R2[k].rank),
                      j * T + k};
        const bool kept = (keep >> k) & 1u;
        const bool up1 = kept & before(c, top);
        const bool up2 = kept & !up1 & before(c, next);
        next = up1 ? top : (up2 ? c : next);
        top = up1 ? c : top;
    }
    const unsigned rest = ~keep & live;
    const int first = rest ? __ffs((int)rest) - 1 : 32;
    const Combo kmin = ((live >> j) & 1u) && rest ? Combo{KMIN, j * T + first}
                                                   : NONE;
    const bool kept_best = before(top, kmin);
    const Combo mine = kept_best ? top : kmin;
    best = argmax<TT>(g, mine, b1);
    // the best's lane, its best (a kept one) masked
    Combo mine2 = mine;
    if (j == b1 && kept_best) {
        const Combo masked{KMIN, j * T + min(first, top.flat - j * T)};
        mine2 = before(next, masked) ? next : masked;
    }
    second = argmax<TT>(g, mine2, b2);
}

template <typename P, int TT>
__global__ void __launch_bounds__(THREADS)
pairing_kernel(In in, Pairing pr, int Bp, int T, int* __restrict__ rf,
               int* __restrict__ pf) {
    constexpr int PAIRS = THREADS / TT;
    // a pair's records, mate 1's TT slots then mate 2's, and one record of
    // padding, so the two pairs of a warp read different banks
    __shared__ Rec<P> recs[PAIRS][2 * TT + 1];
    const int gi = threadIdx.x / TT;
    const int p = blockIdx.x * PAIRS + gi;
    // whole warps leave together; a half-warp past the last pair runs with
    // no slots and writes nothing
    if (blockIdx.x * PAIRS + (int)(threadIdx.x & ~31u) / TT >= Bp) return;
    const bool real = p < Bp;
    const int Tp = real ? T : 0;
    const Group<TT> g;
    const int j = threadIdx.x % TT;
    const unsigned live = Tp >= 32 ? FULL : (1u << Tp) - 1u;
    const long long B = 2LL * Bp;
    const long long r1 = real ? p : 0, r2 = real ? (long long)Bp + p : 0;
    const Slot<P> m1 = load_slot<P>(in, r1, j, T, Tp);
    const Slot<P> m2 = load_slot<P>(in, r2, j, T, Tp);
    // the read fields, loaded beside the slots
    const int n1e = __ldg(in.ee_read + r1), n2e = __ldg(in.ee_read + r2);
    const int inst1 = __ldg(in.inst_read + r1);
    const int inst2 = __ldg(in.inst_read + r2);
    const int snz1 = __ldg(in.seed_nz + r1), snz2 = __ldg(in.seed_nz + r2);
    const bool both_ok = !__ldg(in.filtered + r1) & !__ldg(in.filtered + r2);
    Rec<P>* R1 = recs[gi];
    Rec<P>* R2 = recs[gi] + TT;
    R1[j] = Rec<P>{m1.lo, m1.hi, m1.s, m1.o, m1.r, m1.cp, 0};
    R2[j] = Rec<P>{m2.lo, m2.hi, m2.s, m2.o, m2.r, m2.cp, 0};
    const Bits valid1 = g.ballot(m1.a), valid2 = g.ballot(m2.a);
    __syncwarp();
    Ahead d1, d2;
    for (unsigned m = valid1.both | valid2.both; m; m &= m - 1) {
        const int k = __ffs((int)m) - 1;
        dedupe_step<P>(d1, R1[k], (valid1.mine >> k) & 1u, m1, k, j);
        dedupe_step<P>(d2, R2[k], (valid2.mine >> k) & 1u, m2, k, j);
    }
    const bool rep1 = m1.a && d1.beaten == 0, rep2 = m2.a && d2.beaten == 0;
    const Bits reps1 = g.ballot(rep1), reps2 = g.ballot(rep2);
    const int rank1 = __popc(d1.ahead & reps1.mine);
    const int rank2 = __popc(d2.ahead & reps2.mine);
    R1[j].rank = rank1;
    R2[j].rank = rank2;
    __syncwarp();

    // concordant cross-products: lane i keeps mate-2 slots k as bits
    unsigned conc = 0;
    for (unsigned m = reps2.both; m; m &= m - 1) {
        const int k = __ffs((int)m) - 1;
        const Rec<P>& y = R2[k];
        const bool c = ((reps2.mine >> k) & 1u) & rep1 & (m1.r == y.r) &
                       concordant<P>(pr, m1.lo, m1.hi, m1.o == 0, y.lo,
                                     y.hi, y.o == 0);
        conc |= (unsigned)c << k;
    }
    const unsigned conc2 = g.any(conc).mine;

    // zero-seed-round suppression (bt2_search.cpp:3948/:3968 `break`)
    const bool swap = n1e > 0 && n2e > 0 && n1e > n2e;
    const bool supp = both_ok && ((swap ? inst2 : inst1) == 0 ||
                                  (swap ? snz2 : snz1) == 0);
    const ReadFlags f1 = read_flags<P, TT>(m1, rep1, supp, pr.limit, g);
    const ReadFlags f2 = read_flags<P, TT>(m2, rep2, supp, pr.limit, g);

    // kept combinations: concordant, and an attempted slot of either mate
    // in a concordant combination; the best, then the best but the best's
    // index
    const bool suc1 = f1.att && conc != 0;
    const unsigned suc2 = g.ballot(f2.att && ((conc2 >> j) & 1u)).mine;
    const unsigned keep = conc & (suc1 ? FULL : suc2);
    const int n_kept = (int)g.sum((unsigned)__popc(keep));
    const unsigned any = g.any(keep).both;
    Combo best, second;
    int b1, s1;
    best_two<P, TT>(R2, m1.s, rank1, keep, any, live, pr.shift, j, T, g,
                    best, b1, second, s1);
    if (real && j == 0) {
        const Rec<P>& x = R1[b1];
        const Rec<P>& y = R2[best.flat - b1 * T];
        const int v[PAIR_FIELDS] = {
            n_kept > 0, x.cp, x.o, (int)x.lo, (int)x.hi, x.s,
            y.cp, y.o, (int)y.lo, (int)y.hi, y.s, wadd(x.s, y.s),
            wadd(R1[s1].s, R2[second.flat - s1 * T].s), n_kept,
            f1.hostneed || f2.hostneed};
        #pragma unroll
        for (int q = 0; q < PAIR_FIELDS; ++q) pf[(long long)q * Bp + p] = v[q];
    }
    write_heads<P, TT>(R1, rank1, rep1 && f1.att, real, j, r1, B, g, rf);
    write_heads<P, TT>(R2, rank2, rep2 && f2.att, real, j, r2, B, g, rf);
}

template <typename P, int TT>
void launch(const In& in, const Pairing& pr, int Bp, int T, void* rf,
            void* pf, void* stream) {
    constexpr int PAIRS = THREADS / TT;
    pairing_kernel<P, TT><<<(unsigned)((Bp + PAIRS - 1) / PAIRS), THREADS, 0,
                            (cudaStream_t)stream>>>(in, pr, Bp, T, (int*)rf,
                                                    (int*)pf);
}

}  // namespace

// read_fields (10 x 2 Bp) and pair_fields (15 x Bp), int32, of the pairing
// of Bp pairs of T <= 32 slots a read (reads p and Bp + p a pair). The
// slot arrays are (2 Bp, T): aok, score, orient, rid, cpos, mmug int32;
// occ, exact, half bytes; lo, hi int32, or int64 when pos64 is set. The
// read arrays (2 Bp): ee_read, seed_nz, inst_read int32, filtered bytes.
// policy: 0 ff, 1 rr, 2 fr, 3 rf; limit -1 for none; shift: the key's
// rank field width, bit_length(max(T - 1, 1)).
extern "C" int pe_pairing(const void* aok, const void* score,
                          const void* orient, const void* rid,
                          const void* lo, const void* hi, int pos64,
                          const void* occ, const void* exact,
                          const void* half, const void* mmug,
                          const void* cpos, const void* ee_read,
                          const void* seed_nz, const void* inst_read,
                          const void* filtered, int Bp, int T, int policy,
                          int minins, int maxins, int olap_ok,
                          int contain_ok, int dove_ok, int limit, int shift,
                          void* read_fields, void* pair_fields,
                          void* stream) {
    if (T < 1 || T > 32 || policy < 0 || policy > 3 || Bp < 0)
        return (int)cudaErrorInvalidValue;
    if (Bp == 0) return (int)cudaGetLastError();
    In in{(const int*)aok, (const int*)score, (const int*)orient,
          (const int*)rid, lo, hi, (const uint8_t*)occ,
          (const uint8_t*)exact, (const uint8_t*)half, (const int*)mmug,
          (const int*)cpos, (const int*)ee_read, (const int*)seed_nz,
          (const int*)inst_read, (const uint8_t*)filtered};
    Pairing pr{policy, minins, maxins, olap_ok, contain_ok, dove_ok, limit,
               shift};
    if (pos64)
        (T <= 16 ? launch<long long, 16> : launch<long long, 32>)(
            in, pr, Bp, T, read_fields, pair_fields, stream);
    else
        (T <= 16 ? launch<int, 16> : launch<int, 32>)(
            in, pr, Bp, T, read_fields, pair_fields, stream);
    return (int)cudaGetLastError();
}
