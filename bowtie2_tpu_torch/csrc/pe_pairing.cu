// Kernel K10 PE: the device half of the paired-end pairing, one warp a pair.
//
// Replaces: bowtie2_tpu/ops/fused.py:721 _pe_pairing with
// bowtie2_tpu/pipeline/pe.py:170 pe_classify_jnp, about 30 XLA ops over
// (pairs, T, T) masks: slot dedupe and ranking per read, the concordant
// cross-products under the pairing policy, the zero-seed-round suppression
// and the -D fail-streak fast flags (hostneed), the best and second
// concordant combination by a packed (score sum, rank, rank) key, and each
// read's two ranked heads.
//
// Here a warp takes pair p, reads p (mate 1) and Bp + p (mate 2), T <= 32
// slots each: lane j holds slot j of both reads. What the JAX op computes
// over a (T, T) mask a lane computes over a loop of T steps, the other
// slot's fields by shuffle; what it reduces over a read's slots is a
// ballot or a warp reduction. The combinations (i, k) live on lane i, a
// bit k of its concordance mask. Ties break as the JAX ops' argmax and
// argmin do, on the first index: a lane keeps its first best in k order,
// and the warp reduction orders by (key, flat index). The second best
// combination masks only the best's index, with KMIN, which then still
// competes at its own index, as in the JAX op.
//
// Integers wrap as in the JAX op: extents are int32, or int64 in the large
// index mode (template P), and their differences wrap in P; the score sum
// and the packed key wrap in int32 (the caller keeps the key's range
// within int32 for every combination it keeps). Positions are written
// wrapped to int32, as the JAX op's int32 casts write them.
//
// Bound on the card: a few hundred bytes a pair in, 100 out; the pair's
// work is its dependency chain of T-step shuffle loops, short next to the
// launch, so the kernel is latency-bound: the design keeps a pair in one
// warp with no shared memory or barrier.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;              // warps (pairs) a block
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int KMIN = -2147483647;     // -(1 << 31) + 1
constexpr int NORANK = 32;            // a rank past every slot (T <= 32)
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
// pairing reads of it: whether the combination is not PE_DISCORD
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
    bool ok = compat && frag <= mx && frag >= mn;
    const bool contain = (lo1 >= lo2 && hi1 <= hi2) ||
                         (lo2 >= lo1 && hi2 <= hi1);
    const bool olap = contain || (lo1 <= lo2 && lo2 <= hi1) ||
                      (lo1 <= hi2 && hi2 <= hi1);
    if (!pr.olap_ok) ok = ok && !olap;
    const bool wrong = !olap && ((one_left && lo2 < lo1) ||
                                 (!one_left && lo1 < lo2));
    ok = ok && !wrong;
    if (!pr.contain_ok) ok = ok && !contain;
    const bool dove = (one_left && (hi1 > hi2 || lo2 < lo1)) ||
                      (!one_left && (hi2 > hi1 || lo1 < lo2));
    if (!pr.dove_ok) ok = ok && !dove;
    return ok;
}

// one read's slot j: its fields, and its dedupe and rank over the read
struct Slot {
    bool a;            // a valid alignment
    int s, o, r, cp, mm;
    bool occ, exact, half;
    long long lo, hi;  // extents, widened from P
    bool rep;          // the first of its (orient, end) group
    int rank;          // rank under (not rep, -score, slot)
};

template <typename P>
__device__ __forceinline__ Slot load_slot(const In& in, long long row,
                                          int j, int T) {
    Slot x{};
    if (j < T) {
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
        x.lo = (long long)__ldg((const P*)in.lo + i);
        x.hi = (long long)__ldg((const P*)in.hi + i);
    }
    return x;
}

// dedupe by (orient, end): a slot loses to a same-key slot of higher
// score, or of equal score and earlier index; then the rank
__device__ __forceinline__ void dedupe_rank(Slot& x, int j, int T) {
    bool rep = x.a;
    for (int k = 0; k < T; ++k) {
        const int sk = __shfl_sync(FULL, x.s, k);
        const int ok = __shfl_sync(FULL, x.o, k);
        const long long hk = __shfl_sync(FULL, x.hi, k);
        const bool ak = __shfl_sync(FULL, (int)x.a, k);
        const bool bet = sk > x.s || (sk == x.s && k < j);
        if (ok == x.o && hk == x.hi && x.a && ak && bet) rep = false;
    }
    x.rep = rep;
    int rank = 0;
    for (int k = 0; k < T; ++k) {
        const int sk = __shfl_sync(FULL, x.s, k);
        const bool nk = !__shfl_sync(FULL, (int)rep, k);
        const bool n = !rep;
        rank += (nk < n) || (nk == n && (sk > x.s || (sk == x.s && k < j)));
    }
    x.rank = rank;
}

// (key, flat index) ordered as argmax's first index: larger key, then
// smaller index
__device__ __forceinline__ void argmax_warp(int& key, int& flat) {
    #pragma unroll
    for (int d = 16; d >= 1; d >>= 1) {
        const int k2 = __shfl_xor_sync(FULL, key, d);
        const int f2 = __shfl_xor_sync(FULL, flat, d);
        if (k2 > key || (k2 == key && f2 < flat)) {
            key = k2;
            flat = f2;
        }
    }
}

// a read's -D fast flags and attempted slots under the pair's suppression
struct ReadFlags {
    bool hostneed;     // not fast, or a suppressed read with half hits
    bool suc;          // this slot attempted and in a concordant combination
    int head_key;      // (rank << 5) | slot where attempted, else NORANK's
    unsigned heads;    // the attempted representatives, as lanes
};

__device__ __forceinline__ ReadFlags read_flags(const Slot& x, bool succ,
                                                bool supp, int limit, int j,
                                                int T) {
    const bool half_ok = x.half && (!supp || x.mm <= 1);
    const int nex = __popc(__ballot_sync(FULL, x.occ && x.exact));
    const int nhf = __popc(__ballot_sync(FULL, x.occ && half_ok && !x.exact));
    const int nsd = __popc(__ballot_sync(FULL, x.occ && !x.exact && !x.half));
    const bool fast = limit < 0 ||
        (nex <= limit && nhf <= limit && (supp || nsd <= limit));
    const bool att = x.occ && (!supp || x.exact || half_ok);
    const bool head = j < T && x.rep && att;
    ReadFlags f;
    f.hostneed = !fast || (supp && nhf > 0);
    f.suc = att && succ;
    f.head_key = j < T ? ((head ? x.rank : NORANK) << 5) | j : 0x7FFFFFFF;
    f.heads = __ballot_sync(FULL, head);
    return f;
}

// a read's two ranked heads: argmin of (rank, slot), the second with the
// first masked to NORANK at its own slot; fields as the JAX op lists them
__device__ __forceinline__ void write_heads(const Slot& x,
                                            const ReadFlags& f, int j,
                                            long long row, long long B,
                                            int* __restrict__ rf) {
    const int first = __reduce_min_sync(FULL, f.head_key);
    const int fs = first & 31;
    const int second = __reduce_min_sync(
        FULL, j == fs ? (NORANK << 5) | j : f.head_key);
    const int ss = second & 31;
    const int v[READ_FIELDS] = {
        __shfl_sync(FULL, x.cp, fs), __shfl_sync(FULL, x.o, fs),
        (int)__shfl_sync(FULL, x.lo, fs), (int)__shfl_sync(FULL, x.hi, fs),
        __shfl_sync(FULL, x.s, fs), (first >> 5) < NORANK,
        __shfl_sync(FULL, x.cp, ss), __shfl_sync(FULL, x.s, ss),
        (second >> 5) < NORANK, __popc(f.heads)};
    if (j == 0) {
        #pragma unroll
        for (int q = 0; q < READ_FIELDS; ++q) rf[q * B + row] = v[q];
    }
}

// the first combination of largest key (argmax's first index), over every
// lane's combinations; `masked`, a flat index to read as KMIN (or -1)
__device__ __forceinline__ int best_combo(const Slot& m1, const Slot& m2,
                                          unsigned keep, int sh, int masked,
                                          int j, int T) {
    int key = -2147483647 - 1, flat = 0x7FFFFFFF;
    for (int k = 0; k < T; ++k) {
        const int s2 = __shfl_sync(FULL, m2.s, k);
        const int rk2 = __shfl_sync(FULL, m2.rank, k);
        const int f = j * T + k;
        int kk = KMIN;
        if (((keep >> k) & 1u) && f != masked)
            kk = (int)(((unsigned)wadd(m1.s, s2) << (2 * sh))
                       - ((unsigned)m1.rank << sh) - (unsigned)rk2);
        if (j < T && (k == 0 || kk > key)) {
            key = kk;
            flat = f;
        }
    }
    argmax_warp(key, flat);
    return flat;
}

template <typename P>
__global__ void __launch_bounds__(WARPS * 32)
pairing_kernel(In in, Pairing pr, int Bp, int T, int* __restrict__ rf,
               int* __restrict__ pf) {
    const int p = blockIdx.x * WARPS + threadIdx.x / 32;
    if (p >= Bp) return;                 // whole warps leave together
    const int j = threadIdx.x & 31;
    const long long B = 2LL * Bp;
    const long long r1 = p, r2 = (long long)Bp + p;
    Slot m1 = load_slot<P>(in, r1, j, T);
    Slot m2 = load_slot<P>(in, r2, j, T);
    dedupe_rank(m1, j, T);
    dedupe_rank(m2, j, T);

    // concordant cross-products: lane i keeps mate-2 slots k as bits
    unsigned conc = 0;
    bool succ2 = false;
    for (int k = 0; k < T; ++k) {
        const int rk = __shfl_sync(FULL, m2.r, k);
        const bool repk = __shfl_sync(FULL, (int)m2.rep, k);
        const long long lok = __shfl_sync(FULL, m2.lo, k);
        const long long hik = __shfl_sync(FULL, m2.hi, k);
        const int ok = __shfl_sync(FULL, m2.o, k);
        const bool c = m1.rep && repk && m1.r == rk &&
                       concordant<P>(pr, (P)m1.lo, (P)m1.hi, m1.o == 0,
                                     (P)lok, (P)hik, ok == 0);
        conc |= (unsigned)c << k;
        const unsigned any = __ballot_sync(FULL, c);
        if (j == k) succ2 = any != 0;
    }

    // zero-seed-round suppression (bt2_search.cpp:3948/:3968 `break`)
    const int n1e = __ldg(in.ee_read + r1), n2e = __ldg(in.ee_read + r2);
    const bool swap = n1e > 0 && n2e > 0 && n1e > n2e;
    const int inst_first = __ldg(in.inst_read + (swap ? r2 : r1));
    const int snz_first = __ldg(in.seed_nz + (swap ? r2 : r1));
    const bool both_ok = !__ldg(in.filtered + r1) && !__ldg(in.filtered + r2);
    const bool supp = both_ok && (inst_first == 0 || snz_first == 0);
    const ReadFlags f1 = read_flags(m1, conc != 0, supp, pr.limit, j, T);
    const ReadFlags f2 = read_flags(m2, succ2, supp, pr.limit, j, T);

    // kept combinations, keyed (SS << 2 shift) - (rank1 << shift) - rank2
    // (KMIN where not kept): the best, then the best but the best's index
    const unsigned suc2 = __ballot_sync(FULL, f2.suc);    // every lane
    const unsigned keep = conc & (f1.suc ? FULL : suc2);
    const int n_kept = (int)__reduce_add_sync(FULL, (unsigned)__popc(keep));
    const int bflat = best_combo(m1, m2, keep, pr.shift, -1, j, T);
    const int sflat = best_combo(m1, m2, keep, pr.shift, bflat, j, T);
    const int b1 = bflat / T, b2 = bflat % T;
    const int s1 = __shfl_sync(FULL, m1.s, b1), s2 = __shfl_sync(FULL, m2.s, b2);
    const int v[PAIR_FIELDS] = {
        n_kept > 0,
        __shfl_sync(FULL, m1.cp, b1), __shfl_sync(FULL, m1.o, b1),
        (int)__shfl_sync(FULL, m1.lo, b1), (int)__shfl_sync(FULL, m1.hi, b1),
        s1,
        __shfl_sync(FULL, m2.cp, b2), __shfl_sync(FULL, m2.o, b2),
        (int)__shfl_sync(FULL, m2.lo, b2), (int)__shfl_sync(FULL, m2.hi, b2),
        s2,
        wadd(s1, s2),
        wadd(__shfl_sync(FULL, m1.s, sflat / T),
             __shfl_sync(FULL, m2.s, sflat % T)),
        n_kept,
        f1.hostneed || f2.hostneed};
    if (j == 0) {
        #pragma unroll
        for (int q = 0; q < PAIR_FIELDS; ++q) pf[(long long)q * Bp + p] = v[q];
    }
    write_heads(m1, f1, j, r1, B, rf);
    write_heads(m2, f2, j, r2, B, rf);
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
    const unsigned grid = (unsigned)((Bp + WARPS - 1) / WARPS);
    if (pos64)
        pairing_kernel<long long><<<grid, WARPS * 32, 0,
                                    (cudaStream_t)stream>>>(
            in, pr, Bp, T, (int*)read_fields, (int*)pair_fields);
    else
        pairing_kernel<int><<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
            in, pr, Bp, T, (int*)read_fields, (int*)pair_fields);
    return (int)cudaGetLastError();
}
