/* SA-IS suffix array construction (Nong, Zhang & Chan, 2009).
 *
 * Native build-time component of bowtie2_tpu: linear-time suffix sorting
 * for genome-scale index construction, filling the role of the reference's
 * Karkkainen blockwise sorter / libsais path (blockwise_sa.h:255,
 * third_party/libsais).
 *
 * Memory: everything lives INSIDE the caller's SA buffer plus one n-byte
 * type array per recursion level — the reduced string is compacted into
 * the tail of SA, the recursion's SA is its head, and LMS positions are
 * rebuilt from the type array when needed (the classic two-buffer SA-IS
 * layout). Peak is ~SA + 2n bytes of type arrays across levels, i.e.
 * ~6 bytes/char in the uint32 path — the difference between a human-scale
 * (3.1 Gbp) build fitting in ~23 GB vs ~40 GB with separate LMS arrays.
 *
 * Convention: T[n-1] must be a unique smallest sentinel (the Python
 * wrapper shifts codes up by one and appends 0). SA covers all n suffixes
 * including the sentinel suffix (SA[0] == n-1 on return).
 *
 * Exposed entry points (ctypes):
 *   int sais_u8   (const uint8_t* T, int64_t* SA, int64_t n, int64_t K)
 *   int sais_int64(const int64_t* T, int64_t* SA, int64_t n, int64_t K)
 *   int sais_u8_32(const uint8_t* T, uint32_t* SA, int64_t n, int64_t K)
 * Return 0 on success, negative on bad input / allocation failure.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef int64_t i64;

#define L_TYPE 0
#define S_TYPE 1

struct view {
    const void *T;
    int wide;        /* 0: uint8_t, 1: i64 */
};

static inline i64 chr_at(const struct view *v, i64 i) {
    return v->wide ? ((const i64 *)v->T)[i] : ((const uint8_t *)v->T)[i];
}

static void bucket_bounds(const struct view *v, i64 n, i64 K, i64 *B,
                          int ends) {
    i64 i;
    i64 *cnt = (i64 *)calloc((size_t)K, sizeof(i64));
    for (i = 0; i < n; i++) cnt[chr_at(v, i)]++;
    i64 sum = 0;
    for (i = 0; i < K; i++) {
        sum += cnt[i];
        B[i] = ends ? sum : sum - cnt[i];
    }
    free(cnt);
}

static int is_lms(const unsigned char *ty, i64 i) {
    return i > 0 && ty[i] == S_TYPE && ty[i - 1] == L_TYPE;
}

/* induced sort: SA pre-seeded with LMS positions at bucket ends, -1 holes */
static void induce(const struct view *v, unsigned char *ty, i64 *SA,
                   i64 n, i64 K, i64 *B) {
    i64 i, j;
    /* L pass (left to right, bucket heads) */
    bucket_bounds(v, n, K, B, 0);
    for (i = 0; i < n; i++) {
        j = SA[i];
        if (j > 0 && ty[j - 1] == L_TYPE)
            SA[B[chr_at(v, j - 1)]++] = j - 1;
    }
    /* S pass (right to left, bucket ends) */
    bucket_bounds(v, n, K, B, 1);
    for (i = n - 1; i >= 0; i--) {
        j = SA[i];
        if (j > 0 && ty[j - 1] == S_TYPE)
            SA[--B[chr_at(v, j - 1)]] = j - 1;
    }
}

static int sais_rec(const struct view *v, i64 *SA, i64 n, i64 K) {
    i64 i, j;
    if (n == 0) return 0;
    if (n == 1) { SA[0] = 0; return 0; }

    unsigned char *ty = (unsigned char *)malloc((size_t)n);
    i64 *B = (i64 *)malloc((size_t)K * sizeof(i64));
    if (!ty || !B) { free(ty); free(B); return -2; }

    ty[n - 1] = S_TYPE;  /* the sentinel */
    for (i = n - 2; i >= 0; i--) {
        i64 c0 = chr_at(v, i), c1 = chr_at(v, i + 1);
        ty[i] = (c0 < c1 || (c0 == c1 && ty[i + 1] == S_TYPE))
                    ? S_TYPE : L_TYPE;
    }

    /* ---- step 1: sort LMS substrings by one induction round ---- */
    for (i = 0; i < n; i++) SA[i] = -1;
    bucket_bounds(v, n, K, B, 1);
    for (i = n - 1; i > 0; i--) {
        if (is_lms(ty, i)) SA[--B[chr_at(v, i)]] = i;
    }
    SA[0] = n - 1;   /* sentinel suffix leads; also an honorary LMS anchor */
    induce(v, ty, SA, n, K, B);

    /* ---- step 2: name LMS substrings in sorted order ---- */
    /* collect sorted LMS positions into the front of SA */
    i64 *sorted = SA;
    j = 0;
    for (i = 0; i < n; i++) {
        i64 p = SA[i];
        if (p == n - 1 || is_lms(ty, p)) sorted[j++] = p;
    }
    i64 nlms = j;           /* == #LMS + 1 (sentinel) */
    /* names live in the unused upper region of SA (classic trick: LMS
     * positions are >= 2 apart, so p>>1 slots are unique and
     * nlms + (n-1)/2 < n) — avoids an 8n-byte name array */
    i64 *name_buf = SA + nlms;
    i64 name = 0, prev = -1;
    for (i = 0; i < nlms; i++) {
        i64 p = sorted[i];
        int diff = 0;
        if (prev < 0) {
            diff = 1;
        } else {
            for (j = 0;; j++) {
                i64 a = p + j, b = prev + j;
                if (a >= n || b >= n) { diff = 1; break; }
                if (chr_at(v, a) != chr_at(v, b) || ty[a] != ty[b]) {
                    diff = 1;
                    break;
                }
                if (j > 0 && (is_lms(ty, a) || is_lms(ty, b))) {
                    diff = !(is_lms(ty, a) && is_lms(ty, b));
                    break;
                }
            }
        }
        if (diff) { name++; prev = p; }
        name_buf[p >> 1] = name - 1;
    }

    /* reduced string (names of LMS positions in text order) compacted
     * into the TAIL of SA. Reverse scan: writes descend from SA[n-1]
     * while reads descend from name_buf[(n-1)>>1] = SA[nlms+(n-1)/2];
     * the write index stays >= the read index throughout (it ends at
     * n-nlms >= nlms), so no name is clobbered before it is read. */
    i64 *red = SA + (n - nlms);
    j = n - 1;
    for (i = n - 1; i >= 0; i--) {
        if (i == n - 1 || is_lms(ty, i)) SA[j--] = name_buf[i >> 1];
    }

    /* recursion: reduced SA built in the HEAD of SA */
    if (name < nlms) {
        struct view rv = { red, 1 };
        int rc = sais_rec(&rv, SA, nlms, name);
        if (rc != 0) { free(ty); free(B); return rc; }
    } else {
        for (i = 0; i < nlms; i++) SA[red[i]] = i;
    }

    /* rebuild LMS text positions (text order) into the tail, overwriting
     * the reduced string, then map reduced ranks -> text positions */
    j = n - nlms;
    for (i = 0; i < n; i++) {
        if (i == n - 1 || is_lms(ty, i)) SA[j++] = i;
    }
    for (i = 0; i < nlms; i++) SA[i] = SA[(n - nlms) + SA[i]];

    /* ---- step 3: place sorted LMS, induce final SA ----
     * SA[0..nlms) holds LMS text positions in sorted order; clear the
     * rest and scatter from the highest rank down — each target bucket
     * slot is >= the source slot, so nothing unread is overwritten. */
    for (i = nlms; i < n; i++) SA[i] = -1;
    bucket_bounds(v, n, K, B, 1);
    for (i = nlms - 1; i >= 1; i--) {      /* rank 0 == sentinel */
        i64 p = SA[i];
        SA[i] = -1;
        SA[--B[chr_at(v, p)]] = p;
    }
    SA[0] = n - 1;
    induce(v, ty, SA, n, K, B);

    free(ty); free(B);
    return 0;
}

int sais_u8(const uint8_t *T, i64 *SA, i64 n, i64 K) {
    if (n < 0 || K <= 0 || K > 256) return -1;
    struct view v = { T, 0 };
    return sais_rec(&v, SA, n, K);
}

int sais_int64(const i64 *T, i64 *SA, i64 n, i64 K) {
    if (n < 0 || K <= 0) return -1;
    struct view v = { T, 1 };
    return sais_rec(&v, SA, n, K);
}

/* ---------------- uint32 variant (n < 2^32 - 1) ----------------
 *
 * Same algorithm with 4-byte indexes: halves the SA / scratch memory AND
 * the random-access DRAM traffic, which dominates genome-scale builds.
 * Covers every ".bt2l"-scale genome up to ~4.29 Gbp (GRCh38 is 3.1), so
 * the int64 path above is only needed beyond that. EMPTY32 replaces the
 * -1 hole marker. */

typedef uint32_t u32;
#define EMPTY32 0xFFFFFFFFu

struct view32 {
    const void *T;
    int wide;        /* 0: uint8_t, 1: u32 */
};

static inline u32 chr_at32(const struct view32 *v, u32 i) {
    return v->wide ? ((const u32 *)v->T)[i] : ((const uint8_t *)v->T)[i];
}

static void bucket_bounds32(const struct view32 *v, u32 n, u32 K, u32 *B,
                            int ends) {
    u32 i;
    u32 *cnt = (u32 *)calloc((size_t)K, sizeof(u32));
    for (i = 0; i < n; i++) cnt[chr_at32(v, i)]++;
    u32 sum = 0;
    for (i = 0; i < K; i++) {
        sum += cnt[i];
        B[i] = ends ? sum : sum - cnt[i];
    }
    free(cnt);
}

static void induce32(const struct view32 *v, unsigned char *ty, u32 *SA,
                     u32 n, u32 K, u32 *B) {
    u32 i;
    i64 ii;
    bucket_bounds32(v, n, K, B, 0);
    for (i = 0; i < n; i++) {
        u32 j = SA[i];
        if (j != EMPTY32 && j > 0 && ty[j - 1] == L_TYPE)
            SA[B[chr_at32(v, j - 1)]++] = j - 1;
    }
    bucket_bounds32(v, n, K, B, 1);
    for (ii = (i64)n - 1; ii >= 0; ii--) {
        u32 j = SA[ii];
        if (j != EMPTY32 && j > 0 && ty[j - 1] == S_TYPE)
            SA[--B[chr_at32(v, j - 1)]] = j - 1;
    }
}

static int sais_rec32(const struct view32 *v, u32 *SA, u32 n, u32 K) {
    u32 i, j;
    i64 ii;
    if (n == 0) return 0;
    if (n == 1) { SA[0] = 0; return 0; }

    unsigned char *ty = (unsigned char *)malloc((size_t)n);
    u32 *B = (u32 *)malloc((size_t)K * sizeof(u32));
    if (!ty || !B) { free(ty); free(B); return -2; }

    ty[n - 1] = S_TYPE;
    for (ii = (i64)n - 2; ii >= 0; ii--) {
        u32 c0 = chr_at32(v, (u32)ii), c1 = chr_at32(v, (u32)ii + 1);
        ty[ii] = (c0 < c1 || (c0 == c1 && ty[ii + 1] == S_TYPE))
                     ? S_TYPE : L_TYPE;
    }

    /* step 1: sort LMS substrings by one induction round */
    for (i = 0; i < n; i++) SA[i] = EMPTY32;
    bucket_bounds32(v, n, K, B, 1);
    for (ii = (i64)n - 1; ii > 0; ii--) {
        if (is_lms(ty, ii)) SA[--B[chr_at32(v, (u32)ii)]] = (u32)ii;
    }
    SA[0] = n - 1;
    induce32(v, ty, SA, n, K, B);

    /* step 2: name LMS substrings in sorted order */
    u32 *sorted = SA;
    j = 0;
    for (i = 0; i < n; i++) {
        u32 p = SA[i];
        if (p == n - 1 || is_lms(ty, p)) sorted[j++] = p;
    }
    u32 nlms = j;
    u32 *name_buf = SA + nlms;      /* p>>1 slots, same in-SA trick */
    u32 name = 0, prev = EMPTY32;
    for (i = 0; i < nlms; i++) {
        u32 p = sorted[i];
        int diff = 0;
        if (prev == EMPTY32) {
            diff = 1;
        } else {
            for (j = 0;; j++) {
                u32 a = p + j, b = prev + j;
                if (a >= n || b >= n) { diff = 1; break; }
                if (chr_at32(v, a) != chr_at32(v, b) || ty[a] != ty[b]) {
                    diff = 1;
                    break;
                }
                if (j > 0 && (is_lms(ty, a) || is_lms(ty, b))) {
                    diff = !(is_lms(ty, a) && is_lms(ty, b));
                    break;
                }
            }
        }
        if (diff) { name++; prev = p; }
        name_buf[p >> 1] = name - 1;
    }

    /* reduced string compacted into the TAIL of SA (reverse scan: the
     * descending write index stays >= the descending read index, ending
     * at n-nlms >= nlms, so no unread name is clobbered) */
    u32 *red = SA + (n - nlms);
    ii = (i64)n - 1;
    for (i64 t = (i64)n - 1; t >= 0; t--) {
        if (t == (i64)n - 1 || is_lms(ty, t))
            SA[ii--] = name_buf[(u32)t >> 1];
    }

    /* recursion: reduced SA built in the HEAD of SA */
    if (name < nlms) {
        struct view32 rv = { red, 1 };
        int rc = sais_rec32(&rv, SA, nlms, name);
        if (rc != 0) { free(ty); free(B); return rc; }
    } else {
        for (i = 0; i < nlms; i++) SA[red[i]] = i;
    }

    /* rebuild LMS text positions into the tail (overwrites the reduced
     * string), then map reduced ranks -> text positions */
    ii = (i64)n - (i64)nlms;
    for (i64 t = 0; t < (i64)n; t++) {
        if (t == (i64)n - 1 || is_lms(ty, t)) SA[ii++] = (u32)t;
    }
    for (i = 0; i < nlms; i++) SA[i] = SA[(n - nlms) + SA[i]];

    /* step 3: place sorted LMS, induce final SA (scatter from the
     * highest rank down — target slots are >= source slots) */
    for (ii = (i64)nlms; ii < (i64)n; ii++) SA[ii] = EMPTY32;
    bucket_bounds32(v, n, K, B, 1);
    for (ii = (i64)nlms - 1; ii >= 1; ii--) {
        u32 p = SA[ii];
        SA[ii] = EMPTY32;
        SA[--B[chr_at32(v, p)]] = p;
    }
    SA[0] = n - 1;
    induce32(v, ty, SA, n, K, B);

    free(ty); free(B);
    return 0;
}

int sais_u8_32(const uint8_t *T, u32 *SA, i64 n, i64 K) {
    if (n < 0 || n >= (i64)EMPTY32 || K <= 0 || K > 256) return -1;
    struct view32 v = { T, 0 };
    return sais_rec32(&v, SA, (u32)n, (u32)K);
}
