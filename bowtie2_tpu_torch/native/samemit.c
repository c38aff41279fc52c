/* samemit.c — batched CIGAR + MD:Z decoding of packed backtrace ops.
 *
 * Host-side native stage of the TPU pipeline: the device backtrace kernel
 * (ops/sw.py backtrace) returns one packed op byte per walk step
 * (op(2 bits) | refchar(3) | ismatch(1), walk order = read end -> start);
 * this translates each record's op column into its CIGAR and MD:Z strings,
 * including the leftmost-gap normalization of equal-score gap placements.
 * It replaces pipeline/backtrace.py cigar_md_from_packed (~100 us/record
 * of numpy) with ~1 us/record of C, the same role the reference's native
 * Edit/CIGAR machinery plays (edit.h/cpp Edit::printMD, aligner_bt.cpp).
 *
 * Build: see bowtie2_tpu_torch/native/__init__.py (cc -O3 -shared).
 */

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define OP_M 0
#define OP_I 1
#define OP_D 2
#define OP_NONE 3

static const char REF_CHARS[8] = "ACGTN???";

/* append an unsigned int as decimal */
static inline char *put_u32(char *p, uint32_t v) {
    char tmp[12];
    int n = 0;
    if (v == 0) { *p++ = '0'; return p; }
    while (v) { tmp[n++] = (char)('0' + v % 10); v /= 10; }
    while (n) *p++ = tmp[--n];
    return p;
}

/* Decode one record. ops_col walks read end -> read start with stride
 * `stride` between steps. Work buffers opsk/refc/ismatch must hold at
 * least `bound` entries. Returns 0, or -1 on overflow. */
static int decode_one(const uint8_t *ops_col, long stride, int bound,
                      int read_start, int read_end, int read_len,
                      const int8_t *read, int xeq,
                      uint8_t *opsk, uint8_t *refc, uint8_t *ismatch,
                      char *cigar, int cigar_cap,
                      char *md, int md_cap) {
    /* collect forward-order (5'->3') ops */
    int n = 0, has_gap = 0;
    for (int s = bound - 1; s >= 0; s--) {
        uint8_t b = ops_col[(long)s * stride];
        uint8_t op = b & 3;
        if (op == OP_NONE) continue;
        opsk[n] = op;
        refc[n] = (b >> 2) & 7;
        ismatch[n] = (b >> 5) & 1;
        if (op != OP_M) has_gap = 1;
        n++;
    }

    /* leftmost-gap normalization: shift each gap run left across preceding
     * matching Ms while the score is unchanged (repeat runs) — the
     * reference backtracer reports the leftmost equal-score variant. */
    if (has_gap) {
        int t = 0;
        while (t < n) {
            if (opsk[t] != OP_I && opsk[t] != OP_D) { t++; continue; }
            int e = t;
            while (e + 1 < n && opsk[e + 1] == opsk[t]) e++;
            int kind = opsk[t];
            while (t > 0 && opsk[t - 1] == OP_M && ismatch[t - 1]) {
                if (kind == OP_D) {
                    /* shifting a deletion run one left keeps the score
                     * only when the leading matched char equals the run's
                     * last deleted char; ref chars stay in place */
                    if (refc[t - 1] != refc[e]) break;
                    for (int q = t - 1; q < e; q++) opsk[q] = OP_D;
                    opsk[e] = OP_M;
                    ismatch[e] = 1;
                } else {
                    /* insertion: read position consumed by ops before t-1 */
                    int m_rpos = read_start;
                    for (int q = 0; q < t - 1; q++)
                        if (opsk[q] != OP_D) m_rpos++;
                    int after = m_rpos + (e - t + 1);
                    if (after >= read_len ||
                        (int)read[after] != (int)refc[t - 1]) break;
                    uint8_t mchar = refc[t - 1];
                    for (int q = t - 1; q < e; q++) {
                        opsk[q] = OP_I;
                        refc[q] = 0;
                    }
                    opsk[e] = OP_M;
                    refc[e] = mchar;
                    ismatch[e] = 1;
                }
                t--; e--;
            }
            t = e + 2;
        }
    }

    /* CIGAR: run-length with soft clips; --xeq splits M into '='/'X' */
    char *p = cigar, *pend = cigar + cigar_cap - 16;
    if (read_start > 0) { p = put_u32(p, (uint32_t)read_start); *p++ = 'S'; }
    int i = 0;
    while (i < n) {
        int j = i;
        int key = xeq && opsk[i] == OP_M ? ismatch[i] : 2;
        while (j + 1 < n && opsk[j + 1] == opsk[i] &&
               (xeq && opsk[i] == OP_M ? ismatch[j + 1] : 2) == key) j++;
        if (p >= pend) return -1;
        p = put_u32(p, (uint32_t)(j - i + 1));
        if (xeq && opsk[i] == OP_M)
            *p++ = ismatch[i] ? '=' : 'X';
        else
            *p++ = "MID"[opsk[i]];
        i = j + 1;
    }
    if (read_end < read_len) {
        p = put_u32(p, (uint32_t)(read_len - read_end));
        *p++ = 'S';
    }
    *p = 0;

    /* MD:Z — match run lengths, mismatch ref chars, ^-runs for deletions;
     * insertions are invisible (reference Edit::printMD). */
    char *q = md, *qend = md + md_cap - 16;
    int run = 0, in_del = 0;
    for (i = 0; i < n; i++) {
        if (q >= qend) return -1;
        if (opsk[i] == OP_M) {
            if (ismatch[i]) { run++; in_del = 0; }
            else {
                q = put_u32(q, (uint32_t)run);
                *q++ = REF_CHARS[refc[i]];
                run = 0; in_del = 0;
            }
        } else if (opsk[i] == OP_D) {
            if (in_del && run == 0) {
                *q++ = REF_CHARS[refc[i]];
            } else {
                q = put_u32(q, (uint32_t)run);
                *q++ = '^';
                *q++ = REF_CHARS[refc[i]];
                run = 0;
            }
            in_del = 1;
        }
        /* OP_I: no MD output, and does not reset the match run */
    }
    q = put_u32(q, (uint32_t)run);
    *q = 0;
    return 0;
}

/* Batched entry point.
 * ops: (S, Bc) uint8, C-contiguous (stride Bc between walk steps).
 * cols/read_start/read_end/read_len/bound: (n,) int32 per record.
 * reads: (n, Lmax) int8 oriented read codes.
 * cigar_out/md_out: (n, *_stride) char buffers (NUL-terminated rows).
 * Returns 0 or the number of overflowed records (their rows are ""). */
int cigar_md_batch(const uint8_t *ops, int64_t S, int64_t Bc,
                   const int32_t *cols, const int32_t *read_start,
                   const int32_t *read_end, const int32_t *read_len,
                   const int32_t *bound, const int8_t *reads, int64_t Lmax,
                   int64_t n, int xeq,
                   char *cigar_out, int64_t cigar_stride,
                   char *md_out, int64_t md_stride) {
    int bad = 0;
    /* work buffers sized by the max possible walk length */
    enum { MAXOPS = 32768 };
    uint8_t opsk[MAXOPS], refc[MAXOPS], ismatch[MAXOPS];
    for (int64_t r = 0; r < n; r++) {
        int b = bound[r];
        if (b > (int)S) b = (int)S;
        if (b > MAXOPS) { bad++; cigar_out[r * cigar_stride] = 0;
                          md_out[r * md_stride] = 0; continue; }
        if (decode_one(ops + cols[r], Bc, b, read_start[r], read_end[r],
                       read_len[r], reads + r * Lmax, xeq,
                       opsk, refc, ismatch,
                       cigar_out + r * cigar_stride, (int)cigar_stride,
                       md_out + r * md_stride, (int)md_stride) != 0) {
            bad++;
            cigar_out[r * cigar_stride] = 0;
            md_out[r * md_stride] = 0;
        }
    }
    return bad;
}

/* ---------------- full SAM line assembly ---------------- */

static const char SEQ_CHARS[16] = "ACGTN???????????";

static inline char *put_i32(char *p, int32_t v) {
    if (v < 0) { *p++ = '-'; return put_u32(p, (uint32_t)(-(int64_t)v)); }
    return put_u32(p, (uint32_t)v);
}

/* Build SAM line tails (everything after QNAME) for n records.
 *
 * mode[r]: 0 = unaligned, 1 = aligned, 2..5 = unaligned + filter reason
 * YF:Z:{NS,LN,QC,SC} (reference aligner_result.cpp:1097-1101).
 * rname_i[r]: index into the refnames table (aligned records).
 * opt_xs[r]: INT32_MIN means "omit XS".
 * codes/quals: (n, Lmax) oriented read codes / phred quals.
 * ops/cols/...: backtrace op columns for aligned records (see
 * cigar_md_batch). suffix: constant tail appended to every line (e.g.
 * "\tRG:Z:grp"). out: (n, stride) char rows; outlen[r] = bytes written.
 * Returns number of records that overflowed their row (their len = 0). */
int sam_tails_batch(const int8_t *mode,
                    const int32_t *flag, const int32_t *rname_i,
                    const int32_t *pos, const int32_t *mapq,
                    const int32_t *opt_as, const int32_t *opt_xs,
                    const int32_t *xn, const int32_t *xm,
                    const int32_t *xo, const int32_t *xg,
                    const int8_t *codes, const int8_t *quals,
                    const int32_t *rdlen, int64_t Lmax,
                    const uint8_t *ops, int64_t S, int64_t Bc,
                    const int32_t *cols, const int32_t *read_start,
                    const int32_t *read_end, const int32_t *bound,
                    const char *names, const int32_t *name_off,
                    const char *suffix, int64_t n, int xeq,
                    char *out, int64_t stride, int32_t *outlen) {
    enum { MAXOPS = 32768 };
    /* per-call scratch (malloc'd, ~460 KB): BatchAligner.align_batch is
     * documented thread-safe, so no function-static state here */
    uint8_t *scratch = (uint8_t *)malloc(3 * MAXOPS + 2 * (4 * MAXOPS + 64));
    if (!scratch) return (int)n;
    uint8_t *opsk = scratch, *refc = scratch + MAXOPS,
            *ismatch = scratch + 2 * MAXOPS;
    char *cig = (char *)(scratch + 3 * MAXOPS);
    char *md = cig + 4 * MAXOPS + 64;
    int bad = 0;
    size_t suffix_len = strlen(suffix);
    for (int64_t r = 0; r < n; r++) {
        char *p = out + r * stride;
        char *pend = p + stride - 80 - suffix_len;
        int L = rdlen[r];
        if (2 * L + 160 + (int)suffix_len > stride) { outlen[r] = 0; bad++; continue; }
        *p++ = '\t';
        p = put_i32(p, flag[r]); *p++ = '\t';
        if (mode[r] == 1) {
            const char *nm = names + name_off[rname_i[r]];
            size_t nl = name_off[rname_i[r] + 1] - name_off[rname_i[r]];
            memcpy(p, nm, nl); p += nl; *p++ = '\t';
            p = put_i32(p, pos[r]); *p++ = '\t';
            p = put_i32(p, mapq[r]); *p++ = '\t';
            int b = bound[r] < (int)S ? bound[r] : (int)S;
            if (b > MAXOPS ||
                decode_one(ops + cols[r], Bc, b, read_start[r], read_end[r],
                           L, codes + r * Lmax, xeq, opsk, refc, ismatch,
                           cig, 4 * MAXOPS + 64, md, 4 * MAXOPS + 64) != 0) {
                outlen[r] = 0; bad++; continue;
            }
            size_t cl = strlen(cig);
            if (p + cl + strlen(md) + 2 * L + 120 > pend) { outlen[r] = 0; bad++; continue; }
            memcpy(p, cig, cl); p += cl;
            memcpy(p, "\t*\t0\t0\t", 7); p += 7;
        } else {
            memcpy(p, "*\t0\t0\t*\t*\t0\t0\t", 14); p += 14;
        }
        const int8_t *cd = codes + r * Lmax;
        for (int k = 0; k < L; k++) *p++ = SEQ_CHARS[cd[k] & 15];
        *p++ = '\t';
        const int8_t *q = quals + r * Lmax;
        for (int k = 0; k < L; k++) *p++ = (char)(q[k] + 33);
        if (mode[r] == 1) {
            memcpy(p, "\tAS:i:", 6); p += 6;
            p = put_i32(p, opt_as[r]);
            if (opt_xs[r] != INT32_MIN) {
                memcpy(p, "\tXS:i:", 6); p += 6;
                p = put_i32(p, opt_xs[r]);
            }
            memcpy(p, "\tXN:i:", 6); p += 6; p = put_i32(p, xn[r]);
            memcpy(p, "\tXM:i:", 6); p += 6; p = put_i32(p, xm[r]);
            memcpy(p, "\tXO:i:", 6); p += 6; p = put_i32(p, xo[r]);
            memcpy(p, "\tXG:i:", 6); p += 6; p = put_i32(p, xg[r]);
            memcpy(p, "\tNM:i:", 6); p += 6; p = put_i32(p, xm[r] + xg[r]);
            memcpy(p, "\tMD:Z:", 6); p += 6;
            size_t ml = strlen(md); memcpy(p, md, ml); p += ml;
            memcpy(p, "\tYT:Z:UU", 8); p += 8;
        } else {
            memcpy(p, "\tYT:Z:UU", 8); p += 8;
            if (mode[r] >= 2 && mode[r] <= 5) {
                static const char *YF[4] = { "NS", "LN", "QC", "SC" };
                memcpy(p, "\tYF:Z:", 6); p += 6;
                memcpy(p, YF[mode[r] - 2], 2); p += 2;
            }
        }
        memcpy(p, suffix, suffix_len); p += suffix_len;
        outlen[r] = (int32_t)(p - (out + r * stride));
    }
    free(scratch);
    return bad;
}

/* ---------------- read padding ---------------- */

/* Scatter concatenated read codes/quals into padded (B, Lmax) batch
 * arrays + build reverse complements. Replaces the numpy fancy-index
 * scatter in pipeline/align.py pad_reads (~115ms/10k reads -> ~3ms). */
void pad_reads_c(const int8_t *allseq, const int8_t *allq,
                 const int64_t *starts, const int32_t *lens,
                 int64_t B, int64_t Lmax,
                 int8_t *fw, int8_t *qu, int8_t *rc, int8_t *qu_r) {
    for (int64_t b = 0; b < B; b++) {
        int64_t L = lens[b];
        const int8_t *s = allseq + starts[b];
        const int8_t *q = allq + starts[b];
        int8_t *f = fw + b * Lmax, *fq = qu + b * Lmax;
        int8_t *r = rc + b * Lmax, *rq = qu_r + b * Lmax;
        memcpy(f, s, L);
        memset(f + L, 4, Lmax - L);
        memcpy(fq, q, L);
        memset(fq + L, 0, Lmax - L);
        for (int64_t k = 0; k < L; k++) {
            int8_t c = s[L - 1 - k];
            r[k] = c < 4 ? (int8_t)(3 - c) : (int8_t)4;
            rq[k] = q[L - 1 - k];
        }
        memset(r + L, 4, Lmax - L);
        memset(rq + L, 0, Lmax - L);
    }
}

/* ---------------- paired-end SAM tail builder ----------------
 *
 * Builds everything after QNAME for PE records: decodes CIGAR/MD from
 * packed walk-op columns (device backtrace output or the host's gapless
 * synthesis — same byte layout), plus the PE columns the unpaired builder
 * lacks: RNEXT/PNEXT/TLEN, YS:i and the YT:Z pair-class.
 *
 *   mode: 0 unaligned, 1 aligned, 2..5 unaligned + YF:Z:{NS,LN,QC,SC}
 *   rname_i / rnext_i: -1 -> '*', -2 -> '=', else name-table index
 *   opt_xs / ys: INT32_MIN -> omit
 *   yt: 0 UU, 1 CP, 2 DP, 3 UP
 * Unaligned records with rname_i >= 0 print the mate-echo convention
 * (RNAME/POS from the arrays, MAPQ 0, CIGAR '*'). */
int sam_tails_pe(const int8_t *mode,
                 const int32_t *flag, const int32_t *rname_i,
                 const int32_t *pos, const int32_t *mapq,
                 const int32_t *rnext_i, const int32_t *pnext,
                 const int32_t *tlen,
                 const int32_t *opt_as, const int32_t *opt_xs,
                 const int32_t *xn, const int32_t *xm,
                 const int32_t *xo, const int32_t *xg,
                 const int32_t *ys, const int8_t *yt,
                 const int8_t *codes, const int8_t *quals,
                 const int32_t *rdlen, int64_t Lmax,
                 const uint8_t *ops, int64_t S, int64_t Bc,
                 const int32_t *cols, const int32_t *read_start,
                 const int32_t *read_end, const int32_t *bound,
                 const char *names, const int32_t *name_off,
                 const char *suffix, int64_t n, int xeq,
                 char *out, int64_t stride, int32_t *outlen) {
    static const char *YT[4] = { "UU", "CP", "DP", "UP" };
    static const char *YF[4] = { "NS", "LN", "QC", "SC" };
    enum { MAXOPS = 32768 };
    uint8_t *scratch = (uint8_t *)malloc(3 * MAXOPS + 2 * (4 * MAXOPS + 64));
    if (!scratch) return (int)n;
    uint8_t *opsk = scratch, *refc = scratch + MAXOPS,
            *ismatch = scratch + 2 * MAXOPS;
    char *cig = (char *)(scratch + 3 * MAXOPS);
    char *md = cig + 4 * MAXOPS + 64;
    int bad = 0;
    size_t suffix_len = strlen(suffix);
    for (int64_t r = 0; r < n; r++) {
        char *p = out + r * stride;
        char *pend = p + stride - 80 - suffix_len;
        int L = rdlen[r];
        if (2L * L + 200 + (long)suffix_len > stride) {
            outlen[r] = 0; bad++; continue;
        }
        *p++ = '\t';
        p = put_i32(p, flag[r]); *p++ = '\t';
        if (rname_i[r] >= 0) {
            const char *nm = names + name_off[rname_i[r]];
            size_t nl = name_off[rname_i[r] + 1] - name_off[rname_i[r]];
            memcpy(p, nm, nl); p += nl; *p++ = '\t';
            p = put_i32(p, pos[r]); *p++ = '\t';
            p = put_i32(p, mode[r] == 1 ? mapq[r] : 0); *p++ = '\t';
        } else {
            memcpy(p, "*\t0\t0\t", 6); p += 6;
        }
        long cl = 0, ml = 0;
        if (mode[r] == 1) {
            int b = bound[r] < (int)S ? bound[r] : (int)S;
            if (b > MAXOPS ||
                decode_one(ops + cols[r], Bc, b, read_start[r], read_end[r],
                           L, codes + r * Lmax, xeq, opsk, refc, ismatch,
                           cig, 4 * MAXOPS + 64, md, 4 * MAXOPS + 64) != 0) {
                outlen[r] = 0; bad++; continue;
            }
            cl = (long)strlen(cig);
            ml = (long)strlen(md);
            if (p + cl + ml + 2L * L + 160 > pend) {
                outlen[r] = 0; bad++; continue;
            }
            memcpy(p, cig, cl); p += cl;
        } else {
            *p++ = '*';
        }
        *p++ = '\t';
        if (rnext_i[r] == -2) { *p++ = '='; }
        else if (rnext_i[r] < 0) { *p++ = '*'; }
        else {
            const char *nm = names + name_off[rnext_i[r]];
            size_t nl = name_off[rnext_i[r] + 1] - name_off[rnext_i[r]];
            memcpy(p, nm, nl); p += nl;
        }
        *p++ = '\t';
        p = put_i32(p, pnext[r]); *p++ = '\t';
        p = put_i32(p, tlen[r]); *p++ = '\t';
        const int8_t *cd = codes + r * Lmax;
        for (int k = 0; k < L; k++) *p++ = SEQ_CHARS[cd[k] & 15];
        *p++ = '\t';
        const int8_t *q = quals + r * Lmax;
        for (int k = 0; k < L; k++) *p++ = (char)(q[k] + 33);
        if (mode[r] == 1) {
            memcpy(p, "\tAS:i:", 6); p += 6; p = put_i32(p, opt_as[r]);
            if (opt_xs[r] != INT32_MIN) {
                memcpy(p, "\tXS:i:", 6); p += 6; p = put_i32(p, opt_xs[r]);
            }
            memcpy(p, "\tXN:i:", 6); p += 6; p = put_i32(p, xn[r]);
            memcpy(p, "\tXM:i:", 6); p += 6; p = put_i32(p, xm[r]);
            memcpy(p, "\tXO:i:", 6); p += 6; p = put_i32(p, xo[r]);
            memcpy(p, "\tXG:i:", 6); p += 6; p = put_i32(p, xg[r]);
            memcpy(p, "\tNM:i:", 6); p += 6; p = put_i32(p, xm[r] + xg[r]);
            memcpy(p, "\tMD:Z:", 6); p += 6;
            memcpy(p, md, ml); p += ml;
            if (ys[r] != INT32_MIN) {
                memcpy(p, "\tYS:i:", 6); p += 6; p = put_i32(p, ys[r]);
            }
            memcpy(p, "\tYT:Z:", 6); p += 6;
            memcpy(p, YT[yt[r] & 3], 2); p += 2;
        } else {
            if (ys[r] != INT32_MIN) {
                memcpy(p, "\tYS:i:", 6); p += 6; p = put_i32(p, ys[r]);
            }
            memcpy(p, "\tYT:Z:", 6); p += 6;
            memcpy(p, YT[yt[r] & 3], 2); p += 2;
            if (mode[r] >= 2 && mode[r] <= 5) {
                memcpy(p, "\tYF:Z:", 6); p += 6;
                memcpy(p, YF[mode[r] - 2], 2); p += 2;
            }
        }
        memcpy(p, suffix, suffix_len); p += suffix_len;
        outlen[r] = (int32_t)(p - (out + r * stride));
    }
    free(scratch);
    return bad;
}
