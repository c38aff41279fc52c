/*
 * End-row cells of the unbanded end-to-end DP, for the RNG-trajectory
 * replay (pipeline/seed_replay.py via replay_driver.py dp_cells): H[L, j]
 * for j in [0, R] and the start column of the best path into each cell.
 *
 * A line-for-line C transcription of sw_full_numpy_cells in
 * bowtie2_tpu/ops/sw.py (same int64 arithmetic, same tie rules), which
 * loops over columns in Python for every row; the replay calls it once
 * per visited seed hit.
 *
 * Build: see bowtie2_tpu_torch/native/__init__.py (cc -O3 -shared).
 */
#include <stdint.h>
#include <string.h>

#define NEG (-(INT64_C(1) << 29))

/* read/mm: (L,) codes and mismatch penalties; ref: (R,) codes 0..5;
 * H/HO: (R+1,) outputs; work: 6 * (R+1) int64 scratch. Returns 0. */
int dp_cells(const int64_t *read, const int64_t *mm, int64_t L,
             const int64_t *ref, int64_t R, int64_t match_bonus,
             int64_t n_pen, int64_t rdo, int64_t rde, int64_t rfo,
             int64_t rfe, int64_t gbar, int64_t *H, int64_t *HO,
             int64_t *work)
{
    const int64_t n = R + 1;
    const int64_t rgo = rdo + rde, fgo = rfo + rfe;
    int64_t *E = work, *EO = work + n, *Hn = work + 2 * n,
            *HOn = work + 3 * n, *En = work + 4 * n, *Eo = work + 5 * n;
    for (int64_t j = 0; j < n; ++j) {
        H[j] = 0;                       /* row 0: free start */
        E[j] = NEG;
        HO[j] = j;
        EO[j] = j;
    }
    for (int64_t i = 1; i <= L; ++i) {
        const int64_t rc = read[i - 1], pen = mm[i - 1];
        const int barred = (i - 1) < gbar || (L - i) < gbar;
        for (int64_t j = 0; j < n; ++j) {
            const int64_t ho = H[j] - fgo, ex = E[j] - rfe;
            Eo[j] = ho >= ex ? HO[j] : EO[j];
            En[j] = barred ? NEG : (ho > ex ? ho : ex);
        }
        /* diagonal: column 0 has none */
        Hn[0] = NEG > En[0] ? NEG : En[0];
        HOn[0] = NEG >= En[0] ? 0 : Eo[0];
        for (int64_t j = 1; j < n; ++j) {
            const int64_t c = ref[j - 1];
            int64_t sub;
            if (rc >= 5)
                sub = NEG / 2;
            else if (rc >= 4)
                sub = -n_pen;
            else if (c >= 5)
                sub = NEG / 2;
            else if (c == 4)
                sub = -n_pen;
            else
                sub = c == rc ? match_bonus : -pen;
            const int64_t dg = H[j - 1] + sub;
            Hn[j] = dg > En[j] ? dg : En[j];
            HOn[j] = dg >= En[j] ? HO[j - 1] : Eo[j];
        }
        /* read gap F: sequential scan, an open wins ties */
        int64_t fv = NEG, fvo = 0;
        for (int64_t j = 1; j < n; ++j) {
            const int64_t op = Hn[j - 1] - rgo, ex = fv - rde;
            if (op >= ex) {
                fv = op;
                fvo = HOn[j - 1];
            } else {
                fv = ex;
            }
            if (barred)
                fv = NEG;
            if (fv > Hn[j]) {
                Hn[j] = fv;
                HOn[j] = fvo;
            }
        }
        memcpy(H, Hn, n * sizeof(int64_t));
        memcpy(HO, HOn, n * sizeof(int64_t));
        memcpy(E, En, n * sizeof(int64_t));
        memcpy(EO, Eo, n * sizeof(int64_t));
    }
    return 0;
}
