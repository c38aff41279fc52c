"""Reference-trajectory RNG replay for exact-multimap reads (SE).

The reference picks among equal-score alignments with a per-read LCG
(random_source.h) whose stream position at selection time depends on the
whole alignment trajectory. For reads whose reportable alignments all come
from the exact end-to-end sweep (>= 2 exact hits — once two perfect-score
alignments exist the -M score tightening stops every later phase), the
trajectory is fully determined by the two EE SA ranges:

  rnd.init(genRandSeed(read))                       bt2_search.cpp:3439
  1 draw:   fw/rc range order                       aligner_sw_driver.cpp:104
  Random1toN(width) per nonempty range              random_util.h:86
            (one u32 draw per resolved row; width-1 ranges draw nothing)
  stop at the ReportingState cap                    aln_sink.cpp areDone
            (mhits+1 = 51 by default; -k N stops at N; -a never)
  selectByScore: shuffle each equal-score streak    aln_sink.cpp:1477

Validated EXACT against the reference binary on 2/3/5-copy multimap
corpora (600/600 reads byte-identical choice; tests/test_rng_parity.py).

Imperfect multimap reads (best score < perfect) additionally consume
draws inside the 1mm/seed phases; that trajectory class is not replayed
yet — those reads keep the canonical deterministic choice.

CHARACTERIZED (round 3, via the oracle's --met counters on single
reads) for the 1mm-tie class: the reference's -M score TIGHTENING
(tighten=3, aligner_sw_driver.cpp:1449-1479) raises minsc to
secbest + (diff*3)/4 + 1 after the second equal-score alignment — for
a tie at score s < perfect that is s+1, so every later row FAILS, the
maxEeStreak(15) fail streak ends the 1mm phase after exactly
2 successes + 15 fails = 17 row draws, and the read proceeds into the
SEED phase (whose rankSeedHits + WeightedRandomSampler + per-attempt
Random1toN draws are the remaining unmodeled pieces; a constant-K fit
explains ~2/3 of reads, so the variance is in those samplers). Exact
ties at the PERFECT score do NOT tighten past perfect (minsc++ is
gated on minsc < perfectScore) — which is why the exact-multimap layer
above needs no stopping rule other than the -M cap.
"""

from typing import List, Optional, Tuple

import numpy as np

from bowtie2_tpu_torch.pipeline.rng import (RefRng, Random1toN, gen_rand_seed,
                                      select_by_score)

EE_MAXELT = 400        # maxIters: EE-phase element cap (bt2_search.cpp:464)


def replay_ee_read(seed: int, w_fw: int, w_rc: int,
                   ok_fw: np.ndarray, ok_rc: np.ndarray,
                   khits: int, mhits: int, all_hits: bool,
                   order_draw: bool = True
                   ) -> Optional[Tuple[List[Tuple[int, int]], List[int],
                                       bool]]:
    """Replay one read's EE trajectory + selection.

    w_fw/w_rc: exact-sweep SA range widths per orientation; ok_fw/ok_rc:
    per-row straddle validity (row resolves inside one reference segment).
    khits/mhits: reporting params (mhits=0 => -k/-a mode, no -M cap).
    Returns (accumulated [(orient, elt)] in discovery order, selection
    permutation indices into it, maxed) or None if out of model scope.
    """
    tot = w_fw + w_rc
    if tot < 2 or tot > EE_MAXELT:
        return None
    rng = RefRng(seed)
    if order_draw:            # skipped when the EE phase had no hits
        rn = rng.next_u32() % tot
        fw_first = rn < w_fw
    else:
        fw_first = True
    mhits_set = mhits > 0 and not all_hits
    if all_hits:
        cap = 1 << 62
    elif mhits_set:
        cap = mhits + 1
    else:
        cap = khits
    acc: List[Tuple[int, int]] = []
    done = False
    for ori in ((0, 1) if fw_first else (1, 0)):
        if done:
            break
        w = w_fw if ori == 0 else w_rc
        ok = ok_fw if ori == 0 else ok_rc
        if w == 0:
            continue
        # withoutReplacement = the -a flag (rands_.init(width, all)); for
        # widths >= 128 without -a, Random1toN runs in seen-list mode with
        # DIFFERENT (variable) draw consumption
        r1n = Random1toN(w, without_replacement=all_hits)
        for _ in range(w):
            elt = r1n.next(rng)
            if ok[elt]:
                acc.append((ori, elt))
                if len(acc) >= cap:
                    done = True
                    break
    if len(acc) < 1:
        return None
    maxed = mhits_set and len(acc) > mhits
    if maxed:
        nrep = 1
    elif all_hits:
        nrep = len(acc)
        # -a consumes one extra u32 per accumulated alignment between the
        # EE phase and selection (fitted exact on 2/3/5-copy corpora: the
        # all-mode extend loop draws once per element it revisits)
        for _ in range(len(acc)):
            rng.next_u32()
    else:
        nrep = min(len(acc), khits)
    perm = select_by_score([0] * len(acc), nrep, rng)
    return acc, perm, maxed
