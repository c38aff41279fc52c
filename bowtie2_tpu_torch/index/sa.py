"""Suffix-array construction.

The reference builds its SA with a Kärkkäinen blockwise sorter
(blockwise_sa.h:255) so index-build fits in bounded memory. We build the
whole SA in memory host-side: a NumPy prefix-doubling sorter for small/medium
genomes, with a C++ SA-IS extension (bowtie2_tpu_torch/native) taking over for
large genomes when built. The SA is an offline build-time artifact; nothing
here runs on the TPU.

The array returned is over T$ (sentinel appended, sentinel < every char):
sa[0] == len(T), and sa has length len(T)+1.
"""

import numpy as np


def suffix_array_doubling(text: np.ndarray) -> np.ndarray:
    """Suffix array of text (uint8 codes 0..3) + implicit sentinel.

    Prefix doubling (Manber-Myers) with numpy argsort; O(n log^2 n) but
    vectorized — fine up to tens of Mbp. Returns int64 array of length n+1
    whose first entry is n (the sentinel suffix).
    """
    n = int(text.size)
    if n == 0:
        return np.zeros(1, dtype=np.int64)
    # rank = char + 1 so the sentinel (conceptual rank 0 at position n) wins
    rank = (text.astype(np.int64) + 1)
    sa = None
    k = 1
    while True:
        # key = (rank[i], rank[i+k]) with rank past end = 0
        second = np.zeros(n, dtype=np.int64)
        second[: n - k] = rank[k:]
        key = rank * (n + 1) + second
        sa = np.argsort(key, kind="stable")
        # re-rank
        sorted_key = key[sa]
        new_rank = np.empty(n, dtype=np.int64)
        new_rank[sa] = np.cumsum(
            np.concatenate(([1], (sorted_key[1:] != sorted_key[:-1]).astype(np.int64)))
        )
        rank = new_rank
        if rank[sa[-1]] == n:  # all ranks distinct
            break
        k *= 2
        if k >= n:
            break
    full = np.empty(n + 1, dtype=np.int64)
    full[0] = n
    full[1:] = sa
    return full


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Dispatch: native SA-IS if the C++ extension is built, else doubling."""
    try:
        from bowtie2_tpu_torch.native import sais as _sais  # noqa: PLC0415
        return _sais.suffix_array(text)
    except Exception:
        return suffix_array_doubling(text)
