"""Read recipe `art_pairs_adapter`: the model of `art_pairs`
(art_illumina-like FR pairs) over fragments that may be shorter than the
reads, as an Illumina library left untrimmed gives them. Where a
fragment is shorter than the read length, each mate reads through the
whole fragment into its TruSeq adapter, then into random bases.

Changes from `art_pairs`:
- fragments are N(frag_mean, frag_sd), floored at frag_min, not at the
  read length;
- each mate is laid out as sequenced: its fragment bases (mate 1 the
  forward strand from the fragment's start, mate 2 the reverse strand
  from its end), then its adapter (ADAPTER1, ADAPTER2: Illumina's
  adapter sequences document, TruSeq read 1 and read 2), then random
  bases;
- ART-like quals decay by the read's own cycle (mate 2's profile lower),
  and the quality-driven substitutions cover every base, the adapter
  too;
- a mate's origin is where its read-length footprint starts on the
  forward strand, so that the plain reference's band lies around the
  genomic part (for mate 2 of a short fragment, read_len - fragment
  bases before the fragment); both footprints lie inside one
  reference.

Pairs whose mates hold more than max_n Ns together are dropped.

Parameters: read_len, frag_mean, frag_sd, frag_min, max_n.
"""

import numpy as np

ADAPTER1 = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER2 = "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"


def _codes(s):
    return np.array(["ACGT".index(c) for c in s], np.int8)


def sim_pairs(rng, genome, n, L, fmean, fsd, fmin, max_n):
    """(c1, q1, c2, q2, origin1, origin2, frag) of up to n pairs, codes
    and quals as sequenced, quals as phred."""
    g = genome.codes
    frag = np.maximum(rng.normal(fmean, fsd, n).astype(np.int64), fmin)
    lead = max(L - fmin, 0)             # room for mate 2's footprint
    pos = genome.draw_starts(rng, n, lead + max(int(frag.max()), L) + 1) \
        + lead
    cyc = np.arange(L)
    qprof1 = np.clip(38 - cyc * 0.04 - rng.normal(0, 2, (n, L)), 2, 40)
    qprof2 = np.clip(36 - cyc * 0.05 - rng.normal(0, 2, (n, L)), 2, 40)

    def mate(first, step, comp, adapter, qprof):
        # cycle c reads the fragment base first + step * c while c < frag,
        # then the adapter, then random bases
        idx = first[:, None] + step * cyc[None, :]
        inside = cyc[None, :] < frag[:, None]
        codes = g[np.where(inside, idx, 0)].astype(np.int8)
        if comp:
            codes = np.where(codes < 4, 3 - codes, codes)
        past = np.clip(cyc[None, :] - frag[:, None], 0, None)
        after = np.where(past < adapter.size,
                         adapter[np.minimum(past, adapter.size - 1)],
                         rng.integers(0, 4, (n, L), np.int8))
        codes = np.where(inside, codes, after)
        q = qprof.astype(np.int64)
        err = rng.random((n, L)) < 10.0 ** (-q / 10.0)
        codes = np.where(err & (codes < 4),
                         (codes + rng.integers(1, 4, (n, L))) % 4, codes)
        return codes.astype(np.int8), q.astype(np.uint8)

    c1, q1 = mate(pos, 1, False, _codes(ADAPTER1), qprof1)
    c2, q2 = mate(pos + frag - 1, -1, True, _codes(ADAPTER2), qprof2)
    keep = ((c1 == 4).sum(1) + (c2 == 4).sum(1)) <= max_n
    return (c1[keep], q1[keep], c2[keep], q2[keep], pos[keep],
            (pos + frag - L)[keep], frag[keep])


def draw(rng, genome, n, p):
    """n pairs of reads (codes, quals, origin, strand)."""
    out = []
    while len(out) < n:
        want = n - len(out)
        c1, q1, c2, q2, p1, p2, _f = sim_pairs(
            rng, genome, int(want * 1.05) + 16, p["read_len"],
            p["frag_mean"], p["frag_sd"], p["frag_min"], p["max_n"])
        k = min(want, c1.shape[0])
        out += zip(zip(c1[:k].astype(np.uint8), q1[:k], p1[:k].tolist(),
                       [0] * k),
                   zip(c2[:k].astype(np.uint8), q2[:k], p2[:k].tolist(),
                       [1] * k))
    return out
