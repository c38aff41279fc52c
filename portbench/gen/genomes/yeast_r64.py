"""Genome recipe `yeast_r64`: a synthetic stand-in for the S. cerevisiae
S288C reference R64 (sacCer3): 16 nuclear chromosomes and chrM at the
lengths the configuration's `refs` give, with yeast's base composition
and its dispersed repeat families planted as diverged copies of family
consensus sequences drawn from the genome seed.

Sources of the numbers below: the GC shares from the R64 assembly
(nuclear 38 %, mitochondrial 17 %); the Ty elements, their solo LTRs and
the tRNA genes from Kim et al., Genome Res. 8:464 (1998), the survey of
Ty elements in S288C, and SGD's annotation of R64; the rDNA unit
(RDN1, 9,137 bp, on chrXII near 451 kbp) and the Y' elements (long
class, about 6.7 kb) from SGD. R64 holds about 150 rDNA units in one
array; its assembly and the indexes users align to hold two.

Placement: the rDNA pair and the Y' elements first, at their places; then
every other copy uniformly over the nuclear chromosomes (a chromosome by
its length, a start uniform in it), never over a copy already placed, so
each copy lies whole in the sequence. A copy goes on either strand. Each
copy is its family's consensus with a share of its bases substituted,
drawn uniformly from the family's divergence range. chrM takes no copy.

The counts are R64's at its 12,071,326 nuclear bp; a genome of fewer
nuclear bases (the tests' cut) takes each count scaled by its share of
them, rounded, and at least one copy of each family. Codes 0..3
(A, C, G, T), int8.
"""

import numpy as np

NUCLEAR_GC = 0.38
MITO_GC = 0.17
MITO = "chrM"
R64_NUCLEAR_BP = 12_071_326

# (name, full-length copies, length in bp): Ty1/Ty2
# (one family here, as their LTRs and most of their internal sequence are
# shared), Ty4 and Ty3; each element is LTR + internal + the same LTR
TY_FAMILIES = (("Ty1_2", 45, 5_918), ("Ty4", 3, 6_226), ("Ty3", 2, 5_351))
TY_DIV = (0.005, 0.02)
LTR_LEN = 334
SOLO_LTRS = 280                 # solo deltas of the Ty1/Ty2 family's LTR
SOLO_LTR_DIV = (0.05, 0.15)
RDNA_UNIT = 9_137
RDNA_COPIES = 2                 # tandem, identical
RDNA_CHROM, RDNA_AT = "chrXII", 451_000
YPRIME_LEN = 6_700
YPRIME_COPIES = 19              # at chromosome ends, at most 1 % diverged
YPRIME_DIV = (0.0, 0.01)
YPRIME_FROM_END = 500           # a copy starts within this of its end
TRNA_LEN = 76
TRNA_GENES = 275
TRNA_FAMILIES = 42
TRNA_DIV = (0.01, 0.03)         # about 2 % on average


def background(rng, size, gc):
    """i.i.d. codes at a GC share."""
    return rng.choice(4, size, p=[(1 - gc) / 2, gc / 2, gc / 2,
                                  (1 - gc) / 2]).astype(np.int8)


def mutate(rng, consensus, div):
    """A copy of `consensus` with a share `div` of its bases substituted."""
    copy = consensus.copy()
    nmut = int(round(div * copy.size))
    if nmut:
        at = rng.choice(copy.size, nmut, replace=False)
        copy[at] = (copy[at] + rng.integers(1, 4, nmut)) % 4
    return copy


def scaled(count, share):
    return count if share >= 1.0 else max(1, int(round(count * share)))


def layout(rng, refs):
    """The genome and what was planted: ([(name, codes)],
    [(family, reference name, start, length)])."""
    seqs = [(name, background(rng, int(bp),
                              MITO_GC if name == MITO else NUCLEAR_GC))
            for name, bp in refs]
    nuclear = [i for i, (n, _c) in enumerate(seqs) if n != MITO]
    lens = np.array([seqs[i][1].size for i in nuclear], np.int64)
    share = float(lens.sum()) / R64_NUCLEAR_BP
    used = {i: np.zeros(seqs[i][1].size, bool) for i in nuclear}
    placed = []

    def put(family, i, start, codes):
        g = seqs[i][1]
        g[start:start + codes.size] = codes
        used[i][start:start + codes.size] = True
        placed.append((family, seqs[i][0], int(start), int(codes.size)))

    def strand(codes):
        return (3 - codes)[::-1] if rng.random() < 0.5 else codes

    def anywhere(family, codes):
        for _ in range(10_000):
            i = nuclear[int(rng.choice(len(nuclear), p=lens / lens.sum()))]
            room = seqs[i][1].size - codes.size
            if room <= 0:
                continue
            start = int(rng.integers(0, room))
            if not used[i][start:start + codes.size].any():
                put(family, i, start, codes)
                return
        raise ValueError(f"no free room for a {family} copy")

    # the rDNA pair on chrXII at its place, the Y' elements at ends
    rdna = background(rng, RDNA_UNIT, NUCLEAR_GC)
    names = [n for n, _c in seqs]
    if RDNA_CHROM in names:
        i = names.index(RDNA_CHROM)
        n = seqs[i][1].size
        # clear of a Y' element at the chromosome's right end
        last = n - RDNA_COPIES * RDNA_UNIT - YPRIME_FROM_END - YPRIME_LEN
        at = max(min(int(RDNA_AT * min(share, 1.0)), last), 0)
        put("rDNA", i, at, np.tile(rdna, RDNA_COPIES))
    yprime = background(rng, YPRIME_LEN, NUCLEAR_GC)
    ends = [(i, side) for i in nuclear for side in (0, 1)]
    pick = rng.choice(len(ends), scaled(YPRIME_COPIES, share), replace=False)
    for e in sorted(pick.tolist()):
        i, side = ends[e]
        copy = mutate(rng, yprime, rng.uniform(*YPRIME_DIV))
        off = int(rng.integers(0, YPRIME_FROM_END))
        if side == 0:
            put("Yprime", i, off, copy)
        else:          # pointing to the telomere, as at the left end
            put("Yprime", i, seqs[i][1].size - off - YPRIME_LEN,
                (3 - copy)[::-1])

    # full-length Ty elements, solo LTRs, tRNA genes
    delta = None
    for family, count, length in TY_FAMILIES:
        ltr = background(rng, LTR_LEN, NUCLEAR_GC)
        inner = background(rng, length - 2 * LTR_LEN, NUCLEAR_GC)
        delta = ltr if delta is None else delta
        consensus = np.concatenate([ltr, inner, ltr])
        for _ in range(scaled(count, share)):
            anywhere(family, strand(mutate(rng, consensus,
                                           rng.uniform(*TY_DIV))))
    for _ in range(scaled(SOLO_LTRS, share)):
        anywhere("solo_LTR", strand(mutate(rng, delta,
                                           rng.uniform(*SOLO_LTR_DIV))))
    trna = [background(rng, TRNA_LEN, NUCLEAR_GC)
            for _ in range(scaled(TRNA_FAMILIES, share))]
    for k in range(scaled(TRNA_GENES, share)):
        anywhere("tRNA", strand(mutate(rng, trna[k % len(trna)],
                                       rng.uniform(*TRNA_DIV))))
    return seqs, placed


def make(rng, refs):
    """[(name, codes)] of the configuration's `refs` ([name, bp] each)."""
    return layout(rng, refs)[0]
