"""Paired-end geometry policy (copy of bowtie2_tpu/pipeline/pe.py, with
the device classifier in torch).

Port of the reference's PairedEndPolicy classification semantics
(pe.h:34-121 pePolicyCompat, pe.cpp:37-137 peClassifyPair): given two mate
alignments' exact reference extents and strands, classify the pair as
concordant (normal / overlap / containment / dovetail) or discordant under
the -I/-X fragment limits and the --fr/--rf/--ff orientation policy.

Defaults mirror the reference: overlap OK, containment OK, dovetail NOT OK
(bt2_search.cpp gOlapMatesOK/gContainMatesOK true, gDovetailMatesOK false).
"""

from typing import Tuple

import torch

PE_NORMAL, PE_OVERLAP, PE_CONTAIN, PE_DOVETAIL, PE_DISCORD = 1, 2, 3, 4, 5


def pe_classify(policy: str,
                lo1: int, hi1: int, fw1: bool,
                lo2: int, hi2: int, fw2: bool,
                minfrag: int, maxfrag: int,
                olap_ok: bool = True, contain_ok: bool = True,
                dovetail_ok: bool = False,
                expand_to_fit: bool = True) -> int:
    """Classify one candidate pair. Extents are inclusive global coords.

    Mirrors peClassifyPair (pe.cpp:37): orientation compat, fragment-length
    limits, then overlap/containment/dovetail categorization.
    """
    len1 = hi1 - lo1 + 1
    len2 = hi2 - lo2 + 1
    if expand_to_fit:
        maxfrag = max(maxfrag, len1, len2)
    minfrag = max(minfrag, 1)

    if policy == "ff":
        if fw1 != fw2:
            return PE_DISCORD
        one_left = fw1
    elif policy == "rr":
        if fw1 != fw2:
            return PE_DISCORD
        one_left = not fw1
    elif policy == "fr":
        if fw1 == fw2:
            return PE_DISCORD
        one_left = fw1
    elif policy == "rf":
        if fw1 == fw2:
            return PE_DISCORD
        one_left = not fw1
    else:
        raise ValueError(policy)

    frag = max(hi1, hi2) - min(lo1, lo2) + 1
    if frag > maxfrag or frag < minfrag:
        return PE_DISCORD

    containment = (lo1 >= lo2 and hi1 <= hi2) or (lo2 >= lo1 and hi2 <= hi1)
    typ = PE_NORMAL
    olap = containment or (lo1 <= lo2 <= hi1) or (lo1 <= hi2 <= hi1)
    if olap:
        if not olap_ok:
            return PE_DISCORD
        typ = PE_OVERLAP
    else:
        # wrong relative order without overlap
        if (one_left and lo2 < lo1) or (not one_left and lo1 < lo2):
            return PE_DISCORD
    if containment:
        if not contain_ok:
            return PE_DISCORD
        typ = PE_CONTAIN
    if (one_left and (hi1 > hi2 or lo2 < lo1)) or \
       (not one_left and (hi2 > hi1 or lo1 < lo2)):
        if not dovetail_ok:
            return PE_DISCORD
        typ = PE_DOVETAIL
    return typ


def rescue_window(policy: str, alo: int, ahi: int, afw: bool,
                  anchor_is_mate1: bool, maxfrag: int) -> Tuple[int, int, bool]:
    """Window for the opposite mate's DP given one anchored mate.

    Equivalent role to PairedEndPolicy::otherMate (pe.cpp:161): returns
    (win_lo, win_hi_exclusive, opp_fw) such that every concordant placement
    of the opposite mate lies within the window with that orientation.
    """
    if policy in ("fr", "rf"):
        opp_fw = not afw
    else:
        opp_fw = afw
    if policy == "fr":
        anchor_left = afw
    elif policy == "rf":
        anchor_left = not afw
    elif policy == "ff":
        anchor_left = afw == anchor_is_mate1 or not anchor_is_mate1 and not afw
        # FF: mate1 left iff both fw; anchor left iff (fw and mate1) or
        # (rc and mate2)
        anchor_left = (afw and anchor_is_mate1) or (not afw and not anchor_is_mate1)
    else:  # rr
        anchor_left = (not afw and anchor_is_mate1) or (afw and not anchor_is_mate1)
    if anchor_left:
        return alo, alo + maxfrag, opp_fw
    return ahi - maxfrag + 1, ahi + 1, opp_fw


def pe_classify_np(policy, lo1, hi1, fw1, lo2, hi2, fw2,
                   minfrag: int, maxfrag: int,
                   olap_ok: bool = True, contain_ok: bool = True,
                   dovetail_ok: bool = False,
                   expand_to_fit: bool = True):
    """Vectorized pe_classify over numpy arrays (broadcastable shapes).

    Element-for-element identical to the scalar pe_classify (tested); used
    by the fused PE path to classify whole (pairs, T, T) candidate
    cross-products at once instead of per-pair Python loops."""
    import numpy as np
    lo1, hi1, lo2, hi2 = (np.asarray(a, np.int64) for a in (lo1, hi1, lo2, hi2))
    fw1 = np.asarray(fw1, bool)
    fw2 = np.asarray(fw2, bool)
    len1 = hi1 - lo1 + 1
    len2 = hi2 - lo2 + 1
    mx = np.maximum(np.maximum(np.int64(maxfrag), len1), len2) \
        if expand_to_fit else np.int64(maxfrag)
    mn = max(minfrag, 1)

    if policy == "ff":
        compat = fw1 == fw2
        one_left = fw1
    elif policy == "rr":
        compat = fw1 == fw2
        one_left = ~fw1
    elif policy == "fr":
        compat = fw1 != fw2
        one_left = fw1
    elif policy == "rf":
        compat = fw1 != fw2
        one_left = ~fw1
    else:
        raise ValueError(policy)

    frag = np.maximum(hi1, hi2) - np.minimum(lo1, lo2) + 1
    ok = compat & (frag <= mx) & (frag >= mn)

    containment = ((lo1 >= lo2) & (hi1 <= hi2)) | \
                  ((lo2 >= lo1) & (hi2 <= hi1))
    olap = containment | ((lo1 <= lo2) & (lo2 <= hi1)) | \
        ((lo1 <= hi2) & (hi2 <= hi1))
    typ = np.full(np.broadcast(lo1, lo2, fw1, fw2).shape, PE_NORMAL,
                  np.int8)
    if not olap_ok:
        ok &= ~olap
    typ = np.where(olap, PE_OVERLAP, typ)
    wrong = ~olap & ((one_left & (lo2 < lo1)) | (~one_left & (lo1 < lo2)))
    ok &= ~wrong
    if not contain_ok:
        ok &= ~containment
    typ = np.where(containment, PE_CONTAIN, typ)
    dove = (one_left & ((hi1 > hi2) | (lo2 < lo1))) | \
           (~one_left & ((hi2 > hi1) | (lo1 < lo2)))
    if not dovetail_ok:
        ok &= ~dove
    typ = np.where(dove, PE_DOVETAIL, typ)
    return np.where(ok, typ, PE_DISCORD).astype(np.int8)


def pe_classify_torch(policy, lo1, hi1, fw1, lo2, hi2, fw2,
                      minfrag: int, maxfrag: int,
                      olap_ok: bool = True, contain_ok: bool = True,
                      dovetail_ok: bool = False,
                      expand_to_fit: bool = True) -> torch.Tensor:
    """pe_classify_np on torch tensors (the device-side fused-PE pairing;
    bowtie2_tpu/pipeline/pe.py pe_classify_jnp). Extents are decoded
    global positions; fw1/fw2 bool tensors; broadcastable shapes. Returns
    int8 as the JAX version does."""
    len1 = hi1 - lo1 + 1
    len2 = hi2 - lo2 + 1
    mx = torch.clamp(torch.maximum(len1, len2), min=maxfrag) \
        if expand_to_fit else maxfrag
    mn = max(minfrag, 1)

    if policy == "ff":
        compat = fw1 == fw2
        one_left = fw1
    elif policy == "rr":
        compat = fw1 == fw2
        one_left = ~fw1
    elif policy == "fr":
        compat = fw1 != fw2
        one_left = fw1
    elif policy == "rf":
        compat = fw1 != fw2
        one_left = ~fw1
    else:
        raise ValueError(policy)

    frag = torch.maximum(hi1, hi2) - torch.minimum(lo1, lo2) + 1
    ok = compat & (frag <= mx) & (frag >= mn)

    containment = ((lo1 >= lo2) & (hi1 <= hi2)) | \
                  ((lo2 >= lo1) & (hi2 <= hi1))
    olap = containment | ((lo1 <= lo2) & (lo2 <= hi1)) | \
        ((lo1 <= hi2) & (hi2 <= hi1))
    shape = torch.broadcast_shapes(lo1.shape, lo2.shape, fw1.shape, fw2.shape)
    typ = torch.full(shape, PE_NORMAL, dtype=torch.int8, device=lo1.device)
    if not olap_ok:
        ok = ok & ~olap
    typ = torch.where(olap, PE_OVERLAP, typ)
    wrong = ~olap & ((one_left & (lo2 < lo1)) | (~one_left & (lo1 < lo2)))
    ok = ok & ~wrong
    if not contain_ok:
        ok = ok & ~containment
    typ = torch.where(containment, PE_CONTAIN, typ)
    dove = (one_left & ((hi1 > hi2) | (lo2 < lo1))) | \
           (~one_left & ((hi2 > hi1) | (lo1 < lo2)))
    if not dovetail_ok:
        ok = ok & ~dove
    typ = torch.where(dove, PE_DOVETAIL, typ)
    return torch.where(ok, typ, PE_DISCORD).to(torch.int8)
