"""K10 PE, the device pairing (bowtie2_tpu_torch/ops/fused.py
_pe_pairing), on the CPU: the plain version (what CPU tensors take;
chip_smoke.py holds the kernel, csrc/pe_pairing.cu, to it on the card)
against the JAX package's `_pe_pairing` (bowtie2_tpu/ops/fused.py:721)
called directly on every `ops/cases.py` pairing_cases case: the four
policies, `limit` None and an int, pairs under the zero-seed-round
suppression with need_mm1, tied scores (the first-index argmax and
argmin), T = 1, 8, 15, 16, 17 and 32 slots (the kernel's two-pairs-a-warp
and one-pair-a-warp forms, each with dead slots) at odd pair counts, and
int64 extents past 2^31 (with jax_enable_x64, put back after).
Tolerance: exact (int32 fields)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from bowtie2_tpu.ops import fused as jfused  # noqa: E402
from bowtie2_tpu_torch.ops import _build, cases  # noqa: E402
from bowtie2_tpu_torch.ops import fused as pfused  # noqa: E402

SMALL = cases.pairing_cases(seed=0) + cases.pairing_cases(seed=1, scale=4)
LARGE = cases.pairing_cases(seed=2, large=True)
_JAX_PAIRING = jax.jit(jfused._pe_pairing, static_argnums=(0, 1, 2, 3))


@pytest.fixture(scope="module", autouse=True)
def _x64_restored():
    """The int64 cases turn jax_enable_x64 on: put the flag back as it
    was for the files this process runs after this one."""
    before = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", before)


def _jax(c):
    def run():
        rf, pf = _JAX_PAIRING(c.pairing, c.B, c.Bp, c.T,
                              *map(jnp.asarray, c.arrays))
        return np.asarray(rf), np.asarray(pf)
    if c.arrays[4].dtype == np.int64:
        with jax.enable_x64(True):
            return run()
    return run()


def _port(c):
    return pfused._pe_pairing(c.pairing, c.B, c.Bp, c.T, *[
        torch.from_numpy(np.ascontiguousarray(a)) for a in c.arrays])


def _check(c):
    want_r, want_p = _jax(c)
    _build.reset_counts()
    got_r, got_p = _port(c)
    assert dict(_build.PLAIN_CALLS) == {"pe_pairing": 1}
    assert not _build.LAUNCHES
    assert got_r.dtype == got_p.dtype == torch.int32
    assert got_r.shape == (pfused.PE_READ_FIELDS, c.B)
    assert got_p.shape == (pfused.PE_PAIR_FIELDS, c.Bp)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    return want_r, want_p


@pytest.mark.parametrize("case", SMALL, ids=lambda c: c.name)
def test_pe_pairing_plain_matches_jax(case):
    _check(case)


@pytest.mark.parametrize("case", LARGE, ids=lambda c: c.name)
def test_pe_pairing_plain_matches_jax_large(case):
    _, pf = _check(case)
    # positions past 2^31, written wrapped to int32
    assert (pf[3][pf[0] == 1] < 0).any()


def test_cases_reach_every_rule():
    """Over the cases: every policy and both limits, every PAIRING_TS slot
    count, pairs with and without a kept combination, hostneed pairs,
    suppressed pairs with half hits (need_mm1), tied best keys and tied
    ranked heads."""
    seen = {"policy": set(), "limit": set(), "T": set(), "has": set(),
            "hostneed": 0, "need_mm1": 0, "ties": 0}
    for c in SMALL:
        pol, *_rest, limit = c.pairing
        seen["policy"].add(pol)
        seen["limit"].add(limit is None)
        seen["T"].add(c.T)
        _rf, pf = _jax(c)
        seen["has"] |= set(pf[0].tolist())
        seen["hostneed"] += int(pf[14].sum())
        ee, snz, inst, filt = c.arrays[11:]
        Bp = c.Bp
        swap = (ee[:Bp] > 0) & (ee[Bp:] > 0) & (ee[:Bp] > ee[Bp:])
        first_inst = np.where(swap, inst[Bp:], inst[:Bp])
        first_snz = np.where(swap, snz[Bp:], snz[:Bp])
        supp = ~filt[:Bp] & ~filt[Bp:] & ((first_inst == 0) |
                                          (first_snz == 0))
        occ, exact, half, mmug = c.arrays[6:10]
        hits = (occ & half & ~exact & (mmug <= 1)).any(axis=1)
        seen["need_mm1"] += int((supp & (hits[:Bp] | hits[Bp:])).sum())
        # a best score sum reached by two kept combinations
        seen["ties"] += int(((pf[11] == pf[12]) & (pf[13] > 1)).sum())
    assert seen["policy"] == {"ff", "rr", "fr", "rf"}
    assert seen["limit"] == {True, False}
    assert seen["T"] == set(cases.PAIRING_TS)
    assert seen["has"] == {0, 1}
    assert seen["hostneed"] and seen["need_mm1"] and seen["ties"]


def test_pe_pairing_refuses_devices_without_a_kernel():
    c = SMALL[0]
    meta = [torch.zeros(a.shape, dtype=torch.bool if a.dtype == bool
                        else torch.int32, device="meta") for a in c.arrays]
    with pytest.raises(ValueError, match="no kernel"):
        pfused._pe_pairing(c.pairing, c.B, c.Bp, c.T, *meta)
