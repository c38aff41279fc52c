"""K7, the window gather (bowtie2_tpu_torch/ops/ref.py), on the CPU: the
plain `gather_windows` and `gather_windows_aligned` (what CPU tensors
take; chip_smoke.py holds the kernel, csrc/ref_gather.cu, to them on the
card) against the JAX package's ops on every `ops/cases.py` window_cases
case: windows past either end of the table, negative starts (below -2^24
for the unaligned form's clamp), N runs across word boundaries, widths
that are multiples of 16 or 32 and widths that are not (the unaligned
kernel's 16-code chunks whole, and cut across rows), int32 starts whose
positions wrap,
int64 starts past 2^31 (with jax_enable_x64, put back after), a few
windows whose aligned groups end inside a warp (ragged); and the
aligned form over ShardedWords at 4 shards, against the JAX op under
shard_map, at word indices no shard owns. Tolerance: exact (integer
codes)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from bowtie2_tpu.dist.sharded import _ceil_to, _pad_to  # noqa: E402
from bowtie2_tpu.ops import ref as jref  # noqa: E402
from bowtie2_tpu_torch.ops import _build, cases, fm as pfm  # noqa: E402
from bowtie2_tpu_torch.ops import ref as pref  # noqa: E402

CPU = torch.device("cpu")
S = 4
CASES = cases.window_cases(seed=0) + cases.window_cases(seed=1, scale=4)


@pytest.fixture(scope="module", autouse=True)
def _x64_restored():
    """The int64 cases turn jax_enable_x64 on: put the flag back as it
    was for the files this process runs after this one."""
    before = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", before)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, p):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                  p.numpy().astype(np.int64))


def _x64(c, run):
    """run(), with jax_enable_x64 on for a case of int64 starts."""
    if c.starts.dtype == np.int64:
        with jax.enable_x64(True):
            return run()
    return run()


def _jax_on(c, fn):
    """A JAX op on case c (uint32 word tables, as the JAX package keeps
    them), as numpy arrays."""
    def run():
        out = fn(jnp.asarray(c.ref_words.view(np.uint32)),
                 jnp.asarray(c.refn_words.view(np.uint32)),
                 jnp.asarray(c.starts), jnp.asarray(c.lo),
                 jnp.asarray(c.hi), c.width)
        return jax.tree_util.tree_map(np.asarray, out)
    return _x64(c, run)


def _port(fn, c, words, nwords):
    return fn(words, nwords, _t(c.starts), _t(c.lo), _t(c.hi), c.width)


def test_cases_reach_every_edge():
    """The cases hold what the docstring says they hold."""
    kinds = {c.name.split("_")[0] for c in CASES}
    assert kinds == set(cases.WINDOW_KINDS)
    neg = np.concatenate([c.starts for c in CASES
                          if c.name.startswith("negative")])
    assert (neg < -(1 << 24)).any() and (neg == -(1 << 24)).any()
    big = np.concatenate([c.starts for c in CASES if c.starts.dtype ==
                          np.int64])
    assert (big > (1 << 31)).any() and (big > (1 << 32)).any()
    widths = {c.width for c in CASES}
    assert any(w % 16 for w in widths) and any(w % 32 for w in widths)
    assert any(w % 16 == 0 for w in widths) and any(
        w % 32 == 0 for w in widths)
    for c in CASES:
        n = 16 * c.ref_words.size
        assert c.refn_words.size != c.ref_words.size
        if c.name.startswith("edges"):
            assert (c.starts < 0).any() and (c.starts + c.width > n).any()


def test_ragged_cases_end_inside_a_warp():
    """The ragged cases hold aligned calls whose B x Wa / 16 groups (a
    thread of the aligned kernel each) end inside a warp, among them Wa =
    32, at every scale the tests and chip_smoke.py use."""
    for scale in (1, 4, 8):
        rag = [c for c in cases.window_cases(seed=0, scale=scale)
               if c.name.startswith("ragged")]
        assert len(rag) == len(cases.WINDOW_WIDTHS)
        groups = [c.starts.size * pref.aligned_width(c.width) // 16
                  for c in rag]
        assert any(g % 32 for g in groups)
        assert any(pref.aligned_width(c.width) == 32 for c in rag)
    assert all(g % 32 for g in [
        c.starts.size * pref.aligned_width(c.width) // 16
        for c in CASES if c.name.startswith("ragged") and
        c.name.endswith("@x1")])


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_gather_windows_plain_matches_jax(case):
    want = _jax_on(case, jref.gather_windows)
    words, nwords = _t(case.ref_words), _t(case.refn_words)
    _build.reset_counts()
    got = _port(pref.gather_windows, case, words, nwords)
    assert dict(_build.PLAIN_CALLS) == {"ref_gather": 1}
    assert not _build.LAUNCHES
    assert got.dtype == torch.int32
    _eq(want, got)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_gather_windows_aligned_plain_matches_jax(case):
    want_w, want_s = _jax_on(case, jref.gather_windows_aligned)
    words, nwords = _t(case.ref_words), _t(case.refn_words)
    _build.reset_counts()
    got_w, got_s = _port(pref.gather_windows_aligned, case, words, nwords)
    assert dict(_build.PLAIN_CALLS) == {"ref_gather_aligned": 1}
    assert got_w.shape == (case.starts.size,
                           pref.aligned_width(case.width))
    assert got_w.dtype == got_s.dtype == torch.int32
    _eq(want_w, got_w)
    _eq(want_s, got_s)
    assert ((got_s >= 0) & (got_s < 32)).all()


def _jax_sharded_aligned(c):
    """The JAX aligned gather over word tables sharded S ways, under
    shard_map as the JAX package's fused pipelines run it."""
    def split(words):
        n_pad = _ceil_to(words.size, S)
        return (jnp.asarray(_pad_to(words.view(np.uint32), n_pad)),
                jnp.asarray(np.arange(S, dtype=np.int32) * (n_pad // S)))
    w, wlo = split(c.ref_words)
    n, nlo = split(c.refn_words)

    def body(w, wlo, n, nlo, starts, lo, hi):
        return jref.gather_windows_aligned.__wrapped__(
            jref.ShardedWords(w, wlo), jref.ShardedWords(n, nlo), starts,
            lo, hi, c.width)
    f = jax.jit(shard_map(body, mesh=JMesh(np.array(jax.devices()[:S]),
                                            ("shard",)),
                          in_specs=(JP("shard"),) * 4 + (JP(),) * 3,
                          out_specs=JP(), check_vma=False))

    def run():
        out = f(w, wlo, n, nlo, jnp.asarray(c.starts), jnp.asarray(c.lo),
                jnp.asarray(c.hi))
        return [np.asarray(x) for x in out]
    return _x64(c, run)


@pytest.mark.parametrize("case", cases.window_cases(seed=2),
                         ids=lambda c: c.name)
def test_gather_windows_aligned_sharded_matches_jax(case):
    """ShardedWords at 4 shards: words past the padding or below 0 belong
    to no shard and read as 0 (the tables' lengths are not multiples of
    4, so the padding is read too)."""
    assert case.ref_words.size % S or case.refn_words.size % S
    want_w, want_s = _jax_sharded_aligned(case)
    sw = pref.ShardedWords(pfm.shard_rows(_t(case.ref_words), [CPU] * S,
                                          CPU))
    sn = pref.ShardedWords(pfm.shard_rows(_t(case.refn_words), [CPU] * S,
                                          CPU))
    _build.reset_counts()
    got_w, got_s = _port(pref.gather_windows_aligned, case, sw, sn)
    assert _build.PLAIN_CALLS["ref_gather_aligned_sh"] == 1
    assert not _build.LAUNCHES
    _eq(want_w, got_w)
    _eq(want_s, got_s)


def test_gather_wrappers_refuse_devices_without_a_kernel():
    c = CASES[0]
    words, nwords = _t(c.ref_words), _t(c.refn_words)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    for fn in (pref.gather_windows, pref.gather_windows_aligned):
        with pytest.raises(ValueError, match="no kernel"):
            fn(words, nwords, meta, meta, meta, 40)
