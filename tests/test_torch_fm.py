"""Port FM searches and SA resolution (plain versions) vs the JAX ops.

Same numpy inputs through both; tolerance: exact equality (integer
contracts). Inputs include N codes (4), inactive padding (5), reads with
edits and, for the LF step, rows up to the BWT's last row."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from bowtie2_tpu.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu.index.fmindex import FMIndex as JFMIndex  # noqa: E402
from bowtie2_tpu.ops import fm as jfm  # noqa: E402
from bowtie2_tpu_torch.index.fmindex import FMIndex as PFMIndex  # noqa: E402
from bowtie2_tpu_torch.ops import cases  # noqa: E402
from bowtie2_tpu_torch.ops import fm as pfm  # noqa: E402
from test_torch_corpus import corpus  # noqa: E402


@pytest.fixture(scope="module")
def idx():
    g, reads = corpus(64)
    data = build_index_from_refs([("rep", g)])
    return (data, JFMIndex.from_host(data).fw,
            PFMIndex.from_host(data, device="cpu").fw, reads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, p):
    np.testing.assert_array_equal(np.asarray(j), p.numpy())


def _read_matrix(reads, Lmax=128):
    B = len(reads)
    m = np.full((B, Lmax), 4, np.int32)
    lens = np.zeros(B, np.int32)
    for b, (_, r, _q) in enumerate(reads):
        m[b, :r.size] = r
        lens[b] = r.size
    return m, lens


def _reversed(m, lens):
    L = m.shape[1]
    pos = lens[:, None] - 1 - np.arange(L)[None, :]
    rr = np.take_along_axis(m, np.clip(pos, 0, L - 1), axis=1)
    return np.where(pos >= 0, rr, 5).astype(np.int32)


@pytest.mark.parametrize("genome_len", [2047, 3000])
def test_occ_batch(genome_len):
    """LF counts at every kind of row, including row n + 1 when it lands
    past the last occ block (the JAX gather's fill value)."""
    rng = np.random.default_rng(genome_len)
    data = build_index_from_refs(
        [("g", rng.integers(0, 4, genome_len).astype(np.uint8))],
        ftab_chars=4)
    jh, ph = JFMIndex.from_host(data).fw, PFMIndex.from_host(
        data, device="cpu").fw
    n = ph.n
    i = np.concatenate([rng.integers(0, n + 2, 500), [0, n, n + 1, ph.z_off,
                                                      ph.z_off + 1]])
    i = i.astype(np.int32)
    c = rng.integers(0, 4, i.size).astype(np.int32)
    _eq(jfm.occ_batch(jh, jnp.asarray(i), jnp.asarray(c)),
        pfm.occ_batch(ph, _t(i), _t(c)))
    _eq(jfm.lf_batch(jh, jnp.asarray(i), jnp.asarray(c)),
        pfm.lf_batch(ph, _t(i), _t(c)))


def test_exact_sweep_rr_and_exact_sweep(idx):
    _data, jh, ph, reads = idx
    m, lens = _read_matrix(reads)
    rng = np.random.default_rng(1)
    rnd = rng.integers(0, 5, (16, 128)).astype(np.int32)   # random + Ns
    m = np.concatenate([m, rnd])
    lens = np.concatenate([lens, rng.integers(1, 129, 16)]).astype(np.int32)
    rr = _reversed(m, lens)
    assert (rr == 5).any() and (rr == 4).any()
    js = jfm.exact_sweep_rr(jh, jnp.asarray(rr))
    ps = pfm.exact_sweep_rr(ph, _t(rr))
    for f in ("top", "bot", "nedit"):
        _eq(getattr(js, f), getattr(ps, f))
    assert (ps.nedit.numpy() == 0).any() and (ps.nedit.numpy() > 0).any()
    js2 = jfm.exact_sweep(jh, jnp.asarray(m), jnp.asarray(lens))
    ps2 = pfm.exact_sweep(ph, _t(m), _t(lens))
    for f in ("top", "bot", "nedit"):
        _eq(getattr(js2, f), getattr(ps2, f))


@pytest.fixture(scope="module")
def fill_idx():
    """A genome whose BWT has n + 1 = 2048 rows: the first LF of bot = n + 1
    reads the row past the last block (0xFFFFFFFF in the JAX op)."""
    g = np.random.default_rng(2047).integers(0, 4, 2047).astype(np.uint8)
    data = build_index_from_refs([("g", g)], ftab_chars=4)
    ph = PFMIndex.from_host(data, device="cpu").fw
    assert ph.nrows % 128 == 0 and ph.nrows // 128 == ph.fm_blocks.shape[0]
    return g, JFMIndex.from_host(data).fw, ph


@pytest.mark.parametrize("shape", range(len(cases.SWEEP_SHAPES)),
                         ids=[f"B{b}_L{n}" for b, n in cases.SWEEP_SHAPES])
@pytest.mark.parametrize("genome", ["corpus", "fill"])
def test_exact_sweep_rr_synthetic_cases(request, genome, shape):
    """The exactness sweep's patterns (ops/cases.py), which chip_smoke.py
    holds the fm_sweep kernel to on the card."""
    if genome == "corpus":
        _data, jh, ph, _reads = request.getfixturevalue("idx")
        g = corpus(8)[0]                      # the idx fixture's genome
    else:
        g, jh, ph = request.getfixturevalue("fill_idx")
    _name, rr = cases.sweep_cases(g)[shape]
    js = jfm.exact_sweep_rr(jh, jnp.asarray(rr))
    ps = pfm.exact_sweep_rr(ph, _t(rr))
    for f in ("top", "bot", "nedit"):
        _eq(getattr(js, f), getattr(ps, f))


def test_substring_search(idx):
    _data, jh, ph, reads = idx
    m, lens = _read_matrix(reads)
    half = (lens // 2).astype(np.int32)
    rr = _reversed(m, half)
    jt, jb = jfm.substring_search_rr(jh, jnp.asarray(rr))
    pt, pb = pfm.substring_search_rr(ph, _t(rr))
    _eq(jt, pt)
    _eq(jb, pb)
    assert (pb.numpy() > pt.numpy()).any()
    jt, jb = jfm.substring_search(jh, jnp.asarray(m), jnp.asarray(half))
    pt, pb = pfm.substring_search(ph, _t(m), _t(half))
    _eq(jt, pt)
    _eq(jb, pb)


def _genome_index(request, genome):
    """(genome, JAX half, port half, ftab key length) of either index the
    exactness sweep's cases run on."""
    if genome == "corpus":
        data, jh, ph, _reads = request.getfixturevalue("idx")
        return corpus(8)[0], jh, ph, data.fw.ftab_chars  # the idx genome
    g, jh, ph = request.getfixturevalue("fill_idx")
    return g, jh, ph, 4


@pytest.mark.parametrize("shape", range(len(cases.SWEEP_SHAPES)),
                         ids=[f"B{b}_L{n}" for b, n in cases.SWEEP_SHAPES])
@pytest.mark.parametrize("genome", ["corpus", "fill"])
def test_substring_search_rr_synthetic_cases(request, genome, shape):
    """The read sweep's patterns through the half-read search, which
    chip_smoke.py holds the fm_substring kernel to on the card: interior
    5s, Ns, substitutions, random rows, codes -1 and 6, and patterns
    across the kernel's 128-column staging chunk."""
    g, jh, ph, _K = _genome_index(request, genome)
    _name, rr = cases.sweep_cases(g)[shape]
    jt, jb = jfm.substring_search_rr(jh, jnp.asarray(rr))
    pt, pb = pfm.substring_search_rr(ph, _t(rr))
    _eq(jt, pt)
    _eq(jb, pb)


@pytest.mark.parametrize("shape", range(len(cases.SEED_SHAPES)),
                         ids=[f"L{n}_{r}" for n, r in cases.SEED_SHAPES])
@pytest.mark.parametrize("genome", ["corpus", "fill"])
def test_seed_search_exact_synthetic_cases(request, genome, shape):
    """The seed cases (ops/cases.py), which chip_smoke.py holds the
    fm_seed kernel to on the card: every ftab start, invalid seeds, Ns in
    the ftab tail and the stepped part, ranges that empty at every step,
    codes -1 and 6, and seeds past the kernel's 32-code chunk."""
    g, jh, ph, K = _genome_index(request, genome)
    _name, seeds, valid, seed_len, ftab = cases.seed_cases(g, K)[shape]
    assert not valid.all() and (seeds == -1).any() and (seeds == 6).any()
    jt, jb = jfm.seed_search_exact(jh, jnp.asarray(seeds), jnp.asarray(valid),
                                   seed_len, ftab)
    pt, pb = pfm.seed_search_exact(ph, _t(seeds), _t(valid), seed_len, ftab)
    _eq(jt, pt)
    _eq(jb, pb)


@pytest.mark.parametrize("seed_len,ftab", [(22, 10), (22, 0), (11, 10),
                                           (10, 10)],
                         ids=["ftab", "no_ftab", "half_seed", "ftab_only"])
def test_seed_search_exact(idx, seed_len, ftab):
    _data, jh, ph, reads = idx
    m, lens = _read_matrix(reads)
    rng = np.random.default_rng(seed_len + ftab)
    offs = rng.integers(0, 128 - seed_len, (m.shape[0], 6)).astype(np.int32)
    valid = (offs + seed_len <= lens[:, None]) & \
        (rng.random(offs.shape) < 0.9)
    idxs = offs[:, :, None] + np.arange(seed_len)[None, None, :]
    seeds = np.take_along_axis(m, idxs.reshape(m.shape[0], -1), axis=1
                               ).reshape(-1, seed_len).astype(np.int32)
    assert (seeds == 4).any()
    jt, jb = jfm.seed_search_exact(jh, jnp.asarray(seeds),
                                   jnp.asarray(valid.reshape(-1)),
                                   seed_len, ftab)
    pt, pb = pfm.seed_search_exact(ph, _t(seeds), _t(valid.reshape(-1)),
                                   seed_len, ftab)
    _eq(jt, pt)
    _eq(jb, pb)
    assert (pb.numpy() > pt.numpy()).any()
    jt, jb = jfm.seed_search_offsets(jh, jnp.asarray(m), jnp.asarray(offs),
                                     jnp.asarray(valid), seed_len, ftab)
    pt, pb = pfm.seed_search_offsets(ph, _t(m), _t(offs), _t(valid),
                                     seed_len, ftab)
    _eq(jt, pt)
    _eq(jb, pb)


def test_ftab_lookup(idx):
    _data, jh, ph, _reads = idx
    keys = np.random.default_rng(2).integers(0, 4 ** 10, 300).astype(np.int32)
    for j, p in zip(jfm.ftab_lookup_batch(jh, jnp.asarray(keys)),
                    pfm.ftab_lookup_batch(ph, _t(keys))):
        _eq(j, p)


@pytest.mark.parametrize("period", [16, 32])
def test_sa_resolve(idx, period):
    _data, jh, ph, _reads = idx
    rng = np.random.default_rng(period)
    rows = np.concatenate([rng.integers(0, ph.n + 1, 2000),
                           [0, ph.n, ph.z_off]]).astype(np.int32)
    _eq(jfm.sa_resolve(jh, jnp.asarray(rows), period=period),
        pfm.sa_resolve(ph, _t(rows), period=period))


@pytest.fixture(scope="module")
def resolve_index():
    """(genome, period) -> (host half, JAX half, port half) of an index
    whose marks sit every `period` text positions, built once."""
    built = {}

    def get(genome, period):
        if (genome, period) not in built:
            g = corpus(8)[0] if genome == "corpus" else \
                np.random.default_rng(2047).integers(0, 4, 2047).astype(
                    np.uint8)
            data = build_index_from_refs([("g", g)], ftab_chars=4,
                                         off_rate=period.bit_length() - 1)
            built[genome, period] = (data.fw, JFMIndex.from_host(data).fw,
                                     PFMIndex.from_host(data,
                                                        device="cpu").fw)
        return built[genome, period]
    return get


@pytest.mark.parametrize("kind", cases.RESOLVE_KINDS)
@pytest.mark.parametrize("period", cases.RESOLVE_PERIODS)
@pytest.mark.parametrize("genome", ["corpus", "fill"])
def test_sa_resolve_synthetic_cases(resolve_index, genome, period, kind):
    """The exactness sweep's rows (ops/cases.py), which chip_smoke.py holds
    the sa_resolve kernel to on the card, on indexes marked every 1, 16
    and 32 text positions."""
    host, jh, ph = resolve_index(genome, period)
    rows = dict(cases.resolve_cases(host, period))[kind]
    if kind == "lengths":
        assert set(cases.walk_lengths(host, rows, period).tolist()) == \
            set(range(period))
    _eq(jfm.sa_resolve(jh, jnp.asarray(rows), period=period),
        pfm.sa_resolve(ph, _t(rows), period=period))


def test_sa_resolve_inverts_the_suffix_array(idx):
    """Every joined offset, resolved from its row, comes back."""
    data, _jh, ph, _reads = idx
    sw = pfm.exact_sweep(ph, _t(np.array([[0, 1, 2, 3]], np.int32)),
                         _t(np.array([4], np.int32)))
    top, bot = int(sw.top[0]), int(sw.bot[0])
    rows = np.arange(top, bot, dtype=np.int32)
    pos = pfm.sa_resolve(ph, _t(rows), period=1 << data.off_rate).numpy()
    assert pos.size > 0
    g, _ = corpus(8)
    for p in pos:
        assert list(g[p:p + 4]) == [0, 1, 2, 3]
