"""The sharded index mode in the port (bowtie2_tpu_torch/dist/sharded.py,
K12 `take_sharded` and the sharded K3-K6) on the CPU (device="cpu": the
plain versions), against the JAX package's `shard_mesh` mode, which runs
under jax.shard_map on conftest.py's 8 virtual CPU devices, and against
the port's replicated index. Tolerance: exact for every integer output,
byte-identical for SAM.

- K12: the plain `_take_sharded` (through the `take_sharded` wrapper)
  against the JAX `_take_sharded` under shard_map for S = 2, 4 and 8
  shards of tables of 12, 5 and 1 words a row, at indices that are
  negative, in range, in the padding rows and past the padding.
- K3-K6 over a sharded half (4 shards) against the JAX ops under
  shard_map on every `ops/cases.py` sweep, half-read, seed and resolve
  case, on the corpus genome and on a genome of 2047 bp, whose n + 1 is a
  multiple of 128: there the JAX package's sharded and replicated modes
  give different LF results, and the port gives the sharded one.
- SAM: 192 corpus reads (`collect_raw` and `collect`) and 128 pairs, the
  port's sharded index at 4 and 8 shards against its replicated index and
  the JAX package's `shard_mesh` of 4 devices.
The large row mode's half of these checks is tests/test_torch_zshardidx.py
(the JAX package's large mode turns on jax_enable_x64 process-wide)."""

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
from bowtie2_tpu.dist.sharded import shard_index as jshard_index  # noqa: E402
from bowtie2_tpu.dist.sharded import sharded_in_specs  # noqa: E402
from bowtie2_tpu.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu.index.fmindex import FMIndex as JFMIndex  # noqa: E402
from bowtie2_tpu.io.fastx import SeqRecord as JRec  # noqa: E402
from bowtie2_tpu.ops import fm as jfm  # noqa: E402
from bowtie2_tpu.pipeline.align import PairedAligner as JPaired  # noqa: E402
from bowtie2_tpu.pipeline.align import UnpairedAligner as JAligner  # noqa: E402
from bowtie2_tpu.pipeline.policy import make_policy as jpolicy  # noqa: E402
from bowtie2_tpu_torch.dist.mesh import make_mesh  # noqa: E402
from bowtie2_tpu_torch.dist.sharded import (make_fused_se_sharded,  # noqa: E402
                                            shard_index)
from bowtie2_tpu_torch.index.fmindex import FMIndex as PFMIndex  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord as PRec  # noqa: E402
from bowtie2_tpu_torch.ops import _build, cases  # noqa: E402
from bowtie2_tpu_torch.ops import fm as pfm  # noqa: E402
from bowtie2_tpu_torch.ops import ref as pref  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner as PAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import PairedAligner as PPaired  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy as ppolicy  # noqa: E402
from test_torch_corpus import corpus  # noqa: E402
from test_torch_pe import mk_pairs  # noqa: E402

CPU = torch.device("cpu")
N_SHARDS = 4          # the shard count of the K3-K6 cases
PERIODS = cases.RESOLVE_PERIODS


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, p):
    np.testing.assert_array_equal(np.asarray(j), p.numpy())


def jmesh(S):
    return JMesh(np.array(jax.devices()[:S]), ("shard",))


def pmesh(S):
    return make_mesh(devices=["cpu"] * S, axis="shard")


# ---------------------------------------------------------------------------
# K12
# ---------------------------------------------------------------------------

def _index_classes(rng, n, S, per):
    """Indices negative, in range, in the padding rows [n, S per) and past
    the padding, with the extremes of int32."""
    return np.concatenate([
        rng.integers(-300, 0, 40), rng.integers(0, n, 400),
        np.arange(n, S * per), rng.integers(S * per, S * per + 300, 40),
        [-1, 0, n - 1, S * per - 1, S * per, per - 1, per,
         -(1 << 31), (1 << 31) - 1]]).astype(np.int32)


@pytest.mark.parametrize("row_words", [12, 5, 1])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_take_sharded_matches_jax(S, row_words):
    rng = np.random.default_rng(100 * S + row_words)
    n = 1001 + 2 * row_words         # odd: not a multiple of S
    shape = (n, row_words) if row_words > 1 else (n,)
    table = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(
        np.uint32)
    n_pad = _ceil_to(n, S)
    per = n_pad // S
    assert n_pad > n
    idx = _index_classes(rng, n, S, per)
    idx = idx[:idx.size // 2 * 2].reshape(2, -1)     # any index shape
    lo = np.arange(S, dtype=np.int32) * per
    f = jax.jit(shard_map(
        lambda t, i, l: jfm._take_sharded(t, i, l), mesh=jmesh(S),
        in_specs=(JP("shard"), JP(), JP("shard")), out_specs=JP(),
        check_vma=False))
    want = np.asarray(f(jnp.asarray(_pad_to(table, n_pad)),
                        jnp.asarray(idx), jnp.asarray(lo)))
    rows = pfm.shard_rows(_t(table.view(np.int32)), [CPU] * S, CPU)
    assert rows.per == per and rows.S == S
    assert len({t.data_ptr() for t in rows.shards}) == S
    _build.reset_counts()
    got = pfm.take_sharded(rows, _t(idx))
    assert _build.PLAIN_CALLS["take_sharded"] == 1 and not _build.LAUNCHES
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # int64 indices (the large mode's word indices) give the same rows
    _eq(want.view(np.int32), pfm.take_sharded(rows, _t(idx.astype(np.int64))))


def test_shard_rows_pads_with_zero_rows():
    table = _t(np.arange(30, dtype=np.int32).reshape(10, 3))
    rows = pfm.shard_rows(table, [CPU] * 4, CPU)
    assert rows.per == 3 and [tuple(t.shape) for t in rows.shards] == \
        [(3, 3)] * 4
    np.testing.assert_array_equal(rows.shards[3].numpy(),
                                  [[27, 28, 29], [0, 0, 0], [0, 0, 0]])
    np.testing.assert_array_equal(
        rows.addrs.numpy(), [t.data_ptr() for t in rows.shards])


# ---------------------------------------------------------------------------
# K3-K6 over a sharded half
# ---------------------------------------------------------------------------

def genome_of(kind):
    """The corpus genome (200 kbp) or the 2047-bp genome whose n + 1 is a
    multiple of 128 (tests/test_torch_fm.py's fill genome)."""
    if kind == "corpus":
        return corpus(8)[0]
    return np.random.default_rng(2047).integers(0, 4, 2047).astype(np.uint8)


def build_halves(kind, period=32, large=False):
    """The host index of a genome (ftab keys of 4 codes, marks every
    `period` positions), its JAX halves (sharded over N_SHARDS devices,
    replicated) and the port's (sharded over N_SHARDS CPU shards,
    replicated)."""
    g = genome_of(kind)
    data = build_index_from_refs([("g", g)], ftab_chars=4,
                                 off_rate=period.bit_length() - 1,
                                 large=large)
    return dict(genome=g, data=data,
                jsh=jshard_index(data, jmesh(N_SHARDS)).fw,
                jrep=JFMIndex.from_host(data).fw,
                psh=shard_index(data, pmesh(N_SHARDS), CPU).fw,
                prep=PFMIndex.from_host(data, device=CPU).fw)


@pytest.fixture(scope="module")
def halves():
    """(genome kind, period) -> build_halves', built once."""
    built = {}

    def get(kind, period=32):
        if (kind, period) not in built:
            built[kind, period] = build_halves(kind, period)
        return built[kind, period]
    return get


def jax_sharded(op, half, *arrays, **static):
    """A JAX fm op over a sharded half, under shard_map as the JAX
    package's fused pipelines run it (dist/sharded.py)."""
    fn = {"sweep": lambda h, rr: jfm.exact_sweep_rr.__wrapped__(h, rr),
          "substring": lambda h, rr: jfm.substring_search_rr.__wrapped__(
              h, rr),
          "seed": lambda h, s, v: jfm.seed_search_exact.__wrapped__(
              h, s, v, **static),
          "resolve": lambda h, r: jfm.sa_resolve.__wrapped__(
              h, r, **static)}[op]
    f = shard_map(fn, mesh=jmesh(N_SHARDS),
                  in_specs=(sharded_in_specs().fw,) + (JP(),) * len(arrays),
                  out_specs=JP(), check_vma=False)
    return jax.jit(f)(half, *map(jnp.asarray, arrays))


def port_op(op, half, *arrays, **static):
    # uint32 rows (the large mode's) go to the port as int64 values
    t = [_t(a.astype(np.int64) if a.dtype == np.uint32 else a)
         for a in arrays]
    if op == "sweep":
        return pfm.exact_sweep_rr(half, *t)
    if op == "substring":
        return pfm.substring_search_rr(half, *t)
    if op == "seed":
        return pfm.seed_search_exact(half, *t, static["seed_len"],
                                     static["ftab_chars"])
    return pfm.sa_resolve(half, *t, period=static["period"])


def check_case(h, op, arrays, static):
    """The port's sharded op equals the JAX sharded op on one case."""
    want = jax_sharded(op, h["jsh"], *arrays, **static)
    got = port_op(op, h["psh"], *arrays, **static)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for j, p in zip(want, got):
        _eq(j, p)


def search_case(h, op, shape):
    _name, rr = cases.sweep_cases(h["genome"])[shape]
    return [rr], {}


def seed_case(h, shape):
    _name, seeds, valid, seed_len, K = cases.seed_cases(h["genome"], 4)[shape]
    return [seeds, valid], dict(seed_len=seed_len, ftab_chars=K)


def resolve_case(h, period, kind):
    rows = dict(cases.resolve_cases(h["data"].fw, period))[kind]
    if h["prep"].large:
        rows = rows.astype(np.uint32)
    return [rows], dict(period=period)


GENOMES = ["corpus", "fill"]
SWEEP_IDS = [f"B{b}_L{n}" for b, n in cases.SWEEP_SHAPES]
SEED_IDS = [f"L{n}_{r}" for n, r in cases.SEED_SHAPES]


@pytest.mark.parametrize("shape", range(len(cases.SWEEP_SHAPES)),
                         ids=SWEEP_IDS)
@pytest.mark.parametrize("op", ["sweep", "substring"])
@pytest.mark.parametrize("genome", GENOMES)
def test_sharded_searches_match_jax(halves, genome, op, shape):
    h = halves(genome)
    check_case(h, op, *search_case(h, op, shape))


@pytest.mark.parametrize("shape", range(len(cases.SEED_SHAPES)),
                         ids=SEED_IDS)
@pytest.mark.parametrize("genome", GENOMES)
def test_sharded_seed_search_matches_jax(halves, genome, shape):
    h = halves(genome)
    check_case(h, "seed", *seed_case(h, shape))


@pytest.mark.parametrize("kind", cases.RESOLVE_KINDS)
@pytest.mark.parametrize("period", PERIODS)
@pytest.mark.parametrize("genome", GENOMES)
def test_sharded_sa_resolve_matches_jax(halves, genome, period, kind):
    h = halves(genome, period)
    check_case(h, "resolve", *resolve_case(h, period, kind))


def test_fill_genome_sharded_differs_from_replicated(halves):
    """On the genome whose n + 1 is a multiple of 128 a LF step at row
    n + 1 reads the row past the last block: 0xFFFFFFFF in the JAX
    package's replicated take (checkpoint -1), zeros in its sharded one
    (checkpoint 0), so the two modes' LF results differ there. The port's
    sharded half gives the sharded LF and its replicated half the
    replicated one. The searches' results hide the difference (a LF step
    of row n + 1 is a step of the full range, which empties at once in
    both modes), and equal each other."""
    h = halves("fill")
    n1 = h["prep"].nrows
    assert n1 % 128 == 0 and n1 // 128 == h["prep"].fm_blocks.shape[0]
    i = np.repeat(np.array([0, 5, 127, n1 - 1, n1], np.int32), 4)
    c = np.tile(np.arange(4, dtype=np.int32), 5)
    f = jax.jit(shard_map(
        lambda hh, ii, cc: jfm.lf_batch(hh, ii, cc), mesh=jmesh(N_SHARDS),
        in_specs=(sharded_in_specs().fw, JP(), JP()), out_specs=JP(),
        check_vma=False))
    jsh = np.asarray(f(h["jsh"], jnp.asarray(i), jnp.asarray(c)))
    jrep = np.asarray(jfm.lf_batch(h["jrep"], jnp.asarray(i), jnp.asarray(c)))
    _eq(jsh, pfm.lf_batch(h["psh"], _t(i), _t(c)))
    _eq(jrep, pfm.lf_batch(h["prep"], _t(i), _t(c)))
    past = i == n1
    assert (jsh[past] != jrep[past]).all()
    np.testing.assert_array_equal(jsh[~past], jrep[~past])
    for _name, rr in cases.sweep_cases(h["genome"]):
        for op in ("sweep", "substring"):
            for a, b in zip(port_op(op, h["psh"], rr),
                            port_op(op, h["prep"], rr)):
                assert torch.equal(a, b)


def test_sharded_half_geometry(halves):
    """Each shard holds a quarter of the padded tables; the small tables
    stay whole."""
    h = halves("corpus")
    psh, prep = h["psh"], h["prep"]
    nb = prep.fm_blocks.shape[0]
    assert psh.fm_blocks.per == -(-nb // N_SHARDS)
    assert psh.mark_rows.per == psh.fm_blocks.per
    assert psh.offs.per == -(-prep.offs.shape[0] // N_SHARDS)
    assert all(t.shape == (psh.fm_blocks.per, 12)
               for t in psh.fm_blocks.shards)
    assert torch.equal(psh.ftab, prep.ftab) and torch.equal(psh.fchr,
                                                             prep.fchr)
    whole = torch.cat(psh.fm_blocks.shards)
    assert torch.equal(whole[:nb], prep.fm_blocks)
    assert not whole[nb:].any()
    assert (psh.nrows, psh.z_off, psh.row_dtype, psh.large) == \
        (prep.nrows, prep.z_off, prep.row_dtype, prep.large)


def test_sharded_words_only_through_the_aligned_gather(halves):
    """gather_windows_aligned takes ShardedWords (no clip: words past the
    table are 0, masked to code 5 as the clipped ones are), gather_windows
    refuses them, as the JAX package's plain take would."""
    h = halves("corpus")
    data = h["data"]
    sidx = shard_index(data, pmesh(N_SHARDS), CPU)
    rep = PFMIndex.from_host(data, device=CPU)
    n = int(data.ref_cum[-1])
    starts = _t(np.array([-100, -5, 0, 17, n - 60, n - 3, n + 40], np.int32))
    lo = torch.zeros_like(starts)
    hi = torch.full_like(starts, n)
    got = pref.gather_windows_aligned(sidx.ref_words, sidx.refn_words,
                                      starts, lo, hi, 77)
    want = pref.gather_windows_aligned(rep.ref_words, rep.refn_words,
                                       starts, lo, hi, 77)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(TypeError, match="sharded"):
        pref.gather_windows(sidx.ref_words, sidx.refn_words, starts, lo, hi,
                            77)
    with pytest.raises(ValueError, match="large"):
        make_fused_se_sharded(sidx.mesh, large=True)(sidx, None)


# ---------------------------------------------------------------------------
# SAM: sharded == replicated == the JAX package's shard_mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def se_corpus():
    """The JAX package's shard_mesh run and the port's replicated run of
    192 corpus reads: (data, reads, JAX runs, port runs), each run the
    collect_raw groups and the collect lines."""
    g, reads = corpus(192, n_alu=20)
    data = build_index_from_refs([("rep", g)])
    pol = jpolicy("sensitive")
    jal = JAligner(data, pol, shard_mesh=jmesh(4))
    jrecs = [JRec(name=a, seq=s, qual=q) for a, s, q in reads]
    want = (jal.collect_raw(jal.submit(jrecs)),
            [r.line() for r in jal.collect(jal.submit(jrecs))])
    raw, lines, plain, _al = _port_se(data, reads)
    assert "take_sharded" not in plain
    return data, reads, want, (raw, lines)


def _port_se(data, reads, **kw):
    al = PAligner(data, ppolicy("sensitive"), device="cpu", **kw)
    recs = [PRec(name=a, seq=s, qual=q) for a, s, q in reads]
    _build.reset_counts()
    raw = al.collect_raw(al.submit(recs))
    lines = [r.line() for r in al.collect(al.submit(recs))]
    return raw, lines, dict(_build.PLAIN_CALLS), al


@pytest.mark.parametrize("S", [4, 8])
def test_sharded_se_matches_replicated_and_jax(se_corpus, S):
    data, reads, jax_run, rep_run = se_corpus
    raw, lines, plain, al = _port_se(data, reads, shard_mesh=pmesh(S))
    assert al.sidx.fw.fm_blocks.S == S
    # the fused pipeline read the sharded words (K12's plain version)
    assert plain.get("take_sharded", 0) >= 2
    assert not al.metrics.counters.get("host_batches")
    assert (raw, lines) == rep_run
    assert (raw, lines) == jax_run


def _port_pe(data, pairs, **kw):
    al = PPaired(data, ppolicy("sensitive"), device="cpu", **kw)
    fb = al.submit(pairs)
    assert not isinstance(fb, tuple)
    return [r.line() for r in al.collect(fb)], al.collect_raw(
        al.submit(pairs))


@pytest.fixture(scope="module")
def pe_corpus():
    """128 pairs: the JAX package's shard_mesh lines and the port's
    replicated run (lines, groups)."""
    g, _ = corpus(8, n_alu=5)
    data = build_index_from_refs([("rep", g)])
    raw = mk_pairs(data, np.random.default_rng(7), 128, err=0.005)
    jp = [(JRec(name=a, seq=x, qual=q), JRec(name=a, seq=y, qual=q))
          for a, x, y, q in raw]
    pp = [(PRec(name=a, seq=x, qual=q), PRec(name=a, seq=y, qual=q))
          for a, x, y, q in raw]
    jal = JPaired(data, jpolicy("sensitive"), shard_mesh=jmesh(4))
    return (data, pp, [r.line() for r in jal.collect(jal.submit(jp))],
            _port_pe(data, pp))


@pytest.mark.parametrize("S", [4, 8])
def test_sharded_pe_matches_replicated_and_jax(pe_corpus, S):
    data, pp, want, rep_run = pe_corpus
    lines, groups = _port_pe(data, pp, shard_mesh=pmesh(S))
    assert len(lines) == 256
    assert (lines, groups) == rep_run
    assert lines == want
