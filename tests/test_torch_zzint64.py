"""The int64 row mode (past 2^32 rows: int64 rows and positions, the full
occ checkpoints in a second table, occ_cp64) in the port, on the CPU
(device="cpu": the kernels' plain versions), against the JAX package's
int64 ops and aligners. Tolerance: exact for every integer output,
byte-identical for SAM.

No genome a test can build has 2^32 rows, so both packages are put in
the mode by hand: the JAX halves are built here from the host tables
(int64 n, z_off, fchr, ftab and offs, and occ_cp64 from the JAX
package's `pack_fm_blocks(..., np.int64)`), the port's by
`FMIndex.from_host(..., int64_rows=True)` (or `half_from_tables` with an
`occ_cp64`); each package's aligner takes such an index in place of its
own (built from the forced-large host index, whose segment tables are
int64). Nothing in the JAX package changes for it.

- The plain K3-K6 on the `ops/cases.py` sweep, seed and resolve cases
  over the lambda phage and over a 2047-bp genome whose n + 1 is a
  multiple of 128 (the row past the flat table reads INT64_MIN), flat
  and over 4 shards (the JAX side under shard_map); on `i64_fm_case` at
  a small row count and at a multiple of 128, flat and over 4 shards.
- `occ_batch` / `lf_batch` on checkpoints and fchr shifted past 2^32 (not
  an FM index: the 64-bit adds on the CPU).
- SE (`collect`, `collect_raw`), PE (the fused path) and long-read SAM
  on the lambda fixture: the port's int64 mode against the JAX package's
  int64 mode and against the port's small index; SE also over 4 shards.

The JAX package's int64 ops need jax_enable_x64, which this module turns
on and puts back when it ends: the file sorts after every other
test_torch_* file (tests/test_torch_zlarge.py)."""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from bowtie2_tpu.dist.sharded import ShardedFMHalf as JSHalf  # noqa: E402
from bowtie2_tpu.dist.sharded import _ceil_to, _pad_to  # noqa: E402
from bowtie2_tpu.dist.sharded import sharded_in_specs  # noqa: E402
from bowtie2_tpu.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu.index.fmindex import FMHalf as JHalf  # noqa: E402
from bowtie2_tpu.index.fmindex import pack_fm_blocks  # noqa: E402
from bowtie2_tpu.index.fmindex import pack_mark_rows  # noqa: E402
from bowtie2_tpu.io.fastx import SeqRecord as JRec  # noqa: E402
from bowtie2_tpu.ops import fm as jfm  # noqa: E402
from bowtie2_tpu.pipeline.align import PairedAligner as JPaired  # noqa: E402
from bowtie2_tpu.pipeline.align import UnpairedAligner as JAligner  # noqa: E402
from bowtie2_tpu.pipeline.policy import make_policy as jpolicy  # noqa: E402
from bowtie2_tpu_torch.dist.mesh import make_mesh  # noqa: E402
from bowtie2_tpu_torch.dist.sharded import shard_index  # noqa: E402
from bowtie2_tpu_torch.index.fmindex import FMIndex as PFMIndex  # noqa: E402
from bowtie2_tpu_torch.index.fmindex import ShardedFMHalf  # noqa: E402
from bowtie2_tpu_torch.index.fmindex import half_from_tables  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord as PRec  # noqa: E402
from bowtie2_tpu_torch.ops import _build, cases  # noqa: E402
from bowtie2_tpu_torch.ops import fm as pfm  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner as PAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import FusedPEBatch  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy as ppolicy  # noqa: E402
from test_torch_cli_lambda import GOLDEN_PE, rebuild_lambda  # noqa: E402
from test_torch_corpus import port_sam  # noqa: E402
from test_torch_zlarge import _codes, _jax_recs, _long_reads, _quals  # noqa: E402

CPU = torch.device("cpu")
N_SHARDS = 4
N_SE, N_PE, N_LONG = 128, 96, 8
PORT_PROCS = 2
I64_MIN = -(1 << 63)


@pytest.fixture(scope="module", autouse=True)
def _x64():
    """The JAX package's int64 ops need jax_enable_x64: on for this
    module, then put back as it was for the files this process runs
    after this one."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", before)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, p, msg=""):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                  p.numpy().astype(np.int64), err_msg=msg)


def jax_half(h) -> JHalf:
    """The JAX package's FMHalf of a host HalfIndex in the int64 row mode,
    built as its FMIndex.from_host builds one past 2^32 rows."""
    nb = h.occ_cp.shape[0]
    fm, cp64 = pack_fm_blocks(h.bwt_words, h.occ_cp, np.int64)
    return JHalf(
        n=jnp.asarray(np.int64(h.n)), z_off=jnp.asarray(np.int64(h.z_off)),
        fm_blocks=jnp.asarray(fm), fchr=jnp.asarray(h.fchr.astype(np.int64)),
        ftab=jnp.asarray(h.ftab.astype(np.int64)),
        mark_rows=jnp.asarray(pack_mark_rows(
            h.mark_words.reshape(nb, -1), h.mark_cp)),
        offs=jnp.asarray(h.offs.astype(np.int64)), occ_cp64=jnp.asarray(cp64))


def jax_case_half(c) -> JHalf:
    return JHalf(n=jnp.asarray(np.int64(c.n)),
                 z_off=jnp.asarray(np.int64(c.z_off)),
                 fm_blocks=jnp.asarray(c.fm_blocks), fchr=jnp.asarray(c.fchr),
                 ftab=jnp.asarray(c.ftab), mark_rows=jnp.asarray(c.mark_rows),
                 offs=jnp.asarray(c.offs), occ_cp64=jnp.asarray(c.occ_cp64))


def jmesh(S):
    return JMesh(np.array(jax.devices()[:S]), ("shard",))


def jax_sharded(jh: JHalf, S: int) -> JSHalf:
    """A JAX int64 half split over S devices as the JAX package's
    shard_index splits one (bowtie2_tpu/dist/sharded.py:104-142)."""
    mesh = jmesh(S)
    sh, rep = NamedSharding(mesh, JP("shard")), NamedSharding(mesh, JP())
    nb_pad = _ceil_to(int(jh.fm_blocks.shape[0]), S)
    no_pad = _ceil_to(int(jh.offs.shape[0]), S)

    def pad(a, n):
        return jax.device_put(_pad_to(np.asarray(a), n), sh)
    return JSHalf(
        n=jax.device_put(np.asarray(jh.n), rep),
        z_off=jax.device_put(np.asarray(jh.z_off), rep),
        fm_blocks=pad(jh.fm_blocks, nb_pad),
        fchr=jax.device_put(np.asarray(jh.fchr), rep),
        ftab=jax.device_put(np.asarray(jh.ftab), rep),
        mark_rows=pad(jh.mark_rows, nb_pad), offs=pad(jh.offs, no_pad),
        blk_lo=jax.device_put(np.arange(S, dtype=np.int32) * (nb_pad // S),
                              sh),
        off_lo=jax.device_put(np.arange(S, dtype=np.int32) * (no_pad // S),
                              sh),
        occ_cp64=pad(jh.occ_cp64, nb_pad))


def port_sharded(ph, S: int) -> ShardedFMHalf:
    """The port's int64 half split into S CPU shards (dist/sharded.py
    shard_index's layout)."""
    def split(t):
        return pfm.shard_rows(t, [CPU] * S, CPU)
    return ShardedFMHalf(
        n=ph.n, z_off=ph.z_off, fm_blocks=split(ph.fm_blocks), fchr=ph.fchr,
        ftab=ph.ftab, mark_rows=split(ph.mark_rows), offs=split(ph.offs),
        row_dtype=ph.row_dtype, occ_cp64=split(ph.occ_cp64))


def _jax_op(op, half, arrays, static):
    fn = {"sweep": lambda h, rr: jfm.exact_sweep_rr.__wrapped__(h, rr),
          "substring": lambda h, rr: jfm.substring_search_rr.__wrapped__(
              h, rr),
          "seed": lambda h, s, v: jfm.seed_search_exact.__wrapped__(
              h, s, v, **static),
          "resolve": lambda h, r: jfm.sa_resolve.__wrapped__(
              h, r, **static)}[op]
    if isinstance(half, JSHalf):
        fn = jax.jit(shard_map(
            fn, mesh=jmesh(N_SHARDS),
            in_specs=(sharded_in_specs(large=True).fw,)
            + (JP(),) * len(arrays), out_specs=JP(), check_vma=False))
    else:
        fn = jax.jit(fn)
    return fn(half, *map(jnp.asarray, arrays))


def _port_op(op, half, arrays, static):
    t = [_t(a) for a in arrays]
    if op == "sweep":
        return pfm.exact_sweep_rr(half, *t)
    if op == "substring":
        return pfm.substring_search_rr(half, *t)
    if op == "seed":
        return pfm.seed_search_exact(half, *t, static["seed_len"],
                                     static["ftab_chars"])
    return pfm.sa_resolve(half, *t, period=static["period"])


def check_op(jh, ph, op, arrays, static=None):
    """The port's op equals the JAX op; returns the port's outputs."""
    static = static or {}
    want = _jax_op(op, jh, arrays, static)
    got = _port_op(op, ph, arrays, static)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for j, p in zip(want, got):
        assert p.dtype == (torch.int32 if j.dtype == jnp.int32
                           else torch.int64)
        _eq(j, p, op)
    return got


# ---------------------------------------------------------------------------
# the tables and the plain K3-K6 over real indexes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lam():
    """The lambda phage rebuilt from tests/golden/lambda_pe.sam.gz: name,
    codes, mate-1 and mate-2 records, its small and forced-large host
    indexes, and the port's runs (started here, in processes of their
    own) of the SE, PE and long batches on the small index and in the
    int64 mode."""
    name, genome, m1, m2 = rebuild_lambda(GOLDEN_PE, N_SE)
    g = _codes(genome)
    small = build_index_from_refs([(name, g)])
    large = build_index_from_refs([(name, g)], large=True)
    batches = {
        "se": [(n, _codes(s), _quals(q)) for n, s, q in m1[:N_SE]],
        "pe": [(a[0], _codes(a[1]), _codes(b[1]), _quals(a[2]),
                _quals(b[2])) for a, b in zip(m1[:N_PE], m2[:N_PE])],
        "long": _long_reads(g)[:N_LONG]}
    with ProcessPoolExecutor(PORT_PROCS, mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        port = {(kind, tag): pool.submit(
            port_sam, data, "pe" if kind == "pe" else "se", batches[kind],
            ("collect_raw",) if kind == "long" else
            ("collect", "collect_raw"), True if tag == "i64" else None)
            for kind in ("pe", "se", "long")
            for tag, data in (("i64", large), ("small", small))}
        yield dict(name=name, g=g, small=small, large=large,
                   batches=batches, port=port)


@pytest.fixture(scope="module")
def genomes(lam):
    """kind -> (genome codes, host index, JAX int64 half, port int64
    half): the lambda phage, and a 2047-bp genome whose n + 1 is a
    multiple of 128 (its flat LF at row n + 1 reads the INT64_MIN fill)."""
    fill = np.random.default_rng(2047).integers(0, 4, 2047).astype(np.uint8)
    out = {}
    for kind, g, data in (
            ("lambda", lam["g"], lam["large"]),
            ("fill", fill, build_index_from_refs(
                [("g", fill)], ftab_chars=4, off_rate=4))):
        out[kind] = (g, data, jax_half(data.fw),
                     PFMIndex.from_host(data, device=CPU,
                                        int64_rows=True).fw)
    assert (out["fill"][1].fw.n + 1) % 128 == 0
    return out


def test_int64_tables_equal_jax(lam):
    """from_host's int64 mode: the fused rows and mark rows are the JAX
    package's bit for bit, fchr, ftab, offs and occ_cp64 int64 of the
    same values, rows and ref_cum int64; without int64_rows the index
    keeps its own mode."""
    data = lam["large"]
    jh = jax_half(data.fw)
    p = PFMIndex.from_host(data, device=CPU, int64_rows=True)
    assert p.fw.i64 and p.fw.large and p.fw.row_dtype == torch.int64
    for f in ("fm_blocks", "mark_rows"):
        np.testing.assert_array_equal(
            np.asarray(getattr(jh, f)).view(np.int32),
            getattr(p.fw, f).numpy(), f)
    for f in ("fchr", "ftab", "offs", "occ_cp64"):
        assert getattr(p.fw, f).dtype == torch.int64, f
        np.testing.assert_array_equal(np.asarray(getattr(jh, f)),
                                      getattr(p.fw, f).numpy(), f)
    assert p.ref_cum.dtype == torch.int64
    assert not PFMIndex.from_host(data, device=CPU).fw.i64
    assert not PFMIndex.from_host(lam["small"], device=CPU).fw.large


def _case_arrays(h, op, k):
    """The k-th ops/cases.py case of an op over a genome: (arrays,
    static arguments)."""
    g, data = h[0], h[1]
    if op in ("sweep", "substring"):
        return [cases.sweep_cases(g)[k][1]], {}
    if op == "seed":
        _n, seeds, valid, slen, K = cases.seed_cases(
            g, data.fw.ftab_chars)[k]
        return [seeds, valid], dict(seed_len=slen, ftab_chars=K)
    period = 1 << data.off_rate
    rows = cases.resolve_cases(data.fw, period)[k][1]
    return [rows.astype(np.int64)], dict(period=period)


def _n_cases(op):
    return {"sweep": len(cases.SWEEP_SHAPES),
            "substring": len(cases.SWEEP_SHAPES),
            "seed": len(cases.SEED_SHAPES),
            "resolve": len(cases.RESOLVE_KINDS)}[op]


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "4shards"])
@pytest.mark.parametrize("op", ["sweep", "substring", "seed", "resolve"])
@pytest.mark.parametrize("kind", ["lambda", "fill"])
def test_plain_int64_kernels_match_jax_on_cases(genomes, kind, op, sharded):
    """Every sweep, half-read, seed and resolve case of ops/cases.py over
    the genome's int64 half, flat or over 4 shards (the port's through
    dist/sharded.py shard_index, the JAX package's under shard_map)."""
    h = genomes[kind]
    jh, ph = h[2], h[3]
    if sharded:
        jh = jax_sharded(jh, N_SHARDS)
        ph = shard_index(h[1], make_mesh(devices=["cpu"] * N_SHARDS,
                                         axis="shard"), CPU,
                         int64_rows=True).fw
        assert ph.i64 and ph.occ_cp64.S == N_SHARDS
    _build.reset_counts()
    for k in range(_n_cases(op)):
        arrays, static = _case_arrays(h, op, k)
        check_op(jh, ph, op, arrays, static)
    assert not _build.LAUNCHES


# ---------------------------------------------------------------------------
# i64_fm_case: tables past 2^32 rows at a small row count
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(1 << 16) - 3, 1 << 16],
                ids=["rows", "whole_blocks"])
def synthetic(request):
    """i64_fm_case at 2^16 - 3 rows and at 2^16 (a multiple of 128): its
    JAX half and the port's (half_from_tables with occ_cp64)."""
    c = cases.i64_fm_case(seed=5, rows=request.param, batch=64)
    assert c.occ_cp64.dtype == np.int64 and c.fchr.dtype == np.int64
    ph = half_from_tables(c.n, c.z_off, c.fm_blocks, c.fchr, c.ftab,
                          c.mark_rows, c.offs, True, CPU,
                          occ_cp64=c.occ_cp64)
    assert ph.i64 and ph.offs.dtype == torch.int64
    return c, jax_case_half(c), ph


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "4shards"])
@pytest.mark.parametrize("op", ["sweep", "substring", "seed", "resolve"])
def test_plain_int64_kernels_match_jax_on_i64_fm_case(synthetic, op,
                                                      sharded):
    """The chip's int64 table at a small row count, flat and over 4
    shards; its walked patterns keep live ranges to the end (at whole
    blocks the searches that reach row n + 1 read the flat INT64_MIN
    fill, the sharded zeros)."""
    c, jh, ph = synthetic
    # at whole blocks every search from the full range dies at its first
    # step (the row past the table reads INT64_MIN, or zeros sharded)
    whole = (c.n + 1) % 128 == 0
    if sharded:
        jh, ph = jax_sharded(jh, N_SHARDS), port_sharded(ph, N_SHARDS)
    if op == "sweep":
        got = check_op(jh, ph, op, [c.sweep_rr])
        assert (got[2] == 0).any() != whole
    elif op == "substring":
        check_op(jh, ph, op, [c.substring_rr])
    elif op == "seed":
        for K in (c.ftab_chars, 0):
            top, bot = check_op(jh, ph, op, [c.seeds, c.seed_valid],
                                dict(seed_len=c.seed_len, ftab_chars=K))
        assert ((bot > top).sum() > c.seeds.shape[0] // 4) != whole
    else:
        check_op(jh, ph, op, [c.resolve_rows], dict(period=32))


def test_lf_adds_past_2_32(genomes):
    """occ_batch and lf_batch on the lambda half with every checkpoint
    and fchr shifted past 2^32 (not an FM index: the 64-bit adds, which
    no genome a test can build reaches), at every row to n + 1 and each
    code."""
    _g, data, jh, ph = genomes["lambda"]
    shift = (1 << 33) + 12345
    jh2 = jh._replace(occ_cp64=jh.occ_cp64 + shift, fchr=jh.fchr + 3 * shift)
    ph2 = ph._replace(occ_cp64=ph.occ_cp64 + shift, fchr=ph.fchr + 3 * shift)
    rng = np.random.default_rng(64)
    i = np.concatenate([rng.integers(0, data.fw.n + 2, 4000),
                        [0, data.fw.n, data.fw.n + 1, data.fw.z_off,
                         data.fw.z_off + 1]]).astype(np.int64)
    c = rng.integers(0, 4, i.size).astype(np.int32)
    for jop, pop in ((jfm.occ_batch, pfm.occ_batch),
                     (jfm.lf_batch, pfm.lf_batch)):
        want = jax.jit(jop)(jh2, jnp.asarray(i), jnp.asarray(c))
        got = pop(ph2, _t(i), _t(c))
        assert got.dtype == torch.int64
        _eq(want, got)
        assert (got.numpy() >= (1 << 32)).all()


# ---------------------------------------------------------------------------
# SAM: the lambda fixture in the int64 mode
# ---------------------------------------------------------------------------

def _jax_i64_aligner(lam, kind):
    """The JAX package's aligner over the forced-large index (int64 segment
    tables and host rows) with its halves replaced by the int64 ones."""
    data = lam["large"]
    al = (JPaired if kind == "pe" else JAligner)(data, jpolicy("sensitive"))
    al.idx = al.idx._replace(
        fw=jax_half(data.fw),
        n_ref_total=jnp.asarray(np.int64(data.ref_cum[-1])))
    assert al._row_dtype == np.int64
    return al


def _runs(lam, kind):
    batch = lam["batches"][kind]
    al = _jax_i64_aligner(lam, kind)
    h = al.submit(_jax_recs(batch, kind))
    jax_out = {"path": h[0] if isinstance(h, tuple) else type(h).__name__,
               "collect_raw": al.collect_raw(h)}
    if kind != "long":
        jax_out["collect"] = [r.line() for r in al.collect(h)]
    return {"port_small": lam["port"][kind, "small"].result(),
            "port_i64": lam["port"][kind, "i64"].result(),
            "jax_i64": jax_out}


@pytest.fixture(scope="module")
def se_runs(lam):
    return _runs(lam, "se")


@pytest.mark.parametrize("entry", ["collect", "collect_raw"])
@pytest.mark.parametrize("other", ["port_small", "jax_i64"])
def test_se_int64_matches(se_runs, other, entry):
    got = se_runs["port_i64"][entry]
    assert len(got) == N_SE
    assert got == se_runs[other][entry]


@pytest.fixture(scope="module")
def pe_runs(lam):
    return _runs(lam, "pe")


def test_pe_int64_takes_the_fused_path(pe_runs):
    assert pe_runs["port_i64"]["path"] == FusedPEBatch.__name__
    assert pe_runs["jax_i64"]["path"] == FusedPEBatch.__name__


@pytest.mark.parametrize("entry", ["collect", "collect_raw"])
@pytest.mark.parametrize("other", ["port_small", "jax_i64"])
def test_pe_int64_matches(pe_runs, other, entry):
    got = pe_runs["port_i64"][entry]
    assert len(got) == (2 * N_PE if entry == "collect" else N_PE)
    assert got == pe_runs[other][entry]


@pytest.fixture(scope="module")
def long_runs(lam):
    return _runs(lam, "long")


@pytest.mark.parametrize("other", ["port_small", "jax_i64"])
def test_long_int64_matches(long_runs, other):
    assert long_runs["port_i64"]["path"] == "long"
    got = long_runs["port_i64"]["collect_raw"]
    assert len(got) == N_LONG
    assert got == long_runs[other]["collect_raw"]


def test_se_int64_sharded_matches_flat(lam):
    """The fused SE pipeline over the int64 index split into 4 shards (the
    `_sh` plain versions with occ_cp64 sharded beside fm_blocks) gives the
    flat int64 mode's SAM."""
    recs = [PRec(name=n, seq=c, qual=q)
            for n, c, q in lam["batches"]["se"][:32]]
    out = []
    data = lam["large"]
    for kw in ({}, dict(shard_mesh=make_mesh(devices=["cpu"] * N_SHARDS,
                                             axis="shard"))):
        al = PAligner(data, ppolicy("sensitive"), device=CPU, **kw)
        al.idx = PFMIndex.from_host(data, CPU, int64_rows=True)
        if kw:
            al.sidx = shard_index(data, kw["shard_mesh"], CPU,
                                  int64_rows=True)
        _build.reset_counts()
        out.append(al.collect_raw(al.submit(recs)))
        assert al.idx.fw.i64
        if kw:
            assert al.sidx.fw.i64 and al.sidx.fw.occ_cp64.S == N_SHARDS
            assert _build.PLAIN_CALLS["fm_sweep"] >= 1
    assert out[0] == out[1] and len(out[0]) == 32
