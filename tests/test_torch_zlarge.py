"""The large index mode (uint32 row space, int64 positions) in the port,
on the CPU (device="cpu": the kernels' plain versions), against its small
mode and the JAX package's large mode. Tolerance: exact for every integer
output, byte-identical for SAM.

- SAM on the lambda phage rebuilt from tests/golden/lambda_pe.sam.gz,
  indexed with `build_index_from_refs(..., large=True)`: single-end
  `collect` and `collect_raw` over 256 reads, paired-end over 192 pairs
  (through the fused PE path: `submit` returns a fused batch), and 16
  long reads of 9-12 kbp (the host path in long mode); each against the
  port's small index and the JAX package's large mode.
- The repcorpus (test_torch_corpus) at 20 and 60 Alu-like copies, forced
  large against small: the trajectory replay and the host path.
- The plain K3-K6 (`exact_sweep_rr`, `substring_search_rr`,
  `seed_search_exact`, `sa_resolve`) in large mode against the JAX
  package's uint32 ops on the `ops/cases.py` sweep, seed and resolve
  cases over the forced-large half, and on `large_fm_case` at a small row
  count.
- `_u32pos` against the JAX package's at the edges of its range; the
  int64 row mode that `FMIndex.from_host` takes past 2^32 rows, the
  paired-end refusal at 2^32 - 4096 global coordinates and single-end
  alignment past 2^32; the port's CLI `align` and `inspect` on a large
  index saved to disk.

The JAX package's `FMIndex.from_host` turns on jax_enable_x64 for the
whole process when it loads a large index: the file sorts after every
other test_torch_* file, and a module fixture puts the flag back when it
ends, since the suite's workers take files largest first, not by name."""

import dataclasses
import io
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from bowtie2_tpu.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu.index.fmindex import FMHalf as JHalf  # noqa: E402
from bowtie2_tpu.index.fmindex import FMIndex as JFMIndex  # noqa: E402
from bowtie2_tpu.io.fastx import SeqRecord as JRec  # noqa: E402
from bowtie2_tpu.ops import fm as jfm  # noqa: E402
from bowtie2_tpu.pipeline.align import PairedAligner as JPaired  # noqa: E402
from bowtie2_tpu.pipeline.align import UnpairedAligner as JAligner  # noqa: E402
from bowtie2_tpu.pipeline.align import _u32pos as j_u32pos  # noqa: E402
from bowtie2_tpu.pipeline.policy import make_policy as jpolicy  # noqa: E402
from bowtie2_tpu_torch.cli.main import main as pmain  # noqa: E402
from bowtie2_tpu_torch.index import build as pbuild  # noqa: E402
from bowtie2_tpu_torch.index.fmindex import FMIndex as PFMIndex  # noqa: E402
from bowtie2_tpu_torch.index.fmindex import half_from_tables  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord as PRec  # noqa: E402
from bowtie2_tpu_torch.ops import cases  # noqa: E402
from bowtie2_tpu_torch.ops import fm as pfm  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import _u32pos as p_u32pos  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner as PAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import FusedPEBatch  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import PairedAligner as PPaired  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy as ppolicy  # noqa: E402
from test_torch_cli import _fastq, _sam  # noqa: E402
from test_torch_cli_lambda import GOLDEN_PE, rebuild_lambda  # noqa: E402
from test_torch_corpus import corpus, port_sam  # noqa: E402

N_SE, N_PE, N_LONG, N_REP = 256, 192, 16, 256
# the port's runs go to processes of their own, started with the module,
# beside the JAX package's runs in the test process
PORT_PROCS = 2
_LUT = np.full(256, 4, np.uint8)
_LUT[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


@pytest.fixture(scope="module", autouse=True)
def _x64_restored():
    """The JAX package's large mode turns on jax_enable_x64 for the whole
    process: put the flag back as it was for the files this process runs
    after this one (the suite's workers take files in no fixed order)."""
    before = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", before)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, p):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                  p.numpy().astype(np.int64))


def _codes(seq):
    return _LUT[np.frombuffer(seq.encode(), np.uint8)]


def _quals(qual):
    return (np.frombuffer(qual.encode(), np.uint8) - 33).astype(np.uint8)


@pytest.fixture(scope="module")
def lam():
    """(name, genome codes, mate-1 (name, seq, qual) strings, the small
    index, the forced-large index, the batches as numpy records, and the
    port's runs of them on both indexes, started here); both packages
    build the same IndexData."""
    name, genome, m1, m2 = rebuild_lambda(GOLDEN_PE, N_SE)
    g = _codes(genome)
    small = build_index_from_refs([(name, g)])
    large = build_index_from_refs([(name, g)], large=True)
    assert large.fw.occ_cp.dtype == np.int64
    batches = {
        "se": [(n, _codes(s), _quals(q)) for n, s, q in m1[:N_SE]],
        "pe": [(a[0], _codes(a[1]), _codes(b[1]), _quals(a[2]),
                _quals(b[2])) for a, b in zip(m1[:N_PE], m2[:N_PE])],
        "long": _long_reads(g)}
    # the repcorpus at both densities: the fused path with both replay
    # layers engaged, and a batch that overflows to the host path
    rep = {alu: corpus(N_REP, n_alu=alu) for alu in (20, 60)}
    with ProcessPoolExecutor(PORT_PROCS, mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        port = {(kind, tag): pool.submit(
            port_sam, data, "pe" if kind == "pe" else "se", batches[kind],
            ("collect_raw",) if kind == "long" else
            ("collect", "collect_raw"))
            for kind in ("pe", "se", "long")
            for tag, data in (("large", large), ("small", small))}
        for alu, (rg, reads) in rep.items():
            for tag, flag in (("large", True), ("small", False)):
                port[f"rep{alu}", tag] = pool.submit(
                    port_sam, build_index_from_refs([("rep", rg)],
                                                    large=flag),
                    "se", reads, ("collect_raw",))
        yield name, g, m1, small, large, batches, port


def test_large_tables_equal_jax(lam):
    """from_host's large branch: rows at the API are int64, the tables the
    JAX package's uint32 ones bit for bit, ref_cum int64; the small index
    stays int32."""
    _name, _g, _m1, small, large, _b, _p = lam
    j = JFMIndex.from_host(large)
    p = PFMIndex.from_host(large, device="cpu")
    assert p.fw.large and p.fw.row_dtype == torch.int64
    assert not PFMIndex.from_host(small, device="cpu").fw.large
    assert j.fw.fchr.dtype == jnp.uint32 and j.fw.offs.dtype == jnp.uint32
    for f in ("fm_blocks", "mark_rows", "fchr", "ftab", "offs"):
        x = np.asarray(getattr(j.fw, f)).view(np.int32)
        np.testing.assert_array_equal(x, getattr(p.fw, f).numpy(), f)
    assert p.ref_cum.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(j.ref_cum), p.ref_cum.numpy())


# ---------------------------------------------------------------------------
# the plain K3-K6 in large mode against the JAX package's uint32 ops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def halves(lam):
    """(genome, host half, JAX half, port half) of the forced-large lambda
    index."""
    _name, g, _m1, _small, large, _b, _p = lam
    return (g, large.fw, JFMIndex.from_host(large).fw,
            PFMIndex.from_host(large, device="cpu").fw)


def _sweeps(jh, ph, rr):
    js = jfm.exact_sweep_rr(jh, jnp.asarray(rr))
    ps = pfm.exact_sweep_rr(ph, _t(rr))
    for f in ("top", "bot", "nedit"):
        _eq(getattr(js, f), getattr(ps, f))
    assert ps.top.dtype == torch.int64 and ps.nedit.dtype == torch.int32


def _substrings(jh, ph, rr):
    for j, p in zip(jfm.substring_search_rr(jh, jnp.asarray(rr)),
                    pfm.substring_search_rr(ph, _t(rr))):
        _eq(j, p)


def _seeds(jh, ph, seeds, valid, slen, K):
    for j, p in zip(jfm.seed_search_exact(jh, jnp.asarray(seeds),
                                          jnp.asarray(valid), slen, K),
                    pfm.seed_search_exact(ph, _t(seeds), _t(valid), slen,
                                          K)):
        _eq(j, p)


def _resolves(jh, ph, rows, period):
    _eq(jfm.sa_resolve(jh, jnp.asarray(np.asarray(rows, np.uint32)),
                       period=period),
        pfm.sa_resolve(ph, _t(np.asarray(rows, np.int64)), period=period))


@pytest.mark.parametrize("kernel", ["sweep", "substring", "seed", "resolve"])
def test_plain_large_kernels_match_jax_on_cases(halves, kernel):
    """Every sweep, seed and resolve case of ops/cases.py over the
    forced-large lambda half."""
    g, host, jh, ph = halves
    if kernel in ("sweep", "substring"):
        for _name, rr in cases.sweep_cases(g):
            (_sweeps if kernel == "sweep" else _substrings)(jh, ph, rr)
    elif kernel == "seed":
        for _name, seeds, valid, slen, K in cases.seed_cases(
                g, host.ftab_chars):
            _seeds(jh, ph, seeds, valid, slen, K)
    else:
        period = 1 << 4                       # the index's off_rate
        for _kind, rows in cases.resolve_cases(host, period):
            _resolves(jh, ph, rows, period)


@pytest.fixture(scope="module")
def synthetic():
    """large_fm_case at 2^16 - 3 rows: the JAX half of its uint32 tables
    and the port's."""
    c = cases.large_fm_case(seed=3, rows=(1 << 16) - 3, batch=64)
    jh = JHalf(n=jnp.uint32(c.n), z_off=jnp.uint32(c.z_off),
               fm_blocks=jnp.asarray(c.fm_blocks), fchr=jnp.asarray(c.fchr),
               ftab=jnp.asarray(c.ftab), mark_rows=jnp.asarray(c.mark_rows),
               offs=jnp.asarray(c.offs))
    ph = half_from_tables(c.n, c.z_off, c.fm_blocks, c.fchr, c.ftab,
                          c.mark_rows, c.offs, True, "cpu")
    return c, jh, ph


@pytest.mark.parametrize("kernel", ["sweep", "substring", "seed", "resolve"])
def test_plain_large_kernels_match_jax_on_large_fm_case(synthetic, kernel):
    """The chip's large-table case at a small row count; its walked
    patterns keep live ranges to the end."""
    c, jh, ph = synthetic
    if kernel == "sweep":
        _sweeps(jh, ph, c.sweep_rr)
        assert (pfm.exact_sweep_rr(ph, _t(c.sweep_rr)).nedit == 0).any()
    elif kernel == "substring":
        _substrings(jh, ph, c.substring_rr)
    elif kernel == "seed":
        for K in (c.ftab_chars, 0):
            _seeds(jh, ph, c.seeds, c.seed_valid, c.seed_len, K)
        top, bot = pfm.seed_search_exact(ph, _t(c.seeds), _t(c.seed_valid),
                                         c.seed_len, c.ftab_chars)
        assert (bot > top).sum() > c.seeds.shape[0] // 4
    else:
        _resolves(jh, ph, c.resolve_rows, 32)


def test_u32pos_matches_jax():
    a = np.array([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 4097,
                  (1 << 32) - 4096, (1 << 32) - 1, -1, -31, -4096,
                  (1 << 31) + 12345], np.int64)
    wrapped = (((a + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).astype(np.int32)
    np.testing.assert_array_equal(p_u32pos(wrapped), j_u32pos(wrapped))
    np.testing.assert_array_equal(
        p_u32pos(wrapped)[:6], [0, 1, (1 << 31) - 1, 1 << 31,
                                (1 << 32) - 4097, -4096])


def pad_index(data, P: int):
    """`data` behind a leading all-N reference of P bp (a multiple of 32):
    its global coordinates shift by P, its joined text stays the same (an
    all-N reference adds nothing to it). The words of the leading
    reference are left zero and untouched (np.zeros pages stay unmapped):
    no window reads them, since a position outside its read's reference
    is code 5 whatever its words hold."""
    words = np.zeros(P // 16 + data.ref_words.size, np.uint32)
    words[P // 16:] = data.ref_words
    nwords = np.zeros(P // 32 + data.refn_words.size, np.uint32)
    nwords[P // 32:] = data.refn_words
    return dataclasses.replace(
        data, ref_names=["pad"] + list(data.ref_names),
        ref_lens=np.concatenate([[P], data.ref_lens]).astype(np.int64),
        ref_cum=np.concatenate([[0], P + data.ref_cum]).astype(np.int64),
        seg_global_start=data.seg_global_start + P, ref_words=words,
        refn_words=nwords)


def test_from_host_raises_past_2_32_rows(lam, tmp_path):
    """from_host raised past 2^32 rows and past 2^32 - 4096 global
    coordinates before the int64 row mode was ported. Now a joined text of
    2^32 - 1 bp (2^32 rows) loads in the int64 mode (occ_cp64 present,
    fchr, ftab and offs int64; tests/test_torch_zzint64.py holds the mode
    to the JAX package). At 2^32 - 4096 global coordinates the
    PairedAligner (and the CLI's -1/-2) refuses, naming ROADMAP.md §3,
    since the paired-end exports' int32 position words no longer decode
    (a limit of the JAX package), while single-end alignment runs: the
    lambda phage behind an all-N reference of 2^32 bp aligns as alone."""
    name, g, m1, small, large = lam[:5]
    big = dataclasses.replace(large, fw=dataclasses.replace(
        large.fw, n=(1 << 32) - 1))
    h = PFMIndex.from_host(big, device="cpu").fw
    assert h.i64 and h.large and h.occ_cp64.dtype == torch.int64
    assert all(getattr(h, f).dtype == torch.int64
               for f in ("fchr", "ftab", "offs"))
    assert not PFMIndex.from_host(large, device="cpu").fw.i64
    # the paired-end refusal, at the line and past it (stub coordinates:
    # the aligner refuses before it reads a table)
    edge = dataclasses.replace(small, ref_cum=np.array(
        [0, (1 << 32) - 4096], np.int64))
    pol = ppolicy("sensitive")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        PPaired(edge, pol, device="cpu")
    prefix = os.path.join(str(tmp_path), "edge")
    pbuild.save_index(edge, prefix)
    fq1, fq2 = (os.path.join(str(tmp_path), f"r{k}.fq") for k in (1, 2))
    _fastq(fq1, m1[:4])
    _fastq(fq2, m1[:4])
    err = io.StringIO()
    with redirect_stderr(err):
        rc = pmain(["align", "-x", prefix, "-1", fq1, "-2", fq2, "-S",
                    os.path.join(str(tmp_path), "pe.sam"), "--device",
                    "cpu"])
    assert rc == 1 and "ROADMAP.md" in err.getvalue()
    below = dataclasses.replace(small, ref_cum=np.array(
        [0, (1 << 32) - 4097], np.int64))
    assert PPaired(below, pol, device="cpu").idx.fw.large
    # single end past 2^32
    pad = pad_index(small, 1 << 32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        PPaired(pad, pol, device="cpu")
    recs = [PRec(name=n, seq=_codes(sq), qual=_quals(q))
            for n, sq, q in m1[:32]]
    runs, modes = [], []
    for data in (pad, small):
        al = PAligner(data, pol, device="cpu")
        runs.append(al.collect_raw(al.submit(recs)))
        modes.append((al.idx.fw.large, al.idx.fw.i64))
    assert modes == [(True, False), (False, False)] and len(runs[0]) == 32
    assert sum(1 for grp in runs[0] if not grp[0][0] & 4) > 24
    assert runs[0] == runs[1]


# ---------------------------------------------------------------------------
# SAM: the forced-large index against the small one and the JAX package's
# ---------------------------------------------------------------------------

def _jax_recs(batch, kind):
    if kind == "pe":
        return [(JRec(name=n, seq=a, qual=qa), JRec(name=n, seq=b, qual=qb))
                for n, a, b, qa, qb in batch]
    return [JRec(name=n, seq=c, qual=q) for n, c, q in batch]


def _runs(lam, kind):
    """{run: {entry: output, "path": submit's batch kind}}: the port's
    small and large index (from the module's processes) and the JAX
    package's large mode (here), each of one submitted batch."""
    _name, _g, _m1, _small, large, batches, port = lam
    al = JPaired(large, jpolicy("sensitive")) if kind == "pe" else \
        JAligner(large, jpolicy("sensitive"))
    h = al.submit(_jax_recs(batches[kind], kind))
    jax_out = {"path": h[0] if isinstance(h, tuple) else type(h).__name__,
               "collect_raw": al.collect_raw(h)}
    if kind != "long":
        jax_out["collect"] = [r.line() for r in al.collect(h)]
    return {"port_small": port[kind, "small"].result(),
            "port_large": port[kind, "large"].result(),
            "jax_large": jax_out}


@pytest.fixture(scope="module")
def se_runs(lam):
    return _runs(lam, "se")


@pytest.mark.parametrize("entry", ["collect", "collect_raw"])
@pytest.mark.parametrize("other", ["port_small", "jax_large"])
def test_se_large_matches(se_runs, other, entry):
    got = se_runs["port_large"][entry]
    assert len(got) == N_SE
    assert got == se_runs[other][entry]


@pytest.fixture(scope="module")
def pe_runs(lam):
    return _runs(lam, "pe")


def test_pe_large_takes_the_fused_path(pe_runs):
    """Neither package sends the large mode's batch to the host path."""
    assert pe_runs["port_large"]["path"] == FusedPEBatch.__name__
    assert pe_runs["jax_large"]["path"] == FusedPEBatch.__name__


@pytest.mark.parametrize("entry", ["collect", "collect_raw"])
@pytest.mark.parametrize("other", ["port_small", "jax_large"])
def test_pe_large_matches(pe_runs, other, entry):
    got = pe_runs["port_large"][entry]
    assert len(got) == (2 * N_PE if entry == "collect" else N_PE)
    assert got == pe_runs[other][entry]


def _long_reads(g):
    """16 reads of 9-12 kbp at 1 % substitutions, every fourth with two
    1-3-bp indels, odd ones reverse-complemented, the last random."""
    rng = np.random.default_rng(41)
    out = []
    for i in range(N_LONG):
        L = int(rng.integers(9000, 12000))
        if i == N_LONG - 1:
            c = rng.integers(0, 4, L).astype(np.uint8)
        else:
            p = int(rng.integers(0, g.size - L))
            c = g[p:p + L].astype(np.int8).copy()
            err = rng.random(L) < 0.01
            c[err] = (c[err] + rng.integers(1, 4, int(err.sum()))) % 4
            for _ in range(2 * (i % 4 == 0)):
                q = int(rng.integers(500, c.size - 500))
                n = int(rng.integers(1, 4))
                c = np.delete(c, range(q, q + n)) if rng.random() < 0.5 \
                    else np.concatenate([c[:q], rng.integers(0, 4, n), c[q:]])
            c = c.astype(np.uint8)
            if i % 2:
                c = (3 - c)[::-1].copy()
        out.append((f"L{i}", c, rng.integers(20, 41, c.size).astype(
            np.uint8)))
    return out


@pytest.fixture(scope="module")
def long_runs(lam):
    return _runs(lam, "long")


@pytest.mark.parametrize("other", ["port_small", "jax_large"])
def test_long_large_matches(long_runs, other):
    assert long_runs["port_large"]["path"] == "long"
    got = long_runs["port_large"]["collect_raw"]
    assert len(got) == N_LONG
    assert sum(1 for grp in got if not grp[0][0] & 4) == N_LONG - 1
    assert got == long_runs[other]["collect_raw"]


@pytest.mark.parametrize("alu", [20, 60], ids=["fused", "overflow"])
def test_repcorpus_large_matches_small(lam, alu):
    """The replay layers and the host path in the large mode: the
    repcorpus (test_torch_corpus) with 20 Alu-like copies (the fused
    path; the trajectory replay overrides reads) and 60 (the batch
    overflows the fused DP budget and takes the host path), each index
    forced large against the small one."""
    port = lam[6]
    big = port[f"rep{alu}", "large"].result()
    small = port[f"rep{alu}", "small"].result()
    assert big["collect_raw"] == small["collect_raw"]
    assert big["counters"] == small["counters"]
    assert big["counters"]["traj_overridden"] > 0
    assert big["counters"]["host_batches"] == (alu == 60)


def test_cli_align_and_inspect_a_large_index(lam, tmp_path):
    """The port's CLI loads a forced-large index from disk: `align -U`
    gives the small index's SAM, and `inspect -s` its summary."""
    name, g, m1, small, large, _b, _p = lam
    d = str(tmp_path)
    fq = os.path.join(d, "u.fq")
    _fastq(fq, m1[:32])
    sams = []
    for tag, data in (("small", small), ("large", large)):
        prefix = os.path.join(d, tag)
        pbuild.save_index(data, prefix)
        sam = os.path.join(d, f"{tag}.sam")
        assert pmain(["align", "-x", prefix, "-U", fq, "-S", sam, "--quiet",
                      "--device", "cpu"]) == 0
        sams.append([x for x in _sam(sam) if not x.startswith("@PG")])
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert pmain(["inspect", "-s", prefix]) == 0
        assert f"Sequence\t{name}\t{g.size}" in buf.getvalue()
    assert len(sams[1]) > 32 and sams[0] == sams[1]
    assert pbuild.load_index(os.path.join(d, "large")).fw.occ_cp.dtype \
        == np.int64
