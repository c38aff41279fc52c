"""The port's paired-end path vs the JAX package, on the CPU.

Same numpy inputs through both packages; every contract is integer, so
the tolerance is exact equality throughout:

- the plain origin-tracking DP (`sw_banded(track_origin=True)`) against
  the JAX `sw_banded(track_origin=True)` on every DP case of
  bowtie2_tpu_torch/ops/cases.py (`dp_cases` and `origin_cases`, both
  modes);
- `pe_classify_torch` against `pe_classify_np` for --fr, --rf and --ff
  with the overlap, containment and dovetail flags toggled;
- `fused_pe`'s blob and per-slot export against the JAX program's;
- `PairedAligner`'s SAM records, as objects and as the native line
  groups of `collect_raw`, against the JAX `PairedAligner`'s, end to end and
  --local, on 256 pairs of tests/test_pe_devpair.py's `_mk_pairs` recipe
  (100-bp mates) over test_torch_corpus.py's genome: `fast` (5 repeats,
  0.5 % errors: no pair raises hostneed, so the device pairing's
  decisions are emitted), `hostneed` (20 repeats: some pairs raise it,
  and the batch re-runs the pairing on the host) and `overflow` (60
  repeats, 2 % errors: the fused DP budget overflows end to end and the
  batch takes the phase-by-phase host path);
- the port's device pairing against its own `force_host_pairing`, and
  the count of hostneed pairs per batch against the JAX package's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from bowtie2_tpu.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu.io.fastx import SeqRecord as JRec  # noqa: E402
from bowtie2_tpu.ops import sw as jsw  # noqa: E402
from bowtie2_tpu.pipeline.align import PairedAligner as JPaired  # noqa: E402
from bowtie2_tpu.pipeline.pe import pe_classify_np  # noqa: E402
from bowtie2_tpu.pipeline.policy import make_policy as jpolicy  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord as PRec  # noqa: E402
from bowtie2_tpu_torch.ops import cases  # noqa: E402
from bowtie2_tpu_torch.ops import fused as pfused  # noqa: E402
from bowtie2_tpu_torch.ops import sw as psw  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import PairedAligner as PPaired  # noqa: E402
from bowtie2_tpu_torch.pipeline.pe import pe_classify_torch  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy as ppolicy  # noqa: E402
from test_torch_corpus import (N_LIVE_KINDS, assert_live_region,  # noqa: E402
                               corpus, n_live_of)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


ALL_DP = cases.dp_cases() + cases.origin_cases()


@pytest.mark.parametrize("case", ALL_DP, ids=[c.name for c in ALL_DP])
def test_sw_origin_plain_matches_jax(case):
    c = case
    j = jsw.sw_banded(_j(c.reads), _j(c.quals), _j(c.lens), _j(c.wins),
                      jsw.SWParams(**c.params()), c.band, _j(c.rect_cols),
                      _j(c.col_lo), track_origin=True)
    p = psw.sw_banded(_t(c.reads), _t(c.quals), _t(c.lens), _t(c.wins),
                      psw.SWParams(**c.params()), c.band, _t(c.rect_cols),
                      _t(c.col_lo), track_origin=True)
    for name, a, b in zip(j._fields, j, p):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"{c.name}: {name}")
    # the SE call is unchanged by the flag: no origin, the same DP
    q = psw.sw_banded(_t(c.reads), _t(c.quals), _t(c.lens), _t(c.wins),
                      psw.SWParams(**c.params()), c.band, _t(c.rect_cols),
                      _t(c.col_lo))
    assert q.origin is None
    np.testing.assert_array_equal(q.dirs.numpy(), p.dirs.numpy())


ORIGIN = cases.origin_cases()
PADDED = cases.padded_origin_cases()
_JAX_ORIGIN = {}


def _jax_origin(c):
    if c.name not in _JAX_ORIGIN:
        _JAX_ORIGIN[c.name] = jsw.sw_banded(
            _j(c.reads), _j(c.quals), _j(c.lens), _j(c.wins),
            jsw.SWParams(**c.params()), c.band, _j(c.rect_cols),
            _j(c.col_lo), track_origin=True)
    return _JAX_ORIGIN[c.name]


def _port_origin(c, n_live):
    return psw.sw_banded(_t(c.reads), _t(c.quals), _t(c.lens), _t(c.wins),
                         psw.SWParams(**c.params()), c.band, _t(c.rect_cols),
                         _t(c.col_lo), track_origin=True, n_live=n_live)


_FIELDS = ("score", "row", "lane", "origin", "dirs")


@pytest.mark.parametrize("kind", N_LIVE_KINDS)
@pytest.mark.parametrize("case", ORIGIN, ids=[c.name for c in ORIGIN])
def test_sw_origin_n_live_matches_jax(case, kind):
    """The plain origin DP with n_live: the JAX DP on the live lanes
    (dirs rows below each read's length), the fill on the dead ones."""
    n_live = n_live_of(kind, case.reads.shape[0])
    assert_live_region(_jax_origin(case), _port_origin(case, n_live),
                       case.lens, n_live, _FIELDS)


@pytest.mark.parametrize("whole", [False, True], ids=["n_live", "all"])
@pytest.mark.parametrize("case", PADDED, ids=[c.name for c in PADDED])
def test_sw_origin_padded_matches_jax(case, whole):
    """ops/cases.py padded_origin_cases, laid out as the fused pipelines'
    DP lanes: at the case's n_live, and with every lane live (the length-1
    padding lanes over real codes)."""
    n_live = case.reads.shape[0] if whole else torch.tensor(
        case.n_live, dtype=torch.int32)
    assert 0 < case.n_live < case.reads.shape[0]
    assert_live_region(_jax_origin(case), _port_origin(case, n_live),
                       case.lens, n_live, _FIELDS)


CLASSIFY_FLAGS = [(True, True, False), (False, True, False),
                  (True, False, False), (True, True, True)]


@pytest.mark.parametrize("flags", CLASSIFY_FLAGS,
                         ids=["default", "no_overlap", "no_contain",
                              "dovetail"])
@pytest.mark.parametrize("policy", ["fr", "rf", "ff"])
def test_pe_classify_torch_matches_np(policy, flags):
    r = np.random.default_rng(11)
    n = 4096
    lo1 = r.integers(0, 3000, n)
    hi1 = lo1 + r.integers(20, 400, n)
    lo2 = lo1 + r.integers(-500, 500, n)
    hi2 = lo2 + r.integers(20, 400, n)
    fw1 = r.random(n) < 0.5
    fw2 = r.random(n) < 0.5
    want = pe_classify_np(policy, lo1, hi1, fw1, lo2, hi2, fw2, 100, 500,
                          *flags)
    got = pe_classify_torch(policy, _t(lo1), _t(hi1), _t(fw1), _t(lo2),
                            _t(hi2), _t(fw2), 100, 500, *flags)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) >= 2     # concordant and discordant


def mk_pairs(data, rng, n, L=100, err=0.02, bad_frac=0.15):
    """tests/test_pe_devpair.py's `_mk_pairs` recipe: FR pairs over the
    indexed genome in every outcome class (concordant, fragment too long,
    mate 2 garbage). Returns [(name, codes1, codes2, quals)]."""
    g_words = data.ref_words
    G = int(data.ref_cum[-1])

    def ref_codes(lo, k):
        gp = np.arange(lo, lo + k)
        return ((g_words[gp >> 4] >> (2 * (gp & 15))) & 3).astype(np.int8)

    out = []
    for i in range(n):
        pos = int(rng.integers(0, G - 700))
        kind = rng.random()
        if kind < bad_frac:
            c1 = ref_codes(pos, L)
            c2 = rng.integers(0, 4, L).astype(np.int8)
        elif kind < 2 * bad_frac:
            ins = int(rng.integers(1200, 2000))
            if pos + ins + L >= G:
                ins = 600
            c1 = ref_codes(pos, L)
            c2 = ((3 - ref_codes(pos + ins - L, L)) % 4)[::-1].copy()
        else:
            ins = int(rng.integers(150, 500))
            c1 = ref_codes(pos, L)
            c2 = ((3 - ref_codes(pos + ins - L, L)) % 4)[::-1].copy()
        for c in (c1, c2):
            e = rng.random(L) < err
            c[e] = (c[e] + rng.integers(1, 4, int(e.sum()))) % 4
        out.append((f"p{i}", c1.astype(np.uint8), c2.astype(np.uint8),
                    np.full(L, 35, np.uint8)))
    return out


# (genome repeats, error rate): the fused path with device decisions, the
# hostneed re-pairing on the host, and the DP-budget overflow
BATCHES = {"fast": (5, 0.005), "hostneed": (20, 0.005),
           "overflow": (60, 0.02)}


def _hostneed(blob, B2, Bp, B):
    off = pfused.PE_READ_FIELDS * B2
    pf = np.asarray(blob)[off:off + pfused.PE_PAIR_FIELDS * Bp].reshape(
        pfused.PE_PAIR_FIELDS, Bp)
    return int(pf[-1, :B].sum())


@pytest.fixture(scope="module", params=[
    (b, local) for b in BATCHES for local in (False, True)],
    ids=lambda p: f"{p[0]}-{'local' if p[1] else 'e2e'}")
def pe_run(request):
    batch, local = request.param
    n_alu, err = BATCHES[batch]
    g, _ = corpus(8, n_alu=n_alu)
    data = build_index_from_refs([("rep", g)])
    raw = mk_pairs(data, np.random.default_rng(7), 256, err=err)
    jp = [(JRec(name=a, seq=x, qual=q), JRec(name=a, seq=y, qual=q))
          for a, x, y, q in raw]
    pp = [(PRec(name=a, seq=x, qual=q), PRec(name=a, seq=y, qual=q))
          for a, x, y, q in raw]
    ja = JPaired(data, jpolicy("sensitive", local=local))
    pa = PPaired(data, ppolicy("sensitive", local=local), device="cpu")
    jf = ja.submit(jp)
    pf = pa.submit(pp)
    out = dict(batch=batch, local=local,
               jblob=np.asarray(jf.res.blob), pblob=pf.res.blob.numpy(),
               jslots=np.asarray(jf.res.slots), pslots=pf.res.slots.numpy(),
               jhn=_hostneed(jf.res.blob, jf.B2, jf.Bp, jf.B),
               phn=_hostneed(pf.res.blob, pf.B2, pf.Bp, pf.B),
               overflow=pa._pe_decode(pf) is None)
    out["jsam"] = [r.line() for r in ja.collect(jf)]
    out["psam"] = [r.line() for r in pa.collect(pf)]
    out["praw"] = pa.collect_raw(pf)
    ph = PPaired(data, ppolicy("sensitive", local=local), device="cpu")
    ph.force_host_pairing = True
    out["phost"] = [r.line() for r in ph.align_batch(pp)]
    return out


def test_fused_pe_blob_matches_jax(pe_run):
    r = pe_run
    assert r["pblob"].dtype == np.int32
    np.testing.assert_array_equal(r["pblob"], r["jblob"])
    np.testing.assert_array_equal(r["pslots"], r["jslots"])


def test_paired_sam_matches_jax(pe_run):
    r = pe_run
    assert len(r["psam"]) == 512
    assert r["psam"] == r["jsam"]
    # the native line builder's groups hold the same lines, pair by pair
    assert [line.decode() for g in r["praw"] for _, line in g] == r["jsam"]
    # the batch took the path its name says
    if r["batch"] == "fast":
        assert r["phn"] == 0 and not r["overflow"]
    if r["batch"] == "hostneed":
        assert r["phn"] > 0 and not r["overflow"]
    if r["batch"] == "overflow" and not r["local"]:
        assert r["overflow"]


def test_device_pairing_matches_host_pairing(pe_run):
    r = pe_run
    assert r["psam"] == r["phost"]


def test_hostneed_count_matches_jax(pe_run):
    assert pe_run["phn"] == pe_run["jhn"]
