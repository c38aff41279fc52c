"""Port window gathers, rectangle DP, backtrace and gapless readout (plain
versions) vs the JAX ops, and the port's DP vs the repo's Pallas kernel.

Same numpy inputs through both; tolerance: exact equality (integer
contracts), except the documented tie rule of `sw_pallas` (first maximal
column where `sw_banded` and the port take the rightmost)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from bowtie2_tpu.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu.ops import ref as jref  # noqa: E402
from bowtie2_tpu.ops import sw as jsw  # noqa: E402
from bowtie2_tpu_torch.ops import _build, cases  # noqa: E402
from bowtie2_tpu_torch.ops import ref as pref  # noqa: E402
from bowtie2_tpu_torch.ops import sw as psw  # noqa: E402
from test_torch_corpus import (N_LIVE_KINDS, assert_live_region,  # noqa: E402
                               n_live_of, n_refs_with_ns)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, p, msg=""):
    np.testing.assert_array_equal(np.asarray(j), p.numpy(), err_msg=msg)


@pytest.fixture(scope="module")
def ref_data():
    return build_index_from_refs(n_refs_with_ns())


def _window_args(data, n, rng):
    rid = rng.integers(0, len(data.ref_names), n)
    lo = data.ref_cum[rid].astype(np.int32)
    hi = data.ref_cum[rid + 1].astype(np.int32)
    starts = (lo + rng.integers(-60, (hi - lo) + 20)).astype(np.int32)
    starts[:3] = [-45, int(data.ref_cum[-1]) - 10, 0]     # both ends
    return starts, lo, hi


@pytest.mark.parametrize("width", [131, 97])
def test_gather_windows(ref_data, width):
    rng = np.random.default_rng(width)
    starts, lo, hi = _window_args(ref_data, 300, rng)
    args_j = (jnp.asarray(ref_data.ref_words), jnp.asarray(ref_data.refn_words),
              jnp.asarray(starts), jnp.asarray(lo), jnp.asarray(hi))
    args_p = (_t(ref_data.ref_words.view(np.int32)),
              _t(ref_data.refn_words.view(np.int32)),
              _t(starts), _t(lo), _t(hi))
    w_j = jref.gather_windows(*args_j, width)
    w_p = pref.gather_windows(*args_p, width)
    _eq(w_j, w_p)
    assert (w_p.numpy() == 4).any() and (w_p.numpy() == 5).any()
    (wa_j, cs_j) = jref.gather_windows_aligned(*args_j, width)
    (wa_p, cs_p) = pref.gather_windows_aligned(*args_p, width)
    _eq(wa_j, wa_p)
    _eq(cs_j, cs_p)
    assert wa_p.shape[1] == pref.aligned_width(width)


def _dp_problems(rng, B, L, G, tie=False, W_extra=0):
    """Reads embedded in random windows with substitutions, indels and
    Ns; `tie` makes every read a tandem repeat inside a repeat window."""
    W = L + 2 * G + 1 + W_extra
    reads = rng.integers(0, 4, (B, L)).astype(np.int32)
    wins = rng.integers(0, 4, (B, W)).astype(np.int32)
    if tie:
        unit = rng.integers(0, 4, (B, 5))
        reads = np.tile(unit, (1, L // 5 + 1))[:, :L].astype(np.int32)
        wins = np.tile(unit, (1, W // 5 + 1))[:, :W].astype(np.int32)
    for b in range(B):
        if tie:
            continue
        s = G + int(rng.integers(-3, 4))
        seg = reads[b].copy()
        kind = b % 4
        if kind == 1:                                  # deletion in read
            p = int(rng.integers(15, L - 15))
            seg = np.concatenate([seg[:p], rng.integers(0, 4, 3), seg[p:]])
        elif kind == 2:                                # insertion in read
            p = int(rng.integers(15, L - 15))
            seg = np.concatenate([seg[:p], seg[p + 2:]])
        seg = seg[:W - s]
        wins[b, s:s + seg.size] = seg
        for _ in range(b % 3):
            wins[b, s + int(rng.integers(0, seg.size))] = rng.integers(0, 4)
    reads[rng.random((B, L)) < 0.01] = 4
    wins[rng.random((B, W)) < 0.01] = 4
    quals = rng.integers(5, 41, (B, L)).astype(np.int32)
    lens = np.full(B, L, np.int32)
    lens[::7] = L - 9
    return reads, quals, lens, wins


def _sw_both(reads, quals, lens, wins, p, G, rect_cols=None, col_lo=None):
    j = jsw.sw_banded(jnp.asarray(reads), jnp.asarray(quals),
                      jnp.asarray(lens), jnp.asarray(wins), p, G,
                      None if rect_cols is None else jnp.asarray(rect_cols),
                      None if col_lo is None else jnp.asarray(col_lo))
    q = psw.sw_banded(_t(reads), _t(quals), _t(lens), _t(wins), p, G,
                      None if rect_cols is None else _t(rect_cols),
                      None if col_lo is None else _t(col_lo))
    return j, q


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
@pytest.mark.parametrize("gbar", [4, 0, 10])
@pytest.mark.parametrize("framing", ["plain", "col_lo"])
def test_sw_banded(local, gbar, framing):
    rng = np.random.default_rng(gbar + 2 * local)
    G = 12
    p = psw.SWParams(match_bonus=2 if local else 0, local=local,
                     gap_barrier=gbar)
    jp = jsw.SWParams(*p)
    if framing == "plain":
        reads, quals, lens, wins = _dp_problems(rng, 48, 60, G)
        j, q = _sw_both(reads, quals, lens, wins, jp, G)
    else:
        # word-aligned windows: rect columns at [col_lo, col_lo + rect)
        reads, quals, lens, wins0 = _dp_problems(rng, 48, 60, G)
        shift = rng.integers(0, 32, 48).astype(np.int32)
        Wa = 32 * ((wins0.shape[1] + 62) // 32)
        wins = rng.integers(0, 6, (48, Wa)).astype(np.int32)
        for b in range(48):
            wins[b, shift[b]:shift[b] + wins0.shape[1]] = wins0[b]
        rect = (lens + 2 * G + 1).astype(np.int32)
        j, q = _sw_both(reads, quals, lens, wins, jp, G, rect, shift)
    for f in ("score", "row", "lane", "dirs"):
        _eq(getattr(j, f), getattr(q, f), f)
    assert (q.score.numpy() > psw.NEG_INF).all()


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_sw_banded_ties_take_rightmost(local):
    rng = np.random.default_rng(9)
    G = 10
    p = jsw.SWParams(match_bonus=2 if local else 0, local=local)
    reads, quals, lens, wins = _dp_problems(rng, 16, 40, G, tie=True)
    j, q = _sw_both(reads, quals, lens, wins, p, G)
    for f in ("score", "row", "lane", "dirs"):
        _eq(getattr(j, f), getattr(q, f), f)


_DP_CASES = cases.dp_cases()


@pytest.mark.parametrize("case", _DP_CASES, ids=[c.name for c in _DP_CASES])
def test_sw_banded_synthetic_cases(case):
    """The exactness sweep's DP cases (ops/cases.py), which chip_smoke.py
    holds the sw_rect kernel to on the card: every output, every cell."""
    p = jsw.SWParams(**case.params())
    j, q = _sw_both(case.reads, case.quals, case.lens, case.wins, p,
                    case.band, case.rect_cols, case.col_lo)
    for f in ("score", "row", "lane", "dirs"):
        _eq(getattr(j, f), getattr(q, f), f)


_JAX_DP = {}


def _jax_origin_dp(case):
    """The JAX sw_banded(track_origin=True) on a case, once per case."""
    if case.name not in _JAX_DP:
        _JAX_DP[case.name] = jsw.sw_banded(
            jnp.asarray(case.reads), jnp.asarray(case.quals),
            jnp.asarray(case.lens), jnp.asarray(case.wins),
            jsw.SWParams(**case.params()), case.band,
            None if case.rect_cols is None else jnp.asarray(case.rect_cols),
            None if case.col_lo is None else jnp.asarray(case.col_lo),
            track_origin=True)
    return _JAX_DP[case.name]


@pytest.mark.parametrize("kind", N_LIVE_KINDS)
@pytest.mark.parametrize("case", _DP_CASES, ids=[c.name for c in _DP_CASES])
def test_sw_banded_n_live(case, kind):
    """sw_banded with n_live, both flags: the JAX DP's score, row, lane,
    origin and dirs rows below each read's length on the live lanes, and
    the dead lanes' fill."""
    j = _jax_origin_dp(case)
    n_live = n_live_of(kind, case.reads.shape[0])
    for origin in (False, True):
        q = psw.sw_banded(
            _t(case.reads), _t(case.quals), _t(case.lens), _t(case.wins),
            psw.SWParams(**case.params()), case.band,
            None if case.rect_cols is None else _t(case.rect_cols),
            None if case.col_lo is None else _t(case.col_lo),
            track_origin=origin, n_live=n_live)
        assert (q.origin is not None) == origin
        assert_live_region(j, q, case.lens, n_live,
                           ("score", "row", "lane", "dirs")
                           + (("origin",) if origin else ()))


def _plain_dp(case):
    """(row, lane, dirs) numpy arrays of the port's plain DP on a case."""
    q = psw.sw_banded(
        _t(case.reads), _t(case.quals), _t(case.lens), _t(case.wins),
        psw.SWParams(**case.params()), case.band,
        None if case.rect_cols is None else _t(case.rect_cols),
        None if case.col_lo is None else _t(case.col_lo))
    return q.row.numpy(), q.lane.numpy(), q.dirs.numpy()


_BT_BULK = next(c for c in _DP_CASES if c.name.startswith(cases.BULK_SOURCE))
_BT_SOURCES = ([(f"bt_{c.name}", (c, 0)) for c in _DP_CASES]
               + [(f"bt_bulk_{_BT_BULK.name}", (_BT_BULK, cases.BULK_WALKS))]
               + [(c.name, c) for c in cases.bt_random_cases()])


@pytest.mark.parametrize("source", [s for _, s in _BT_SOURCES],
                         ids=[n for n, _ in _BT_SOURCES])
def test_backtrace_synthetic_cases(source):
    """The exactness sweep's walks (ops/cases.py), which chip_smoke.py
    holds the backtrace kernel to on the card: the op bytes of every step
    and the seven fields."""
    if isinstance(source, cases.BTCase):
        c = source
    else:
        dp_case, walks = source
        c = cases.bt_case(dp_case, *_plain_dp(dp_case), walks=walks)
    bj = jsw.backtrace(jnp.asarray(c.dirs), jnp.asarray(c.sel),
                       jnp.asarray(c.rows), jnp.asarray(c.lanes),
                       jnp.asarray(c.reads), jnp.asarray(c.quals),
                       jnp.asarray(c.wins), jsw.SWParams(**c.params()),
                       c.band)
    bq = psw.backtrace(_t(c.dirs), _t(c.sel), _t(c.rows), _t(c.lanes),
                       _t(c.reads), _t(c.quals), _t(c.wins),
                       psw.SWParams(**c.params()), c.band)
    for f in jsw.BTResult._fields:
        _eq(getattr(bj, f), getattr(bq, f), f)
    if isinstance(source, cases.BTCase):
        # some walk runs out of steps, and some column goes below 0
        assert ((bq.ops[-1].numpy() & 3) != psw.OP_NONE).any()
        assert (bq.ref_start_win.numpy() < 0).any()


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_backtrace_and_diag_readout(local):
    rng = np.random.default_rng(21 + local)
    G = 12
    p = jsw.SWParams(match_bonus=2 if local else 0, local=local)
    reads, quals, lens, wins = _dp_problems(rng, 64, 60, G)
    j, q = _sw_both(reads, quals, lens, wins, p, G)
    sel = np.concatenate([np.arange(0, 64, 3), [5, 5]]).astype(np.int32)
    bj = jsw.backtrace(j.dirs, jnp.asarray(sel), j.row[sel], j.lane[sel],
                       jnp.asarray(reads[sel]), jnp.asarray(quals[sel]),
                       jnp.asarray(wins[sel]), p, G)
    bq = psw.backtrace(q.dirs, _t(sel), q.row[sel], q.lane[sel],
                       _t(reads[sel]), _t(quals[sel]), _t(wins[sel]), p, G)
    for f in jsw.BTResult._fields:
        _eq(getattr(bj, f), getattr(bq, f), f)
    assert (bq.n_gc.numpy() > 0).any()
    np.testing.assert_array_equal(bq.score_check.numpy(),
                                  q.score.numpy()[sel])
    dj = jsw.diag_readout(jnp.asarray(reads[sel]), jnp.asarray(quals[sel]),
                          jnp.asarray(wins[sel]), j.row[sel], j.lane[sel],
                          jnp.asarray(lens[sel]), p)
    dq = psw.diag_readout(_t(reads[sel]), _t(quals[sel]), _t(wins[sel]),
                          q.row[sel], q.lane[sel], _t(lens[sel]), p)
    for a, b in zip(dj, dq):
        _eq(a, b)


READOUT_CASES = cases.readout_cases()


def test_readout_cases_reach_the_kernels_edges():
    """The readout cases hold rows -1 and past Lmax, rows near -2^31
    where rows - s wraps in int32 onto position Lmax - 1 (from step 1, at
    the last step only, and at no step) in every edge case of 17 or more
    candidates a scale, reads past the kernel's 256-step tile with rows
    past it, and candidate counts that are not multiples of 16 (byte
    stores), or of 16 but not of the 32-candidate block, at scale 1 and
    8."""
    for scale in (1, 8):
        cs = cases.readout_cases(scale=scale)
        rows = np.concatenate([c.rows for c in cs])
        assert (rows == -1).any()
        edges = [c for c in cs if c.name.startswith("edges_")
                 and c.reads.shape[0] >= 17 * scale]
        assert edges
        for d in (None, 2, 1):
            assert all((c.rows.astype(np.int64) == -2**31 + (
                0 if d is None else c.reads.shape[1] - d)).any()
                for c in edges)
        assert any((c.rows >= c.reads.shape[1]).any() for c in cs)
        assert any((c.rows >= 2 * c.reads.shape[1]).any() for c in cs)
        assert any(c.reads.shape[1] > 256 and
                   ((c.rows >= 256) & (c.rows < c.reads.shape[1])).any()
                   for c in cs)
        assert {768, 8192} <= {c.reads.shape[1] for c in cs}
        counts = {c.reads.shape[0] for c in cs}
        assert any(n % 16 for n in counts)
        assert any(n % 16 == 0 and n % 32 for n in counts)


@pytest.mark.parametrize("k", range(len(READOUT_CASES)),
                         ids=[c.name for c in READOUT_CASES])
def test_diag_readout_plain_matches_jax_on_cases(k):
    """The readout's plain version (the one CPU tensors take) against the
    JAX op on every ops/cases.py readout case: every output exact."""
    c = READOUT_CASES[k]
    args = (c.reads, c.quals, c.wins, c.rows, c.lanes, c.lens)
    dj = jsw.diag_readout(*map(jnp.asarray, args), jsw.SWParams(**c.params))
    _build.reset_counts()
    dq = psw.diag_readout(*map(_t, args), psw.SWParams(**c.params))
    assert _build.PLAIN_CALLS["diag_readout"] == 1 and not _build.LAUNCHES
    assert dq[0].shape == (c.reads.shape[1], c.reads.shape[0])
    assert dq[0].dtype == torch.uint8 and dq[5].dtype == torch.bool
    for f, a, b in zip(("ops", "dscore", "n_mm", "n_refn", "base", "ok"),
                       dj, dq):
        _eq(a, b, f)
    # the case reaches its edges: diagonals out of the window, N, OP_NONE
    assert not dq[5].all() or c.reads.shape[1] == 1
    assert (dq[0].numpy() == psw.OP_NONE).any() or c.reads.shape[1] == 1


def _pallas_or_skip():
    try:
        from bowtie2_tpu.ops.pallas_sw import TB, sw_pallas
    except Exception as e:       # same posture as tests/test_pallas.py
        pytest.skip(f"pallas unavailable: {e}")
    return TB, sw_pallas


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
def test_port_dp_matches_sw_pallas(local):
    """Tie-free problems: score, row, lane and every direction cell."""
    TB, sw_pallas = _pallas_or_skip()
    rng = np.random.default_rng(4 + local)
    B, L, G = 2 * TB, 64, 16
    W = L + 2 * G + 1
    reads = rng.integers(0, 4, (B, L)).astype(np.int32)
    wins = rng.integers(0, 4, (B, W)).astype(np.int32)
    wins[:, G:G + L] = reads
    for b in range(B):
        for _ in range(b % 5):
            wins[b, G + rng.integers(0, L)] = rng.integers(0, 4)
    quals = rng.integers(5, 41, (B, L)).astype(np.int32)
    lens = np.full(B, L, np.int32)
    lens[::7] = L - 9
    p = jsw.SWParams(match_bonus=2 if local else 0, local=local)
    pl_res = sw_pallas(jnp.asarray(reads), jnp.asarray(quals),
                       jnp.asarray(lens), jnp.asarray(wins), p, G)
    q = psw.sw_banded(_t(reads), _t(quals), _t(lens), _t(wins), p, G)
    _eq(pl_res.score, q.score, "score")
    _eq(pl_res.row, q.row, "row")
    _eq(pl_res.lane, q.lane, "lane")
    np.testing.assert_array_equal(np.asarray(pl_res.dirs),
                                  psw.unpack_dirs(q.dirs, W))


def test_port_dp_vs_sw_pallas_tie_rule():
    """On an end-to-end tie the Pallas kernel reports the first maximal
    column and the port (like sw_banded) the rightmost."""
    TB, sw_pallas = _pallas_or_skip()
    rng = np.random.default_rng(13)
    G = 16
    p = jsw.SWParams()
    reads, quals, lens, wins = _dp_problems(rng, TB, 64, G, tie=True)
    pl_res = sw_pallas(jnp.asarray(reads), jnp.asarray(quals),
                       jnp.asarray(lens), jnp.asarray(wins), p, G)
    q = psw.sw_banded(_t(reads), _t(quals), _t(lens), _t(wins), p, G)
    _eq(pl_res.score, q.score, "score")
    _eq(pl_res.row, q.row, "row")
    lane_pl, lane_q = np.asarray(pl_res.lane), q.lane.numpy()
    assert (lane_q >= lane_pl).all()
    assert (lane_q > lane_pl).any()


@pytest.mark.parametrize("gbar", [4, 0, 12])
def test_sw_full_numpy_cells(gbar):
    """The replay layer's end-row cell oracle (native/dpcells.c): equal to
    the JAX package's, origins (tie rules) included."""
    rng = np.random.default_rng(30 + gbar)
    for case in range(40):
        L = int(rng.integers(12, 50))
        p = jsw.SWParams(gap_barrier=gbar,
                         read_gap_open=int(rng.integers(0, 6)),
                         read_gap_extend=int(rng.integers(1, 4)))
        read = rng.integers(0, 4, L)
        R = L + int(rng.integers(0, 30))
        if case % 3 == 0:                       # tandem repeat: ties
            unit = rng.integers(0, 4, int(rng.integers(1, 4)))
            read = np.tile(unit, L)[:L]
            ref = np.tile(unit, R)[:R]
        else:
            ref = rng.integers(0, 4, R)
            s = int(rng.integers(0, R - L + 1))
            ref[s:s + L] = read
            cut = int(rng.integers(5, L - 5))
            ref = np.concatenate([ref[:s + cut], rng.integers(0, 4, 2),
                                  ref[s + cut:]])[:R]
        read[rng.random(L) < 0.05] = 4
        ref = np.where(rng.random(R) < 0.03, 4, ref)
        ref = np.where(rng.random(R) < 0.03, 5, ref)
        quals = rng.integers(2, 41, L)
        hj, oj = jsw.sw_full_numpy_cells(read, quals, ref, p)
        hp, op = psw.sw_full_numpy_cells(read, quals, ref, psw.SWParams(*p))
        np.testing.assert_array_equal(hj, hp)
        np.testing.assert_array_equal(oj, op)
