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
from bowtie2_tpu_torch.ops import ref as pref  # noqa: E402
from bowtie2_tpu_torch.ops import sw as psw  # noqa: E402
from test_torch_corpus import n_refs_with_ns  # noqa: E402


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
