"""The port's span recorder (utils/metrics.py TRACE) and its spans and
counters on the main paths, on the CPU (device="cpu").

- The recorder: nesting, parents, self time, clipping to a window, batch
  numbers; off, it records nothing and enters no `record_function`;
  under torch.profiler it records, and its `bt2x:` ranges reach the
  profiler's trace.
- One batch of each path: fused SE, SE over the fused DP budget, long
  SE, fused PE, PE with pairs the device pairing flags, PE over the
  budget, PE with a long mate. Every host readback (`Tensor.cpu`, as
  `_np` does it) falls inside a `fetch` span, every span carries the
  batch's number, and the batch's span names are the ones its path has.
- The counters: `overflow_batches` / `overflow_dropped` count the
  overflow (and nothing is written to stderr for it), `repair_batches`
  / `repair_pairs` / `hostneed_pairs` the host re-pairing; the CLI's
  end-of-run lines and its `-t` span table.
"""

import contextlib
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)

from bowtie2_tpu_torch.cli import main as pcli  # noqa: E402
from bowtie2_tpu_torch.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import PairedAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy  # noqa: E402
from bowtie2_tpu_torch.utils import metrics  # noqa: E402
from bowtie2_tpu_torch.utils.metrics import TRACE, Tracer  # noqa: E402
from test_torch_corpus import corpus  # noqa: E402
from test_torch_pe import mk_pairs  # noqa: E402

SPANS = {"submit", "collect", "fetch", "emit_fused", "replay", "host_path",
         "host_search", "host_backtrace", "rescue", "host_emit", "emit_fast",
         "repair_host"}


@pytest.fixture
def counted_rf(monkeypatch):
    """record_function, counting the ranges entered."""
    real = metrics._tprof.record_function
    names = []

    def rf(name, *a, **k):
        names.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(metrics._tprof, "record_function", rf)
    return names


def test_spans_nest_with_parents_and_batches(counted_rf):
    tr = Tracer()
    tr.on = True
    k = tr.next_batch()
    with tr.span("submit"):
        pass
    with tr.span("collect"):
        with tr.span("fetch"):
            pass
        with tr.span("host_path"):
            with tr.span("host_search"):
                with tr.span("fetch"):
                    pass
    k2 = tr.next_batch()
    with tr.span("submit"):
        pass
    names = [r[0] for r in tr.records]
    assert names == ["submit", "collect", "fetch", "host_path",
                     "host_search", "fetch", "submit"]
    assert [r[3] for r in tr.records] == [-1, -1, 1, 1, 3, 4, -1]
    assert (k, k2) == (0, 1)
    assert [r[4] for r in tr.records] == [0] * 6 + [1]
    assert all(r[2] >= r[1] > 0 for r in tr.records)
    assert counted_rf == ["bt2x:" + n for n in names]
    tot = tr.totals()
    assert tot["fetch"][0] == 2 and tot["submit"][0] == 2
    # self time is the span's time less its children's
    c = tr.records[1]
    kids = sum(r[2] - r[1] for r in tr.records if r[3] == 1)
    assert tr.self_seconds("collect") == pytest.approx(
        (c[2] - c[1] - kids) * 1e-9, abs=1e-12)
    tr.clear()
    assert tr.records == [] and tr.totals() == {}


def test_self_time_and_clipping_on_fixed_records():
    tr = Tracer()
    # ns: a [0, 100) holds b [10, 40) (holding c [15, 20)) and b [50, 60);
    # a second a [200, 300) nests an a [220, 250)
    tr.records = [["a", 0, 100, -1, 0], ["b", 10, 40, 0, 0],
                  ["c", 15, 20, 1, 0], ["b", 50, 60, 0, 0],
                  ["a", 200, 300, -1, 1], ["a", 220, 250, 4, 1]]
    ns = 1e-9
    assert tr.self_seconds("a") == pytest.approx((60 + 70 + 30) * ns)
    assert tr.self_seconds("b") == pytest.approx((25 + 10) * ns)
    # a span inside one of its own name is counted once
    assert tr.seconds("a") == pytest.approx(200 * ns)
    assert tr.seconds("b") == pytest.approx(40 * ns)
    # [t0, t1] in perf_counter seconds: [30 ns, 230 ns]
    t0, t1 = 30 * ns, 230 * ns
    assert tr.seconds("a", t0, t1) == pytest.approx((70 + 30) * ns)
    assert tr.seconds("b", t0, t1) == pytest.approx((10 + 10) * ns)
    assert tr.self_seconds("a", t0, t1) == pytest.approx(
        (70 - 20 + 30 - 10 + 10) * ns)
    assert tr.seconds("d") == 0.0 and tr.self_seconds("d") == 0.0


def test_off_records_nothing(counted_rf):
    tr = Tracer()
    with tr.span("submit"):
        with tr.span("fetch"):
            pass
    assert tr.records == [] and counted_rf == []
    assert tr.span("collect") is tr.span("fetch")       # one shared span


def test_profiler_turns_spans_on():
    tr = Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("collect"):
            torch.ones(4).add_(1)
    with tr.span("collect"):                           # profiler stopped
        pass
    assert [r[0] for r in tr.records] == ["collect"]
    assert "bt2x:collect" in {e.name for e in prof.events()}


# ---------------------------------------------------------------------------
# the spans and counters on one batch of each path


def _long_genome():
    rng = np.random.default_rng(21)
    g = rng.integers(0, 4, 40_000).astype(np.uint8)
    return g, build_index_from_refs([("long", g)])


def _mutated(rng, codes, rate=0.004):
    c = codes.copy()
    e = rng.random(c.size) < rate
    c[e] = (c[e] + rng.integers(1, 4, int(e.sum()))) % 4
    return c


def _rec(name, codes, q=35):
    return SeqRecord(name=name, seq=np.asarray(codes, np.uint8),
                     qual=np.full(len(codes), q, np.uint8))


def _se_batch(kind):
    if kind == "long":
        g, data = _long_genome()
        rng = np.random.default_rng(3)
        recs = [_rec(f"l{i}", _mutated(rng, g[p:p + 9000]))
                for i, p in enumerate((1000, 20_000))]
        return data, recs
    n_alu = {"fused": 20, "overflow": 60}[kind]
    g, reads = corpus(400, n_alu=n_alu)
    n = 200 if kind == "fused" else 400
    return (build_index_from_refs([("rep", g)]),
            [SeqRecord(name=a, seq=s, qual=q) for a, s, q in reads[:n]])


def _pe_batch(kind):
    if kind == "long":
        g, data = _long_genome()
        rng = np.random.default_rng(4)
        pairs = [(_rec(f"p{i}", _mutated(rng, g[p:p + 9000])),
                  _rec(f"p{i}", (3 - g[p + 9100:p + 9200])[::-1]))
                 for i, p in enumerate((500, 25_000))]
        return data, pairs
    n_alu, err = {"fused": (5, 0.005), "hostneed": (20, 0.005),
                  "overflow": (60, 0.02)}[kind]
    g, _ = corpus(8, n_alu=n_alu)
    data = build_index_from_refs([("rep", g)])
    raw = mk_pairs(data, np.random.default_rng(7), 256, err=err)
    return data, [(SeqRecord(name=a, seq=x, qual=q),
                   SeqRecord(name=a, seq=y, qual=q)) for a, x, y, q in raw]


# (aligner class, batch maker, kind): the spans every batch of the path
# opens, and those it may open besides (on reads that need them)
PATHS = {
    "se_fused": (UnpairedAligner, _se_batch, "fused",
                 {"submit", "collect", "fetch", "emit_fused"},
                 {"replay", "host_backtrace"}),
    "se_overflow": (UnpairedAligner, _se_batch, "overflow",
                    {"submit", "collect", "fetch", "host_path",
                     "host_search", "host_backtrace", "host_emit"},
                    {"replay"}),
    "se_long": (UnpairedAligner, _se_batch, "long",
                {"submit", "collect", "fetch", "host_path", "host_search",
                 "host_backtrace", "host_emit"}, {"replay"}),
    "pe_fused": (PairedAligner, _pe_batch, "fused",
                 {"submit", "collect", "fetch", "emit_fast"},
                 {"rescue", "host_backtrace"}),
    "pe_hostneed": (PairedAligner, _pe_batch, "hostneed",
                    {"submit", "collect", "fetch", "repair_host"},
                    {"rescue", "host_backtrace"}),
    "pe_overflow": (PairedAligner, _pe_batch, "overflow",
                    {"submit", "collect", "fetch", "host_path",
                     "host_search", "host_backtrace", "host_emit"},
                    {"rescue"}),
    "pe_long": (PairedAligner, _pe_batch, "long",
                {"submit", "collect", "fetch", "host_path", "host_search",
                 "host_backtrace", "host_emit"}, {"rescue"}),
}


@pytest.fixture(scope="module", params=sorted(PATHS))
def traced_batch(request):
    """One batch of a path through submit and collect_raw with tracing on:
    its records, its counters, what it wrote to stderr, and for each host
    readback the span it ran in."""
    cls, make, kind, _need, _may = PATHS[request.param]
    data, batch = make(kind)
    al = cls(data, make_policy("sensitive"), device="cpu")
    inside = []
    real_cpu = torch.Tensor.cpu
    own = "cpu" in vars(torch.Tensor)

    def cpu(t, *a, **k):
        inside.append(TRACE.records[TRACE._stack[-1]][0]
                      if TRACE._stack else None)
        return real_cpu(t, *a, **k)
    err = io.StringIO()
    TRACE.clear()
    TRACE.on = True
    torch.Tensor.cpu = cpu
    try:
        with contextlib.redirect_stderr(err):
            h = al.submit(batch)
            groups = al.collect_raw(h)
    finally:
        if own:
            torch.Tensor.cpu = real_cpu
        else:
            del torch.Tensor.cpu
        TRACE.on = False
    recs = [list(r) for r in TRACE.records]
    TRACE.clear()
    return dict(path=request.param, h=h, n=len(batch), groups=groups,
                records=recs, counters=dict(al.metrics.counters),
                stderr=err.getvalue(), inside=inside)


def test_every_readback_is_a_fetch(traced_batch):
    r = traced_batch
    assert r["inside"] and set(r["inside"]) == {"fetch"}
    assert sum(1 for x in r["records"] if x[0] == "fetch") == \
        len(r["inside"])


def test_batch_spans_are_the_paths(traced_batch):
    r = traced_batch
    _cls, _make, _kind, need, may = PATHS[r["path"]]
    names = {x[0] for x in r["records"]}
    assert names <= SPANS
    assert need <= names <= need | may, sorted(names)
    # submit and collect are the outer spans; every other span sits in
    # one of them; all carry the batch's number
    outer = [x[0] for x in r["records"] if x[3] < 0]
    assert outer == ["submit", "collect"]
    k = r["h"][2] if isinstance(r["h"], tuple) else r["h"].batch
    assert k >= 0 and {x[4] for x in r["records"]} == {k}
    # no span inside a per-read loop: a handful of each a batch
    assert max(sum(1 for x in r["records"] if x[0] == n)
               for n in names - {"fetch"}) <= 4
    assert len(r["groups"]) == r["n"]


def test_overflow_and_repair_counters(traced_batch):
    r = traced_batch
    c = r["counters"]
    over = r["path"] in ("se_overflow", "pe_overflow")
    assert c.get("overflow_batches", 0) == int(over)
    assert (c.get("overflow_dropped", 0) > 0) == over
    assert c.get("host_batches", 0) == int(over or r["path"] == "pe_long")
    repair = r["path"] == "pe_hostneed"
    assert c.get("repair_batches", 0) == int(repair)
    assert c.get("repair_pairs", 0) == (r["n"] if repair else 0)
    assert (c.get("hostneed_pairs", 0) > 0) == repair
    assert "budget" not in r["stderr"]


def test_tracing_off_on_a_batch(counted_rf):
    data, recs = _se_batch("fused")
    al = UnpairedAligner(data, make_policy("sensitive"), device="cpu")
    TRACE.clear()
    groups = al.collect_raw(al.submit(recs[:64]))
    assert len(groups) == 64
    assert TRACE.records == [] and counted_rf == []


def test_cli_host_path_lines(capsys):
    pcli._host_path_report({}, 5)
    assert capsys.readouterr().err == ""
    pcli._host_path_report({"overflow_batches": 2, "overflow_dropped": 31,
                            "repair_batches": 1, "repair_pairs": 2048,
                            "hostneed_pairs": 3}, 5)
    assert capsys.readouterr().err.splitlines() == [
        "fused DP budget exceeded in 2 of 5 batches (31 candidates); they "
        "ran on the host path",
        "pairing re-run on the host in 1 of 5 batches (2048 pairs, of which "
        "the device pairing flagged 3)"]


def test_cli_time_prints_the_spans(tmp_path):
    g, reads = corpus(400, n_alu=60)
    fa, fq = tmp_path / "g.fa", tmp_path / "r.fq"
    fa.write_text(">rep\n" + "".join("ACGTN"[c] for c in g) + "\n")
    fq.write_text("".join(
        f"@{n}\n{''.join('ACGTN'[c] for c in s)}\n+\n"
        f"{''.join(chr(x + 33) for x in q)}\n" for n, s, q in reads))
    idx = str(tmp_path / "idx")
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        assert pcli.main(["build", str(fa), idx, "-q"]) == 0
        assert pcli.main(["align", "-x", idx, "-U", str(fq), "-S",
                          os.path.join(tmp_path, "o.sam"), "--device",
                          "cpu", "-t", "--batch", "400"]) == 0
    lines = err.getvalue().splitlines()
    assert "fused DP budget exceeded in 1 of 1 batches" in err.getvalue()
    spans = {ln.split()[1].rstrip(":") for ln in lines
             if ln.startswith("Span ")}
    assert {"submit", "collect", "host_path", "host_search",
            "host_emit"} <= spans <= SPANS
    assert not TRACE.on
