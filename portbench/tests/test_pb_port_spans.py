"""The readers of the port's own spans (portbench/port_spans.py and the
metrics that use it) on synthetic records and a synthetic profiler trace:
the trace's reduction ignores the port's `bt2x:` ranges, idle gaps are
named by the innermost port span, and each reader gives its share."""

import json
import sys

import pytest

from portbench import manifest, port_spans
from portbench.run import Ctx
from portbench.tests.test_pb_trace import write_trace
from portbench.trace import Spans, Trace
from bowtie2_tpu_torch.utils.metrics import TRACE

NEW = {"se.submit_share", "pe.submit_share", "se.device_wait_share",
       "pe.device_wait_share", "se.emit_fused_share", "pe.emit_fast_share",
       "pe.host_search_share", "pe.host_pairing_share",
       "pe.host_emit_share", "long.host_emit_share"}

# the port's records of a 1-s window [10 s, 11 s] of the process's clock,
# in ns: a submit (holding a fetch); a collect holding a fetch, the fused
# SE emission (holding a replay), a host path (search, rescue with a
# backtrace, emission, and 50 ms of its own) and the fused PE emission; a
# submit before the window and one across its end
S = 10_000_000_000
MS = 1_000_000
RECORDS = [
    ["submit", S - 50 * MS, S - 40 * MS, -1, 0],
    ["submit", S + 0, S + 100 * MS, -1, 1],                     # 1
    ["fetch", S + 10 * MS, S + 20 * MS, 1, 1],
    ["collect", S + 100 * MS, S + 900 * MS, -1, 1],             # 3
    ["fetch", S + 100 * MS, S + 130 * MS, 3, 1],
    ["emit_fused", S + 130 * MS, S + 300 * MS, 3, 1],           # 5
    ["replay", S + 200 * MS, S + 250 * MS, 5, 1],
    ["host_path", S + 300 * MS, S + 800 * MS, 3, 1],            # 7
    ["host_search", S + 300 * MS, S + 500 * MS, 7, 1],          # 8
    ["fetch", S + 400 * MS, S + 420 * MS, 8, 1],
    ["rescue", S + 500 * MS, S + 600 * MS, 7, 1],               # 10
    ["host_backtrace", S + 550 * MS, S + 580 * MS, 10, 1],
    ["host_emit", S + 600 * MS, S + 750 * MS, 7, 1],
    ["emit_fast", S + 800 * MS, S + 900 * MS, 3, 1],
    ["submit", S + 950 * MS, S + 1050 * MS, -1, 2],
]
# percent of the 1-s window
WANT = {"se.submit_share": 9.0 + 5.0, "pe.submit_share": 9.0 + 5.0,
        "se.device_wait_share": 6.0, "pe.device_wait_share": 6.0,
        "se.emit_fused_share": 12.0, "pe.emit_fast_share": 10.0,
        "pe.host_search_share": 18.0, "pe.host_pairing_share": 5.0,
        "pe.host_emit_share": 15.0, "long.host_emit_share": 15.0}


@pytest.fixture
def records(monkeypatch):
    monkeypatch.setattr(TRACE, "records", [list(r) for r in RECORDS])
    port_spans._REPORTED.clear()
    return TRACE.records


def ctx_of(trace=None, spans=None):
    return Ctx(1.0, 10.0, 11.0, spans or Spans(), {}, 1, trace, set(), [])


def test_every_new_metric_has_a_reader():
    assert NEW <= set(manifest.metric_names())
    bench = manifest.Bench()
    entries = {m["name"]: m for m in bench.data["per_layer"]}
    for n in NEW:
        assert entries[n]["source"] == "program_span"
        assert entries[n]["unit"] == "%" and entries[n]["better"] == "lower"


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_reader_gives_its_share(records, name):
    got = manifest.reader(name)(ctx_of())
    assert got == pytest.approx(WANT[name], abs=1e-6)


def test_share_clips_to_the_window(records):
    ctx = ctx_of()
    assert port_spans.share(ctx, "host_path") == pytest.approx(50.0)
    assert port_spans.self_share(ctx, "rescue") == pytest.approx(7.0)
    assert port_spans.share(ctx, "collect") == pytest.approx(80.0)
    # 100 ms inside, and 50 of the one across the window's end
    assert port_spans.share(ctx, "submit") == pytest.approx(15.0)


def test_no_recorder_or_no_records_read_none(records, monkeypatch):
    ctx = ctx_of()
    far = Ctx(1.0, 100.0, 101.0, Spans(), {}, 1, None, set(), [])
    for name in NEW:
        assert manifest.reader(name)(far) is None
    monkeypatch.setitem(sys.modules, "bowtie2_tpu_torch.utils.metrics",
                        None)
    for name in NEW:
        assert manifest.reader(name)(ctx) is None


def test_gaps_named_by_innermost_port_span(tmp_path):
    p = tmp_path / "t.json"
    write_trace(p)
    tr = Trace(str(p))
    # the trace's 1-ms window; its gaps (70, 600) and (700, 900) us have
    # their middles at 335 us (in host_search) and 800 us (in emit_fast)
    us = 1000
    recs = [["collect", S + 100 * us, S + 990 * us, -1, 1],
            ["host_path", S + 300 * us, S + 990 * us, 0, 1],
            ["host_search", S + 300 * us, S + 500 * us, 1, 1],
            ["host_backtrace", S + 550 * us, S + 580 * us, 1, 1],
            ["emit_fast", S + 750 * us, S + 850 * us, 1, 1]]
    ctx = Ctx(1e-3, 10.0, 10.001, Spans(), {}, 1, tr, set(), [])
    assert port_spans.idle_gaps(ctx, recs) == [
        ["host_search", pytest.approx(530e-6)],
        ["emit_fast", pytest.approx(200e-6)]]
    assert port_spans.innermost(recs, S + 995 * us) == port_spans.OUTSIDE
    assert port_spans.innermost(recs, S + 930 * us) == "host_path"
    assert port_spans.innermost(recs, S + 560 * us) == "host_backtrace"
    assert port_spans.idle_gaps(ctx_of(), recs) is None     # no trace


def test_port_ranges_leave_the_trace_reduction_alone(tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    write_trace(a)
    ev = json.loads(a.read_text())["traceEvents"]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "bt2x:" + n,
            "ts": ts, "dur": dur}
           for n, ts, dur in (("collect", 1100.0, 890.0),
                              ("fetch", 1150.0, 40.0),
                              ("emit_fused", 1250.0, 600.0),
                              ("replay", 1300.0, 100.0))]
    b.write_text(json.dumps({"traceEvents": ev}))
    ta, tb = Trace(str(a)), Trace(str(b))
    assert tb.host == ta.host and tb.ops == ta.ops
    _busy, gaps = ta.busy()
    assert tb.busy() == ta.busy()
    assert tb.named_gaps(gaps) == ta.named_gaps(gaps)
    for t in (0.0, 150e-6, 350e-6, 999e-6):
        assert tb.host_at(t) == ta.host_at(t)


def test_report_logs_once(records, capsys):
    spans = Spans()
    spans.intervals["collect_raw"] = [(10.099, 10.901)]
    ctx = ctx_of(spans=spans)
    for name in sorted(NEW):
        manifest.reader(name)(ctx)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2
    assert out[0].startswith("portbench: port spans in the window")
    got = json.loads(out[0].split(": ", 2)[2])
    # the submit before the window is out; the one across its end is cut
    assert got["submit"] == [2, pytest.approx(0.15), pytest.approx(0.14)]
    assert got["fetch"][0] == 3
    # the port's collect (0.8 s) against the benchmark's (0.802 s)
    assert out[1] == ("portbench: port collect 0.800000 s against the "
                      "benchmark's collect_raw 0.802000 s: 0.2000 % of "
                      "the window")
