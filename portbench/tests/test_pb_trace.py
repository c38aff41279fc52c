"""Idle share, named gaps and the DP roofline share on a synthetic
profiler trace."""

import json

import pytest

from portbench.run import Ctx
from portbench.trace import Spans, Trace, base_name


def write_trace(path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pb:window",
         "ts": 1000.0, "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "pb:collect_raw",
         "ts": 1100.0, "dur": 900.0},
        {"ph": "X", "cat": "user_annotation", "name": "pb:run_replays",
         "ts": 1200.0, "dur": 300.0},
        {"ph": "X", "cat": "kernel", "ts": 1000.0, "dur": 50.0,
         "name": "void sw_warp_kernel<1, false, false>(Args, SwParams)"},
        {"ph": "X", "cat": "kernel", "ts": 1020.0, "dur": 50.0,
         "name": "void at::native::elementwise_kernel<128, 2>(int)"},
        {"ph": "X", "cat": "kernel", "ts": 1600.0, "dur": 100.0,
         "name": "void (anonymous namespace)::sw_warp_kernel<2, false, "
                 "true>((anonymous namespace)::Args, SwParams)"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 1900.0, "dur": 150.0,
         "name": "Memcpy DtoH"},
        {"ph": "X", "cat": "kernel", "ts": 500.0, "dur": 10.0,
         "name": "void sw_block_kernel<1, false>(Args, SwParams)"},
    ]
    path.write_text(json.dumps({"traceEvents": ev}))


def test_busy_idle_and_gaps(tmp_path):
    p = tmp_path / "t.json"
    write_trace(p)
    tr = Trace(str(p))
    assert tr.window_s == pytest.approx(1e-3)
    busy, gaps = tr.busy()
    # [0, 70) + [600, 700) + [900, 1000) us of the window (the copy is
    # cut at its end; the kernel before the window is out)
    assert busy == pytest.approx(270e-6)
    assert [(round(a * 1e6), round(b * 1e6)) for a, b in gaps] == \
        [(70, 600), (700, 900)]
    named = tr.named_gaps(gaps)
    assert named[0][0] == "run_replays"
    assert named[0][1] == pytest.approx(530e-6)
    assert named[1] == ["collect_raw", pytest.approx(200e-6)]
    ctx = Ctx(1.0, 0.0, 1.0, Spans(), {}, 1, tr, {"sw_warp_kernel"},
              [(False, 25e-6), (False, 15e-6), (True, 50e-6)])
    assert ctx.idle_pct() == pytest.approx(73.0)
    # mean least time 20 us over the one non-origin kernel's 50 us
    assert ctx.dp_roofline(origin=False) == pytest.approx(40.0)
    assert ctx.dp_roofline(origin=True) == pytest.approx(50.0)
    # device time 50 + 50 + 100 + 100 (the copy, cut) us; the torch op's
    # 50 is a sixth of it
    assert ctx.torch_op_share() == pytest.approx(100.0 / 6)


def test_busy_on_each_card(tmp_path):
    p = tmp_path / "t.json"
    ev = [{"ph": "X", "cat": "user_annotation", "name": "pb:window",
           "ts": 0.0, "dur": 1000.0}]
    for card, (ts, dur) in ((0, (0.0, 100.0)), (1, (50.0, 300.0)),
                            (1, (500.0, 100.0))):
        ev.append({"ph": "X", "cat": "kernel", "ts": ts, "dur": dur,
                   "name": "void k(int)", "args": {"device": card}})
    p.write_text(json.dumps({"traceEvents": ev}))
    tr = Trace(str(p))
    assert tr.busy(0)[0] == pytest.approx(100e-6)
    assert tr.busy(1)[0] == pytest.approx(400e-6)
    assert tr.busy()[0] == pytest.approx(450e-6)
    assert tr.busy(2)[0] == 0.0


def test_base_names():
    assert base_name("void sw_warp_kernel<1, false, false>(Args, "
                     "SwParams)") == "sw_warp_kernel"
    assert base_name("void at::native::vectorized_elementwise_kernel<4, "
                     "at::native::FillFunctor<int> >(int)") == \
        "vectorized_elementwise_kernel"
    assert base_name("Memcpy DtoH") == "DtoH"
    assert base_name("void (anonymous namespace)::sw_block_kernel<1, "
                     "false>((anonymous namespace)::Args)") == \
        "sw_block_kernel"


def test_span_share_counts_only_the_window():
    spans = Spans()
    spans.intervals["collect_raw"] = [(0.5, 1.5), (2.0, 3.0)]
    spans.intervals["run_replays"] = []
    ctx = Ctx(2.0, 1.0, 3.0, spans, {}, 1, None, set(), [])
    assert ctx.span_share("collect_raw") == pytest.approx(75.0)
    assert ctx.span_share("run_replays") == 0.0
    assert ctx.span_share("_emit_aligned") is None
    assert ctx.idle_pct() is None
