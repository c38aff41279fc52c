"""The port's own spans over the window, for the per-layer metrics that
read them (portbench/metrics/*.py).

The port keeps its spans in memory (bowtie2_tpu_torch/utils/metrics.py
`TRACE`: name, start, end, parent span, batch, on time.perf_counter_ns)
while torch.profiler records, so a traced run on the card (--trace 1)
holds every span of its window, and each also shows in the profiler's
trace as a `bt2x:<name>` range. A share is percent of the window, each
span clipped to [t0, t1] (the window's own time.perf_counter, the clock
of the records). A program without the recorder, or a run that recorded
nothing in the window (--trace 0, or the CPU, where nothing profiles),
reads None, and the metric is left out of the result.

The first reader of a run also logs the port's view of the window:
each span's calls, seconds and self seconds; the port's `collect`
against the benchmark's own span around `collect_raw`; and the ten
longest idle gaps of the device, each named by the innermost port span
the host was in at the gap's middle ("outside the port" where none
was)."""

import json

OUTSIDE = "outside the port"


def recorder(ctx):
    """The port's recorder where it recorded a span inside the window,
    else None."""
    try:
        from bowtie2_tpu_torch.utils.metrics import TRACE
    except ImportError:
        return None
    a, b = int(ctx.t0 * 1e9), int(ctx.t1 * 1e9)
    if not any(r[2] > a and r[1] < b for r in TRACE.records):
        return None
    return TRACE


def share(ctx, name):
    """Percent of the window inside the port's spans `name` (a span
    inside one of its own name counted once)."""
    tr = recorder(ctx)
    if tr is None:
        return None
    report(ctx, tr)
    return 100.0 * tr.seconds(name, ctx.t0, ctx.t1) / ctx.window_s


def self_share(ctx, name):
    """Percent of the window in the self time of the port's spans `name`:
    their time less what their child spans cover."""
    tr = recorder(ctx)
    if tr is None:
        return None
    report(ctx, tr)
    return 100.0 * tr.self_seconds(name, ctx.t0, ctx.t1) / ctx.window_s


def innermost(records, t_ns):
    """The name of the innermost record covering time t_ns, or OUTSIDE.
    Spans nest, so the covering record that started last is the
    innermost."""
    inner = None
    for r in records:
        if r[1] <= t_ns <= r[2] and (inner is None or r[1] >= inner[1]):
            inner = r
    return inner[0] if inner else OUTSIDE


def idle_gaps(ctx, records, top=10):
    """The longest idle gaps of the device in the profiler's trace, each
    named by the innermost port span at its middle: [[name, seconds]].
    The trace counts from the window's start, the records from the
    process's clock: the window starts at t0 on both (the benchmark
    enters its window range just before it reads t0)."""
    if ctx.trace is None:
        return None
    _busy, gaps = ctx.trace.busy()
    longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:top]
    return [[innermost(records, int((ctx.t0 + (a + b) / 2) * 1e9)), b - a]
            for a, b in longest]


_REPORTED = set()


def report(ctx, tr):
    """Log the port's view of the window once a run (see the module's
    docstring)."""
    if id(ctx) in _REPORTED:
        return
    _REPORTED.add(id(ctx))
    t0, t1 = ctx.t0, ctx.t1
    a, b = int(t0 * 1e9), int(t1 * 1e9)
    names = sorted({r[0] for r in tr.records if r[2] > a and r[1] < b})
    spans = {n: [sum(1 for r in tr.records
                     if r[0] == n and r[2] > a and r[1] < b),
                 round(tr.seconds(n, t0, t1), 6),
                 round(tr.self_seconds(n, t0, t1), 6)] for n in names}
    _log("port spans in the window [calls, s, self s]: "
         + json.dumps(spans))
    if "collect_raw" in ctx.spans.intervals:
        outside = ctx.spans.seconds("collect_raw", t0, t1)
        inside = tr.seconds("collect", t0, t1)
        _log(f"port collect {inside:.6f} s against the benchmark's "
             f"collect_raw {outside:.6f} s: "
             f"{100.0 * (outside - inside) / ctx.window_s:.4f} % of the "
             f"window")
    gaps = idle_gaps(ctx, tr.records)
    if gaps is not None:
        _log("idle gaps by port span: " + json.dumps(
            [[n, round(s, 6)] for n, s in gaps]))


def _log(msg):
    print(f"portbench: {msg}", flush=True)
