"""Interval metrics (reference PerfMetrics, bt2_search.cpp:1968-2870).

The reference merges per-thread counter blocks and emits a ~129-column TSV
line every --met seconds. Here the pipeline is batched, so counters
accumulate per batch under a lock and `report_line` emits one row; the CLI
drives periodic emission to --met-file / --met-stderr.

The header is the REFERENCE'S column set verbatim (bt2_search.cpp first-
line emission), so downstream --met consumers parse unchanged. Columns
whose counters exist in this pipeline are filled with real values:

  Time/Read/Base/UnfilteredRead/UnfilteredBase, Paired/Unpaired,
  AlCon*/AlDis/AlUnp* outcome counts, SeedSearch/NRange/NElt,
  ExactAttempts/ExactSucc/ExactRanges/ExactRows (exact-sweep phase),
  1mmAttempts/1mmRanges (pigeonhole half-read phase), the DP16Ex* family
  (our single int32 kernel reports as the 16-bit lane: Dps/Cell/Bt) and
  MemPeak (host RSS). Counters tied to reference-internal mechanisms that
  do not exist here (SSE 8-bit lane, cache hits, checkpoint fixups,
  mini-fill rejections) stay 0 — structurally absent, not unmeasured.

`TRACE` is the process's span recorder: where the aligners do their work
per batch (submit, the blob's readback, the emission, the host path and
its phases, the replay) they open a span, and while tracing is on each
span is kept in memory as a record and shows in torch.profiler's trace as
a `bt2x:<name>` range, on the clock of the kernels and copies. Off, a
span costs two attribute tests.
"""

import contextlib
import functools
import threading
import time

import torch.autograd.profiler as _tprof

HEADER = (
    "Time Read Base SameRead SameReadBase UnfilteredRead UnfilteredBase "
    "Paired Unpaired AlConUni AlConRep AlConFail AlDis AlConFailUni "
    "AlConFailRep AlConFailFail AlConRepUni AlConRepRep AlConRepFail "
    "AlUnpUni AlUnpRep AlUnpFail SeedSearch NRange NElt IntraSCacheHit "
    "InterSCacheHit OutOfMemory AlBWOp AlBWBranch ResBWOp ResBWBranch "
    "ResResolve ResReport RedundantSHit BestMinEdit0 BestMinEdit1 "
    "BestMinEdit2 ExactAttempts ExactSucc ExactRanges ExactRows ExactOOMs "
    "1mmAttempts 1mmSucc 1mmRanges 1mmRows 1mmOOMs UngappedSucc "
    "UngappedFail UngappedNoDec DPExLt10Gaps DPExLt5Gaps DPExLt3Gaps "
    "DPMateLt10Gaps DPMateLt5Gaps DPMateLt3Gaps DP16ExDps DP16ExDpSat "
    "DP16ExDpFail DP16ExDpSucc DP16ExCol DP16ExCell DP16ExInner "
    "DP16ExFixup DP16ExGathSol DP16ExBt DP16ExBtFail DP16ExBtSucc "
    "DP16ExBtCell DP16ExCoreRej DP16ExNRej DP8ExDps DP8ExDpSat "
    "DP8ExDpFail DP8ExDpSucc DP8ExCol DP8ExCell DP8ExInner DP8ExFixup "
    "DP8ExGathSol DP8ExBt DP8ExBtFail DP8ExBtSucc DP8ExBtCell "
    "DP8ExCoreRej DP8ExNRej DP16MateDps DP16MateDpSat DP16MateDpFail "
    "DP16MateDpSucc DP16MateCol DP16MateCell DP16MateInner DP16MateFixup "
    "DP16MateGathSol DP16MateBt DP16MateBtFail DP16MateBtSucc "
    "DP16MateBtCell DP16MateCoreRej DP16MateNRej DP8MateDps DP8MateDpSat "
    "DP8MateDpFail DP8MateDpSucc DP8MateCol DP8MateCell DP8MateInner "
    "DP8MateFixup DP8MateGathSol DP8MateBt DP8MateBtFail DP8MateBtSucc "
    "DP8MateBtCell DP8MateCoreRej DP8MateNRej DPBtFiltStart DPBtFiltScore "
    "DpBtFiltDom MemPeak UncatMemPeak EbwtMemPeak CacheMemPeak "
    "ResolveMemPeak AlignMemPeak DPMemPeak MiscMemPeak DebugMemPeak"
).split()

# internal counter name -> reference column
COLMAP = {
    "reads": "Read", "bases": "Base",
    "unf_reads": "UnfilteredRead", "unf_bases": "UnfilteredBase",
    "pairs": "Paired", "unpaired": "Unpaired",
    "conc_uni": "AlConUni", "conc_rep": "AlConRep", "conc_fail": "AlConFail",
    "disc": "AlDis",
    "al_one": "AlUnpUni", "al_rep": "AlUnpRep", "unal": "AlUnpFail",
    "seed_searches": "SeedSearch",
    "seed_nrange": "NRange", "seed_nelt": "NElt",
    "fm_lf_steps": "AlBWOp",
    "sa_resolves": "ResResolve",
    "ex_attempts": "ExactAttempts", "ex_succ": "ExactSucc",
    "ex_ranges": "ExactRanges", "ex_rows": "ExactRows",
    "mm1_attempts": "1mmAttempts", "mm1_ranges": "1mmRanges",
    "dp_problems": "DP16ExDps", "dp_cells": "DP16ExCell",
    "backtraces": "DP16ExBt",
    "mate_dps": "DP16MateDps",
}

class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.t0 = time.time()
        self.counters = {}

    def add(self, **kw) -> None:
        with self._lock:
            for k, v in kw.items():
                self.counters[k] = self.counters.get(k, 0) + v

    def header_line(self) -> str:
        return "\t".join(HEADER)

    def report_line(self) -> str:
        import resource
        with self._lock:
            vals = {col: 0 for col in HEADER}
            for k, col in COLMAP.items():
                vals[col] = self.counters.get(k, 0)
            # al_multi folds into AlUnpUni (the reference's nunp_uni counts
            # every read reported non-repetitively, unique or not)
            vals["AlUnpUni"] += self.counters.get("al_multi", 0)
            vals["Time"] = f"{time.time() - self.t0:.2f}"
            vals["MemPeak"] = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024
        return "\t".join(str(int(v)) if not isinstance(v, str) else v
                         for v in (vals[c] for c in HEADER))


class MetricsSink:
    """Periodic TSV emitter (reference: reportInterval, bt2_search.cpp:2064)."""

    def __init__(self, metrics: Metrics, stream=None, path: str = None,
                 every: int = 1):
        self.metrics = metrics
        self.every = max(every, 1)
        self.f = open(path, "w") if path else stream
        self._last = 0.0
        if self.f:
            self.f.write(metrics.header_line() + "\n")

    def maybe_report(self) -> None:
        if self.f is None:
            return
        now = time.time()
        if now - self._last >= self.every:
            self._last = now
            self.f.write(self.metrics.report_line() + "\n")
            self.f.flush()

    def final(self) -> None:
        if self.f is None:
            return
        self.f.write(self.metrics.report_line() + "\n")
        self.f.flush()


SPAN_PREFIX = "bt2x:"       # the spans' record_function ranges


_NULL_SPAN = contextlib.nullcontext()    # the span of a recorder that is off


class _Span:
    __slots__ = ("tr", "rec", "rf")

    def __init__(self, tr, name):
        self.tr = tr
        self.rec = [name, 0, 0, tr._stack[-1] if tr._stack else -1,
                    tr.batch]

    def __enter__(self):
        tr, rec = self.tr, self.rec
        tr._stack.append(len(tr.records))
        tr.records.append(rec)
        self.rf = _tprof.record_function(SPAN_PREFIX + rec[0])
        self.rf.__enter__()
        rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        self.tr._stack.pop()
        return False


class Tracer:
    """Spans of the port's host work, one recorder a process (`TRACE`),
    as `ops/_build.LAUNCHES` is one launch counter a process.

    Tracing is on while `on` is set (the CLI's -t) or while
    torch.profiler records, so a profiled run gets the port's spans
    beside its kernels with no switch of its own. Each span is a record
    [name, start ns, end ns, parent record (-1 for none), batch number]
    on time.perf_counter_ns. `submit` numbers every batch
    (`next_batch`) and makes it the current one, as `collect_raw` does
    for the batch it collects, so every span of one batch carries its
    number. Spans go at batch level only, never inside a per-read loop,
    and are opened from one thread at a time."""

    def __init__(self):
        self.on = False
        self.records = []
        self.batch = -1
        self._stack = []
        self._batches = 0

    def span(self, name: str):
        """A context manager: the span `name` while tracing is on, else a
        shared one that records nothing."""
        if not (self.on or _tprof._is_profiler_enabled):
            return _NULL_SPAN
        return _Span(self, name)

    def traced(self, name: str):
        """Decorator: the function's every call is a span `name`."""
        def deco(fn):
            @functools.wraps(fn)
            def run(*a, **k):
                with self.span(name):
                    return fn(*a, **k)
            return run
        return deco

    def next_batch(self) -> int:
        """The next batch's number, made the current one."""
        self.batch = self._batches
        self._batches += 1
        return self.batch

    def clear(self) -> None:
        self.records = []
        self._stack = []

    @staticmethod
    def _bounds(t0, t1):
        """[t0, t1] in seconds of time.perf_counter, as ns (None: open)."""
        return (-1 << 62 if t0 is None else int(t0 * 1e9),
                1 << 62 if t1 is None else int(t1 * 1e9))

    @staticmethod
    def _clip(rec, a, b):
        return max(0, min(rec[2], b) - max(rec[1], a))

    def seconds(self, name: str, t0=None, t1=None) -> float:
        """Wall seconds inside [t0, t1] (time.perf_counter seconds) of the
        spans `name` that no span of the same name encloses."""
        a, b = self._bounds(t0, t1)
        recs = self.records
        tot = 0
        for rec in recs:
            if rec[0] != name:
                continue
            p = rec[3]
            while p >= 0 and recs[p][0] != name:
                p = recs[p][3]
            if p < 0:
                tot += self._clip(rec, a, b)
        return tot * 1e-9

    def self_seconds(self, name: str, t0=None, t1=None) -> float:
        """Self time of the spans `name` inside [t0, t1]: each span's time
        less what its child spans cover."""
        a, b = self._bounds(t0, t1)
        recs = self.records
        own = {i for i, r in enumerate(recs) if r[0] == name}
        tot = sum(self._clip(recs[i], a, b) for i in own)
        tot -= sum(self._clip(r, a, b) for r in recs if r[3] in own)
        return tot * 1e-9

    def totals(self):
        """{name: (count, total seconds, self seconds)} over every
        record."""
        names = sorted({r[0] for r in self.records})
        return {n: (sum(1 for r in self.records if r[0] == n),
                    self.seconds(n), self.self_seconds(n)) for n in names}


TRACE = Tracer()
