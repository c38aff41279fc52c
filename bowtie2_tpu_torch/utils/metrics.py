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
"""

import threading
import time

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

# kept for library users / internal timing reports
FIELDS = ("secs", "reads", "unal", "al_one", "al_multi",
          "fm_lf_steps", "sa_resolves", "dp_problems", "dp_cells",
          "backtraces",
          "t_search", "t_resolve", "t_dp", "t_backtrace", "t_host")


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
