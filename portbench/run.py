"""Run one cell of the benchmark of bowtie2_tpu_torch once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the port's kernels (the first run in a checkout), reads
the configuration's genome and index from portbench/cache (or makes them
there), makes the cell's reads from --seed and warms the aligner up on
reads of its own. The window then drives the port as its CLI does
(`submit`, then `collect_raw` once more than `depth` batches are in
flight) until the first `collect_raw` that returns after --seconds. The
rate is every read (or pair) of every batch collected over the time from
the window's start to that return. With --trace 1 the window runs under
torch.profiler with the benchmark's spans, and the result holds the
cell's per-layer metrics instead of its end-to-end ones. After the
window the plain reference (portbench/reference) judges a sample of the
collected records. The last line of standard output is the result.
"""

import os
import time

T_START = time.time()

# One host thread for every math library of the process, set before any
# of them loads: the port's host work is single-threaded Python and NumPy,
# and thread pools on a machine's shared host cores only add spread
# between runs (four torch threads spread runs of one seed 10-20 % on an
# H100 machine with 8 host cores).
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"

import argparse  # noqa: E402
import collections  # noqa: E402
import concurrent.futures  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

from portbench import deploy, manifest  # noqa: E402
from portbench.gen.traffic import Traffic  # noqa: E402
from portbench.reference.check import Judge  # noqa: E402
from portbench.trace import (Spans, Trace, base_name, clean,  # noqa: E402
                             csrc_kernels)
from portbench.window import drive, rate  # noqa: E402

THREADS = 1              # torch's host threads, fixed for steady runs
FORBIDDEN = ("jax", "jaxlib", "flax", "bowtie2_tpu")


def log(msg):
    print(f"portbench: {msg}", flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: bowtie2_tpu_torch is not bowtie2_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def policy(config):
    """The port's Policy for a configuration: its preset, with the
    scoring and paired-end settings it states."""
    from bowtie2_tpu_torch.pipeline.policy import make_policy

    s, pe = config["scoring"], config.get("pe") or {}
    kw = dict(match_bonus=s["ma"], mm_pen_max=s["mp"][0],
              mm_pen_min=s["mp"][1], n_pen=s["np"],
              read_gap_open=s["rdg"][0], read_gap_extend=s["rdg"][1],
              ref_gap_open=s["rfg"][0], ref_gap_extend=s["rfg"][1],
              gap_barrier=s["gbar"])
    if pe:
        kw.update(minins=pe["minins"], maxins=pe["maxins"],
                  mate_fw_rc=pe["orient"])
    return make_policy(config["preset"], local=bool(config["local"]), **kw)


M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3   # glibc's mallopt parameters


def pin_allocator(spec):
    """Fix glibc's mmap and trim thresholds where the mix asks for it
    (`"malloc": {"mmap_threshold": bytes, "trim_threshold": bytes}`).
    Left to itself glibc raises its mmap threshold (to 32 MiB at most) to
    the size of each larger mapped block that is freed, so whether the
    window's per-batch host arrays are mapped and unmapped on every call
    or kept on the heap depends on what the process freed before.
    Returns what was set, or None."""
    want = spec.get("malloc")
    if not want:
        return None
    import ctypes

    libc = ctypes.CDLL(None)
    for param, key in ((M_MMAP_THRESHOLD, "mmap_threshold"),
                       (M_TRIM_THRESHOLD, "trim_threshold")):
        if libc.mallopt(param, int(want[key])) != 1:
            raise RuntimeError(f"mallopt refused {key} = {want[key]}")
    return want


def make_batch(draw, k, tag, mode):
    """Batch k of a read stream as (units, names, the port's records)."""
    units = draw(k)
    names = [f"{tag}{k}r{i}" for i in range(len(units))]
    return units, names, mode.records(units, names)


class DPLog:
    """The rectangle DP's calls on the card during the window: each
    call's live problems' lengths and rect columns, for the roofline
    (work/dp.py). Holds the call's small tensors and reads them after
    the window, so the window has no extra host sync."""

    def __init__(self, sw_mod):
        self.calls = []
        self.on = False
        self._sw, self._fn = sw_mod, sw_mod._sw_banded_cuda

        def logged(reads, mmpen, read_lens, refwins, p, rect_cols, col_lo,
                   n_live=None, track_origin=False):
            if self.on:
                self.calls.append((read_lens, rect_cols, col_lo is not None,
                                   n_live, track_origin))
            return self._fn(reads, mmpen, read_lens, refwins, p, rect_cols,
                            col_lo, n_live=n_live, track_origin=track_origin)
        sw_mod._sw_banded_cuda = logged

    def restore(self):
        self._sw._sw_banded_cuda = self._fn

    def work(self):
        """[(origin, least seconds)] of the logged calls."""
        from portbench.work.dp import dp_work, least_seconds
        out = []
        for lens, rc, has_lo, n_live, origin in self.calls:
            n = lens.shape[0] if n_live is None else int(n_live)
            n = min(max(n, 0), lens.shape[0])
            byt, cells = dp_work(lens[:n].cpu().numpy(),
                                 rc[:n].cpu().numpy(), has_lo, origin)
            out.append((origin, least_seconds(byt, cells, origin)))
        return out


class Ctx:
    """What a per-layer metric's reader (portbench/metrics/*.py) reads:
    the window's spans, the port's counters, the profiler's trace, the
    DP calls' work."""

    def __init__(self, window_s, t0, t1, spans, counters, batches, trace,
                 csrc, dp):
        self.window_s, self.t0, self.t1 = window_s, t0, t1
        self.spans, self.counters, self.batches = spans, counters, batches
        self.trace, self.csrc, self.dp = trace, csrc, dp

    def span_share(self, name):
        """Percent of the window spent in the span `name` (0 where it was
        wrapped and never called), or None where no span wraps it."""
        if name not in self.spans.intervals:
            return None
        return 100.0 * self.spans.seconds(name, self.t0, self.t1) / \
            self.window_s

    def idle_pct(self):
        if self.trace is None:
            return None
        busy, _ = self.trace.busy()
        return 100.0 * (1.0 - busy / self.trace.window_s)

    def torch_op_share(self):
        """Percent of the window's device time (kernels, copies, sets) in
        kernels not built from the port's csrc/."""
        if self.trace is None:
            return None
        total = sum(d for _n, _c, _s, d in self.trace.ops)
        other = sum(d for n, c, _s, d in self.trace.ops
                    if c == "kernel" and base_name(n) not in self.csrc)
        return 100.0 * other / total if total > 0 else None

    def dp_kernel(self, name):
        """Whether a kernel of the profiler's trace is the rectangle DP,
        and whether it tracks origins: (is_dp, origin)."""
        b = base_name(name)
        if b == "sw_warp_kernel":
            last = clean(name).split(">")[0].split(",")[-1].strip()
            return True, last in ("true", "(bool)1", "1")
        if b == "sw_block_kernel":
            return True, False
        if b.startswith("sw_block_origin"):
            return True, True
        return False, False

    def dp_roofline(self, origin):
        """Percent of the rectangle DP's roofline over the window's calls
        of one entry (origin tracking or not): the mean least time a call
        needs over the mean time of its kernels in the trace."""
        calls = [t for o, t in self.dp if o == origin]
        times = [d for n, c, _s, d in (self.trace.ops if self.trace else ())
                 if c == "kernel" and self.dp_kernel(n) == (True, origin)]
        if not calls or not times:
            return None
        return 100.0 * (sum(calls) / len(calls)) / (sum(times) / len(times))


def run_cell(cell, seed, seconds, trace, device="cuda", fault=None,
             cache=deploy.CACHE, t_start=T_START):
    """One run of a cell: returns the result object (without its checks'
    printing). device "cpu" runs the port's plain versions (tests);
    fault(aligner), where given, breaks the timed path underneath."""
    import torch

    torch.set_num_threads(THREADS)
    from bowtie2_tpu_torch.ops import _build, sw
    from bowtie2_tpu_torch.pipeline import traj_replay

    cuda = device == "cuda"
    spec, config = cell.traffic, cell.config
    mode = manifest.plug("modes", spec["mode"])
    paired = mode.PAIRED
    log(f"host: {os.cpu_count()} CPUs, torch threads {THREADS}; torch "
        f"{torch.__version__}")
    if cuda:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        log(f"card: {smi.stdout.strip() or 'nvidia-smi gave nothing'}")
        t = time.time()
        _build.build()
        log(f"kernels built or found in {time.time() - t:.3f} s")
    t = time.time()
    genome, data = deploy.load(config, cell.config_file, log, cache)
    log(f"genome and index of {cell.config_name} in {time.time() - t:.3f} s")
    al = mode.aligner(data, policy(config), None if cuda else "cpu",
                      cell.chips)
    if fault is not None:
        fault(al)
    traffic = Traffic(spec, genome, seed)
    pinned = pin_allocator(spec)
    if pinned:
        log(f"glibc allocator pinned: {json.dumps(pinned, sort_keys=True)}")
    t = time.time()
    gc.disable()             # millions of small objects: no collections
    # Batch k is drawn from (seed, k) alone, so the mix's `pool_threads`
    # make the same pool whatever their number: more where NumPy's bulk
    # draws release the GIL, one where the recipe loops in Python. They
    # have all ended before the warm-up.
    with concurrent.futures.ThreadPoolExecutor(
            int(spec["pool_threads"])) as ex:
        pool = list(ex.map(lambda k: make_batch(traffic.batch, k, "b", mode),
                           range(int(spec["pool_batches"]))))
    gc.enable()
    log(f"read pool: {len(pool)} batches of {traffic.size} "
        f"{'pairs' if paired else 'reads'} in {time.time() - t:.3f} s")
    t = time.time()
    for k in range(int(spec["warm_batches"])):
        al.collect_raw(al.submit(make_batch(traffic.warm, k, "w", mode)[2]))
    spans, dplog, prof = Spans(), None, None
    if trace:
        for attr in spec["spans"]:
            spans.wrap(al, attr)
        spans.wrap(traj_replay, "run_replays")
        if cuda:
            dplog = DPLog(sw)
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts):  # its first start
                torch.ones(1, device="cuda").add_(1)
            prof = torch.profiler.profile(activities=acts)
    if cuda:
        torch.cuda.synchronize()
    log(f"warm-up: {spec['warm_batches']} batches in {time.time() - t:.3f} s")

    gc.collect()
    gc.freeze()              # the read pool is the benchmark's, not the port's
    setup_s = time.time() - t_start
    counters0 = dict(al.metrics.counters)
    _build.reset_counts()
    if prof is not None:
        prof.start()
        dplog.on = True
    extra = []

    def batch_at(k):
        if k < len(pool):
            return pool[k]
        extra.append(k)
        return make_batch(traffic.batch, k, "b", mode)

    def collect(h):
        # the batch's SAM text, as the CLI writes it (cli/main.py)
        return b"\n".join(line for g in al.collect_raw(h) for _f, line in g)

    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    with torch.profiler.record_function("pb:window") if trace \
            else contextlib.nullcontext():
        spans.on = True
        collected, pend, t0, t1, marks = drive(
            al.submit, collect, batch_at, int(spec["depth"]), seconds)
        spans.on = False
    gc.unfreeze()
    if cuda:
        torch.cuda.synchronize()
    if prof is not None:
        dplog.on = False
        prof.stop()
    launches = dict(_build.LAUNCHES)
    counters = {c: v - counters0.get(c, 0)
                for c, v in al.metrics.counters.items()}
    window_s = t1 - t0
    n_units = sum(len(u) for u, _g, _n in collected)
    per_s = rate(collected, t0, t1)
    if extra:
        print(f"portbench: the read pool ({len(pool)} batches) ran dry: "
              f"{len(extra)} batches were made inside the window from "
              f"(seed, batch), and their making is in its time; the "
              f"result says so under `batches_made_in_window`",
              file=sys.stderr, flush=True)
    log(f"window: {len(collected)} batches collected ({n_units} "
        f"{'pairs' if paired else 'reads'}) in {window_s:.6f} s = "
        f"{per_s:.4f}/s; {len(pend)} batches in flight at its end; port "
        f"counters {json.dumps(counters, sort_keys=True)}; launches "
        f"{json.dumps(launches, sort_keys=True)}")
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    log(f"this process's CPU time in the window: "
        f"{ru1.ru_utime - ru0.ru_utime + ru1.ru_stime - ru0.ru_stime:.3f} s "
        f"of {t1 - t0:.3f} s, {ru1.ru_stime - ru0.ru_stime:.3f} s of it "
        f"in the system")
    gaps = np.diff([t0] + marks)
    log(f"seconds between collects: first {gaps[0]:.4f}, then median "
        f"{np.median(gaps[1:]) if len(gaps) > 1 else 0:.4f}, quartiles "
        f"{np.percentile(gaps[1:], 25) if len(gaps) > 1 else 0:.4f} "
        f"{np.percentile(gaps[1:], 75) if len(gaps) > 1 else 0:.4f}, "
        f"max {gaps.max():.4f}")
    t = time.time()
    while pend:
        al.collect_raw(pend.popleft()[2])
    if cuda:
        torch.cuda.synchronize()
    log(f"in-flight batches drained in {time.time() - t:.3f} s")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(i))
                                    for i in range(cell.chips))
           if cuda else 0}

    metrics, breakdown = {}, None
    if trace:
        tr = None
        if prof is not None:
            t = time.time()
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                prof.export_chrome_trace(path)
                tr = Trace(path)
            finally:
                os.unlink(path)
            dplog.restore()
            busy, gaps = tr.busy()
            dev["busy_s"] = busy if cell.chips == 1 else sum(
                tr.busy(i)[0] for i in range(cell.chips)) / cell.chips
            dev["window_s"] = tr.window_s
            csrc = csrc_kernels(os.path.join(os.path.dirname(
                _build.__file__), os.pardir, "csrc"))
            seen = collections.Counter(
                base_name(n) for n, c, _s, _d in tr.ops if c == "kernel"
                and base_name(n) in csrc)
            want = sum(launches.values())
            log(f"profiler: {sum(seen.values())} launches of the port's "
                f"kernels seen ({json.dumps(dict(seen), sort_keys=True)}); "
                f"_build.LAUNCHES counts {want}; shortfall "
                f"{want - sum(seen.values())}; trace read in "
                f"{time.time() - t:.3f} s")
            ks = sorted(tr.kernel_seconds().items(), key=lambda x: -x[1])
            breakdown = {"device_ops": [[n, s] for n, s in ks[:10]],
                         "idle_gaps": tr.named_gaps(gaps)}
        else:
            csrc = set()
        log("spans in the window: " + json.dumps({
            n: [len(v), round(spans.seconds(n, t0, t1), 6)]
            for n, v in sorted(spans.intervals.items())}))
        spans.restore()
        ctx = Ctx(window_s, t0, t1, spans, counters, len(collected), tr,
                  csrc, dplog.work() if dplog else [])
        for m in cell.per_layer:
            v = manifest.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] == spec["rate_metric"]:
                metrics[m["name"]] = {"value": per_s, "unit": m["unit"]}

    del al
    if cuda:
        torch.cuda.empty_cache()
    t = time.time()
    judge = Judge(genome, config, spec, paired)
    nums = judge.judge(collected, seed)
    log(f"reference: {nums['eligible']} reads of a sample of "
        f"{min(judge.size, n_units)} units judged in {time.time() - t:.3f} "
        f"s: {json.dumps(nums)}")
    checks = {c: {"value": nums[c], "limit": cell.limits[c]}
              for c in ("missing", "field_err", "miss_pct")}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": n_units * (2 if paired else 1),
           "failed": nums["missing"], "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["batches_made_in_window"] = len(extra)
    out["checks"] = checks
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = manifest.Bench().cell(a.workload)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"portbench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    out = run_cell(cell, a.seed, a.seconds, a.trace)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}, which nothing the "
              f"benchmark runs may import", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
