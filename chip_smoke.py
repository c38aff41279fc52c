#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (bowtie2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--reads 100000] [--batch 8192] [--seed 7]

Phases, each of which exits non-zero when it fails:

1. The card: prints `nvidia-smi`'s name and power limit and the torch and
   CUDA versions, then builds every CUDA kernel of the port from
   `bowtie2_tpu_torch/csrc/` (one nvcc process per source, all at once).
2. The corpus: the default genome of scripts/make_repcorpus.py (5 Mbp,
   1200 Alu-like copies, 5 tandem arrays) and --reads 100-bp reads drawn
   from it with --seed, as that script draws them. The index is built on
   the host and its tables are moved to the card.
3. The main path: `UnpairedAligner.submit` / `collect_raw` over batches of
   --batch reads, driven as bench.py's run() drives the JAX package, at
   --sensitive defaults (end to end). The kernel launch counts are set to 0
   just before and read just after: every kernel must have launched, and
   no plain PyTorch version may have run.
4. The output: the SAM groups of the first batch must be byte-identical
   to the same aligner's run with device="cpu" (the plain versions).
5. The --local path: the first batch again with --sensitive-local, with
   its own counts and the same two checks.
6. The kernels: each kernel is run again on the inputs the end-to-end
   path gave it first and held to its plain version on the same card
   tensors (exact equality: every contract is integer), and so are the
   inputs the --local path gave it; the end-to-end ones are timed with
   CUDA events, and the least time the card could take is computed from
   them: the larger of the bytes the function must move over 3.35 TB/s
   and the integer operations it needs over 67 T/s (see OPS_* below).

The lines before the last are a JSON object {"kernels": [...]} and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, SXM part): HBM bandwidth, and 67e12
# float32 operations a second outside the tensor cores. The data sheet
# gives no 32-bit integer rate; no unit of the card issues more 32-bit
# integer operations a second than that (the float32 figure counts a
# fused multiply-add as two), so integer operations over it give a time
# no longer than the least the card could take.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

# the least integer operations each unit of work needs, counted from the
# function each kernel computes (not from the kernels' instruction mix):
# - one LF step, occ(c, i) = fchr[c] + cp[c] + #(c among the block's first
#   i mod 128 codes) - [c == 0 and i > z]. The codes lie 16 to a 32-bit
#   word, so a step needs on average 4.5 of the block's 8 words, each an
#   XOR with c's pattern, a fold of every 2-bit code to one bit (shift,
#   AND, AND), a popcount and an add (6); then the two adds and the
#   z-row test and subtract (4): 31;
# - one sa_resolve step: the code at the row (shift, AND), its mark bit
#   (shift, AND) and an LF step: 35; per row, the marked row's rank (on
#   average 2 of 4 mark words below it: mask, popcount, add each), the
#   rank add and offs[rank] + steps: 9;
# - one DP cell of the affine-gap recurrence: the substitution score
#   (compare, select), E and F (two subtracts and a max each), the
#   diagonal add, H as the max of three (two maxes), the best-cell
#   compare: 12;
# - one backtrace step: the cell's direction bits (shift, AND), the move
#   (compare, select), row and column (two adds), the op byte (shift, OR)
#   and the score term (add): 9.
OPS_LF = 31
OPS_RESOLVE_STEP = 35
OPS_RESOLVE_ROW = 9
OPS_DP_CELL = 12
OPS_BT_STEP = 9

KERNELS = {  # name -> (source, TPU-side function it replaces)
    "fm_sweep": ("bowtie2_tpu_torch/csrc/fm_search.cu",
                 "bowtie2_tpu/ops/fm.py:215"),
    "fm_seed": ("bowtie2_tpu_torch/csrc/fm_search.cu",
                "bowtie2_tpu/ops/fm.py:335"),
    "fm_substring": ("bowtie2_tpu_torch/csrc/fm_search.cu",
                     "bowtie2_tpu/ops/fm.py:275"),
    "sa_resolve": ("bowtie2_tpu_torch/csrc/sa_resolve.cu",
                   "bowtie2_tpu/ops/fm.py:408"),
    "sw_rect": ("bowtie2_tpu_torch/csrc/sw_rect.cu",
                "bowtie2_tpu/ops/pallas_sw.py:145"),
    "backtrace": ("bowtie2_tpu_torch/csrc/backtrace.cu",
                  "bowtie2_tpu/ops/sw.py:365"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def load_repcorpus():
    path = os.path.join(HERE, "scripts", "make_repcorpus.py")
    spec = importlib.util.spec_from_file_location("make_repcorpus", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Recorder:
    """Wraps each kernel's wrapper to keep the arguments of its first
    call, so phase 5 replays the kernels at the main path's shapes."""

    def __init__(self, fm, sw):
        self.args = {}
        i32 = torch.int32
        self._patch(fm, "exact_sweep_rr", "fm_sweep",
                    lambda half, rr: (half, rr.to(i32).contiguous()))
        self._patch(fm, "substring_search_rr", "fm_substring",
                    lambda half, rr: (half, rr.to(i32).contiguous()))
        self._patch(fm, "seed_search_exact", "fm_seed",
                    lambda half, seeds, valid, seed_len, ftab_chars=0: (
                        half, seeds.to(i32).contiguous(),
                        valid.to(torch.bool).contiguous(), seed_len,
                        ftab_chars))
        self._patch(fm, "sa_resolve", "sa_resolve",
                    lambda half, rows, period=32: (
                        half, rows.to(i32).contiguous(), period))
        self._patch(sw, "_sw_banded_cuda", "sw_rect", lambda *a: a)
        self._patch(sw, "_backtrace_cuda", "backtrace", lambda *a: a)

    def take(self):
        """The arguments recorded so far; recording starts afresh."""
        args, self.args = self.args, {}
        return args

    def _patch(self, mod, attr, name, norm):
        orig = getattr(mod, attr)

        def wrapped(*a, **k):
            if name not in self.args:
                self.args[name] = norm(*a, **k)
            return orig(*a, **k)
        setattr(mod, attr, wrapped)
        setattr(self, "orig_" + name, orig)


def host_timers(targets):
    """Wall seconds spent in each (object, attribute) callable: where the
    host's time goes on the main path. Returns the accumulating dict."""
    acc = {}
    for obj, attr in targets:
        fn = getattr(obj, attr)

        def timed(*a, _fn=fn, _name=attr, **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                acc[_name] = acc.get(_name, 0.0) + time.perf_counter() - t0
        setattr(obj, attr, timed)
    return acc


def time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def fm_work(fm, name, args):
    """(bytes, LF steps) that the search needs on these inputs: each
    input read once, each output written once; LF steps counted by
    replaying the plain version's state on the card."""
    half = args[0]
    tables = nbytes(half.fm_blocks, half.fchr)
    if name == "fm_sweep":
        rr = args[1]
        steps = int((rr < 4).sum()) * 2
        return tables + nbytes(rr) + 3 * rr.shape[0] * 4, steps
    if name == "fm_substring":
        rr = args[1]
        B, L = rr.shape
        top = torch.zeros(B, dtype=torch.int32, device=rr.device)
        bot = torch.full((B,), half.nrows, dtype=torch.int32,
                         device=rr.device)
        steps = 0
        for p in range(L):
            c = rr[:, p]
            live = (c < 4) & (top < bot)
            steps += 2 * int(live.sum())
            ntop, nbot = fm._lf2(half, top, bot, torch.clamp(c, 0, 3))
            dead = (c >= 4) | ~(top < bot)
            act = c < 5
            top = torch.where(act, torch.where(dead, 1, ntop), top)
            bot = torch.where(act, torch.where(dead, 0, nbot), bot)
        return tables + nbytes(rr) + 2 * B * 4, steps
    if name == "fm_seed":
        _, seeds, valid, seed_len, K = args
        B = seeds.shape[0]
        # replay: ftab start (last K chars), then LF steps right to left
        if not 0 < K <= seed_len:
            K = 0
        if K:
            tail = seeds[:, seed_len - K:]
            w = 4 ** torch.arange(K - 1, -1, -1, dtype=torch.int32,
                                  device=seeds.device)
            key = (torch.clamp(tail, 0, 3) * w).sum(dim=1)
            top0, bot0 = fm.ftab_lookup_batch(half, key)
            ok = valid & ~(tail >= 4).any(dim=1)
            top = torch.where(ok, top0, 1)
            bot = torch.where(ok, bot0, 0)
        else:
            top = torch.zeros(B, dtype=torch.int32, device=seeds.device)
            bot = torch.where(valid, half.nrows, 0).to(torch.int32)
        steps = 0
        for q in range(seed_len - K - 1, -1, -1):
            c = seeds[:, q]
            live = (c < 4) & (top < bot)
            steps += 2 * int(live.sum())
            ntop, nbot = fm._lf2(half, top, bot, torch.clamp(c, 0, 3))
            dead = (c >= 4) | ~(top < bot)
            top = torch.where(dead, 1, ntop)
            bot = torch.where(dead, 0, nbot)
        return (tables + nbytes(half.ftab, seeds, valid) + 2 * B * 4,
                steps)
    raise KeyError(name)


def resolve_work(fm, args):
    """sa_resolve: bytes of the tables and rows; steps = the LF walk
    length of each row (offset minus the marked row's sample)."""
    half, rows, period = args
    steps = 0
    row = rows.clone()
    done = torch.zeros_like(row, dtype=torch.bool)
    for _ in range(period):
        block = row // 128
        pos = (row % 128)[:, None]
        mb, _ = fm._mark_bits(half, block)
        done = done | (mb.gather(1, pos.long())[:, 0] == 1)
        steps += int((~done).sum())
        frows = fm._rows(half, block)
        c = fm._crumbs(frows[:, :8]).gather(1, pos.long())[:, 0]
        nrow = half.fchr.index_select(0, c.long()) + \
            fm._occ_rows(half, row, c, frows)
        row = torch.where(done, row, nrow.to(torch.int32))
    byt = nbytes(half.fm_blocks, half.fchr, half.mark_rows, half.offs,
                 rows) + rows.numel() * 4
    return byt, steps * OPS_RESOLVE_STEP + rows.numel() * OPS_RESOLVE_ROW


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--reps", type=int, default=20,
                    help="launches per kernel timing")
    a = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one GPU")
    sys.path.insert(0, HERE)
    try:
        from bowtie2_tpu_torch.index.build import build_index_from_refs
        from bowtie2_tpu_torch.io.fastx import SeqRecord
        from bowtie2_tpu_torch.ops import _build, fm, sw
        from bowtie2_tpu_torch.pipeline.align import (UnpairedAligner,
                                                      bucket_groups)
        from bowtie2_tpu_torch.pipeline import traj_replay
        from bowtie2_tpu_torch.pipeline.policy import make_policy
        mrc = load_repcorpus()
    except (ImportError, FileNotFoundError) as e:
        fail(f"the port is not beside this script: {e}")
    if "jax" in sys.modules or any(m.startswith("bowtie2_tpu.")
                                   for m in sys.modules):
        fail("the JAX package was imported")

    # ---------------- phase 1: card, versions, kernel build ----------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "unknown"
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.time()
    try:
        _build.build()
    except Exception as e:                      # nvcc missing or failing
        fail(f"kernel build: {e}")
    log(f"kernel build: {time.time() - t0:.1f} s "
        f"({', '.join(_build.SOURCES)})")

    # ---------------- phase 2: corpus + index ----------------
    t0 = time.time()
    rng = np.random.default_rng(a.seed)
    genome = mrc.make_genome(rng)
    reads = mrc.sample_reads(rng, genome, a.reads)
    records = [SeqRecord(name=f"rr{i}", seq=r.astype(np.uint8),
                         qual=q.astype(np.uint8))
               for i, (r, q) in enumerate(reads)]
    data = build_index_from_refs([("rep", genome.astype(np.uint8))])
    log(f"corpus: {genome.size} bp genome, {len(records)} reads, index "
        f"built in {time.time() - t0:.1f} s")

    # ---------------- phase 3: the main path on the card ----------------
    rec = Recorder(fm, sw)
    pol = make_policy("sensitive")
    aligner = UnpairedAligner(data, pol)
    spent = host_timers([(aligner, "submit"), (aligner, "collect_raw"),
                         (aligner, "_decode"),
                         (aligner, "_search_candidates"),
                         (traj_replay, "run_replays"),
                         (traj_replay, "emit_overrides")])
    torch.cuda.synchronize()

    def run(al, recs):
        by_bucket = bucket_groups([r.seq.size for r in recs])
        handles, firsts = [], []
        for bkt in sorted(by_bucket):
            idxs = by_bucket[bkt]
            for k in range(0, len(idxs), a.batch):
                chunk = [recs[j] for j in idxs[k:k + a.batch]]
                handles.append(al.submit(chunk))
                firsts.append(chunk)
        groups = [al.collect_raw(h) for h in handles]
        return groups, firsts

    _build.reset_counts()
    t0 = time.time()
    try:
        groups, chunks = run(aligner, records)
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"main path: {type(e).__name__}: {e}")
    wall = time.time() - t0
    launches = dict(_build.LAUNCHES)
    plain = dict(_build.PLAIN_CALLS)
    n_groups = sum(len(g) for g in groups)
    aligned = sum(1 for gs in groups for g in gs if not g[0][0] & 4)
    timers = {k: round(v, 3) for k, v in aligner.metrics.counters.items()
              if k.startswith("t_")}
    log(f"main path: {len(records)} reads in {wall:.2f} s = "
        f"{len(records) / wall:.1f} reads/s; {aligned} aligned; "
        f"host-path batches {aligner.metrics.counters.get('host_batches', 0)}"
        f" of {len(chunks)}; trajectory overrides "
        f"{aligner.metrics.counters.get('traj_overridden', 0)}; "
        f"launches {launches}; plain calls {plain}; host timers {timers}; "
        f"wall s in {({k: round(v, 2) for k, v in spent.items()})}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if n_groups != len(records):
        fail(f"{n_groups} SAM groups for {len(records)} reads")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    if plain:
        fail(f"plain versions ran on the card's main path: {plain}")
    if aligned < 0.9 * len(records):
        fail(f"only {aligned} of {len(records)} reads aligned")
    for gs in groups:
        for g in gs:
            for _flag, line in g:
                if line.count(b"\t") < 10:
                    fail(f"malformed SAM line: {line[:80]!r}")

    # ---------------- phase 4: card vs CPU on the first batch -------------
    t0 = time.time()
    cpu_al = UnpairedAligner(data, pol, device="cpu")
    cpu_groups = cpu_al.collect_raw(cpu_al.submit(chunks[0]))
    ndiff = sum(1 for x, y in zip(groups[0], cpu_groups) if x != y)
    log(f"SAM check: first batch of {len(chunks[0])} reads, card vs CPU "
        f"plain versions: {ndiff} groups differ ({time.time() - t0:.1f} s)")
    if len(cpu_groups) != len(groups[0]) or ndiff:
        fail(f"card and CPU SAM differ in {ndiff} of {len(chunks[0])} reads")
    e2e_args = rec.take()

    # ---------------- phase 5: the --local path, first batch ---------------
    lpol = make_policy("sensitive", local=True)
    laligner = UnpairedAligner(data, lpol)
    torch.cuda.synchronize()
    _build.reset_counts()
    t0 = time.time()
    try:
        lgroups = laligner.collect_raw(laligner.submit(chunks[0]))
        torch.cuda.synchronize()
    except Exception as e:
        fail(f"--local path: {type(e).__name__}: {e}")
    lwall = time.time() - t0
    llaunches = dict(_build.LAUNCHES)
    lplain = dict(_build.PLAIN_CALLS)
    laligned = sum(1 for g in lgroups if not g[0][0] & 4)
    log(f"--local path: {len(chunks[0])} reads in {lwall:.2f} s; "
        f"{laligned} aligned; launches {llaunches}; plain calls {lplain}")
    missing = [k for k in KERNELS if llaunches.get(k, 0) == 0]
    if missing:
        fail(f"kernels never launched on the --local path: {missing}")
    if lplain:
        fail(f"plain versions ran on the card's --local path: {lplain}")
    t0 = time.time()
    cpu_l = UnpairedAligner(data, lpol, device="cpu")
    cpu_lgroups = cpu_l.collect_raw(cpu_l.submit(chunks[0]))
    ndiff = sum(1 for x, y in zip(lgroups, cpu_lgroups) if x != y)
    log(f"SAM check (--local): card vs CPU plain versions: {ndiff} groups "
        f"differ ({time.time() - t0:.1f} s)")
    if len(cpu_lgroups) != len(lgroups) or ndiff:
        fail(f"--local card and CPU SAM differ in {ndiff} reads")
    local_args = rec.take()

    # ---------------- phase 6: each kernel against its plain version ------
    plains = {"fm_sweep": fm._sweep_plain, "fm_substring": fm._substring_plain,
              "fm_seed": fm._seed_plain, "sa_resolve": fm._resolve_plain,
              "sw_rect": sw._sw_banded_plain, "backtrace": sw._backtrace_plain}
    def max_err(kern, plain, args):
        got = kern(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        got_t = list(got) if isinstance(got, tuple) else [got]
        want_t = list(want) if isinstance(want, tuple) else [want]
        if len(got_t) != len(want_t):
            return got, 1 << 31
        err = 0
        for g, w in zip(got_t, want_t):
            if g.shape != w.shape:
                return got, 1 << 31
            if g.numel():
                err = max(err, int((g.long() - w.long()).abs().max()))
        return got, err

    kernels_out = []
    ok = True
    for name, (src, repl) in KERNELS.items():
        args = e2e_args[name]
        kern = getattr(rec, "orig_" + name)
        got, err = max_err(kern, plains[name], args)
        lerr = max_err(kern, plains[name], local_args[name])[1] \
            if name in local_args else 0
        equal = err == 0 and lerr == 0
        ok &= equal
        ms = time_cuda(lambda: kern(*args), a.reps)
        plain_ms = time_cuda(lambda: plains[name](*args), 2)
        if name in ("fm_sweep", "fm_substring", "fm_seed"):
            byt, lf = fm_work(fm, name, args)
            ops = lf * OPS_LF
        elif name == "sa_resolve":
            byt, ops = resolve_work(fm, args)
        elif name == "sw_rect":
            reads_, mmpen, lens, refwins, _p, rect_cols, col_lo = args
            res = got
            byt = nbytes(reads_, mmpen, lens, refwins, rect_cols) + \
                (nbytes(col_lo) if col_lo is not None else 0) + \
                nbytes(res.score, res.row, res.lane, res.dirs)
            # cells the data needs: each problem's rows x its rect columns
            ops = int((lens.long() * rect_cols.long()).sum()) * OPS_DP_CELL
        else:   # backtrace
            dirs, sel, rows, lanes, reads_, mmpen, refwins, _p, S = args
            walked = int((got.ops != 3).sum()) + sel.numel()
            byt = walked * 4 + nbytes(sel, rows, lanes, reads_, mmpen,
                                      refwins, got.ops) + 7 * sel.numel() * 4
            ops = walked * OPS_BT_STEP
        t_bytes = byt / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_OPS_S * 1e3
        kernels_out.append(dict(
            name=name, route="cuda", source=src, replaces=repl,
            launches=launches.get(name, 0), max_abs_err=max(err, lerr),
            equal=equal, launches_local=llaunches.get(name, 0),
            ms=round(ms, 4), plain_ms=round(plain_ms, 3),
            bound_ms=round(max(t_bytes, t_ops), 5),
            bytes_ms=round(t_bytes, 5), ops_ms=round(t_ops, 5),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None,
            shape=[list(t.shape) for t in args
                   if isinstance(t, torch.Tensor)][:2]))
        log(f"kernel {name}: equal={equal} max_abs_err={err} "
            f"(local {lerr}) "
            f"ms={ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={max(t_bytes, t_ops):.5f} (bytes {t_bytes:.5f}, "
            f"operations {t_ops:.5f})")
    print(json.dumps({"kernels": kernels_out}), flush=True)
    if not ok:
        fail("a kernel disagrees with its plain version")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
