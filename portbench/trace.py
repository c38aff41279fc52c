"""The benchmark's own spans around calls into the port, and the
reduction of a torch.profiler trace of the window to device busy time,
idle gaps and kernel times.

Spans wrap (object, attribute) callables, as chip_smoke.py host_timers
does, and add a record_function range of the same name (`pb:<name>`) so
that the trace can say what the host was doing in each idle gap of the
device."""

import gzip
import json
import os
import re
import time

PREFIX = "pb:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Wall-clock intervals of wrapped callables, kept while `on`."""

    def __init__(self):
        self.on = False
        self.intervals = {}          # name -> [(t0, t1)]
        self._undo = []

    def wrap(self, obj, attr, name=None):
        import torch

        fn = getattr(obj, attr)
        name = name or attr
        acc = self.intervals.setdefault(name, [])

        def timed(*a, **k):
            if not self.on:
                return fn(*a, **k)
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(PREFIX + name):
                    return fn(*a, **k)
            finally:
                acc.append((t0, time.perf_counter()))
        setattr(obj, attr, timed)
        self._undo.append((obj, attr, fn))

    def seconds(self, name, t0, t1):
        """Wall seconds of the name's calls inside [t0, t1]."""
        return sum(max(0.0, min(b, t1) - max(a, t0))
                   for a, b in self.intervals.get(name, ()))

    def restore(self):
        for obj, attr, fn in reversed(self._undo):
            if isinstance(obj, type) or not hasattr(type(obj), attr):
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)
        self._undo.clear()


def csrc_kernels(csrc_dir):
    """Names of the __global__ functions of the port's CUDA sources."""
    names = set()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")
    for f in os.listdir(csrc_dir):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc_dir, f)) as fh:
                names.update(pat.findall(fh.read()))
    return names


def base_name(kernel):
    """A demangled kernel name without its return type, template
    arguments and parameters: `void (anonymous namespace)::
    sw_warp_kernel<1, false>(Args)` -> `sw_warp_kernel`."""
    s = clean(kernel).split("(")[0].split("<")[0].strip()
    return s.split()[-1].split("::")[-1] if s else kernel


def clean(kernel):
    """A demangled kernel name without `(anonymous namespace)::`."""
    return kernel.replace("(anonymous namespace)::", "")


class Trace:
    """The device activity of a profiled window, in seconds from the
    window's start: `ops` [(name, category, start, dur)], on every card;
    `on_device` {card: [(start, dur)]}; `host` [(span name, start, end)]
    of the benchmark's spans; `window_s`."""

    def __init__(self, path, window_name=PREFIX + "window"):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events = json.load(f)["traceEvents"]
        win = [e for e in events if e.get("name") == window_name
               and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError("the trace holds no window annotation")
        t0 = float(win[0]["ts"])
        self.window_s = float(win[0]["dur"]) * 1e-6
        t1 = t0 + float(win[0]["dur"])
        self.ops, self.host, self.on_device = [], [], {}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s, d = float(e["ts"]), float(e["dur"])
            if s + d < t0 or s > t1:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                a, b = max(s, t0), min(s + d, t1)
                self.ops.append((e.get("name", "?"), cat, (a - t0) * 1e-6,
                                 (b - a) * 1e-6))
                self.on_device.setdefault(
                    int((e.get("args") or {}).get("device", 0)), []).append(
                        ((a - t0) * 1e-6, (b - a) * 1e-6))
            elif cat == "user_annotation" and \
                    e.get("name", "").startswith(PREFIX) and \
                    e["name"] != window_name:
                self.host.append((e["name"][len(PREFIX):], (s - t0) * 1e-6,
                                  (s + d - t0) * 1e-6))
        self.ops.sort(key=lambda o: o[2])

    def busy(self, card=None):
        """Seconds of the window in which some device operation ran (the
        union of their intervals; on one card, where given), and the idle
        gaps [(start, end)]."""
        busy, gaps, end = 0.0, [], 0.0
        ivs = [(s, d) for _n, _c, s, d in self.ops] if card is None else \
            sorted(self.on_device.get(card, ()))
        for s, d in ivs:
            if s > end:
                gaps.append((end, s))
            if s + d > end:
                busy += s + d - max(s, end)
                end = s + d
        if end < self.window_s:
            gaps.append((end, self.window_s))
        return busy, gaps

    def kernel_seconds(self):
        """{kernel name: summed seconds} over the window's kernels."""
        out = {}
        for n, c, _s, d in self.ops:
            if c == "kernel":
                out[n] = out.get(n, 0.0) + d
        return out

    def host_at(self, t):
        """The innermost benchmark span the host was in at time t."""
        inner = None
        for name, a, b in self.host:
            if a <= t <= b and (inner is None or a >= inner[1]):
                inner = (name, a)
        return inner[0] if inner else "outside the port's calls"

    def named_gaps(self, gaps, top=10):
        """The longest idle gaps, each named by the span the host was in
        at its middle: [[name, seconds]]."""
        longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:top]
        return [[self.host_at((a + b) / 2), b - a] for a, b in longest]
