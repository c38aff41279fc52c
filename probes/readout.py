"""Probe of K10 SE, the gapless readout (csrc/diag_readout.cu), beside
probes/readout_warp.cu (the same function with a warp a candidate) and,
with --parent DIR, another build of diag_readout.cu (DIR/diag_readout.cu)
on the card. Not part of the port and not run by its tests.

Each design is built with the port's nvcc flags (its ptxas line printed),
held to the plain version on every ops/cases.py readout case at scale 1
and 8 (exact), and timed in turns (each design in order, then in reverse,
TURN_REPS launches a window after a stream spin: chip_smoke.py
time_cuda) at each of SHAPES, candidates x Lmax x window width, built by
chip_smoke.py readout_call (diagonal start columns 30-61: a band of 30
plus a column shift below 32); then the summed time of the SE main
path's launches (LAUNCHES) in each design, launches x the mean of its
two windows.

    python3 probes/readout.py [--parent DIR]

Prints the card's name and power limit, then one JSON object a line.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from bowtie2_tpu_torch.ops import _build, cases, sw  # noqa: E402

# the SE main path's calls (chip_smoke.py phase 3: 50,000 100-bp reads in
# batches of 8,192, the last of 1,024 after padding), one block's worth,
# and the fused path's shapes for 250-300-bp and 500-768-bp reads
SHAPES = ((8192, 128, 224), (1024, 128, 224), (32, 128, 224),
          (8192, 384, 480), (128, 768, 864))
LAUNCHES = {(8192, 128, 224): 6, (1024, 128, 224): 1}
SEED = 7


def build(srcs):
    """{design: library} from {design: source path}, one nvcc each, all
    started together."""
    tmp = tempfile.mkdtemp(prefix="probe_readout_")
    procs = {}
    for name, src in srcs.items():
        so = os.path.join(tmp, name + ".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", so,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, p) in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            sys.exit(f"build of {srcs[name]} failed:\n{out}")
        libs[name] = ctypes.CDLL(so)
        print(json.dumps({"ptxas": name, "usage": _build.ptxas_usage(out)}),
              flush=True)
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, metavar="DIR")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    srcs = {"port": os.path.join(_build.CSRC, "diag_readout.cu"),
            "warp": os.path.join(ROOT, "probes", "readout_warp.cu")}
    if a.parent:
        srcs["parent"] = os.path.join(a.parent, "diag_readout.cu")
    libs = build(srcs)
    dev = torch.device("cuda")

    def run(name, args):
        return cs.with_lib(_build, libs[name],
                           lambda: sw.diag_readout(*args), "diag_readout")

    errs = {name: 0 for name in libs}
    for scale in (1, 8):
        for c in cases.readout_cases(scale=scale):
            args = tuple(torch.from_numpy(x).to(dev) for x in (
                c.reads, c.quals, c.wins, c.rows, c.lanes, c.lens)) + (
                sw.SWParams(**c.params),)
            want = sw._diag_readout_plain(*args)
            for name in libs:
                errs[name] = max(errs[name],
                                 cs.result_err(run(name, args), want))
    print(json.dumps({"max_abs_err_on_cases": errs}), flush=True)
    if any(errs.values()):
        sys.exit("a design differs from the plain version")

    names = list(libs)
    means = {}
    for i, (Bc, L, Wf) in enumerate(SHAPES):
        base = 30 + torch.randint(0, 32, (Bc,), generator=torch.Generator()
                                  .manual_seed(SEED + i)).numpy()
        args = cs.readout_call(Bc, L, Wf, base, sw.SWParams(), SEED + i,
                               dev)
        want = sw._diag_readout_plain(*args)
        err = {n: cs.result_err(run(n, args), want) for n in names}
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            ms[n].append(round(cs.time_cuda(lambda: run(n, args),
                                            cs.TURN_REPS), 5))
        means[(Bc, L, Wf)] = {n: sum(v) / 2 for n, v in ms.items()}
        print(json.dumps({"shape": [Bc, L, Wf], "reps": cs.TURN_REPS,
                          "ms": ms,
                          "max_abs_err": err}), flush=True)
    total = {n: sum(k * means[shape][n] for shape, k in LAUNCHES.items())
             for n in names}
    print(json.dumps({"launches": [list(k) + [v] for k, v in
                                   LAUNCHES.items()],
                      "summed_ms": {n: round(v, 5) for n, v in
                                    total.items()}}), flush=True)


if __name__ == "__main__":
    main()
