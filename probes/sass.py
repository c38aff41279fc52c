"""Probe: the SASS of one kernel of a csrc/ source in two builds, from
two directories (e.g. the parent commit's bowtie2_tpu_torch/csrc and this
tree's), each built with the port's nvcc flags (each directory's headers
first) and read back by cuobjdump. Not part of the port and not run by
its tests.

    python3 probes/sass.py SOURCE DIR_A DIR_B --func NAME [--out DIR]

For each kernel whose name (as ops/_build.py kernel_name gives it)
starts with NAME: its instruction count in each build, by opcode, and the
opcodes whose counts differ; with --out, each build's listing without
addresses or encodings, and a unified diff of the two, as files there.
Prints the card's name and power limit, then one JSON object a line.
"""

import argparse
import difflib
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bowtie2_tpu_torch.ops import _build  # noqa: E402

INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def listing(src_dir, source, tmp, tag):
    """{kernel name: [instruction text]} of csrc-style source
    `source`.cu in src_dir, built with the port's flags."""
    so = os.path.join(tmp, f"{tag}.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", src_dir,
                        "-I", _build.CSRC, "-o", so,
                        os.path.join(src_dir, source + ".cu")],
                       capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"build of {src_dir}/{source}.cu failed:\n"
                 f"{r.stdout}{r.stderr}")
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(_build.kernel_name(m.group(1)), [])
            continue
        m = INSTR.search(line)
        if cur is not None and m:
            cur.append(re.sub(r"\s+", " ", m.group(1)))
    return out, _build.ptxas_usage(r.stdout + r.stderr)


def opcode(ins):
    parts = ins.split(" ")
    op = parts[1] if parts[0].startswith("@") and len(parts) > 1 \
        else parts[0]
    return op.split(".")[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source")
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    ap.add_argument("--func", required=True)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    tmp = tempfile.mkdtemp(prefix="probe_sass_")
    (la, ua), (lb, ub) = (listing(d, a.source, tmp, t) for d, t in (
        (a.dir_a, "a"), (a.dir_b, "b")))
    if a.out:
        os.makedirs(a.out, exist_ok=True)
    for name in sorted(set(la) | set(lb)):
        if not name.startswith(a.func):
            continue
        ia, ib = la.get(name, []), lb.get(name, [])
        ca, cb = ({}, {})
        for ins, c in ((ia, ca), (ib, cb)):
            for x in ins:
                c[opcode(x)] = c.get(opcode(x), 0) + 1
        diff = {op: [ca.get(op, 0), cb.get(op, 0)]
                for op in sorted(set(ca) | set(cb))
                if ca.get(op, 0) != cb.get(op, 0)}
        print(json.dumps({"kernel": name, "instructions": [len(ia), len(ib)],
                          "ptxas": [ua.get(name), ub.get(name)],
                          "opcodes_that_differ": diff}), flush=True)
        if a.out:
            base = os.path.join(a.out, re.sub(r"[^\w]+", "_", name))
            for tag, ins in (("a", ia), ("b", ib)):
                with open(f"{base}.{tag}.sass", "w") as f:
                    f.write("\n".join(ins) + "\n")
            with open(f"{base}.diff", "w") as f:
                f.writelines(difflib.unified_diff(
                    [x + "\n" for x in ia], [x + "\n" for x in ib],
                    "a", "b", n=2))


if __name__ == "__main__":
    main()
