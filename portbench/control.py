"""The control of a cell's comparison, at the cell's own size: the
reference put in the program's place with one guarantee broken
(reference/control.py), judged exactly as a run's records are.

    python3 -m portbench.control --workload <name> --seed <n> [--batches 8]

It draws the cell's window batches 0..batches-1 from --seed, the same
sample of them that a run judges, and prints the comparison's numbers as
one JSON line. It needs no card and imports nothing of the port; the
benchmark's own runs do not run it.

    python3 -m portbench.control --workload <name> --seed <n> \
        --fault <name> [--seconds 5]

runs the cell on the card with a fault of portbench/faults.py planted
under the timed path, and prints that run's numbers."""

import argparse
import json
import sys
import time

from portbench import deploy, manifest
from portbench.faults import FAULTS
from portbench.gen.traffic import Traffic
from portbench.reference.check import Judge, reads_of, sample
from portbench.reference.control import control_groups


def control_numbers(cell, seed, batches, cache=deploy.CACHE):
    genome = deploy.genome_only(cell.config, cell.config_file, cache)
    traffic = Traffic(cell.traffic, genome, seed)
    units, names = [], []
    for k in range(batches):
        u = traffic.batch(k)
        units += u
        names += [f"b{k}r{i}" for i in range(len(u))]
    judge = Judge(genome, cell.config, cell.traffic,
                  manifest.plug("modes", cell.traffic["mode"]).PAIRED)
    lengths = [sum(r[0].size for r in reads_of(u)) for u in units]
    pick = sample(len(units), lengths, seed, judge.size)
    su, sn = [units[i] for i in pick], [names[i] for i in pick]
    out = judge.numbers(su, sn, control_groups(su, sn, genome, judge))
    out["missing"] = 0
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--seconds", type=float, default=5.0)
    a = ap.parse_args(argv)
    cell = manifest.Bench().cell(a.workload)
    t = time.time()
    if a.fault:
        from portbench.run import run_cell
        out = {c: v["value"] for c, v in run_cell(
            cell, a.seed, a.seconds, 0, fault=FAULTS[a.fault])[
                "checks"].items()}
        out["fault"] = a.fault
    else:
        out = control_numbers(cell, a.seed, a.batches)
    out.update(workload=a.workload, seed=a.seed, seconds=time.time() - t,
               limits=cell.limits)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
