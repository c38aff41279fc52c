"""The plain reference against the port's own output on the CPU at a
tiny size, end to end and local: it passes the records as the port
prints them, fails a record altered by one base of CIGAR or of position
(and, local, a soft clip moved into an M run), and fails the control
(every mismatch at the largest penalty). The end-to-end numbers on the
same records are those the reference gave before it learnt local
mode."""

import numpy as np
import pytest

from portbench import manifest
from portbench.gen.genome import Genome
from portbench.reference.check import Judge
from portbench.reference.control import control_groups
from portbench.reference.sam import Record
from portbench.tests.conftest import SCORING

CONFIG = {"scoring": SCORING, "local": False,
          "pe": {"minins": 0, "maxins": 500, "orient": "fr"}}
LOCAL = dict(CONFIG, local=True, scoring=dict(
    SCORING, ma=2, score_min=["G", 20, 8]))     # --sensitive-local


@pytest.fixture(scope="module")
def base():
    """A 200-kbp genome with diverged repeats and an N run, its index, and
    two dozen 150-bp ART-like pairs drawn from it."""
    from bowtie2_tpu_torch.index.build import build_index_from_refs

    rng = np.random.default_rng(11)
    g = manifest.plug("gen/genomes", "uniform").make(
        rng, [["tiny", 200_000]])[0][1].astype(np.uint8)
    seg = g[5_000:5_300].copy()
    for _ in range(40):                 # diverged repeats: multimaps
        p = int(rng.integers(0, 199_000))
        c = seg.copy()
        m = rng.random(300) < 0.04
        c[m] = (c[m] + 1) % 4
        g[p:p + 300] = c
    g[100_000:100_400] = 4
    data = build_index_from_refs([("tiny", g)])
    g = Genome([("tiny", g)])
    spec = {"read_len": 150, "frag_mean": 200, "frag_sd": 10, "max_n": 8}
    pairs = manifest.plug("gen/reads", "art_pairs").draw(
        np.random.default_rng(5), g, 24, spec)
    return g, data, pairs, [f"r{i}" for i in range(24)]


def align(base, preset, local, pairs=None):
    """The port's SE and PE records of the base's reads (or of `pairs`)
    on the CPU."""
    from bowtie2_tpu_torch.io.fastx import SeqRecord
    from bowtie2_tpu_torch.pipeline.align import UnpairedAligner
    from bowtie2_tpu_torch.pipeline.paired import PairedAligner
    from bowtie2_tpu_torch.pipeline.policy import make_policy

    g, data, base_pairs, names = base
    pairs = base_pairs if pairs is None else pairs
    pol = make_policy(preset, local=local)
    se = [u[0] for u in pairs]
    sal = UnpairedAligner(data, pol, device="cpu")
    se_groups = sal.collect_raw(sal.submit(
        [SeqRecord(n, u[0], u[1]) for n, u in zip(names, se)]))
    pal = PairedAligner(data, pol, device="cpu")
    pe_groups = pal.collect_raw(pal.submit(
        [(SeqRecord(n, a[0], a[1]), SeqRecord(n, b[0], b[1]))
         for n, (a, b) in zip(names, pairs)]))
    return {"se": (se, se_groups), "pe": (pairs, pe_groups)}


@pytest.fixture(scope="module")
def world(base):
    return base[0], align(base, "very-sensitive", False), base[3]


def clip_bait(pairs):
    """The pairs with every third read's second base (as sequenced)
    changed at quality 40: a local alignment gains by clipping two bases
    (a match bonus of 2 lost, a penalty of 6 saved)."""
    out = []
    for j, pair in enumerate(pairs):
        mates = []
        for m, (c, q, o, s) in enumerate(pair):
            if (2 * j + m) % 3 == 0:
                c, q = c.copy(), q.copy()
                c[1], q[1] = (c[1] + 1) % 4, 40
            mates.append((c, q, o, s))
        out.append(tuple(mates))
    return out


@pytest.fixture(scope="module")
def local_world(base):
    return base[0], align(base, "sensitive", True, clip_bait(base[2])), \
        base[3]


def sam(groups):
    return b"\n".join(line for g in groups for _f, line in g)


def judge(g, mode, config=CONFIG):
    return Judge(g, config, {"ref_band": 16, "check_units": 24},
                 mode == "pe")


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_port_output_passes(world, mode):
    g, runs, names = world
    units, groups = runs[mode]
    got = judge(g, mode).judge([(units, sam(groups), names)], 1)
    assert got["missing"] == 0 and got["field_err"] == 0
    assert got["eligible"] == 24 * (2 if mode == "pe" else 1)
    assert got["miss_pct"] == 0.0


def _alter(groups, how):
    """The first aligned record of the first group, altered."""
    out = [list(gr) for gr in groups]
    flag, line = out[0][0]
    f = line.split(b"\t")
    assert not flag & 4 and f[5] == b"150M"
    if how == "cigar":
        f[5] = b"149M1I"
    else:
        f[3] = str(int(f[3]) + 1).encode()
    out[0][0] = (flag, b"\t".join(f))
    return out


@pytest.mark.parametrize("how", ["cigar", "pos"])
@pytest.mark.parametrize("mode", ["se", "pe"])
def test_one_altered_record_fails(world, mode, how):
    g, runs, names = world
    units, groups = runs[mode]
    got = judge(g, mode).judge([(units, sam(_alter(groups, how)), names)],
                               1)
    assert got["field_err"] >= 1


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_half_the_batch_left_out_fails(world, mode):
    g, runs, names = world
    units, groups = runs[mode]
    got = judge(g, mode).judge([(units, sam(groups[:12]), names)], 1)
    assert got["missing"] == 12 * (2 if mode == "pe" else 1)


def noisy(units, mode):
    """The units with two mismatches at quality 20 in each read, 10 bases
    or more from its ends: the control's flat penalty (6) exceeds the
    configured one (2 + 4 * 20 // 40 = 4) on each."""
    rng = np.random.default_rng(3)
    out = []
    for u in units:
        reads = list(u) if mode == "pe" else [u]
        new = []
        for c, q, o, s in reads:
            c, q = c.copy(), np.full(c.size, 20, np.uint8)
            j = rng.choice(np.arange(10, c.size - 10), 2, replace=False)
            c[j] = (c[j] + 1) % 4
            new.append((c, q, o, s))
        out.append(tuple(new) if mode == "pe" else new[0])
    return out


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_control_fails(world, mode):
    """The control, kept at a size a test run holds: on reads with low
    quality mismatches its scores fall below the reference's."""
    g, runs, names = world
    units = noisy(runs[mode][0], mode)
    J = judge(g, mode)
    got = J.judge([(units, sam(control_groups(units, names, g, J)), names)],
                  1)
    assert got["missing"] == 0
    assert got["field_err"] > 0 and got["miss_pct"] > 50.0


def _shift(line):
    """A record's POS one base on."""
    f = line.split(b"\t")
    f[3] = str(int(f[3]) + 1).encode()
    return b"\t".join(f)


def e2e_case(world, mode, case):
    """One set of records for the end-to-end Judge: the port's, one
    altered, half left out, every third group's moved, or the control's
    on noisy reads."""
    g, runs, names = world
    units, groups = runs[mode]
    if case in ("cigar", "pos"):
        groups = _alter(groups, case)
    elif case == "half":
        groups = groups[:12]
    elif case == "mixed":           # every third group's records moved
        groups = [[(f, _shift(line) if i % 3 == 0 and not f & 4 else line)
                   for f, line in gr] for i, gr in enumerate(groups)]
    elif case == "control":
        units = noisy(units, mode)
        groups = control_groups(units, names, g, judge(g, mode))
    return units, sam(groups), names


# The end-to-end Judge's numbers on e2e_case's records (missing,
# field_err, miss_pct, eligible, misses), as the reference gave them
# before it learnt local mode.
E2E_NUMBERS = {
    "se.port": (0, 0, 0.0, 24, 0),
    "se.cigar": (0, 1, 4.166666666666667, 24, 1),
    "se.pos": (0, 1, 4.166666666666667, 24, 1),
    "se.half": (12, 12, 0.0, 12, 0),
    "se.control": (0, 24, 100.0, 24, 24),
    "se.mixed": (0, 8, 33.333333333333336, 24, 8),
    "pe.port": (0, 0, 0.0, 48, 0),
    "pe.cigar": (0, 1, 2.0833333333333335, 48, 1),
    "pe.pos": (0, 2, 2.0833333333333335, 48, 1),
    "pe.half": (24, 24, 0.0, 24, 0),
    "pe.control": (0, 48, 100.0, 48, 48),
    "pe.mixed": (0, 24, 33.333333333333336, 48, 16),
}


@pytest.mark.parametrize("case", sorted(E2E_NUMBERS))
def test_end_to_end_numbers_unchanged(world, case):
    mode, what = case.split(".")
    got = judge(world[0], mode).judge([e2e_case(world, mode, what)], 1)
    assert got == dict(zip(("missing", "field_err", "miss_pct", "eligible",
                            "misses"), E2E_NUMBERS[case]))


def _alter_local(groups, how):
    """One aligned record of the port's local output, altered: the first
    one's last M run a base shorter and an I after it, or its POS a base
    on; or the first soft-clipped one's clip aligned (POS moved back by
    a leading clip), its AS kept."""
    out = [list(gr) for gr in groups]
    for gi, gr in enumerate(out):
        for ri, (flag, line) in enumerate(gr):
            f = line.split(b"\t")
            if flag & 4 or (how == "clip" and b"S" not in f[5]):
                continue
            ops = Record(line).ops()
            if how == "cigar":
                j = max(j for j, (_n, op) in enumerate(ops) if op == "M")
                ops[j:j + 1] = [(ops[j][0] - 1, "M"), (1, "I")]
            elif how == "pos":
                f = _shift(line).split(b"\t")
            else:
                lead = ops[0][0] if ops[0][1] == "S" else 0
                f[3] = str(int(f[3]) - lead).encode()
                ops = [(n, "M" if op == "S" else op) for n, op in ops]
            merged = []
            for n, op in ops:
                if merged and merged[-1][1] == op:
                    n += merged.pop()[0]
                merged.append((n, op))
            f[5] = "".join(f"{n}{op}" for n, op in merged).encode()
            out[gi][ri] = (flag, b"\t".join(f))
            return out
    raise AssertionError(f"no record to alter by {how}")


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_local_port_output_passes(local_world, mode):
    g, runs, names = local_world
    units, groups = runs[mode]
    got = judge(g, mode, LOCAL).judge([(units, sam(groups), names)], 1)
    assert got["missing"] == 0 and got["field_err"] == 0, got
    assert got["eligible"] == 24 * (2 if mode == "pe" else 1)
    assert got["miss_pct"] == 0.0


@pytest.mark.parametrize("how", ["cigar", "pos", "clip"])
@pytest.mark.parametrize("mode", ["se", "pe"])
def test_local_altered_record_fails(local_world, mode, how):
    g, runs, names = local_world
    units, groups = runs[mode]
    got = judge(g, mode, LOCAL).judge(
        [(units, sam(_alter_local(groups, how)), names)], 1)
    assert got["field_err"] >= 1


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_local_control_fails(local_world, mode):
    """The control in local mode prints local records (every mismatch at
    the largest penalty) and is found not correct."""
    g, runs, names = local_world
    units = noisy(runs[mode][0], mode)
    J = judge(g, mode, LOCAL)
    groups = control_groups(units, names, g, J)
    got = J.judge([(units, sam(groups), names)], 1)
    assert got["missing"] == 0
    assert got["field_err"] > 0 and got["miss_pct"] > 50.0
