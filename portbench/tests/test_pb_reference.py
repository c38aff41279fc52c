"""The plain reference against the port's own output on the CPU at a
tiny size: it passes the records as the port prints them, fails a
record altered by one base of CIGAR or of position, and fails the
control (every mismatch at the largest penalty)."""

import numpy as np
import pytest

from portbench import manifest
from portbench.gen.genome import Genome
from portbench.reference.check import Judge
from portbench.reference.control import control_groups
from portbench.tests.conftest import SCORING

CONFIG = {"scoring": SCORING,
          "pe": {"minins": 0, "maxins": 500, "orient": "fr"}}


@pytest.fixture(scope="module")
def world():
    from bowtie2_tpu_torch.index.build import build_index_from_refs
    from bowtie2_tpu_torch.io.fastx import SeqRecord
    from bowtie2_tpu_torch.pipeline.align import UnpairedAligner
    from bowtie2_tpu_torch.pipeline.paired import PairedAligner
    from bowtie2_tpu_torch.pipeline.policy import make_policy

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
    pol = make_policy("very-sensitive")
    spec = {"read_len": 150, "frag_mean": 200, "frag_sd": 10, "max_n": 8}
    pairs = manifest.plug("gen/reads", "art_pairs").draw(
        np.random.default_rng(5), g, 24, spec)
    se = [u[0] for u in pairs]
    names = [f"r{i}" for i in range(24)]
    sal = UnpairedAligner(data, pol, device="cpu")
    se_groups = sal.collect_raw(sal.submit(
        [SeqRecord(n, u[0], u[1]) for n, u in zip(names, se)]))
    pal = PairedAligner(data, pol, device="cpu")
    pe_groups = pal.collect_raw(pal.submit(
        [(SeqRecord(n, a[0], a[1]), SeqRecord(n, b[0], b[1]))
         for n, (a, b) in zip(names, pairs)]))
    return g, {"se": (se, se_groups), "pe": (pairs, pe_groups)}, names


def sam(groups):
    return b"\n".join(line for g in groups for _f, line in g)


def judge(g, mode):
    return Judge(g, CONFIG, {"ref_band": 16, "check_units": 24},
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


@pytest.mark.parametrize("mode", ["se", "pe"])
def test_control_fails(world, mode):
    """The control, kept at a size a test run holds: on reads with low
    quality mismatches its scores fall below the reference's."""
    g, runs, names = world
    units = runs[mode][0]
    # every read with mismatches at quality 20: the control's flat
    # penalty (6) exceeds the configured one (2 + 4 * 20 // 40 = 4)
    rng = np.random.default_rng(3)
    noisy = []
    for u in units:
        reads = list(u) if mode == "pe" else [u]
        out = []
        for c, q, o, s in reads:
            c, q = c.copy(), np.full(c.size, 20, np.uint8)
            j = rng.choice(np.arange(10, c.size - 10), 2, replace=False)
            c[j] = (c[j] + 1) % 4
            out.append((c, q, o, s))
        noisy.append(tuple(out) if mode == "pe" else out[0])
    J = judge(g, mode)
    got = J.judge([(noisy, sam(control_groups(noisy, names, g, J)), names)],
                  1)
    assert got["missing"] == 0
    assert got["field_err"] > 0 and got["miss_pct"] > 50.0
