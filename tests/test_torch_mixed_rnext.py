"""Mates aligned, but neither as a concordant nor as a discordant pair
(mate 1 a multimapper, so `YT:Z:UP` on both): each record names its
mate's place, RNEXT the mate's reference ('=' where it is its own), PNEXT
the mate's POS, TLEN 0, as Bowtie 2 prints them. On a genome of two
references, end to end and --local, by the fused PE emission
(`collect_raw`), the object path (`collect`) and the host path
(`align_batch_host`), on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bowtie2_tpu_torch.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import PairedAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy  # noqa: E402

REPEAT = (10_000, 40_000)        # two exact copies of 400 bp in chrA


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(17)
    a = rng.integers(0, 4, 60_000).astype(np.uint8)
    b = rng.integers(0, 4, 60_000).astype(np.uint8)
    a[REPEAT[1]:REPEAT[1] + 400] = a[REPEAT[0]:REPEAT[0] + 400]
    data = build_index_from_refs([("chrA", a), ("chrB", b)])
    pairs, want = [], []
    for i in range(24):
        p1 = REPEAT[0] + int(rng.integers(0, 300))
        m1 = a[p1:p1 + 100]
        other = ("chrB", b) if i % 2 == 0 else ("chrA", a)
        p2 = int(rng.integers(20_000, 30_000))     # > maxins from mate 1
        m2 = (3 - other[1][p2:p2 + 100])[::-1]
        q = np.full(100, 35, np.uint8)
        pairs.append((SeqRecord(name=f"u{i}", seq=m1.copy(), qual=q),
                      SeqRecord(name=f"u{i}", seq=m2.copy(), qual=q)))
        want.append((other[0], p2 + 1))
    return data, pairs, want


@pytest.mark.parametrize("local", [False, True], ids=["e2e", "local"])
@pytest.mark.parametrize("path", ["collect_raw", "collect", "host"])
def test_up_mates_name_each_others_place(world, local, path):
    data, pairs, want = world
    al = PairedAligner(data, make_policy("sensitive", local=local),
                       device="cpu")
    if path == "host":
        lines = [r.line() for r in al.align_batch_host(pairs)]
    else:
        h = al.submit(pairs)
        lines = [ln.decode() for g in al.collect_raw(h) for _f, ln in g] \
            if path == "collect_raw" else [r.line() for r in al.collect(h)]
    recs = {}
    for ln in lines:
        f = ln.split("\t")
        if not int(f[1]) & 0x100:
            recs[(f[0], 1 if int(f[1]) & 0x40 else 2)] = f
    cross = 0
    for i, (ref2, pos2) in enumerate(want):
        r1, r2 = recs[(f"u{i}", 1)], recs[(f"u{i}", 2)]
        assert "YT:Z:UP" in r1 and "YT:Z:UP" in r2
        assert not (int(r1[1]) | int(r2[1])) & 0x4
        assert r1[2] == "chrA" and (r2[2], int(r2[3])) == (ref2, pos2)
        assert r1[6] == ("=" if ref2 == "chrA" else "chrB")
        assert r2[6] == ("=" if ref2 == "chrA" else "chrA")
        assert (int(r1[7]), int(r2[7])) == (int(r2[3]), int(r1[3]))
        assert r1[8] == r2[8] == "0"
        cross += ref2 == "chrB"
    assert cross == 12
