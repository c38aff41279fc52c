"""The port's counters of local-mode work, on the CPU: `clipped_records`
and `clipped_bases` (aligned records emitted with a soft clip, and their
clipped bases) equal what the emitted CIGARs show, on the fused PE
emission (`collect_raw`), the object path (`collect`), the host
re-pairing (`force_host_pairing`), the host path (`align_batch_host`)
and the single-end paths, also where `_emit_pair`
drops a pair whose second mate fails its score check; `bt_walks` counts
the walks the fused paths send to the backtrace (every chosen slot in
local mode, the gapped rest end to end; none on the host path)."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bowtie2_tpu_torch.index.build import build_index_from_refs  # noqa: E402
from bowtie2_tpu_torch.io.fastx import SeqRecord  # noqa: E402
from bowtie2_tpu_torch.pipeline.align import UnpairedAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.paired import PairedAligner  # noqa: E402
from bowtie2_tpu_torch.pipeline.policy import make_policy  # noqa: E402

L = 100
ADAPTER = np.array(["ACGT".index(c) for c in
                    "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"], np.uint8)


@pytest.fixture(scope="module")
def world():
    """A 150-kbp random genome, its index, and 96 FR pairs of 100-bp
    mates: every sixth pair's fragment is 40-80 bp, so both mates read
    through it into an adapter and random bases (a local alignment clips
    them); the rest have fragments of 200-400 bp and 1 % substitutions."""
    rng = np.random.default_rng(31)
    g = rng.integers(0, 4, 150_000).astype(np.uint8)
    data = build_index_from_refs([("g", g)])
    pairs = []
    for i in range(96):
        frag = int(rng.integers(40, 81)) if i % 6 == 0 else \
            int(rng.integers(200, 401))
        p = int(rng.integers(200, g.size - 600))
        f = g[p:p + frag]
        rcf = (3 - f)[::-1]
        tail = np.concatenate([ADAPTER, rng.integers(0, 4, L).astype(
            np.uint8)])
        m1 = np.concatenate([f, tail])[:L].copy()
        m2 = np.concatenate([rcf, tail])[:L].copy()
        for m in (m1, m2):
            e = rng.random(L) < 0.01
            m[e] = (m[e] + rng.integers(1, 4, int(e.sum()))) % 4
        q = np.full(L, 35, np.uint8)
        pairs.append((SeqRecord(name=f"p{i}", seq=m1, qual=q),
                      SeqRecord(name=f"p{i}", seq=m2, qual=q.copy())))
    return data, pairs


def _clips(lines):
    """(records with a soft clip, their clipped bases) of SAM lines."""
    n = bases = 0
    for ln in lines:
        f = ln.split("\t")
        if int(f[1]) & 4:
            continue
        s = [int(k) for k in re.findall(r"(\d+)S", f[5])]
        n += bool(s)
        bases += sum(s)
    return n, bases


def _aligned(lines):
    return sum(1 for ln in lines if not int(ln.split("\t")[1]) & 4)


def _counts(al):
    c = al.metrics.counters
    return c.get("clipped_records", 0), c.get("clipped_bases", 0)


@pytest.mark.parametrize("path", ["collect_raw", "collect", "repair",
                                  "host"])
def test_pe_clip_counters_equal_the_cigars(world, path):
    data, pairs = world
    al = PairedAligner(data, make_policy("sensitive", local=True),
                       device="cpu")
    al.force_host_pairing = path == "repair"
    if path == "host":
        lines = [r.line() for r in al.align_batch_host(pairs)]
    else:
        h = al.submit(pairs)
        lines = [ln.decode() for g in al.collect_raw(h) for _f, ln in g] \
            if path != "collect" else [r.line() for r in al.collect(h)]
    n, bases = _clips(lines)
    assert al.metrics.counters.get("repair_batches", 0) == (path == "repair")
    assert n >= 2 * (96 // 6) and bases > n * 10
    assert _counts(al) == (n, bases)
    walks = al.metrics.counters.get("bt_walks", 0)
    if path == "host":
        assert walks == 0
    else:                 # local mode walks every record it reports
        assert walks >= _aligned(lines)


def test_a_dropped_pair_takes_its_clip_back(world, monkeypatch):
    """A read-through pair whose mate 2 fails the score check in
    `_emit_pair`: mate 1's record, made and counted, is not emitted, and
    its clip leaves the count again."""
    data, pairs = world
    al = PairedAligner(data, make_policy("sensitive", local=True),
                       device="cpu")
    inner = al._emit_aligned

    def emit(rec, *a, **k):
        flag = a[11] if len(a) > 11 else k.get("flag_extra", 0)
        if rec.name == "p0" and flag & 0x80:
            return None
        return inner(rec, *a, **k)
    monkeypatch.setattr(al, "_emit_aligned", emit)
    lines = [r.line() for r in al.collect(al.submit(pairs))]
    p0 = [ln for ln in lines if ln.startswith("p0\t")]
    assert [int(ln.split("\t")[1]) & 0x4 for ln in p0] == [0, 4]
    assert "S" in p0[0].split("\t")[5]
    assert _counts(al) == _clips(lines)


@pytest.mark.parametrize("local", [False, True])
def test_se_counters(world, local):
    data, pairs = world
    reads = [p[0] for p in pairs]
    al = UnpairedAligner(data, make_policy("sensitive", local=local),
                         device="cpu")
    al.collect_raw(al.submit(reads))
    h = al.submit(reads)
    lines = [r.line() for r in al._align_batch_host(reads)]
    c = al.metrics.counters
    Bp = h.Bp
    want = 2 * (Bp * h.kk_bt if local else max(Bp * h.kk_bt // 4, 64))
    assert c["bt_walks"] == want           # the launches' static shape
    # the host path's records are counted; the fused SE emission's are not
    assert _counts(al) == _clips(lines)
    assert (_counts(al)[0] > 0) == local
