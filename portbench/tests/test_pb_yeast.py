"""The yeast.pe100.local cell's own files on the CPU: the `yeast_r64`
genome recipe, the `art_pairs_adapter` read recipe, the K9 share's
reader, and the port in --sensitive-local against the plain reference
on a cut of the cell (17 references of 20-40 kbp, the same families at
scaled-down counts, two batches of 64 pairs)."""

import collections
import json
import os
import types

import numpy as np
import pytest

from portbench import manifest
from portbench.gen.genome import Genome, make_refs
from portbench.gen.genomes import yeast_r64
from portbench.gen.reads import art_pairs_adapter as adapter_reads
from portbench.gen.traffic import Traffic
from portbench.reference.check import Judge, by_name, primaries
from portbench.reference.sam import Record, revcomp, se_mapq_ok
from portbench.run import policy

CONFIG = json.load(open(os.path.join(manifest.ROOT, "portbench", "configs",
                                     "yeast_r64_local.json")))
SPEC = json.load(open(os.path.join(manifest.PKG, "traffic",
                                   "art_pe100_adapter.json")))
R64 = [("chrI", 230_218), ("chrII", 813_184), ("chrIII", 316_620),
       ("chrIV", 1_531_933), ("chrV", 576_874), ("chrVI", 270_161),
       ("chrVII", 1_090_940), ("chrVIII", 562_643), ("chrIX", 439_888),
       ("chrX", 745_751), ("chrXI", 666_816), ("chrXII", 1_078_177),
       ("chrXIII", 924_431), ("chrXIV", 784_333), ("chrXV", 1_091_291),
       ("chrXVI", 948_066), ("chrM", 85_779)]
# the cut: 17 references of 20-40 kbp, chrXII long enough for the rDNA
# pair and a Y' element
CUT = [[n, 40_000 if n == "chrXII" else 20_000 + (7_919 * i) % 20_001]
       for i, (n, _bp) in enumerate(R64)]
CODES = "ACGTN"


def genome(refs=CUT, seed=None):
    spec = dict(CONFIG["genome"], refs=refs)
    if seed is not None:
        spec["seed"] = seed
    return Genome(make_refs(spec))


@pytest.fixture(scope="module")
def cut():
    return genome()


def test_r64_names_lengths_and_families():
    assert [tuple(r) for r in CONFIG["genome"]["refs"]] == R64
    assert CONFIG["genome_bp"] == sum(bp for _n, bp in R64) == 12_157_105
    refs, placed = yeast_r64.layout(
        np.random.default_rng(CONFIG["genome"]["seed"]),
        CONFIG["genome"]["refs"])
    assert [(n, c.size) for n, c in refs] == R64
    counts = collections.Counter(p[0] for p in placed)
    want = {f: k for f, k, _bp in yeast_r64.TY_FAMILIES}
    want.update(solo_LTR=yeast_r64.SOLO_LTRS, tRNA=yeast_r64.TRNA_GENES,
                Yprime=yeast_r64.YPRIME_COPIES, rDNA=1)
    assert counts == want
    planted = sum(p[3] for p in placed)
    assert 0.04 < planted / CONFIG["genome_bp"] < 0.05
    seqs = dict(refs)
    for fam, name, start, length in placed:
        if fam == "rDNA":       # two identical tandem units at 451 kbp
            assert (name, start) == ("chrXII", 451_000)
            g = seqs[name]
            u = yeast_r64.RDNA_UNIT
            assert length == 2 * u
            assert (g[start:start + u] == g[start + u:start + 2 * u]).all()
        if fam == "Yprime":
            n = seqs[name].size
            assert start < 500 or start + length > n - 500
    gc = {n: float(np.isin(c, (1, 2)).mean()) for n, c in refs}
    assert gc["chrM"] < 0.25
    assert all(abs(v - 0.38) < 0.01 for n, v in gc.items() if n != "chrM")


def test_r64_same_codes_from_the_same_seed():
    a, b, c = genome(), genome(), genome(seed=65)
    assert (a.codes == b.codes).all()
    assert not (a.codes == c.codes).all()
    # the cut keeps every family, at a scaled count
    _refs, placed = yeast_r64.layout(np.random.default_rng(64), CUT)
    fams = collections.Counter(p[0] for p in placed)
    assert set(fams) == {"Ty1_2", "Ty4", "Ty3", "solo_LTR", "tRNA",
                         "Yprime", "rDNA"}
    assert fams["solo_LTR"] < yeast_r64.SOLO_LTRS


def test_adapter_batches_come_from_seed_stream_and_k(cut):
    one, two = (Traffic(SPEC, cut, 2_147_483_659) for _ in range(2))
    a, b, w = one.batch(3), two.batch(3), one.warm(3)
    assert len(a) == SPEC["batch"]
    for x, y in zip(a, b):
        for m, n in zip(x, y):
            assert (m[0] == n[0]).all() and (m[1] == n[1]).all()
            assert m[2:] == n[2:]
    assert any((x[0][0] != y[0][0]).any() for x, y in zip(a, w))


def _sim(g, n=20_000):
    return adapter_reads.sim_pairs(
        np.random.default_rng(21), g, n, SPEC["read_len"],
        SPEC["frag_mean"], SPEC["frag_sd"], SPEC["frag_min"], SPEC["max_n"])


def test_every_footprint_lies_inside_one_reference(cut):
    L = SPEC["read_len"]
    units = adapter_reads.draw(np.random.default_rng(4), cut, 4_000, SPEC)
    for pair in units:
        for codes, _q, origin, _strand in pair:
            name, at = cut.locate(origin)
            lo, hi = cut.bounds(name)
            assert codes.size == L and at >= 0 and lo + at + L <= hi


def test_short_fragments_read_into_their_adapters(cut):
    c1, _q1, c2, _q2, p1, _p2, frag = _sim(cut)
    assert frag.min() == SPEC["frag_min"]        # the floor holds, and bites
    short = np.nonzero(frag < SPEC["read_len"])[0]
    assert 0.04 < short.size / frag.size < 0.06
    agree = total = 0
    for k in short.tolist():
        f, p = int(frag[k]), int(p1[k])
        g = cut.codes[p:p + f]
        for codes, genomic, adapter in (
                (c1[k], g, adapter_reads.ADAPTER1),
                (c2[k], revcomp(g), adapter_reads.ADAPTER2)):
            n = min(len(adapter), codes.size - f)
            want = np.concatenate([genomic, [CODES.index(x)
                                             for x in adapter[:n]]])
            agree += int((codes[:f + n] == want).sum())
            total += f + n
    assert agree / total > 0.99          # all but the sequencing errors


def test_bt_device_pct_reads_the_walks_share():
    read = manifest.reader("pel.bt_device_pct")
    assert read(types.SimpleNamespace(trace=None)) is None
    ops = [("void (anonymous namespace)::bt_kernel(BtArgs)", "kernel", 0, 1.0),
           ("void (anonymous namespace)::sw_warp_kernel<1, true, true>"
            "(Args, SwParams)", "kernel", 1, 2.0),
           ("Memcpy DtoH", "gpu_memcpy", 3, 1.0)]
    got = read(types.SimpleNamespace(trace=types.SimpleNamespace(ops=ops)))
    assert got == pytest.approx(25.0)


def _sam(groups):
    return b"\n".join(line for g in groups for _f, line in g)


def _garbage_mates(units, every, seed):
    """The units with every `every`-th mate 2 replaced by random bases: a
    mate 1 without its mate is reported unpaired (YT:Z:UP)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (m1, m2) in enumerate(units):
        if i % every == 0:
            m2 = (rng.integers(0, 4, m2[0].size).astype(np.uint8),) + m2[1:]
        out.append((m1, m2))
    return out


@pytest.fixture(scope="module")
def yeast_run(cut):
    """Two batches of 64 pairs of the cell's mix on the cut, and a third
    with a random mate 2 in every fourth pair, through the port's
    PairedAligner in --sensitive-local on the CPU: each batch's
    collect_raw lines, and the lines of the same batches by the object
    path, the host path and the host re-pairing."""
    from bowtie2_tpu_torch.index.build import build_index_from_refs

    data = build_index_from_refs(cut.refs())
    mode = manifest.plug("modes", "pe")
    pol = policy(CONFIG)
    assert pol.local and pol.match_bonus == 2
    traffic = Traffic(dict(SPEC, batch=64), cut, 2_121_000_007)
    al = mode.aligner(data, pol, "cpu", 1)
    objs = mode.aligner(data, pol, "cpu", 1)
    legacy = mode.aligner(data, pol, "cpu", 1)
    legacy.force_host_pairing = True     # the host re-pairing, every batch
    batches = []
    for k in range(3):
        units = traffic.batch(k)
        if k == 2:
            units = _garbage_mates(units, 4, k)
        names = [f"b{k}r{i}" for i in range(len(units))]
        recs = mode.records(units, names)
        h = al.submit(recs)
        raw = _sam(al.collect_raw(h))
        batches.append(dict(
            units=units, names=names, raw=raw,
            collect=b"\n".join(r.line().encode() for r in objs.collect(h)),
            host=b"\n".join(r.line().encode()
                            for r in objs.align_batch_host(recs)),
            legacy=_sam(legacy.collect_raw(legacy.submit(recs)))))
    return cut, al, batches


def _judge(g, batches):
    j = Judge(g, CONFIG, dict(SPEC, check_units=10_000), True)
    return j.judge([(b["units"], b["raw"], b["names"]) for b in batches], 5)


def test_port_passes_the_reference(yeast_run):
    g, _al, batches = yeast_run
    got = _judge(g, batches[:2])
    assert got["missing"] == 0 and got["field_err"] == 0, got
    assert got["eligible"] >= 250 and got["miss_pct"] == 0.0, got


def _clipped(batches):
    """(record index, batch, group key, Record) of every soft-clipped
    record."""
    out = []
    for b, batch in enumerate(batches):
        for qname, grp in by_name(batch["raw"]).items():
            for i, (_flag, line) in enumerate(grp):
                rec = Record(line)
                if rec.aligned and b"S" in rec.cigar:
                    out.append((b, qname, i, rec))
    return out


def test_a_record_is_clipped_at_its_adapter(yeast_run):
    _g, _al, batches = yeast_run
    heads = {adapter_reads.ADAPTER1[:12], adapter_reads.ADAPTER2[:12]}
    at_adapter = 0
    for _b, _q, _i, rec in _clipped(batches[:2]):
        ops = rec.ops()
        seq = rec.seq.decode()          # as sequenced: the 3' end last
        if rec.flag & 16:
            seq = "".join(CODES[c] for c in revcomp(
                [CODES.index(x) for x in seq]))
            ops = ops[::-1]
        if ops[-1][1] == "S" and seq[len(seq) - ops[-1][0]:][:12] in heads:
            at_adapter += 1
    assert at_adapter >= 2


@pytest.mark.parametrize("how", ["cigar", "pos"])
def test_an_altered_clipped_record_fails(yeast_run, how):
    g, _al, batches = yeast_run
    b, qname, i, rec = _clipped(batches[:2])[0]
    lines = batches[b]["raw"].split(b"\n")
    at = [k for k, ln in enumerate(lines)
          if ln.split(b"\t", 1)[0].decode() == qname][i]
    f = lines[at].split(b"\t")
    if how == "pos":
        f[3] = str(int(f[3]) + 1).encode()
    else:                    # one base moves from a soft clip to its M run
        ops = rec.ops()
        k = 0 if ops[0][1] == "S" else len(ops) - 1
        j = 1 if k == 0 else k - 1
        ops[k] = (ops[k][0] - 1, "S")
        ops[j] = (ops[j][0] + 1, ops[j][1])
        f[5] = "".join(f"{n}{op}" for n, op in ops if n).encode()
    lines[at] = b"\t".join(f)
    bad = [dict(x) for x in batches[:2]]
    bad[b]["raw"] = b"\n".join(lines)
    assert _judge(g, bad)["field_err"] >= 1


@pytest.mark.parametrize("path", ["collect", "host", "legacy"])
def test_fast_raw_lines_equal_the_object_paths(yeast_run, path):
    _g, _al, batches = yeast_run
    for batch in batches:
        assert batch["raw"] == batch[path]


def test_up_records_mapq_follows_from_as_and_xs(yeast_run):
    g, _al, batches = yeast_run
    sc = Judge(g, CONFIG, SPEC, True).sc
    up = 0
    for batch in batches:
        for grp in by_name(batch["raw"]).values():
            for rec in primaries(grp):
                if rec.aligned and rec.tags.get("YT") == "UP":
                    up += 1
                    assert se_mapq_ok(rec, len(rec.seq), sc), rec.qname
    assert up >= 8
    assert _judge(g, batches)["field_err"] == 0


def test_clip_counters_equal_the_cigars(yeast_run):
    _g, al, batches = yeast_run
    recs = [r for _b, _q, _i, r in _clipped(batches)]
    c = al.metrics.counters
    assert c["clipped_records"] == len(recs) > 0
    assert c["clipped_bases"] == sum(n for r in recs for n, op in r.ops()
                                     if op == "S")
    aligned = sum(1 for b in batches for ln in b["raw"].split(b"\n")
                  if not int(ln.split(b"\t")[1]) & 4)
    # local mode walks every record the fused emission reports
    assert aligned <= c["bt_walks"] <= c["backtraces"]
