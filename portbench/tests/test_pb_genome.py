"""Genomes of one or more references: recipes found by file, the cache's
digest over a configuration's own recipe only, reads drawn within one
reference, and the reference's comparison over several of them."""

import json
import os
import shutil

import numpy as np
import pytest

from portbench import deploy, manifest
from portbench.gen.genome import PAD, Genome, make_refs
from portbench.reference.check import Judge
from portbench.tests.conftest import SCORING

CONFIG = {"scoring": SCORING,
          "pe": {"minins": 0, "maxins": 500, "orient": "fr"}}


def test_one_reference_draws_as_a_plain_integers_call():
    g = Genome([("a", np.zeros(50_000, np.uint8))])
    got = g.draw_starts(np.random.default_rng(4), 1000, 150)
    want = np.random.default_rng(4).integers(0, 50_000 - 150, 1000)
    assert (got == want).all()
    assert g.codes.size == 50_000 and g.bounds("a") == (0, 50_000)


def test_several_references_draw_within_one():
    refs = make_refs({"recipe": "uniform", "seed": 9,
                      "refs": [["r1", 3_000], ["r2", 500], ["r3", 8_000]]})
    g = Genome(refs)
    assert g.starts.tolist() == [0, 3_000 + PAD, 3_500 + 2 * PAD]
    assert (g.codes[3_000:3_000 + PAD] == 4).all()
    for name, codes in refs:
        lo, hi = g.bounds(name)
        assert (g.codes[lo:hi] == codes).all()
    starts = g.draw_starts(np.random.default_rng(1), 5_000, 600)
    for s in starts.tolist():
        name, at = g.locate(s)
        assert name != "r2" and at + 600 <= dict(refs)[name].size
    assert int(g.draw_starts(np.random.default_rng(2), None, 600)) >= 0


def test_cache_digest_is_the_configurations_own(tmp_path, monkeypatch):
    pkg = tmp_path / "portbench"
    shutil.copytree(os.path.join(manifest.PKG, "gen", "genomes"),
                    pkg / "gen" / "genomes")
    monkeypatch.setattr(manifest, "PKG", str(pkg))
    config = {"genome": {"recipe": "uniform", "seed": 1,
                         "refs": [["x", 1000]]}}
    path = tmp_path / "x.json"
    path.write_text(json.dumps(config))
    before = deploy.cache_dir(config, str(path), str(tmp_path))
    (pkg / "gen" / "genomes" / "yeastsim.py").write_text(
        "def make(rng, refs):\n    return []\n")
    assert deploy.cache_dir(config, str(path), str(tmp_path)) == before
    with open(pkg / "gen" / "genomes" / "uniform.py", "a") as f:
        f.write("\n")
    assert deploy.cache_dir(config, str(path), str(tmp_path)) != before


@pytest.fixture(scope="module")
def two_refs():
    from bowtie2_tpu_torch.index.build import build_index_from_refs
    from bowtie2_tpu_torch.pipeline.policy import make_policy

    g = Genome(make_refs({"recipe": "uniform", "seed": 21,
                          "refs": [["chrA", 120_000], ["chrB", 90_000]]}))
    data = build_index_from_refs(g.refs())
    pol = make_policy("very-sensitive")
    spec = {"read_len": 150, "frag_mean": 200, "frag_sd": 10, "max_n": 8}
    pairs = manifest.plug("gen/reads", "art_pairs").draw(
        np.random.default_rng(8), g, 32, spec)
    names = [f"r{i}" for i in range(32)]
    out = {}
    for mode, units in ((manifest.plug("modes", "se"),
                         [u[0] for u in pairs]),
                        (manifest.plug("modes", "pe"), pairs)):
        al = mode.aligner(data, pol, "cpu", 1)
        out[mode.PAIRED] = (units, al.collect_raw(al.submit(
            mode.records(units, names))))
    return g, out, names


def _sam(groups):
    return b"\n".join(line for gr in groups for _f, line in gr)


@pytest.mark.parametrize("paired", [False, True])
def test_two_references_pass_and_a_wrong_rname_fails(two_refs, paired):
    g, out, names = two_refs
    units, groups = out[paired]
    judge = Judge(g, CONFIG, {"ref_band": 16, "check_units": 32}, paired)
    rnames = {rname_of(line) for gr in groups for _f, line in gr}
    assert rnames >= {"chrA", "chrB"}
    got = judge.judge([(units, _sam(groups), names)], 3)
    assert got["missing"] == 0 and got["field_err"] == 0, got
    assert got["miss_pct"] == 0.0
    bad = [list(gr) for gr in groups]
    flag, line = bad[0][0]
    f = line.split(b"\t")
    f[2] = b"chrB" if f[2] == b"chrA" else b"chrA"
    bad[0][0] = (flag, b"\t".join(f))
    got = judge.judge([(units, _sam(bad), names)], 3)
    assert got["field_err"] >= 1


def rname_of(line):
    return line.split(b"\t")[2].decode()
