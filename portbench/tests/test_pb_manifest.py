"""The manifest loader finds configurations, traffic, limits and metric
readers by name, and a new file is a new entry."""

import json
import os
import shutil

from portbench import manifest


def test_every_cell_resolves():
    bench = manifest.Bench()
    assert bench.cells()
    for name in bench.cells():
        cell = bench.cell(name)
        assert cell.traffic["mode"] in manifest.names("modes")
        manifest.plug_file("gen/reads", cell.traffic["recipe"])
        manifest.plug_file("gen/genomes", cell.config["genome"]["recipe"])
        assert {"missing", "field_err", "miss_pct"} <= set(cell.limits)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.traffic["rate_metric"] in e2e
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(manifest.reader(m["name"]))


def test_names_follow_the_files():
    bench = manifest.Bench()
    used = {w["traffic"] for w in bench.data["workloads"]}
    assert used <= set(manifest.traffic_names())
    assert {m["name"] for m in bench.data["per_layer"]} <= \
        set(manifest.metric_names())


def test_a_new_file_is_a_new_entry(tmp_path, monkeypatch):
    pkg = tmp_path / "portbench"
    for sub in ("traffic", "metrics", "limits", "configs", "modes",
                "gen/reads", "gen/genomes"):
        shutil.copytree(os.path.join(manifest.PKG, sub), pkg / sub)
    monkeypatch.setattr(manifest, "PKG", str(pkg))
    before = (manifest.traffic_names(), manifest.metric_names())
    (pkg / "gen" / "reads" / "fixed.v2.py").write_text(
        "def draw(rng, genome, n, p):\n    return ['read'] * n\n")
    assert manifest.names("gen/reads") == sorted(
        ["art_pairs", "fixed.v2", "long_indel", "uniform_sub"])
    assert manifest.plug("gen/reads", "fixed.v2").draw(None, None, 2, {}) \
        == ["read", "read"]
    spec = json.loads((pkg / "traffic" / "sub_se100.json").read_text())
    spec["read_len"] = 150
    (pkg / "traffic" / "sub_se150.json").write_text(json.dumps(spec))
    (pkg / "metrics" / "se.new_share.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (pkg / "limits" / "ecoli.se150.json").write_text(
        json.dumps({"missing": 0, "field_err": 0, "miss_pct": 1.0}))
    assert manifest.traffic_names() == sorted(before[0] + ["sub_se150"])
    assert manifest.metric_names() == sorted(before[1] + ["se.new_share"])
    assert manifest.reader("se.new_share")(None) == 42.0

    bench = json.loads(open(os.path.join(manifest.ROOT,
                                         "BENCHMARK.json")).read())
    bench["workloads"].append({"name": "ecoli.se150",
                               "config": "ecoli_k12sim",
                               "traffic": "sub_se150", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "se.new_share", "unit": "%",
                               "better": "lower", "source": "host_clock",
                               "layer": "a test", "moves": "se_reads_per_s",
                               "workloads": ["ecoli.se150"]})
    for m in bench["end_to_end"]:
        if m["name"] == "se_reads_per_s":
            m["workloads"].append("ecoli.se150")
    root = tmp_path / "root"
    (root / "portbench" / "configs").mkdir(parents=True)
    for c in bench["configs"]:
        shutil.copy(os.path.join(manifest.ROOT, c["file"]),
                    root / c["file"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = manifest.Bench(str(root)).cell("ecoli.se150")
    assert cell.traffic["read_len"] == 150
    assert [m["name"] for m in cell.per_layer] == ["se.new_share"]
    assert {m["name"] for m in cell.end_to_end} == {"se_reads_per_s",
                                                    "setup_s"}
