"""Tests of the benchmark harness. They run on the CPU at tiny sizes,
with the port's plain versions; a test marked `card` needs a CUDA card
and skips without one (run on the card: python3 -m pytest
portbench/tests -m card)."""

import json
import os
import types

import pytest

from portbench import manifest

SCORING = {"ma": 0, "mp": [6, 2], "np": 1, "rdg": [5, 3], "rfg": [5, 3],
           "gbar": 4, "score_min": ["L", -0.6, -0.6],
           "n_ceil": ["L", 0, 0.15]}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


def tiny_cell(tmp_path, mode):
    """A cell of a 300-kbp uniform genome and batches of two dozen reads
    or pairs: the harness's whole path on the CPU in seconds."""
    config = {
        "name": "tiny", "genome": {"recipe": "uniform", "seed": 3,
                                   "refs": [["tiny", 300_000]]},
        "preset": "very-sensitive", "local": False, "scoring": SCORING,
        "pe": {"minins": 0, "maxins": 500, "orient": "fr"},
        "index": {"large": False}}
    path = os.path.join(tmp_path, "tiny.json")
    with open(path, "w") as f:
        json.dump(config, f)
    base = {"art_pe150": "pe", "sub_se100": "se"}
    name = {v: k for k, v in base.items()}[mode]
    with open(os.path.join(manifest.PKG, "traffic", name + ".json")) as f:
        traffic = json.load(f)
    traffic.update(batch=24, pool_batches=8, warm_batches=1,
                   check_units=40)
    limits = {"missing": 0, "field_err": 0, "miss_pct": 1.0}
    return types.SimpleNamespace(
        name=f"tiny.{mode}", chips=1, config=config, config_file=path,
        config_name="tiny", traffic=traffic, limits=limits, per_layer=[],
        end_to_end=[{"name": "setup_s"}, {"name": traffic["rate_metric"],
                                           "unit": "u"}])


@pytest.fixture
def tiny(tmp_path):
    return lambda mode: tiny_cell(str(tmp_path), mode)
