"""BENCHMARK.json and the files it names, found by name.

A cell's configuration is the file its `configs` entry names; its
traffic mix is portbench/traffic/<traffic>.json; its limits are
portbench/limits/<cell>.json; a per-layer metric's reader is
portbench/metrics/<metric>.py; the way a traffic mix drives the port is
portbench/modes/<mode>.py; a genome recipe is
portbench/gen/genomes/<recipe>.py and a read recipe
portbench/gen/reads/<recipe>.py. Nothing here knows a cell, a
configuration, a recipe or a metric by name: a new one is new files and
entries.
"""

import importlib.util
import json
import os

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def _json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of `workloads`, with its configuration, traffic, limits
    and the metrics it reports."""

    def __init__(self, bench, entry, root):
        self.name = entry["name"]
        self.entry = entry
        self.chips = int(entry["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[entry["config"]]
        self.config_name = conf["name"]
        self.config = _json(os.path.join(root, conf["file"]))
        self.config_file = os.path.join(root, conf["file"])
        self.traffic_name = entry["traffic"]
        self.traffic = _json(os.path.join(PKG, "traffic",
                                          entry["traffic"] + ".json"))
        self.limits = _json(os.path.join(PKG, "limits", self.name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if self.name in m.get("workloads", [self.name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (self.name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


class Bench:
    def __init__(self, root=ROOT):
        self.root = root
        self.data = _json(os.path.join(root, "BENCHMARK.json"))

    def cells(self):
        return [w["name"] for w in self.data["workloads"]]

    def cell(self, name):
        for w in self.data["workloads"]:
            if w["name"] == name:
                return Cell(self.data, w, self.root)
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def plug_file(kind, name):
    """The file of a plug-in: portbench/<kind>/<name>.py."""
    path = os.path.join(PKG, kind, name + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no {kind} {name!r}: {path} is not there")
    return path


def plug(kind, name):
    """The module of portbench/<kind>/<name>.py, loaded by its path (a
    name may hold dots), once a process."""
    path = plug_file(kind, name)
    if path not in _PLUGS:
        spec = importlib.util.spec_from_file_location(
            "portbench_" + "_".join((kind + "/" + name).replace(
                "-", "/").replace(".", "/").split("/")), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PLUGS[path] = mod
    return _PLUGS[path]


_PLUGS = {}


def names(kind, ext=".py"):
    """The names of the files of portbench/<kind>/ that end in ext."""
    return sorted(f[:-len(ext)] for f in os.listdir(os.path.join(PKG, kind))
                  if f.endswith(ext) and not f.startswith("_"))


def traffic_names():
    return names("traffic", ".json")


def metric_names():
    return names("metrics")


def reader(metric):
    """The `read(ctx)` function of portbench/metrics/<metric>.py."""
    return plug("metrics", metric).read
