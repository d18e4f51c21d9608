"""Where the benchmark finds its parts by name: BENCHMARK.json at the root
of the checkout, a configuration's file (its `file` entry), a traffic mix
at portbench/traffic/<traffic>.json, a cell's limits at
portbench/limits/<cell>.json, a metric's reader at
portbench/metrics/<metric>.py and a model's plain reference at
portbench.reference.<model>. Adding a cell, a configuration, a mix or a
metric adds files and entries; no file here changes."""

import importlib
import importlib.util
import json
import os

__all__ = ["PACKAGE_DIR", "ROOT", "Cell", "load_cell", "load_reader"]

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
PACKAGE = os.path.basename(PACKAGE_DIR)
ROOT = os.path.dirname(PACKAGE_DIR)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of BENCHMARK.json's workloads with what it names: the
    configuration (dict), the traffic (dict), the limits of the numbers
    compared (dict), the end-to-end and per-layer metric entries that it
    reports, and the model's reference module."""

    def __init__(self, bench, name, root):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = self.entry["chips"]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _read_json(os.path.join(
            root, configs[self.entry["config"]]["file"]))
        self.root = root
        base = os.path.join(root, PACKAGE)
        self.traffic = _read_json(os.path.join(
            base, "traffic", f"{self.entry['traffic']}.json"))
        self.limits = _read_json(os.path.join(base, "limits",
                                              f"{name}.json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if _applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
        self.reference = importlib.import_module(
            f"portbench.reference.{self.config['model']}")


def load_cell(name, root=ROOT):
    """The Cell named `name` of <root>/BENCHMARK.json."""
    return Cell(_read_json(os.path.join(root, "BENCHMARK.json")), name, root)


def load_reader(name, root=ROOT):
    """The module of metrics/<name>.py (a metric's name may hold dots, so
    it is loaded by path). Its read(w) returns the metric's value, or None
    where the run holds nothing for it to read."""
    path = os.path.join(root, PACKAGE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
