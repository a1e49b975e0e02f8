"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) resolves to its configuration file
(the ``file`` of its entry in ``configs``), its traffic mix
(``sdrbench/traffic/<traffic>.json``), the code that runs its receiver
(``sdrbench/receivers/<receiver>.py``, the configuration's ``receiver``)
and a reader for each per-layer metric it reports
(``sdrbench/metrics/<metric>.py``, a ``read(record)`` function).  A later
change adds a cell, a configuration or a metric by adding files and
entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH = "BENCHMARK.json"
PKG = "sdrbench"


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: list       # entries of BENCHMARK.json's end_to_end it reports
    per_layer: list        # entries of per_layer it reports
    root: str

    def receiver_path(self) -> str:
        return os.path.join(self.root, PKG, "receivers",
                            f"{self.config['receiver']}.py")

    def metric_path(self, name: str) -> str:
        return os.path.join(self.root, PKG, "metrics", f"{name}.py")


def load(root: str = ".") -> dict:
    with open(os.path.join(root, BENCH)) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ".") -> Cell:
    bench = load(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in {BENCH}; there are "
                       f"{sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, PKG, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, name) and m["moves"] in moved]
    return Cell(name, int(w["chips"]), w["config"], w["traffic"], config,
                traffic, e2e, layer, root)


def load_module(path: str, name: str):
    """A receiver or a metric reader, loaded from its file."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
