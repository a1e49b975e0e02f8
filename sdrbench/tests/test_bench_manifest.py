"""BENCHMARK.json against the contract, every cell resolved to its files,
a new cell and metric picked up from added files alone, and the import
rules of the benchmark's own modules."""

import ast
import json
import os
import re

import pytest

from sdrbench import manifest
from sdrbench.tests.conftest import REPO, TINY, make_tree, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    return manifest.load(REPO)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_manifest_keys_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
        assert not p.endswith("_torch") and os.path.isdir(os.path.join(REPO, p))
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for key, entry_keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                            ("workloads", {"name", "config", "traffic", "chips", "why"})):
        names = [e["name"] for e in b[key]]
        assert len(names) == len(set(names))
        for e in b[key]:
            assert set(e) == entry_keys
            assert NAME.match(e["name"]) and _line(e["why"])
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert os.path.getsize(os.path.join(REPO, manifest.BENCH)) <= 64 * 1024


def test_configs_and_cells():
    b = _bench()
    used = {w["config"] for w in b["workloads"]}
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert c["source"].startswith("https://") and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in b["workloads"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    assert 1 <= len(b["workloads"]) <= 24


def test_metrics_moves_and_workloads_agree():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        for c in m.get("workloads", cells):
            assert c in cells
            assert c in e2e[m["moves"]].get("workloads", cells)
    for c in cells:
        cell = manifest.cell(c, REPO)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", [w["name"] for w in manifest.load(REPO)["workloads"]])
def test_every_cell_resolves_to_its_files(name):
    cell = manifest.cell(name, REPO)
    assert os.path.isfile(cell.receiver_path())
    for m in cell.per_layer:
        assert os.path.isfile(cell.metric_path(m["name"]))
        assert callable(manifest.load_module(cell.metric_path(m["name"]),
                                             "m_" + m["name"]).read)
    for key in ("read_bytes", "ring_reads", "rds", "warmup_reads",
                "compare_reads", "trace_reads"):
        assert key in cell.traffic
    assert set(cell.config["limits"]) >= {"audio_gap_lsb", "audio_rms_lsb"}


def test_a_new_cell_and_metric_come_from_added_files(tmp_path):
    root = make_tree(str(tmp_path))
    with open(os.path.join(root, "sdrbench", "metrics", "s16_ms.py"), "w") as f:
        f.write("def read(rec):\n"
                "    s = rec.span_mean_s('s16')\n"
                "    return None if s is None else s * 1e3\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "s16_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "output",
                               "moves": "throughput", "workloads": [TINY]})
    with open(path, "w") as f:
        json.dump(bench, f)
    cell = manifest.cell(TINY, root)
    assert "s16_ms" in {m["name"] for m in cell.per_layer}
    result, _ = run_tiny(root, seconds=0.3, trace=True)
    assert result["metrics"]["s16_ms"]["unit"] == "ms"
    assert result["metrics"]["s16_ms"]["value"] > 0
    assert "demod_ms" in result["metrics"]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _modules(sub=""):
    base = os.path.join(REPO, "sdrbench", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _modules():
        for mod in _imports(path):
            assert mod.split(".")[0] not in {"jax", "jaxlib", "flax", "tpu_sdr"}, \
                (path, mod)


def test_the_reference_imports_nothing_of_the_program():
    for path in _modules("reference"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top != "tpu_sdr_torch", (path, mod)
            if top == "sdrbench":
                assert mod.startswith("sdrbench.reference"), (path, mod)
