"""CPU tests of the benchmark (``python -m pytest sdrbench/tests``), and
the few marked ``cuda`` that need the card and skip without one.

``tiny_root`` is a copy of the benchmark with one made-up cell small
enough for the CPU: 8 channels of 170 kHz, two RDS stations, reads of
21,760 bytes, the port's plain versions of its kernels."""

import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = "tiny.rds"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs the benchmark on the card; needs a GPU")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def make_tree(dst: str) -> str:
    """A copy of BENCHMARK.json and sdrbench/ with the tiny cell added."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "sdrbench"), os.path.join(dst, "sdrbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "sdrbench", "configs", "wbfm_wideband8.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny8", num_channels=8, channels=[2, 5])
    with open(os.path.join(dst, "sdrbench", "configs", "tiny8.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(REPO, "sdrbench", "traffic", "rds.json")) as f:
        traffic = json.load(f)
    traffic.update(read_bytes=21760, ring_reads=208, warmup_reads=24,
                   compare_reads=6, trace_reads=6)
    with open(os.path.join(dst, "sdrbench", "traffic", "tinyrds.json"), "w") as f:
        json.dump(traffic, f)
    path = os.path.join(dst, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny8", "source": "a test", "reduced":
                             ["num_channels", "channels"], "why": "CPU tests",
                             "file": "sdrbench/configs/tiny8.json"})
    bench["workloads"].append({"name": TINY, "config": "tiny8",
                               "traffic": "tinyrds", "chips": 1, "why": "tests"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TINY)
    with open(path, "w") as f:
        json.dump(bench, f)
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tree(str(tmp_path_factory.mktemp("tiny")))


def run_tiny(root, seed=2_700_000_001, seconds=0.6, trace=False, **kw):
    """One run of the tiny cell on the CPU; (result, log text)."""
    import io

    from sdrbench import run

    log = io.StringIO()
    result, _ = run.run(TINY, seed, seconds, trace, root=root, device="cpu",
                        log=log, **kw)
    return result, log.getvalue()
