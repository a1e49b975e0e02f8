"""The readers of the program's own spans and counters (``program.py``
and the ``program_span`` / ``program_counter`` metrics): a number from a
traced run of the CPU test cell, the bytes copied a sample exactly what
the reads join, stage and unpack, and nothing, without raising, where the
program keeps no totals or holds no read."""

import json
import os
from types import SimpleNamespace

import pytest

from sdrbench import manifest
from sdrbench.tests.conftest import REPO, TINY, make_tree, run_tiny

NEW = ("join_ms", "stage_ms", "sync_wait_ms", "unpack_ms",
       "host_copy_bytes_per_sample", "rds_host_ms", "rds_sync_wait_ms")
RDS_ONLY = ("rds_host_ms", "rds_sync_wait_ms")


def _reader(name):
    return manifest.load_module(os.path.join(REPO, "sdrbench", "metrics",
                                             f"{name}.py"), f"program_{name}")


def _mono_tree(dst):
    """The tiny cell without RDS: no decoders, no multiplex."""
    root = make_tree(dst)
    path = os.path.join(root, "sdrbench", "traffic", "tinyrds.json")
    with open(path) as f:
        traffic = json.load(f)
    traffic["rds"] = False
    with open(path, "w") as f:
        json.dump(traffic, f)
    return root


def test_the_new_metrics_are_declared_as_program_readings():
    per_layer = {m["name"]: m for m in manifest.load(REPO)["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == ("program_counter" if name.startswith("host_copy")
                               else "program_span")
        assert m["workloads"] == (["wide8.rds"] if name in RDS_ONLY else
                                  ["full64.reads5570k", "full64.reads696k",
                                   "wide8.rds", "wide8.mono"])


def test_each_reader_reads_a_traced_run(tiny_root):
    from tpu_sdr_torch.utils import profiling

    profiling.reset()
    result, log = run_tiny(tiny_root, trace=True)
    assert result["correct"], log
    got = result["metrics"]
    for name in NEW:
        assert got[name]["value"] > 0, name
    # the program's parts of a read lie within the harness's span of it
    parts = sum(got[n]["value"] for n in ("join_ms", "stage_ms",
                                         "sync_wait_ms", "unpack_ms"))
    assert parts < got["demod_ms"]["value"]
    assert got["rds_host_ms"]["value"] + got["rds_sync_wait_ms"]["value"] \
        < got["rds_ms"]["value"]


def test_bytes_copied_a_sample_are_the_reads_joins_staging_and_unpack(
        tmp_path):
    """A read of whole chunks copies itself twice (the join, the staging
    copy) and unpacks each station's 32 kHz audio in float32."""
    from tpu_sdr_torch.utils import profiling

    root = _mono_tree(str(tmp_path))
    cell = manifest.cell(TINY, root)
    profiling.reset()
    result, log = run_tiny(root, trace=True)
    assert result["correct"], log
    c, rb = cell.config, int(cell.traffic["read_bytes"])
    samples = rb // 2
    frames = samples // c["num_channels"]
    audio = len(c["channels"]) * frames * c["rate_resample"] \
        // c["channel_rate"] * 4
    assert samples % (c["num_channels"] * 85 * 8) == 0
    assert result["metrics"]["host_copy_bytes_per_sample"]["value"] == \
        (2 * rb + audio) / samples
    for name in RDS_ONLY:
        assert name not in result["metrics"]


@pytest.mark.parametrize("totals", ["empty", "absent"])
def test_without_totals_each_reader_finds_nothing(monkeypatch, totals):
    from tpu_sdr_torch.utils import profiling

    profiling.reset()
    if totals == "absent":  # a program older than its spans
        monkeypatch.delattr(profiling, "totals")
    rec = SimpleNamespace(cell=manifest.cell("wide8.rds", REPO))
    for name in NEW:
        assert _reader(name).read(rec) is None, name
