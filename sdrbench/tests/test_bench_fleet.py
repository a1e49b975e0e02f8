"""The fleet cell (``fleet16.reads256k``: ``FusedWbfmBatchStreamer`` over
dongles' reads) on the CPU at a tiny size: 4 dongles of 300,000-byte
reads, so that the residual is never empty and both graph keys (2 and 3
chunks a row) come up in four reads.  The port's plain path agrees with
the reference, the control fails, each fault the cell can have, planted
under the harness, turns ``correct`` false, the work is the same for every
seed, and the program's spans and counter are read."""

import json
import os

import numpy as np
import pytest

from sdrbench import manifest
from sdrbench.receivers import fleet
from sdrbench.reference import fm
from sdrbench.tests.conftest import make_tree

CELL = "tiny.fleet"
DONGLES, READ = 4, 300_000
FLEET_METRICS = ("fleet_join_ms", "fleet_stage_ms", "fleet_sync_wait_ms",
                 "fleet_unpack_ms", "fleet_host_copy_bytes_per_sample")


def make_fleet_tree(dst: str) -> str:
    """The benchmark's copy with a tiny fleet cell added."""
    root = make_tree(dst)
    conf = os.path.join(root, "sdrbench", "configs")
    with open(os.path.join(conf, "wbfm_fleet16.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tinyfleet", dongles=DONGLES, dongle_read_bytes=READ)
    with open(os.path.join(conf, "tinyfleet.json"), "w") as f:
        json.dump(cfg, f)
    traffic_dir = os.path.join(root, "sdrbench", "traffic")
    with open(os.path.join(traffic_dir, "fleet16.json")) as f:
        traffic = json.load(f)
    traffic.update(read_bytes=DONGLES * READ, ring_reads=4, warmup_reads=4,
                   compare_reads=3, trace_reads=2)
    with open(os.path.join(traffic_dir, "tinyfleet.json"), "w") as f:
        json.dump(traffic, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tinyfleet", "source": "a test",
                             "reduced": ["dongles", "dongle_read_bytes"],
                             "why": "CPU tests",
                             "file": "sdrbench/configs/tinyfleet.json"})
    bench["workloads"].append({"name": CELL, "config": "tinyfleet",
                               "traffic": "tinyfleet", "chips": 1,
                               "why": "tests"})
    for m in bench["per_layer"]:
        if "fleet16.reads256k" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="module")
def fleet_root(tmp_path_factory):
    return make_fleet_tree(str(tmp_path_factory.mktemp("fleet")))


def run_fleet(root, seed=2_700_000_011, seconds=0.6, trace=False, **kw):
    import io

    from sdrbench import run

    log = io.StringIO()
    result, _ = run.run(CELL, seed, seconds, trace, root=root, device="cpu",
                        log=log, **kw)
    return result, log.getvalue()


def test_the_port_agrees_with_the_reference(fleet_root):
    result, log = run_fleet(fleet_root)
    assert result["correct"], log
    c = result["checks"]
    assert c["audio_gap_lsb"]["value"] <= 1
    assert c["audio_rms_lsb"]["value"] < 0.1
    assert result["attempted"] > 0


def test_the_control_fails_both_limits(fleet_root):
    result, log = run_fleet(fleet_root, control="tf32")
    assert not result["correct"], log
    for c in result["checks"].values():
        assert c["value"] > c["limit"]


def _wrap(monkeypatch, before=None, after=None):
    from tpu_sdr_torch.ops import fused_fm as FF

    orig = FF.FusedWbfmBatchStreamer.demodulate

    def demodulate(self, bufs):
        if before is not None:
            before(self)
        audio = orig(self, bufs)
        return audio if after is None else after(self, audio)

    monkeypatch.setattr(FF.FusedWbfmBatchStreamer, "demodulate", demodulate)


def _dongles_swapped(monkeypatch):
    _wrap(monkeypatch, after=lambda s, audio: audio[[1, 0, 2, 3]])


def _residual_dropped(monkeypatch):
    """Row 1's residual is lost after each read (its bytes replaced by
    silence, so the rows stay in step)."""
    def drop(s, audio):
        pending = s._pending.copy()
        pending[1] = 127
        s._pending = pending
        return audio
    _wrap(monkeypatch, after=drop)


def _one_sample_altered(monkeypatch):
    def alter(s, audio):
        audio = audio.copy()
        audio[2, audio.shape[1] // 2] += 0.05
        return audio
    _wrap(monkeypatch, after=alter)


def _carries_reset(monkeypatch):
    from tpu_sdr_torch.ops import fused_fm as FF

    def reset(s):
        s.states = FF.init_carry(s.device).repeat(s.stations, 1, 1)
        s.resamp_hists = s.resamp_hists.new_zeros(s.resamp_hists.shape)
    _wrap(monkeypatch, before=reset)


@pytest.mark.parametrize("plant", [_dongles_swapped, _residual_dropped,
                                   _one_sample_altered, _carries_reset])
def test_a_fault_under_the_harness_is_not_correct(fleet_root, monkeypatch,
                                                  plant):
    plant(monkeypatch)
    result, log = run_fleet(fleet_root, seed=2_700_000_012)
    assert not result["correct"], log


def test_a_whole_run_prints_the_same_signature_for_two_seeds(fleet_root):
    sigs = []
    for seed in (3, 2**31 + 3):
        _, log = run_fleet(fleet_root, seed=seed, seconds=0.3)
        line = [ln for ln in log.splitlines()
                if ln.startswith("work signature: ")]
        sigs.append(json.loads(line[0].split(": ", 1)[1]))
    assert sigs[0] == sigs[1]
    # a read and its residual give 2 chunks a row, or 3
    assert sigs[0]["graph_keys"] == {"FusedWbfmBatchStreamer": 2}
    assert sigs[0]["stations"] == 1 and sigs[0]["read_bytes"] == DONGLES * READ


def _bytes_copied(reads: int, cfg: dict) -> int:
    """What ``reads`` reads of the tiny fleet copy on the CPU's host: each
    join of the residual and the read, the copy of the whole chunks into one
    block where a residual is left, the copy into the static input, the
    float32 audio unpacked."""
    q, frame = fleet.chunk_bytes(cfg), fm.frame_bytes(cfg)
    up = fm.resampler_ratio(cfg)[0]
    total, pending = 0, 0
    for _ in range(reads):
        joined = pending + READ
        usable = joined - joined % q
        pending = joined - usable
        total += DONGLES * (joined + (usable if pending else 0) + usable
                            + usable // frame * up * 4)
    return total


def test_the_program_metrics_are_read(fleet_root):
    from tpu_sdr_torch.utils import profiling

    profiling.reset()
    result, log = run_fleet(fleet_root, trace=True)
    assert result["correct"], log
    got = result["metrics"]
    for name in FLEET_METRICS:
        assert got[name]["value"] > 0, name
    assert "k1_roofline" not in got and "k2_roofline" not in got  # no card
    # the totals hold the warm-up's reads and the window's, not the traced
    cell = manifest.cell(CELL, fleet_root)
    reads = int(cell.traffic["warmup_reads"]) + result["attempted"]
    assert profiling.totals()["spans"]["FusedWbfmBatchStreamer.demodulate"][0] \
        == reads
    assert got["fleet_host_copy_bytes_per_sample"]["value"] == pytest.approx(
        _bytes_copied(reads, cell.config) / reads / (DONGLES * READ / 2),
        rel=1e-12)


def test_a_dongles_stream_is_its_rows_in_order():
    """Dongle d's bytes are row d of each read, the reads cycling the
    ring; a read's span is its whole chunks after the residual before it."""
    from types import SimpleNamespace

    plan = SimpleNamespace(read_bytes=3 * 10, ring_reads=2)
    ring = np.arange(60, dtype=np.uint8)
    got = fleet.stream_bytes(plan, ring, 3, 1, 5, 35)
    want = np.concatenate([ring[10:20], ring[40:50], ring[10:20],
                           ring[40:50]])[5:35]
    assert np.array_equal(got, want)
    cfg = {"decim": 6, "rate_out": 170_000, "rate_resample": 32_000}
    q = fleet.chunk_bytes(cfg)
    assert q == 130_560
    assert fleet.span_of_read(cfg, 0, 262_144) == (0, 2 * q)
    assert fleet.span_of_read(cfg, 127, 262_144) == (254 * q, 257 * q)
