"""``correct`` on the CPU at a tiny size: the port's plain path agrees
with the reference, the control fails, and each fault a cell can have,
planted under the harness, turns ``correct`` false.  On the card (marked
``cuda``): the control fails and a sound run passes in every cell."""

import os
import subprocess
import sys

import numpy as np
import pytest

from sdrbench import manifest
from sdrbench.reference import dsp
from sdrbench.tests.conftest import REPO, run_tiny


def test_the_port_agrees_with_the_reference(tiny_root):
    result, log = run_tiny(tiny_root)
    assert result["correct"], log
    c = result["checks"]
    assert c["audio_gap_lsb"]["value"] <= 1
    assert c["rds_wrong_groups"]["value"] == 0
    assert c["rds_missed_groups"]["value"] == 0
    assert result["attempted"] > 0 and "compared: 7 reads" in log


def test_the_control_fails(tiny_root):
    result, log = run_tiny(tiny_root, control="tf32")
    assert not result["correct"], log
    c = result["checks"]
    assert c["audio_rms_lsb"]["value"] > c["audio_rms_lsb"]["limit"]


def test_tf32_rounding():
    import torch

    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10, -3.0 - 2.0**-12])
    assert dsp.round_tf32(x).tolist() == [1.0, 1.0 + 2.0**-10,
                                          1.0 + 2.0**-10, -3.0]


def _stale_state(monkeypatch):
    from tpu_sdr_torch.models import wbfm_wideband as wb

    orig = wb.demodulate_block_fused

    def stale(data, carry, quad, hist, *args):
        out = orig(data, carry, quad, hist, *args)
        return out[:-3] + (carry, quad, hist)

    monkeypatch.setattr(wb, "demodulate_block_fused", stale)


def _wrap_audio(monkeypatch, change):
    from tpu_sdr_torch.models import wbfm_wideband as wb

    orig = wb.WidebandStreamer.demodulate

    def demodulate(self, buf):
        audio = orig(self, buf).copy()
        change(audio)
        return audio

    monkeypatch.setattr(wb.WidebandStreamer, "demodulate", demodulate)


def _half_the_stations(monkeypatch):
    def drop(audio):
        audio[audio.shape[0] // 2:] = 0.0
    _wrap_audio(monkeypatch, drop)


def _one_sample_altered(monkeypatch):
    def alter(audio):
        audio[0, audio.shape[1] // 2] += 0.05
    _wrap_audio(monkeypatch, alter)


def _rds_group_altered(monkeypatch):
    from tpu_sdr_torch.models import rds

    orig = rds.GroupSynchronizer.feed

    def feed(self, bits):
        got = orig(self, bits)
        return [(a, b, c, d ^ 1) if k == 0 else (a, b, c, d)
                for k, (a, b, c, d) in enumerate(got)]

    monkeypatch.setattr(rds.GroupSynchronizer, "feed", feed)


DROP_EVERY = 40


def _rds_read_dropped(monkeypatch):
    """Each decoder skips one read's multiplex in every DROP_EVERY, as a
    station that loses its signal for a read would: the groups around each
    gap are lost until the decoder syncs again."""
    from tpu_sdr_torch.models import rds

    orig = rds.RdsStreamDecoder.feed_mpx

    def feed_mpx(self, mpx):
        self.fed = getattr(self, "fed", 0) + 1
        return [] if self.fed % DROP_EVERY == 0 else orig(self, mpx)

    monkeypatch.setattr(rds.RdsStreamDecoder, "feed_mpx", feed_mpx)


# the faults this cell can have; there is no exchange between chips to leave
# out (one card), and no mean over a batch (each station's audio is its own)
@pytest.mark.parametrize("plant", [_stale_state, _half_the_stations,
                                   _one_sample_altered, _rds_group_altered,
                                   _rds_read_dropped])
def test_a_fault_under_the_harness_is_not_correct(tiny_root, monkeypatch, plant):
    plant(monkeypatch)
    result, log = run_tiny(tiny_root, seed=2_700_000_002)
    assert not result["correct"], log


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "sdrbench"), tmp_path / "sdrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "sdrbench.run", "--workload",
                          "wide8.mono", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in manifest.load(REPO)["workloads"]])
def test_on_the_card_the_control_fails_and_a_run_passes(card, name):
    from sdrbench import run

    sound, _ = run.run(name, 2_900_000_001, 2.0, False, root=REPO)
    control, _ = run.run(name, 2_900_000_002, 2.0, False, root=REPO,
                         control="tf32")
    assert sound["correct"] and not control["correct"]
    assert np.isfinite(sound["metrics"]["throughput"]["value"])
