"""tpu_sdr_torch.apps.rtl_fm on the CPU, against tpu_sdr.apps.rtl_fm.

Every mode from a capture file (s16 output against the JAX CLI's; the
narrowband fronts differ by JAX's split-bf16 decimator weights, so the
bar is the tone and >= 80 dB, the same as the float chain's CLI test),
``--rds`` (the same station text), ``-l`` squelch, the squelch-driven
scan loop on the port's frequency-aware fake dongle, and the usage
errors, which must be the JAX CLI's.
"""

import io
import logging
import sys

import numpy as np
import pytest
import torch

from tpu_sdr.utils import synth
from tpu_sdr_torch.apps import rtl_fm
from tpu_sdr_torch.control import fake

torch.set_num_threads(1)

FS = 1_020_000
F_A, F_EMPTY, F_B = 94_900_000, 95_200_000, 95_500_000
TONE_A, TONE_B = 800.0, 1_500.0


def _to_u8(baseband: np.ndarray) -> np.ndarray:
    n = len(baseband)
    sig = baseband * np.choose(np.arange(n) % 4, [1 + 0j, -1j, -1 + 0j, 1j])
    iq = np.empty(2 * n)
    iq[0::2], iq[1::2] = sig.real, sig.imag
    return np.clip(np.round(iq * 127.0 + 127.5), 0, 255).astype(np.uint8)


def _capture(mode: str, n: int = 510 * 500) -> np.ndarray:
    t = np.arange(n) / FS
    if mode == "am":
        return _to_u8(0.45 * (1.0 + 0.8 * np.sin(2 * np.pi * 1_000.0 * t))
                      + 0j)
    if mode == "usb":
        return _to_u8(0.7 * np.exp(2j * np.pi * 1_000.0 * t))
    if mode == "lsb":
        return _to_u8(0.7 * np.exp(-2j * np.pi * 1_000.0 * t))
    dev = 5_000.0 if mode == "fm" else 75_000.0
    u8, _ = synth.synth_wbfm_u8(n, capture_rate=FS, audio_freq=1_000.0,
                                deviation=dev)
    return np.asarray(u8, np.uint8)


class _BinStdout:
    def __init__(self):
        self.buffer = io.BytesIO()

    def flush(self):
        pass

    def write(self, s):
        pass


def _pcm(main, argv, monkeypatch):
    out = _BinStdout()
    monkeypatch.setattr(sys, "stdout", out)
    assert main(argv) == 0
    return np.frombuffer(out.buffer.getvalue(), dtype="<i2").astype(np.float64)


def _snr_db(ref, got):
    err = got - ref
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))


@pytest.mark.parametrize("mode", ["wbfm", "fm", "am", "usb", "lsb"])
def test_file_modes_match_the_jax_cli(tmp_path, monkeypatch, mode):
    from tpu_sdr.apps import rtl_fm as jrtl_fm

    path = tmp_path / f"{mode}.bin"
    path.write_bytes(_capture(mode).tobytes())
    argv = ["-M", mode, "--file", str(path)]
    got = _pcm(rtl_fm.main, argv + ["--torch-device", "cpu"], monkeypatch)
    exp = _pcm(jrtl_fm.main, argv, monkeypatch)
    assert got.shape == exp.shape and len(got) >= 8_000
    assert _snr_db(exp[32:], got[32:]) >= 80.0
    assert synth.tone_snr(got, 1_000.0, 32_000, skip=400) >= 25.0


def _rds_capture(pi, ps, repeats=5):
    from tpu_sdr_torch.models import rds as R

    groups = [R.make_group_0a(pi, 4, seg, ps[2 * seg: 2 * seg + 2])
              for seg in range(4)]
    bits = np.concatenate([np.concatenate(groups)] * repeats)
    n = int(np.ceil((len(bits) + 8) / 1187.5 * FS))
    n -= n % (6 * 85)
    u8, _, _ = synth.synth_wbfm_stereo_u8(n, capture_rate=FS, rds_bits=bits)
    return u8


def test_rds_prints_the_station_text_as_jax(tmp_path, monkeypatch, capsys):
    from tpu_sdr.apps import rtl_fm as jrtl_fm

    pi, ps = 0xBEEF, "TPURADIO"
    path = tmp_path / "rds.bin"
    path.write_bytes(bytes(_rds_capture(pi, ps)))
    argv = ["--file", str(path), "--rds"]
    errs = []
    for main, more in ((jrtl_fm.main, []),
                       (rtl_fm.main, ["--torch-device", "cpu"])):
        assert len(_pcm(main, argv + more, monkeypatch)) > 1000
        errs.append([ln for ln in capsys.readouterr().err.splitlines()
                     if ln.startswith("[rds]")])
    assert errs[1] == errs[0]
    assert f"[rds] PI: {pi:04X}" in errs[1]
    assert f"[rds] PS: '{ps}'" in errs[1]


def test_squelch_mutes_the_capture(tmp_path, monkeypatch):
    path = tmp_path / "am.bin"
    path.write_bytes(_capture("am", 510 * 300).tobytes())
    pcm = _pcm(rtl_fm.main, ["-M", "am", "--file", str(path), "-l", "0",
                             "--torch-device", "cpu"], monkeypatch)
    assert len(pcm) > 1000 and np.all(pcm == 0)


USAGE_ERRORS = [
    ["-M", "fm", "--rds"],
    ["-M", "wbfm", "-l", "-40"],
    ["-f", "94.9M", "-f", "95.5M", "-M", "fm", "-l", "-30", "--file", "x"],
    ["-f", "94.9M", "-f", "95.5M", "--blocks", "1"],
    ["-f", "94.9M", "-f", "95.5M", "-M", "am"],
    ["-M", "am", "--fine-tune", "100"],
    ["-M", "usb", "--deemph", "75"],
    ["-M", "dsb"],
]


@pytest.mark.parametrize("argv", USAGE_ERRORS)
def test_usage_errors_equal_the_jax_cli(argv, capsys):
    from tpu_sdr.apps import rtl_fm as jrtl_fm

    errs = []
    for main in (jrtl_fm.main, rtl_fm.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[1] == errs[0]


def test_expand_freq_spec_equals_jax():
    from tpu_sdr.apps.rtl_fm import expand_freq_spec as jexpand

    for spec in ("94.9M", "100k", "88M:88.4M:200k", "118M:118.1M:25k"):
        assert rtl_fm.expand_freq_spec(spec) == jexpand(spec)
    for bad in ("88M:87M:100k", "88M:89M"):
        with pytest.raises(SystemExit):
            rtl_fm.expand_freq_spec(bad)


@pytest.fixture
def scan_dongle():
    fake.clear_fake_devices()
    fake.register_fake_device(fake.FakeDeviceSpec(
        serial="scan0001",
        source_factory=lambda: fake.StationSource(
            [(F_A, TONE_A, 4_000.0, 0.0, 0.45),   # stops after 0.45 s
             (F_B, TONE_B, 4_000.0, 0.0, float("inf"))],
            noise_std=0.002)))
    yield
    fake.clear_fake_devices()


def _tone_db(pcm: np.ndarray, freq: float, rate: int = 32_000) -> float:
    t = np.arange(len(pcm)) / rate
    z = (pcm * np.exp(-2j * np.pi * freq * t)).mean()
    return 10 * np.log10(2 * np.abs(z) ** 2 / (np.mean(pcm ** 2) + 1e-12)
                         + 1e-12)


def test_scan_finds_both_stations(scan_dongle, caplog, monkeypatch):
    """The JAX scan test on the port's fake: dwell on A while it sends,
    hop on when it stops, skip the empty channel, land on B."""
    with caplog.at_level(logging.INFO, logger="rtl_fm"):
        pcm = _pcm(rtl_fm.main, [
            "-M", "fm", "-l", "-30", "--scan-hold", "2", "--blocks", "14",
            "-f", str(F_A), "-f", str(F_EMPTY), "-f", str(F_B),
            "--torch-device", "cpu"], monkeypatch)
    found = [r.getMessage() for r in caplog.records
             if "signal at" in r.getMessage()]
    assert any(str(F_A) in m for m in found), found
    assert any(str(F_B) in m for m in found), found
    assert not any(str(F_EMPTY) in m for m in found), found
    assert len(pcm) > 20_000
    assert _tone_db(pcm, TONE_A) > -20 and _tone_db(pcm, TONE_B) > -20


def test_scan_range_syntax_hops(scan_dongle, caplog, monkeypatch):
    with caplog.at_level(logging.INFO, logger="rtl_fm"):
        _pcm(rtl_fm.main, ["-M", "fm", "-l", "-30", "--scan-hold", "1",
                           "--blocks", "14", "-f", f"{F_A}:{F_B}:300k",
                           "--torch-device", "cpu"], monkeypatch)
    assert any(str(F_B) in r.getMessage() for r in caplog.records
               if "signal at" in r.getMessage())


def test_live_dongle_without_scanning(monkeypatch):
    """One frequency from a fake dongle through the port's BlockFeeder."""
    fake.clear_fake_devices()
    fake.register_fake_device(fake.FakeDeviceSpec(
        serial="live0002",
        source_factory=lambda: fake.SynthFmSource(capture_rate=FS)))
    try:
        pcm = _pcm(rtl_fm.main, ["-M", "wbfm", "--blocks", "6",
                                 "--torch-device", "cpu"], monkeypatch)
    finally:
        fake.clear_fake_devices()
    assert synth.tone_snr(pcm, 1_000.0, 32_000, skip=4000) > 20


def test_requires_cuda_by_default(tmp_path, monkeypatch):
    path = tmp_path / "am.bin"
    path.write_bytes(_capture("am", 510 * 10).tobytes())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rtl_fm.main(["-M", "am", "--file", str(path)])
