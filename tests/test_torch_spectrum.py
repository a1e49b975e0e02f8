"""tpu_sdr_torch's Welch PSD and rtl_power against tpu_sdr's.

The port accumulates |X|² in float32 as JAX does, in another summation
order: dB bins within 0.01 dB.  The CLI rows (two decimals) agree in
every frequency field and within 0.01 dB, plus the last printed digit,
in each bin.
"""

import io
import sys

import numpy as np
import pytest
import torch

from tpu_sdr.ops import spectrum as JS
from tpu_sdr_torch import convert
from tpu_sdr_torch.apps import rtl_power as trp
from tpu_sdr_torch.ops import spectrum as TS

torch.set_num_threads(1)

CPU = torch.device("cpu")
DB_TOL = 0.01


def synth_tone_u8(n: int, freq_frac: float, amp: float = 100.0,
                  seed: int = 0) -> np.ndarray:
    """Complex tone at ``freq_frac`` of fs + light noise, as u8 I/Q."""
    rng = np.random.default_rng(seed)
    ph = 2 * np.pi * freq_frac * np.arange(n)
    u8 = np.empty(2 * n, np.uint8)
    u8[0::2] = np.clip(np.round(127.5 + amp * np.cos(ph)
                                + rng.normal(0, 1.0, n)), 0, 255)
    u8[1::2] = np.clip(np.round(127.5 + amp * np.sin(ph)
                                + rng.normal(0, 1.0, n)), 0, 255)
    return u8


@pytest.mark.parametrize("n_fft,frac,cut", [(1024, 0.125, 2 * 7 * 1024 + 100),
                                            (512, -0.2, 5_001),
                                            (256, -0.25, 512)])
def test_psd_streamer_matches_jax(n_fft, frac, cut):
    buf = synth_tone_u8(40 * n_fft, frac, seed=3)
    ref, port = JS.PsdStreamer(n_fft), TS.PsdStreamer(n_fft, device=CPU)
    for s in (ref, port):
        s.accumulate(buf[:cut])
        s.accumulate(buf[cut:])
    assert port.segments == ref.segments == 40
    exp, got = ref.finalize_db(), port.finalize_db()
    assert got.dtype == np.float64 and got.shape == (n_fft,)
    np.testing.assert_allclose(got, exp, rtol=0, atol=DB_TOL)
    peak = int(np.argmax(got))
    assert abs(peak - (n_fft // 2 + int(round(frac * n_fft)))) <= 1


def test_psd_state_converts_both_ways():
    buf = synth_tone_u8(8 * 256, 0.1)
    ref = JS.PsdStreamer(256)
    ref.accumulate(buf)
    port = TS.PsdStreamer(256, device=CPU)
    port.state = convert.psd_state_from_jax(ref.state, device=CPU)
    assert port.state.count == 8
    np.testing.assert_allclose(port.finalize_db(), ref.finalize_db(),
                               rtol=0, atol=0)
    acc, count = convert.psd_state_to_jax(port.state)
    assert count == np.float32(8.0) and acc.dtype == np.float32
    np.testing.assert_array_equal(acc, np.asarray(ref.state.acc))


def _run(main, argv):
    old = sys.stdout
    sys.stdout = out = io.StringIO()
    try:
        rc = main(argv)
    finally:
        sys.stdout = old
    assert rc == 0
    return out.getvalue()


def _rows(text):
    rows = []
    for line in text.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        rows.append((parts[2:6], np.array([float(v) for v in parts[6:]])))
    return rows


def _same_rows(got_text, exp_text):
    got, exp = _rows(got_text), _rows(exp_text)
    assert len(got) == len(exp) > 0
    for (g_hz, g_db), (e_hz, e_db) in zip(got, exp):
        assert g_hz == e_hz and g_db.shape == e_db.shape
        np.testing.assert_allclose(g_db, e_db, rtol=0, atol=DB_TOL + 0.0101)
    return got


def test_rtl_power_file_mode_matches_jax(tmp_path):
    from tpu_sdr.apps import rtl_power as jrp

    rate, center = 1_024_000, 100_000_000
    path = tmp_path / "cap.bin"
    path.write_bytes(synth_tone_u8(300_000, 0.125, seed=7).tobytes())
    argv = ["-f", str(center), "-s", str(rate), "--file", str(path)]
    rows = _same_rows(_run(trp.main, argv + ["--torch-device", "cpu"]),
                      _run(jrp.main, argv))
    (hz_low, hz_high, step, _), bins = rows[0]
    assert int(hz_low) == center - rate // 2
    peak_hz = int(hz_low) + float(step) * int(np.argmax(bins))
    assert abs(peak_hz - (center + rate / 8)) <= 2 * float(step)


@pytest.mark.parametrize("extra", [["-b", "2"], ["-b", "1", "-p", "2"],
                                   ["-b", "1", "-c", "0"]])
def test_rtl_power_fake_dongle_scan_matches_jax(extra):
    """A scan over two hops of a fake dongle synthesising WBFM (both
    packages' fakes serve the same bytes): the same rows."""
    from tpu_sdr.apps import rtl_power as jrp
    from tpu_sdr.control import fake as jfake
    from tpu_sdr_torch.control import fake as tfake

    rate = 1_020_000
    argv = ["-f", f"94000000:{94_000_000 + 2 * rate}:8k", "-s", str(rate),
            *extra]
    texts = []
    for fake, main, more in ((jfake, jrp.main, []),
                             (tfake, trp.main, ["--torch-device", "cpu"])):
        fake.clear_fake_devices()
        fake.register_fake_device(fake.FakeDeviceSpec(
            serial="pw000001",
            source_factory=lambda f=fake: f.SynthFmSource(capture_rate=rate)))
        try:
            texts.append(_run(main, argv + more))
        finally:
            fake.clear_fake_devices()
    rows = _same_rows(texts[1], texts[0])
    n_hops = len(trp.hop_centers(94_000_000, 94_000_000 + 2 * rate, rate,
                                 1.0 if "-c" in extra else trp.HOP_CROP))
    assert len(rows) == n_hops * (2 if "-p" in extra else 1)


def test_rtl_power_requires_cuda_by_default(tmp_path, monkeypatch):
    path = tmp_path / "cap.bin"
    path.write_bytes(synth_tone_u8(4096, 0.1).tobytes())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trp.main(["-f", "100M", "--file", str(path)])
