"""tpu_sdr_torch.utils.synth makes the same bytes as tpu_sdr.utils.synth
and scores a tone the same way."""

import numpy as np
import pytest

from tpu_sdr.utils import synth as jsynth
from tpu_sdr_torch.utils import synth


@pytest.mark.parametrize("noise_std", [0.0, 0.05])
def test_synth_wbfm_u8_matches_jax_package(noise_std):
    kw = dict(capture_rate=1_020_000, audio_freq=700.0, noise_std=noise_std,
              seed=3)
    got, audio = synth.synth_wbfm_u8(40_000, **kw)
    exp, exp_audio = jsynth.synth_wbfm_u8(40_000, **kw)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(audio, exp_audio)


def test_synth_multistation_u8_matches_jax_package():
    kw = dict(station_freqs=[3 * 170e3, -4 * 170e3], audio_freqs=[1e3, 2.5e3],
              deviation=45_000.0)
    got, audios = synth.synth_multistation_u8(30_000, 64 * 170_000, **kw)
    exp, exp_audios = jsynth.synth_multistation_u8(30_000, 64 * 170_000, **kw)
    np.testing.assert_array_equal(got, exp)
    for a, e in zip(audios, exp_audios):
        np.testing.assert_array_equal(a, e)


def test_tone_snr_matches_jax_package():
    rng = np.random.default_rng(1)
    t = np.arange(8000) / 32_000
    x = np.sin(2 * np.pi * 1_000 * t + 0.3) + 0.01 * rng.standard_normal(8000)
    got = synth.tone_snr(x, 1_000.0, 32_000, skip=100)
    assert got == pytest.approx(jsynth.tone_snr(x, 1_000.0, 32_000, skip=100),
                                abs=1e-9)
    assert 35.0 < got < 40.0


@pytest.mark.parametrize("shift", [0, 3, -2])
def test_align_and_snr_matches_jax_package(shift):
    rng = np.random.default_rng(2)
    ref = rng.standard_normal(3000)
    test = np.roll(ref, -shift)[:2900] * 0.7 + 1e-3 * rng.standard_normal(2900)
    got = synth.align_and_snr(ref, test, max_lag=4, skip=10)
    exp = jsynth.align_and_snr(ref, test, max_lag=4, skip=10)
    assert got[1] == exp[1] == shift
    assert got[0] == pytest.approx(exp[0], abs=1e-9)
    assert synth.snr_db(ref, ref) == jsynth.snr_db(ref, ref) == np.inf
