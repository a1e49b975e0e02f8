"""Synthetic WBFM captures and the tone SNR that scores them (numpy only),
the counterpart of ``tpu_sdr/utils/synth.py`` with the same arithmetic,
so that both packages make the same bytes.

A known audio tone (or a stereo multiplex, with an RDS subcarrier when
bits are given) is FM-modulated, offset (or placed in a wideband capture)
and quantized to interleaved u8 I/Q, as an RTL-SDR delivers it.
``snr_db`` and ``align_and_snr`` score one chain's audio against
another's (the boxcar chain against the exact one).
"""

from __future__ import annotations

import numpy as np


def _to_u8(sig: np.ndarray) -> np.ndarray:
    """Complex samples in [-1, 1] -> interleaved u8 I/Q."""
    iq = np.empty(2 * len(sig), dtype=np.float64)
    iq[0::2] = sig.real
    iq[1::2] = sig.imag
    return np.clip(np.round(iq * 127.0 + 127.5), 0, 255).astype(np.uint8)


def synth_wbfm_u8(num_samples: int, capture_rate: float = 1_020_000.0,
                  audio_freq: float = 1_000.0, deviation: float = 75_000.0,
                  amplitude: float = 0.9, noise_std: float = 0.0,
                  seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """``num_samples`` complex samples of one station FM-modulated by an
    ``audio_freq`` tone, at -fs/4 (the offset-tuned capture that the fs/4
    rotation brings to DC), with optional complex Gaussian noise.  Returns
    ``(iq_u8 of length 2*num_samples, the modulating audio)``."""
    t = np.arange(num_samples) / capture_rate
    audio = np.sin(2 * np.pi * audio_freq * t)
    phase = 2 * np.pi * deviation * np.cumsum(audio) / capture_rate
    offset = np.choose(np.arange(num_samples) % 4, [1 + 0j, -1j, -1 + 0j, 1j])
    sig = amplitude * np.exp(1j * phase) * offset
    if noise_std > 0:
        rng = np.random.default_rng(seed)
        sig = sig + noise_std * (rng.standard_normal(num_samples)
                                 + 1j * rng.standard_normal(num_samples))
    return _to_u8(sig), audio


def _rds_sign(t: np.ndarray, bits) -> np.ndarray:
    """The RDS subcarrier's +-1 symbol at times ``t``: the bits
    differentially encoded, each bit a biphase pair at the pilot-locked
    1187.5 bit/s clock."""
    b = np.asarray(bits, np.uint8)
    d = np.bitwise_xor.accumulate(b)
    tb = t * 1187.5
    k = np.minimum(tb.astype(int), len(b) - 1)
    frac = tb - tb.astype(int)
    return np.where(d[k] == 0, 1.0, -1.0) * np.where(frac < 0.5, 1.0, -1.0)


def synth_multistation_u8(num_samples: int, capture_rate: float,
                          station_freqs: list[float],
                          audio_freqs: list[float],
                          deviation: float = 75_000.0,
                          amplitude: float | None = None,
                          rds_bits: list | None = None
                          ) -> tuple[np.ndarray, list[np.ndarray]]:
    """A wideband capture holding several stations: station s is
    FM-modulated by an ``audio_freqs[s]`` tone at ``station_freqs[s]`` Hz
    from the capture centre.  ``rds_bits``: one entry a station; a
    non-None entry gives that station a pilot and a 57 kHz RDS subcarrier
    carrying those bits.  Returns ``(iq_u8, per-station audio)``."""
    if len(station_freqs) != len(audio_freqs):
        raise ValueError("one audio tone a station")
    if rds_bits is None:
        rds_bits = [None] * len(station_freqs)
    if len(rds_bits) != len(station_freqs):
        raise ValueError("one rds_bits entry a station")
    if amplitude is None:
        amplitude = 0.85 / len(station_freqs)
    t = np.arange(num_samples) / capture_rate
    sig = np.zeros(num_samples, dtype=np.complex128)
    audios = []
    for f_c, f_a, bits in zip(station_freqs, audio_freqs, rds_bits):
        audio = np.sin(2 * np.pi * f_a * t)
        audios.append(audio)
        mod = audio
        if bits is not None:
            mod = (0.6 * audio + 0.1 * np.cos(2 * np.pi * 19_000.0 * t)
                   + 0.06 * _rds_sign(t, bits)
                   * np.cos(2 * np.pi * 57_000.0 * t))
        phase = 2 * np.pi * deviation * np.cumsum(mod) / capture_rate
        sig += amplitude * np.exp(1j * (phase + 2 * np.pi * f_c * t))
    return _to_u8(sig), audios


def synth_wbfm_stereo_u8(num_samples: int, capture_rate: float = 1_020_000.0,
                         left_freq: float = 800.0, right_freq: float = 1_300.0,
                         deviation: float = 75_000.0,
                         rds_bits: np.ndarray | None = None
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A stereo station at -fs/4: the pilot-tone multiplex 0.45 (L+R) +
    0.1 pilot at 19 kHz + 0.45 (L-R) cos 38 kHz (+ 0.06 RDS at 57 kHz
    carrying ``rds_bits``), L a ``left_freq`` tone and R a ``right_freq``
    tone of amplitude 0.5.  Returns ``(iq_u8, left audio, right audio)``."""
    t = np.arange(num_samples) / capture_rate
    left = 0.5 * np.sin(2 * np.pi * left_freq * t)
    right = 0.5 * np.sin(2 * np.pi * right_freq * t)
    pilot = np.cos(2 * np.pi * 19_000.0 * t)
    sub = np.cos(2 * np.pi * 38_000.0 * t)  # phase-locked 2x pilot
    mpx = 0.45 * (left + right) + 0.1 * pilot + 0.45 * (left - right) * sub
    if rds_bits is not None:
        mpx = mpx + 0.06 * _rds_sign(t, rds_bits) * np.cos(
            2 * np.pi * 57_000.0 * t)
    phase = 2 * np.pi * deviation * np.cumsum(mpx) / capture_rate
    offset = np.choose(np.arange(num_samples) % 4, [1 + 0j, -1j, -1 + 0j, 1j])
    return _to_u8(0.9 * np.exp(1j * phase) * offset), left, right


def tone_snr(x: np.ndarray, freq: float, fs: float, skip: int = 0) -> float:
    """SNR (dB) of a recovered ``freq`` tone: ``x`` (after ``skip``
    samples, mean removed) is projected onto sin and cos at ``freq``, so
    the filters' delay and gain do not count as error."""
    x = np.asarray(x[skip:], dtype=np.float64)
    x = x - x.mean()
    t = np.arange(len(x)) / fs
    basis = np.stack([np.sin(2 * np.pi * freq * t),
                      np.cos(2 * np.pi * freq * t)], axis=1)
    coef, *_ = np.linalg.lstsq(basis, x, rcond=None)
    fit = basis @ coef
    p_err = np.dot(x - fit, x - fit)
    if p_err == 0:
        return np.inf
    return float(10 * np.log10(np.dot(fit, fit) / p_err))


def snr_db(reference: np.ndarray, test: np.ndarray, skip: int = 0) -> float:
    """SNR (dB) of ``test`` against ``reference`` after the best scalar gain,
    both mean-removed, the first ``skip`` samples dropped."""
    n = min(len(reference), len(test))
    r = np.asarray(reference[skip:n], dtype=np.float64)
    x = np.asarray(test[skip:n], dtype=np.float64)
    r = r - r.mean()
    x = x - x.mean()
    denom = np.dot(x, x)
    if denom == 0:
        return -np.inf
    err = r - np.dot(r, x) / denom * x
    p_err = np.dot(err, err)
    if p_err == 0:
        return np.inf
    return float(10 * np.log10(np.dot(r, r) / p_err))


def align_and_snr(reference: np.ndarray, test: np.ndarray, max_lag: int = 256,
                  skip: int = 0) -> tuple[float, int]:
    """The best :func:`snr_db` over integer lags in [-max_lag, max_lag], and
    its lag (filter delays shift one chain against another)."""
    best = (-np.inf, 0)
    for lag in range(-max_lag, max_lag + 1):
        if lag >= 0:
            s = snr_db(reference[lag:], test, skip=skip)
        else:
            s = snr_db(reference, test[-lag:], skip=skip)
        if s > best[0]:
            best = (s, lag)
    return best
