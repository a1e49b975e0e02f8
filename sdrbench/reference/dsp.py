"""The wideband WBFM receiver in plain PyTorch: u8 I/Q -> polyphase
filter bank (K channels) -> the selected channels -> quadrature
discriminator -> rational resampler -> s16, as the configuration states
it, designed and computed here from the configuration alone.

``precision="float64"`` is the reference.  ``precision="tf32"`` is the
control: the same computation in float32, with both operands of every
product of the filter bank and of the resampler rounded to TF32 (10
mantissa bits, round to nearest, as the tensor cores round them), the
step below the configuration's float32 that would tempt a later change.

The output of a read depends on the samples before it only through the
filters' histories (the bank's ``taps_per_branch`` frames, one sample of
the discriminator, ``resample_taps_per_phase - 1`` samples of the
resampler), so :func:`audio_s16` takes the read with enough of the bytes
before it (``lookback_bytes``) and starts from zeros there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

S16_SCALE = 0.9 * 32767.0


def kaiser_lowpass(num_taps: int, cutoff: float, atten_db: float) -> np.ndarray:
    """Kaiser-windowed sinc, ``cutoff`` in cycles a sample, unit DC gain
    (float64)."""
    if atten_db > 50:
        beta = 0.1102 * (atten_db - 8.7)
    elif atten_db >= 21:
        beta = 0.5842 * (atten_db - 21) ** 0.4 + 0.07886 * (atten_db - 21)
    else:
        beta = 0.0
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * n) * np.kaiser(num_taps, beta)
    return h / h.sum()


def bank_taps(cfg: dict) -> np.ndarray:
    """(T+1, K) branch filters ``G[t, p] = h[t K - p]`` of the K*T-tap
    prototype cut off at ``pfb_cutoff_frac`` of the channel's Nyquist,
    70 dB stop band, gain K."""
    K, T = int(cfg["num_channels"]), int(cfg["taps_per_branch"])
    h = kaiser_lowpass(K * T, cfg["pfb_cutoff_frac"] / (2 * K), 70.0) * K
    G = np.zeros((T + 1, K))
    for t in range(T + 1):
        for p in range(K):
            if 0 <= t * K - p < K * T:
                G[t, p] = h[t * K - p]
    return G


def resampler_ratio(cfg: dict) -> tuple[int, int]:
    g = math.gcd(int(cfg["channel_rate"]), int(cfg["rate_resample"]))
    return int(cfg["rate_resample"]) // g, int(cfg["channel_rate"]) // g


def resampler_phases(cfg: dict) -> np.ndarray:
    """(up, T) phases ``h[p + t up]`` of the up*T-tap anti-alias filter cut
    off at ``resample_cutoff_frac`` of the tighter Nyquist, 60 dB, gain up."""
    up, down = resampler_ratio(cfg)
    T = int(cfg["resample_taps_per_phase"])
    h = kaiser_lowpass(up * T, cfg["resample_cutoff_frac"] / (2 * max(up, down)),
                       60.0) * up
    return h.reshape(T, up).T.copy()


def lookback_bytes(cfg: dict) -> int:
    """Bytes before a read that fix its output: whole resampler frames
    covering every filter's history."""
    K = int(cfg["num_channels"])
    _, down = resampler_ratio(cfg)
    need = int(cfg["taps_per_branch"]) + 1 + int(cfg["resample_taps_per_phase"])
    return 2 * K * down * -(-need // down)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with TF32's 10 mantissa bits."""
    i = x.contiguous().view(torch.int32)
    return torch.bitwise_and(i + 0x1000, -0x2000).view(torch.float32)


def audio_s16(cfg: dict, data: np.ndarray, skip_bytes: int, *,
              precision: str = "float64", device="cpu") -> np.ndarray:
    """u8 bytes (a whole number of resampler frames of K-channel frames)
    -> (stations, samples) s16 of the bytes after ``skip_bytes``."""
    if precision not in ("float64", "tf32"):
        raise ValueError(f"precision {precision!r}")
    tf32 = precision == "tf32"
    dt = torch.float32 if tf32 else torch.float64
    op = round_tf32 if tf32 else (lambda t: t)
    K = int(cfg["num_channels"])
    up, down = resampler_ratio(cfg)
    chans = [int(c) for c in cfg["channels"]]
    u8 = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    m = u8.numel() // (2 * K)
    if u8.numel() % (2 * K * down) or skip_bytes % (2 * K * down):
        raise ValueError("not whole resampler frames")
    x = (u8.reshape(m, K, 2).to(dt) - 127.5) / 127.5

    # filter bank: Y[m, k] = sum_t sum_p X[m - t, p] G[t, p] e^{-2 pi i k p / K}
    G = bank_taps(cfg)
    R = G.shape[0]
    w = np.exp(-2j * np.pi * np.outer(np.arange(K), chans) / K)   # (p, s)
    M = (G[::-1, :, None] * w[None]).reshape(R * K, len(chans))    # row r*K+p: lag R-1-r
    Mr = op(torch.from_numpy(M.real.copy()).to(device, dt))
    Mi = op(torch.from_numpy(M.imag.copy()).to(device, dt))
    zero = torch.zeros(R - 1, K, dtype=dt, device=device)
    wr = op(torch.cat([zero, x[..., 0]]).reshape(-1).unfold(0, R * K, K))
    wi = op(torch.cat([zero, x[..., 1]]).reshape(-1).unfold(0, R * K, K))
    yr = (wr @ Mr - wi @ Mi).T          # (stations, m)
    yi = (wr @ Mi + wi @ Mr).T

    # discriminator: angle(y[n] conj(y[n-1])) / pi
    pr = torch.cat([torch.ones_like(yr[:, :1]), yr[:, :-1]], dim=1)
    pi_ = torch.cat([torch.zeros_like(yi[:, :1]), yi[:, :-1]], dim=1)
    mpx = torch.atan2(yi * pr - yr * pi_, yr * pr + yi * pi_) / math.pi

    # resampler up/down: y[j] = sum_t h[p, t] x[q - t], j down = q up + p
    H = torch.from_numpy(resampler_phases(cfg)).to(device, dt)
    T = H.shape[1]
    j = torch.arange(m // down * up, device=device)
    q, p = (j * down) // up, (j * down) % up
    xp = torch.cat([torch.zeros(len(chans), T - 1, dtype=dt, device=device),
                    mpx], dim=1)
    win = op(xp[:, q[:, None] + (T - 1) - torch.arange(T, device=device)])
    audio = (win * op(H[p])).sum(dim=-1)
    audio = audio[:, skip_bytes // (2 * K) // down * up:]
    s16 = torch.clamp(audio.to(torch.float64) * S16_SCALE, -32768, 32767)
    return torch.trunc(s16).to(torch.int16).cpu().numpy()
