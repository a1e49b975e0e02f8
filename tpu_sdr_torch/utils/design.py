"""Filter-bank designers and chain configuration, without JAX.

Numpy copies of the weight builders that the JAX package keeps in modules
which load JAX (``tpu_sdr/ops/fm.py``: ``make_banded_decim_matrix``,
``make_split_bf16``, ``make_aligned_poly_matrix``,
``make_aligned_boxcar_matrix``, ``make_polyphase``;
``tpu_sdr/models/wbfm.py``: ``WbfmConfig``; ``tpu_sdr/models/wbfm_exact.py``:
``optimal_settings``; ``tpu_sdr/ops/channelizer.py``: ``design_pfb``,
``pfb_mxu_matrices``, ``channel_frequencies``), with the same defaults and
the same outputs.  The prototype filters come from the port's copy of
``tpu_sdr/utils/firdes.py`` (``tpu_sdr_torch.utils.firdes``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from tpu_sdr_torch.utils import firdes


@dataclass(frozen=True)
class WbfmConfig:
    """WBFM chain configuration (field for field the JAX ``WbfmConfig``).

    Defaults mirror the reference's ``optimal_settings(94.9M, 170k)``:
    capture 1.02 Msps, decimate by 6 to 170 kHz, resample to 32 kHz audio.
    The port's chains compute in float32 whatever ``mxu_precision`` says;
    the field stays so that a configuration converts 1:1.
    """

    capture_rate: int = 1_020_000
    decim: int = 6
    rate_out: int = 170_000
    rate_resample: int = 32_000
    filter_mode: str = "fir"
    fir_taps_per_phase: int = 12
    fir_cutoff_frac: float = 0.9
    resample_taps_per_phase: int = 48
    resample_cutoff_frac: float = 0.8
    deemphasis_tau: float = 0.0
    emit_mpx: bool = False
    mxu_precision: str = "split_bf16"

    @property
    def resample_up(self) -> int:
        return self.rate_resample // math.gcd(self.rate_out, self.rate_resample)

    @property
    def resample_down(self) -> int:
        return self.rate_out // math.gcd(self.rate_out, self.rate_resample)

    @property
    def num_taps(self) -> int:
        return self.decim * self.fir_taps_per_phase


def decimator_taps(config: WbfmConfig) -> np.ndarray:
    """The anti-alias FIR of the ÷decim stage (``num_taps`` f32 taps)."""
    return firdes.decimating_lowpass(
        config.decim, taps_per_phase=config.fir_taps_per_phase,
        cutoff_frac=config.fir_cutoff_frac)


def resampler_poly(config) -> np.ndarray:
    """The audio resampler's prototype filter split into (up, T) phases,
    for a ``WbfmConfig`` or a ``WidebandConfig`` (the same resampler
    fields)."""
    h = firdes.resampler_taps(
        config.resample_up, config.resample_down,
        taps_per_phase=config.resample_taps_per_phase,
        cutoff_frac=config.resample_cutoff_frac)
    return make_polyphase(h, config.resample_up)


def make_banded_decim_matrix(taps: np.ndarray, decim: int,
                             chunk_out: int = 128) -> np.ndarray:
    """Banded W (chunk_out*decim + L - decim, chunk_out) with
    ``W[r*decim + j, r] = taps[::-1][j]``: chunked frames @ W is the
    decimating FIR."""
    taps_rev = np.asarray(taps, dtype=np.float32)[::-1]
    L = len(taps_rev)
    W = np.zeros((chunk_out * decim + L - decim, chunk_out), dtype=np.float32)
    for r in range(chunk_out):
        W[r * decim: r * decim + L, r] = taps_rev
    return W


def make_split_bf16(W: np.ndarray, scale: float = 255.0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(W_hi, W_lo) bfloat16 tensors with ``W/scale ≈ W_hi + W_lo``: the TPU
    kernel's split-precision weights, rounded from float64 as the JAX
    package rounds them."""
    Ws = torch.from_numpy(np.asarray(W, dtype=np.float64) / scale)
    W_hi = Ws.to(torch.bfloat16)
    W_lo = (Ws - W_hi.to(torch.float64)).to(torch.bfloat16)
    return W_hi, W_lo


def split_bf16_sum(w_hi, w_lo) -> torch.Tensor:
    """A split-bf16 pair as one f32 tensor ``W_hi + W_lo``: the weights the
    TPU kernel's two bf16 matmuls apply, for one f32 FMA each.  Takes bf16
    tensors, or arrays of any dtype numpy can cast to f32."""
    def f32(w):
        if torch.is_tensor(w):
            return w.to(torch.float32)
        return torch.from_numpy(np.asarray(w, dtype=np.float32))

    return (f32(w_hi) + f32(w_lo)).contiguous()


def make_aligned_poly_matrix(h_poly: np.ndarray, up: int, down: int,
                             frames_per_row: int = 1) -> np.ndarray:
    """V for the frame-matmul resampler: ``V[(T-1) + k*down + o_s - t,
    k*up + s] = h_poly[p_s, t]`` with o_s = (s*down)//up, p_s = (s*down)%up,
    ``frames_per_row`` frames packed side by side."""
    hp = np.asarray(h_poly, dtype=np.float32)
    T = hp.shape[1]
    F_ = frames_per_row
    V = np.zeros((down * F_ + T - 1, up * F_), dtype=np.float32)
    for k in range(F_):
        for s in range(up):
            o = (s * down) // up
            p = (s * down) % up
            for t in range(T):
                V[(T - 1) + k * down + o - t, k * up + s] = hp[p, t]
    return V


def make_aligned_boxcar_matrix(rate_out: int, rate_resample: int
                               ) -> tuple[np.ndarray, int, int]:
    """V (down, up) for the reference's boxcar resampler on whole frames,
    and its (up, down): emission s of a frame averages inputs (e_{s-1},
    e_s] with e_s = ceil((s+1)*fast/slow) - 1, scaled by 1/(fast//slow).
    No window crosses the frame's left edge, so V has no history rows."""
    g = math.gcd(rate_out, rate_resample)
    up, down = rate_resample // g, rate_out // g
    div = rate_out // rate_resample
    V = np.zeros((down, up), dtype=np.float32)
    fast, slow = rate_out, rate_resample
    for s in range(up):
        e = ((s + 1) * fast + slow - 1) // slow - 1
        e_prev = (s * fast + slow - 1) // slow - 1
        V[e_prev + 1:e + 1, s] = 1.0 / div
    return V, up, down


def make_polyphase(h: np.ndarray, up: int) -> np.ndarray:
    """Prototype taps -> (up, T) polyphase matrix, ``h_poly[p, t] = h[p + t*up]``."""
    L = len(h)
    T = -(-L // up)
    hp = np.zeros(up * T, dtype=np.float32)
    hp[:L] = h
    return hp.reshape(T, up).T.copy()


def design_pfb(num_channels: int, taps_per_branch: int = 8,
               atten_db: float = 70.0, cutoff_frac: float = 0.45) -> np.ndarray:
    """The PFB's (T+1, K) analysis branch matrix: ``G[t, p] = h[tK - p]``
    of a K*T-tap prototype lowpass cut off at ``cutoff_frac`` of the
    channel Nyquist (fs / 2K), zero where the index leaves the prototype."""
    K = num_channels
    T = taps_per_branch
    L = K * T
    h = firdes.lowpass(L, cutoff_frac / (2 * K), 1.0, atten_db) * K
    G = np.zeros((T + 1, K), dtype=np.float32)
    for t in range(T + 1):
        for p in range(K):
            j = t * K - p
            if 0 <= j < L:
                G[t, p] = h[j]
    return G


def pfb_mxu_matrices(h_poly: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Branch filter and channel DFT folded into one matrix:
    ``M[t*K + p, k] = G[t, p] * exp(-2j pi p k / K)``, so that
    ``Y[m] = X_win[m] @ M`` with ``X_win[m, t*K + p] = X[m - t, p]``.
    Returns (M_re, M_im) float32."""
    G = np.asarray(h_poly, dtype=np.float64)
    rows, K = G.shape
    p = np.arange(K)
    k = np.arange(K)
    dft = np.exp(-2j * np.pi * np.outer(p, k) / K)  # (p, k)
    M = (G[:, :, None] * dft[None, :, :]).reshape(rows * K, K)
    return M.real.astype(np.float32), M.imag.astype(np.float32)


def channel_frequencies(num_channels: int, fs: float) -> np.ndarray:
    """Centre frequency of each channel (k > K/2 wrap negative)."""
    k = np.arange(num_channels)
    k = np.where(k <= num_channels // 2, k, k - num_channels)
    return k * fs / num_channels


@dataclass(frozen=True)
class WbfmExactConfig:
    """Demodulation settings (ref ``DemodConfig``, simple_fm.rs:179-185)."""

    rate_in: int = 170_000
    rate_out: int = 170_000
    rate_resample: int = 32_000
    downsample: int = 6
    output_scale: int = 42


@dataclass(frozen=True)
class RadioConfig:
    """Capture settings (ref ``RadioConfig``, simple_fm.rs:172-176)."""

    capture_freq: int
    capture_rate: int


def optimal_settings(freq: int, rate: int, rate_resample: int = 32_000):
    """Capture + demod settings for a target frequency and rate (ref
    ``optimal_settings``, simple_fm.rs:189-214).  ``capture_freq`` is
    offset by fs/4, which the fs/4 rotation undoes."""
    downsample = (1_000_000 // rate) + 1
    capture_rate = downsample * rate
    capture_freq = freq + capture_rate // 4
    output_scale = max((1 << 15) // (128 * downsample), 1)
    radio = RadioConfig(capture_freq=capture_freq, capture_rate=capture_rate)
    demod = WbfmExactConfig(rate_in=rate, rate_out=rate,
                            rate_resample=rate_resample,
                            downsample=downsample, output_scale=output_scale)
    return radio, demod
