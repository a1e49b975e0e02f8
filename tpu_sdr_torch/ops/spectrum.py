"""Streaming power-spectral-density estimation (Welch) in PyTorch — the
counterpart of ``tpu_sdr/ops/spectrum.py`` and the data plane of
``rtl_power``.

u8 I/Q blocks -> centred float32 (``ops.fm.u8_to_f32``) -> Hann-windowed
segments -> complex64 FFT (``torch.fft.fft``) -> |X|² summed over segments
into fftshifted bins.  The accumulator stays on the device across blocks;
:func:`psd_db` (numpy float64, copied from the JAX package) reads it back
once, when the hop is finalised.  The segment count, moved only by block
sizes, is a host int.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_sdr_torch.ops.fm import u8_to_f32


class PsdState(NamedTuple):
    """Accumulated (power-sum, segment-count) across blocks."""

    acc: torch.Tensor  # (n_fft,) f32: summed |X|^2 per bin, fftshifted
    count: int         # segments accumulated


def psd_init(n_fft: int, device: str | torch.device) -> PsdState:
    return PsdState(torch.zeros(n_fft, dtype=torch.float32, device=device), 0)


def hann(n_fft: int) -> np.ndarray:
    # periodic Hann (matches scipy.signal.welch's default family)
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
            ).astype(np.float32)


def psd_accumulate(buf: torch.Tensor, state: PsdState, window: torch.Tensor,
                   n_fft: int) -> PsdState:
    """Accumulate one u8 I/Q block (at least ``2*n_fft`` bytes; a trailing
    remainder that does not fill a segment is dropped) into the state."""
    re, im = u8_to_f32(buf)
    n_seg = re.shape[-1] // n_fft
    if n_seg == 0:
        raise ValueError(f"block of {buf.shape[-1]} bytes holds no "
                         f"{n_fft}-point segment")
    x = torch.complex(re[:n_seg * n_fft], im[:n_seg * n_fft]).reshape(
        n_seg, n_fft)
    X = torch.fft.fft(x * window, dim=-1)
    p = torch.fft.fftshift(X.abs().square().sum(dim=0))
    return PsdState(state.acc + p, state.count + n_seg)


def psd_db(state: PsdState, window: np.ndarray) -> np.ndarray:
    """Finalize: averaged, window-compensated power bins in dB (relative
    full scale; bin order is ascending frequency, -fs/2 .. +fs/2).  The
    one read-back of the accumulator."""
    acc = state.acc
    if torch.is_tensor(acc):
        acc = acc.cpu().numpy()
    acc = np.asarray(acc, np.float64)
    count = max(float(state.count), 1.0)
    scale = count * float(np.sum(np.asarray(window, np.float64) ** 2))
    return (10.0 * np.log10(np.maximum(acc / scale, 1e-20))).astype(
        np.float64)


class PsdStreamer:
    """Feed u8 blocks, read dB bins once at the end."""

    def __init__(self, n_fft: int = 1024, *, device: str | torch.device):
        self.n_fft = n_fft
        self.device = torch.device(device)
        self.window_np = hann(n_fft)
        self.window = torch.from_numpy(self.window_np).to(self.device)
        self.state = psd_init(n_fft, self.device)
        self._pending = np.zeros(0, np.uint8)

    def accumulate(self, buf: np.ndarray) -> None:
        data = np.concatenate([self._pending,
                               np.asarray(buf, np.uint8).ravel()])
        quantum = 2 * self.n_fft
        usable = len(data) - (len(data) % quantum)
        self._pending = data[usable:]
        if usable:
            self.state = psd_accumulate(
                torch.from_numpy(data[:usable]).to(self.device), self.state,
                self.window, self.n_fft)

    @property
    def segments(self) -> float:
        return float(self.state.count)

    def finalize_db(self) -> np.ndarray:
        return psd_db(self.state, self.window_np)
