"""WBFM float chain in plain PyTorch — the counterpart of
``tpu_sdr/models/wbfm.py`` in its ``fir`` mode on the aligned resampler
path:

    u8 I/Q -> f32 -> fs/4 rotate -> 72-tap FIR, ÷6 (banded matmul)
           -> quadrature discriminator (exact atan2)
           -> 16/85 frame-matmul polyphase resampler -> audio

All arithmetic is float32.  It is the port's oracle for the fused kernels
and what ``simple_fm --mode fir`` runs.  The boxcar mode, de-emphasis and
the multiplex tap are not ported yet and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tpu_sdr_torch.ops import fm as F
from tpu_sdr_torch.utils import design
from tpu_sdr_torch.utils.design import WbfmConfig


class WbfmState(NamedTuple):
    rot: int  # fs/4 phase of the next block's first sample
    fir: F.FirState
    quad: F.QuadState
    resamp: F.AlignedResampleState


class WbfmParams(nn.Module):
    """The chain's filter banks as buffers: the decimator's banded matrix
    and the resampler's frame matrix."""

    def __init__(self, config: WbfmConfig, device: torch.device):
        super().__init__()
        W = design.make_banded_decim_matrix(design.decimator_taps(config),
                                            config.decim)
        V = design.make_aligned_poly_matrix(design.resampler_poly(config),
                                            config.resample_up,
                                            config.resample_down)
        self.register_buffer("decim_W", torch.from_numpy(W).to(device))
        self.register_buffer("resamp_V", torch.from_numpy(V).to(device))


def init_state(config: WbfmConfig, device: torch.device) -> WbfmState:
    T = config.resample_taps_per_phase
    return WbfmState(0, F.fir_init(config.num_taps, device),
                     F.quad_init(device), F.aligned_resample_init(T, device))


def _check_ported(config: WbfmConfig) -> None:
    if config.filter_mode != "fir":
        raise NotImplementedError(
            f"filter_mode={config.filter_mode!r} is not ported yet (fir only)")
    if config.deemphasis_tau > 0 or config.emit_mpx:
        raise NotImplementedError(
            "de-emphasis and the multiplex tap are not ported yet")


def demodulate_block(buf: torch.Tensor, state: WbfmState, params: WbfmParams,
                     config: WbfmConfig) -> tuple[torch.Tensor, WbfmState]:
    """One u8 I/Q block -> (audio f32, new_state).  The byte length must be
    a multiple of ``2*decim*resample_down`` (the aligned resampler path)."""
    _check_ported(config)
    quantum = 2 * config.decim * config.resample_down
    if buf.numel() % quantum:
        raise ValueError(f"block of {buf.numel()} bytes is not a multiple of "
                         f"{quantum} (the aligned-resampler quantum)")
    re, im = F.u8_to_f32(buf)
    re, im, rot = F.rotate_fs4(re, im, state.rot)
    re, im, fir = F.fir_decimate_mxu(re, im, params.decim_W, config.num_taps,
                                     config.decim, state.fir)
    y, quad = F.quadrature_demod(re, im, state.quad)
    audio, resamp = F.aligned_resample(
        y, params.resamp_V, config.resample_up, config.resample_down,
        state.resamp)
    return audio, WbfmState(rot, fir, quad, resamp)


class WbfmStreamer:
    """Feed u8 blocks of any size, receive float audio.  Each block is cut
    to a multiple of ``2*decim*resample_down`` bytes so every call stays on
    the aligned resampler path; the residual bytes lead the next call."""

    def __init__(self, config: WbfmConfig | None = None, *,
                 device: str | torch.device):
        self.config = config or WbfmConfig()
        _check_ported(self.config)
        self.device = torch.device(device)
        self.params = WbfmParams(self.config, self.device)
        self.state = init_state(self.config, self.device)
        self._pending = np.zeros(0, dtype=np.uint8)

    def demodulate(self, buf: np.ndarray) -> np.ndarray:
        data = np.concatenate([self._pending, np.asarray(buf, dtype=np.uint8)])
        quantum = 2 * self.config.decim * self.config.resample_down
        usable = len(data) - (len(data) % quantum)
        self._pending = data[usable:]
        if usable == 0:
            return np.zeros(0, dtype=np.float32)
        block = torch.from_numpy(data[:usable]).to(self.device)
        audio, self.state = demodulate_block(block, self.state, self.params,
                                             self.config)
        return audio.cpu().numpy()
