"""Stereo WBFM decoder in PyTorch — the counterpart of
``tpu_sdr/models/wbfm_stereo.py``.

The discriminator output of the float chain's front end is the FM
multiplex: (L+R)/2 at baseband, a 19 kHz pilot and (L-R)/2 as DSB-SC
around 38 kHz.  It is decoded as::

    y(t) ──LPF15k──────────────────────────► S = (L+R)/2 ─┐
      │                                                    ├─► L = S+D
      ├─BPF19k→ p ──square──BPF38k──/mean(p²)─► cos(2·θp)  ├─► R = S−D
      │                                   │                │
      └────────────── × ──────LPF15k── ×2 ┴──► D = (L−R)/2 ┘

then (optionally) de-emphasis per channel and the aligned polyphase
resampler to 32 kHz per channel.  The front is ``models.wbfm``'s at decim
3 (1.02 Msps -> 340 kHz: a 170 kHz channel truncates the multiplex's
Carson bandwidth and caps the separation near 26 dB).  Every filter is a
banded matmul in float32 (``ops.fm.fir_filter_mxu``); the carrier is
normalised per block by the pilot power ``mean(p²) = A²/2``, so outputs
depend on where blocks are cut, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tpu_sdr_torch.models import wbfm as M
from tpu_sdr_torch.ops import fm as F
from tpu_sdr_torch.utils import design, firdes, graphs
from tpu_sdr_torch.utils.design import WbfmConfig


@dataclass(frozen=True)
class StereoConfig:
    """Field for field the JAX ``StereoConfig``: a wideband front (decim
    3, 340 kHz), filter lengths scaled with that rate, per-channel
    de-emphasis (0 disables) and the multiplex tap (``emit_mpx``, which
    RDS consumes)."""

    base: WbfmConfig = None   # front-end config (defaults to FIR, decim 3)
    audio_taps: int = 257     # 15 kHz LPF at 340 kHz
    pilot_taps: int = 513     # 19 kHz +-1.5 kHz BPF
    sub_taps: int = 513       # 38 kHz +-3 kHz BPF
    deemphasis_tau: float = 0.0
    emit_mpx: bool = False

    def __post_init__(self):
        if self.base is None:
            object.__setattr__(self, "base", WbfmConfig(
                filter_mode="fir", decim=3, rate_out=340_000))


class StereoState(NamedTuple):
    """The eleven carries of the JAX ``StereoState``, field for field."""

    front: M.WbfmState
    lpf_s: F.FirState      # mono LPF history
    bpf_p: F.FirState      # pilot BPF history
    bpf_c: F.FirState      # 38k carrier BPF history (on p^2)
    lpf_d: F.FirState      # difference LPF history
    dly_y: F.DelayState    # multiplex delay matching the carrier path
    dly_s: F.DelayState    # mono-arm delay matching the difference arm
    de_l: F.DeemphState    # per-channel de-emphasis carries
    de_r: F.DeemphState
    rs_l: F.AlignedResampleState
    rs_r: F.AlignedResampleState


class StereoParams(nn.Module):
    """The decoder's weights as buffers: the front's (``front``, a
    ``WbfmParams``) and the banded 15 kHz LPF (``W_s``, ``W_d``), 19 kHz
    BPF (``W_p``) and 38 kHz BPF (``W_c``)."""

    def __init__(self, config: StereoConfig, device: torch.device):
        super().__init__()
        fs = config.base.rate_out
        lp = firdes.lowpass(config.audio_taps, 15_000.0, fs)
        bp_p = firdes.bandpass(config.pilot_taps, 19_000.0, 1_500.0, fs)
        bp_c = firdes.bandpass(config.sub_taps, 38_000.0, 3_000.0, fs)
        self.front = M.WbfmParams(config.base, device)
        for name, h in (("W_s", lp), ("W_p", bp_p), ("W_c", bp_c),
                        ("W_d", lp)):
            self.register_buffer(name, torch.from_numpy(
                design.make_banded_decim_matrix(h, 1)).to(device))


def make_params(config: StereoConfig, *, device: str | torch.device
                ) -> StereoParams:
    return StereoParams(config, torch.device(device))


def carrier_delay(config: StereoConfig) -> int:
    """Group delay of the pilot->carrier recovery path (samples):
    (pilot_taps-1)/2 + (sub_taps-1)/2, exact for the symmetric designs."""
    return (config.pilot_taps - 1) // 2 + (config.sub_taps - 1) // 2


def init_state(config: StereoConfig, device: str | torch.device
               ) -> StereoState:
    device = torch.device(device)
    T = config.base.resample_taps_per_phase
    d = carrier_delay(config)
    return StereoState(
        M.init_state(config.base, device),
        F.fir_init(config.audio_taps, device),
        F.fir_init(config.pilot_taps, device),
        F.fir_init(config.sub_taps, device),
        F.fir_init(config.audio_taps, device),
        F.delay_init(d, device), F.delay_init(d, device),
        F.deemph_init(device), F.deemph_init(device),
        F.aligned_resample_init(T, device), F.aligned_resample_init(T, device))


def demodulate_block(buf: torch.Tensor, state: StereoState,
                     params: StereoParams, config: StereoConfig):
    """u8 I/Q block (a multiple of ``2*decim*down`` bytes) -> ((2, m)
    audio [L, R], new state), or ((2, m) audio, multiplex, new state) with
    ``config.emit_mpx``."""
    cfg = config.base
    up, down = cfg.resample_up, cfg.resample_down
    quantum = 2 * cfg.decim * down
    if buf.shape[-1] == 0 or buf.shape[-1] % quantum:
        raise ValueError(f"block of {buf.shape[-1]} bytes is not a positive "
                         f"multiple of {quantum}")

    # the mono front end up to the discriminator output (the multiplex)
    re, im = F.u8_to_f32(buf)
    re, im, rot = F.rotate_fs4(re, im, state.front.rot)
    re, im, fir = F.fir_decimate_mxu(re, im, params.front.decim_W,
                                     cfg.num_taps, cfg.decim, state.front.fir)
    y, quad = F.quadrature_demod(re, im, state.front.quad)

    # the recovered carrier lags the multiplex by the pilot and carrier
    # filters' group delay; the product arm and the mono arm are delayed
    # to match, so both land on one time base
    p, bpf_p = F.fir_filter_mxu(y, params.W_p, state.bpf_p)          # pilot
    p2 = p * p
    c_raw, bpf_c = F.fir_filter_mxu(p2, params.W_c, state.bpf_c)     # A²/2·cos2θ
    pilot_pow = torch.clamp(p2.mean(), min=1e-12)                     # = A²/2
    c38 = c_raw / pilot_pow

    y_d, dly_y = F.delay(y, state.dly_y)
    d_raw, lpf_d = F.fir_filter_mxu(y_d * c38, params.W_d, state.lpf_d)
    d = 2.0 * d_raw                                                   # (L-R)/2

    s_raw, lpf_s = F.fir_filter_mxu(y, params.W_s, state.lpf_s)      # (L+R)/2
    s, dly_s = F.delay(s_raw, state.dly_s)

    left = s + d
    right = s - d
    de_l, de_r = state.de_l, state.de_r
    if config.deemphasis_tau > 0:
        alpha = F.deemph_alpha(cfg.rate_out, config.deemphasis_tau)
        left, de_l = F.deemphasis(left, alpha, de_l)
        right, de_r = F.deemphasis(right, alpha, de_r)

    audio_l, rs_l = F.aligned_resample(left, params.front.resamp_V, up, down,
                                       state.rs_l)
    audio_r, rs_r = F.aligned_resample(right, params.front.resamp_V, up, down,
                                       state.rs_r)
    front = M.WbfmState(rot, fir, quad, state.front.resamp,
                        state.front.box_resamp, state.front.deemph)
    new_state = StereoState(front, lpf_s, bpf_p, bpf_c, lpf_d, dly_y, dly_s,
                            de_l, de_r, rs_l, rs_r)
    audio = torch.stack([audio_l, audio_r])
    if config.emit_mpx:
        return audio, y, new_state
    return audio, new_state


class WbfmStereoStreamer:
    """Feed u8 blocks of any size, receive (2, m) float stereo audio.  Each
    call consumes a multiple of ``2*decim*down`` bytes; the residual leads
    the next call.  With ``config.emit_mpx`` each call also leaves the
    block's 340 kHz multiplex in ``last_mpx``.  The step runs through
    ``utils.graphs``, keyed on the block's length and the front's fs/4
    phase: one CUDA graph replay a call on the card."""

    def __init__(self, config: StereoConfig | None = None, *,
                 device: str | torch.device):
        self.config = config or StereoConfig()
        self.device = torch.device(device)
        self.params = make_params(self.config, device=self.device)
        self.state = init_state(self.config, self.device)
        base = self.config.base
        self._quantum = 2 * base.decim * base.resample_down
        self._pending = np.zeros(0, dtype=np.uint8)
        self.last_mpx: np.ndarray | None = None  # set when config.emit_mpx
        self.graphs = graphs.StepGraphs("WbfmStereoStreamer", self._step,
                                        self.device)

    def _step(self, ints, inputs, carries):
        state = graphs.join_state(self.state, ints, carries)
        *outputs, new = demodulate_block(inputs[0], state, self.params,
                                         self.config)
        new_ints, new_carries = graphs.split_state(new)
        return outputs, new_carries, new_ints

    def demodulate(self, buf: np.ndarray) -> np.ndarray:
        block, self._pending, _ = graphs.split_residual(
            self._pending, buf, self._quantum)
        if graphs.width(block) == 0:
            if self.config.emit_mpx:
                self.last_mpx = np.zeros(0, np.float32)
            return np.zeros((2, 0), np.float32)
        ints, carries = graphs.split_state(self.state)
        out, carries, ints = self.graphs(ints, [block], carries)
        self.state = graphs.join_state(self.state, ints, carries)
        if self.config.emit_mpx:
            self.last_mpx = out[1]
        return out[0]
