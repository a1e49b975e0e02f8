"""Multi-mode narrowband receiver in PyTorch: AM / NBFM / USB / LSB — the
counterpart of ``tpu_sdr/models/multimode.py`` (the original C
``rtl_fm``'s ``-M`` modes, which the reference dropped).

All modes share the front end (u8 -> fs/4 rotation -> banded FIR
decimation to the 170 kHz channel rate):

* **AM**: the envelope ``sqrt(I² + Q²)`` after the channel filter, less
  its block mean (rtl_fm's carry-free DC removal);
* **NBFM**: the quadrature discriminator at the channel rate, with
  optional de-emphasis at the audio rate;
* **USB/LSB**: a complex shift by -+half the audio bandwidth (plus the
  fine-tune offset), the aligned resampler to 32 kHz, a sharp lowpass
  there, the shift back, and the real part.

Squelch mutes a block whose mean channel power is below a dBFS
threshold; that power is returned for the host's scan decisions.  All
arithmetic is float32; the JAX front runs split-bf16 weights, which
``convert.multimode_params_from_jax`` carries over as their effective f32
sum.  The SSB mixer phases are built in float32 exactly as in JAX: the
phase reaches ~1e4 rad, where another order of operations moves it by
~1e-3 rad.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tpu_sdr_torch.ops import fm as F
from tpu_sdr_torch.utils import design, firdes, graphs


@dataclass(frozen=True)
class MultimodeConfig:
    """Field for field the JAX ``MultimodeConfig``."""

    mode: str = "am"              # am | nbfm | usb | lsb
    capture_rate: int = 1_020_000
    decim: int = 6                # -> 170 kHz channel rate
    rate_out: int = 170_000
    rate_resample: int = 32_000
    fir_taps_per_phase: int = 12
    channel_bw: float = 12_500.0  # Hz (AM/NBFM); SSB uses audio_bw
    audio_bw: float = 3_000.0     # Hz (SSB)
    channel_taps: int = 129
    resample_taps_per_phase: int = 48
    squelch_db: float | None = None   # dBFS; None = always open
    fine_tune_hz: float = 0.0         # SSB software fine tuning
    deemphasis_tau: float = 0.0       # NBFM de-emphasis (s); 0 disables

    @property
    def resample_up(self) -> int:
        return self.rate_resample // math.gcd(self.rate_out, self.rate_resample)

    @property
    def resample_down(self) -> int:
        return self.rate_out // math.gcd(self.rate_out, self.rate_resample)


class MultimodeState(NamedTuple):
    """The nine carries of the JAX ``MultimodeState``; the fs/4 phase and
    the two SSB phase indices (moved only by block sizes) are ints."""

    rot: int
    fir: F.FirState        # front decimator
    chan: F.FirState       # channel/sideband filter (complex pair)
    quad: F.QuadState      # NBFM discriminator
    resamp: F.AlignedResampleState     # audio (or SSB I) resampler
    resamp_q: F.AlignedResampleState   # SSB Q resampler
    ssb_phase: int         # shift phase index at rate_out
    ssb_phase2: int        # shift-back phase index at rate_resample
    deemph: F.DeemphState


class MultimodeParams(nn.Module):
    """The front's banded decimator (``decim_W``, float32), the banded
    channel or sideband filter (``chan_W``) and the resampler's frame
    matrix (``resamp_V``), as buffers."""

    def __init__(self, config: MultimodeConfig, device: torch.device):
        super().__init__()
        taps = firdes.decimating_lowpass(
            config.decim, taps_per_phase=config.fir_taps_per_phase,
            cutoff_frac=0.9)
        if config.mode in ("usb", "lsb"):
            # sideband select at the audio rate, where the taps are sharp
            ch = firdes.lowpass(config.channel_taps, config.audio_bw / 2,
                                config.rate_resample)
        else:
            ch = firdes.lowpass(config.channel_taps, config.channel_bw,
                                config.rate_out)
        h = firdes.resampler_taps(config.resample_up, config.resample_down,
                                  taps_per_phase=config.resample_taps_per_phase)
        V = design.make_aligned_poly_matrix(
            design.make_polyphase(h, config.resample_up), config.resample_up,
            config.resample_down)
        for name, w in (
                ("decim_W", design.make_banded_decim_matrix(taps, config.decim)),
                ("chan_W", design.make_banded_decim_matrix(ch, 1)),
                ("resamp_V", V)):
            self.register_buffer(name, torch.from_numpy(w).to(device))


def make_params(config: MultimodeConfig, *, device: str | torch.device
                ) -> MultimodeParams:
    return MultimodeParams(config, torch.device(device))


def init_state(config: MultimodeConfig, device: str | torch.device
               ) -> MultimodeState:
    device = torch.device(device)
    T = config.resample_taps_per_phase
    return MultimodeState(
        0, F.fir_init(config.decim * config.fir_taps_per_phase, device),
        F.fir_init(config.channel_taps, device), F.quad_init(device),
        F.aligned_resample_init(T, device), F.aligned_resample_init(T, device),
        0, 0, F.deemph_init(device))


def _mixer(phase, n: int, coef: float, device):
    """cos and sin of ``coef * (phase + k)``, k < n, in float32 as the JAX
    model builds them: the index in float32, the coefficient rounded to
    float32, one float32 product.  ``phase``: an int, or a 0-d float32
    tensor holding it (exact below 2**24: the same bits)."""
    k = phase + torch.arange(n, dtype=torch.float32, device=device)
    ph = k * float(np.float32(coef))
    return torch.cos(ph), torch.sin(ph)


def demodulate_block(buf: torch.Tensor, state: MultimodeState,
                     params: MultimodeParams, config: MultimodeConfig,
                     ssb_index: torch.Tensor | None = None):
    """u8 I/Q block (a multiple of ``2*decim*down`` bytes) -> (audio,
    channel power (a 0-d tensor), new state).  ``ssb_index``: the state's
    two SSB phase indices as a (2,) float32 tensor on the device, which the
    mixers then read in their place (the graphed streamer's input: the
    indices move every block, so they cannot be part of its key); the new
    state's indices are still the state's ints moved on."""
    up, down = config.resample_up, config.resample_down
    quantum = 2 * config.decim * down
    if buf.shape[-1] == 0 or buf.shape[-1] % quantum:
        raise ValueError(f"block of {buf.shape[-1]} bytes is not a positive "
                         f"multiple of {quantum}")
    if config.mode not in ("am", "nbfm", "usb", "lsb"):
        raise ValueError(f"unknown mode {config.mode}")
    L = config.decim * config.fir_taps_per_phase

    re, im = F.u8_to_f32(buf)
    re, im, rot = F.rotate_fs4(re, im, state.rot)
    re, im, fir = F.fir_decimate_mxu(re, im, params.decim_W, L, config.decim,
                                     state.fir)
    dev = re.device
    n = re.shape[-1]
    if config.mode in ("usb", "lsb"):
        # shift the wanted sideband to centre (USB [0, bw] -> [-bw/2,
        # bw/2]; LSB mirrored), select it at the audio rate, shift back,
        # take the real part; both shifts carry integer phase indices, and
        # the fine tune (whole Hz, so the wrapped index stays continuous)
        # rides the first mixer only
        shift = (-config.audio_bw / 2 if config.mode == "usb"
                 else config.audio_bw / 2)
        shift1 = shift - round(config.fine_tune_hz)
        c, s = _mixer(state.ssb_phase if ssb_index is None else
                      ssb_index[0], n,
                      2 * np.pi * (shift1 / config.rate_out), dev)
        sr = re * c - im * s
        si = re * s + im * c
        ssb_phase = (state.ssb_phase + n) % config.rate_out

        sr32, rs = F.aligned_resample(sr, params.resamp_V, up, down,
                                      state.resamp)
        si32, rs_q = F.aligned_resample(si, params.resamp_V, up, down,
                                        state.resamp_q)
        sr32, si32, chan = F.fir_decimate_mxu(
            sr32, si32, params.chan_W, config.channel_taps, 1, state.chan)
        m = sr32.shape[-1]
        c2, s2 = _mixer(state.ssb_phase2 if ssb_index is None else
                        ssb_index[1], m,
                        2 * np.pi * (shift / config.rate_resample), dev)
        audio = sr32 * c2 + si32 * s2
        ssb_phase2 = (state.ssb_phase2 + m) % config.rate_resample
        power = _channel_power(sr32, si32)
        return _squelch(audio, power, config), power, MultimodeState(
            rot, fir, chan, state.quad, rs, rs_q, ssb_phase, ssb_phase2,
            state.deemph)

    re, im, chan = F.fir_decimate_mxu(re, im, params.chan_W,
                                      config.channel_taps, 1, state.chan)
    quad = state.quad
    if config.mode == "am":
        env = torch.sqrt(re * re + im * im)
        audio_ch = env - env.mean()  # DC removal, rtl_fm-style
    else:
        audio_ch, quad = F.quadrature_demod(re, im, quad)
    audio, rs = F.aligned_resample(audio_ch, params.resamp_V, up, down,
                                   state.resamp)
    deemph = state.deemph
    if config.mode == "nbfm" and config.deemphasis_tau > 0:
        alpha = F.deemph_alpha(config.rate_resample, config.deemphasis_tau)
        audio, deemph = F.deemphasis(audio, alpha, deemph)
    power = _channel_power(re, im)
    return _squelch(audio, power, config), power, MultimodeState(
        rot, fir, chan, quad, rs, state.resamp_q, state.ssb_phase,
        state.ssb_phase2, deemph)


def _channel_power(ch_re, ch_im):
    """Mean filtered-channel power (linear, full scale 1.0): the squelch
    measurement, also returned to the host for scan-mode hop decisions."""
    return (ch_re * ch_re + ch_im * ch_im).mean()


def _squelch(audio, power, config: MultimodeConfig):
    """Mute the block when the filtered channel's mean power is below the
    configured dBFS threshold (no-op when squelch is off)."""
    if config.squelch_db is None:
        return audio
    threshold = float(np.float32(10.0 ** (config.squelch_db / 10.0)))
    return torch.where(power > threshold, audio, torch.zeros_like(audio))


class MultimodeStreamer:
    """Feed u8 blocks of any size, receive float audio (the narrowband
    twin of ``WbfmStreamer``).  Each call that consumes at least one
    quantum takes one measurement: ``last_power``, ``last_squelch_open``
    and ``n_measurements`` (a call below one quantum leaves them stale),
    which the scan loop reads.

    The step runs through ``utils.graphs``: one CUDA graph replay a call
    on the card, keyed on the block's length and the fs/4 phase.  The SSB
    modes' mixer indices move every block, so they go in as a device
    input beside the block, and the host moves the state's ints on."""

    def __init__(self, config: MultimodeConfig | None = None, *,
                 device: str | torch.device):
        self.config = config or MultimodeConfig()
        self.device = torch.device(device)
        self.params = make_params(self.config, device=self.device)
        self.state = init_state(self.config, self.device)
        self._quantum = 2 * self.config.decim * self.config.resample_down
        self._pending = np.zeros(0, dtype=np.uint8)
        self.last_power: float | None = None
        self.last_squelch_open: bool = True
        self.n_measurements: int = 0
        self.graphs = graphs.StepGraphs("MultimodeStreamer", self._step,
                                        self.device)

    def _step(self, ints, inputs, carries):
        state = graphs.join_state(self.state, ints, carries)
        audio, power, new = demodulate_block(
            inputs[0], state, self.params, self.config,
            inputs[1] if len(inputs) > 1 else None)
        new_ints, new_carries = graphs.split_state(new)
        return [audio, power], new_carries, new_ints

    def demodulate(self, buf: np.ndarray) -> np.ndarray:
        block, self._pending, _ = graphs.split_residual(
            self._pending, buf, self._quantum)
        if graphs.width(block) == 0:
            return np.zeros(0, np.float32)
        state = self.state
        inputs = [block]
        if self.config.mode in ("usb", "lsb"):
            # the key sees indices 0; the step's ints are then the moves
            inputs.append(np.array([state.ssb_phase, state.ssb_phase2],
                                   np.float32))
            state = state._replace(ssb_phase=0, ssb_phase2=0)
        ints, carries = graphs.split_state(state)
        (audio, power), carries, ints = self.graphs(ints, inputs, carries)
        new = graphs.join_state(state, ints, carries)
        if self.config.mode in ("usb", "lsb"):
            new = new._replace(
                ssb_phase=(self.state.ssb_phase + new.ssb_phase)
                % self.config.rate_out,
                ssb_phase2=(self.state.ssb_phase2 + new.ssb_phase2)
                % self.config.rate_resample)
        self.state = new
        self.last_power = float(power)
        self.last_squelch_open = (
            self.config.squelch_db is None
            or self.last_power > 10.0 ** (self.config.squelch_db / 10.0))
        self.n_measurements += 1
        return audio

    def reset(self) -> None:
        """Drop all streaming carries (a scan-mode retune: samples before
        and after a hop are not continuous)."""
        self.state = init_state(self.config, self.device)
        self._pending = np.zeros(0, dtype=np.uint8)
        self.last_power = None
        self.last_squelch_open = True
        self.n_measurements = 0
