"""Wideband multi-station WBFM in PyTorch — the counterpart of
``tpu_sdr/models/wbfm_wideband.py``: one wideband capture -> K channels
(PFB channelizer) -> the WBFM tail (quadrature discriminator + 16/85
polyphase audio resampler) on every selected channel, as one batch over a
leading station axis.

Two fronts:

* plain — ``ops.channelizer.pfb_analyze`` in float32 on normalised samples
  (the JAX package's XLA front); block quantum ``2*K*down`` bytes;
* fused — K3 (``ops.fused_channelizer.channelize``) on the raw bytes with
  its own (2H, K) x255 carry; block quantum one chunk of ``8*down`` frames.

Geometry: capture rate ``K * 170 kHz`` makes each channel the reference's
170 kHz demodulator rate, so the standard 170k -> 32k resampler applies
unchanged.  The tail is plain PyTorch (it is XLA, not Pallas, in the JAX
package): exact ``atan2`` and f32 matmuls, never TF32 or ``conv1d``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tpu_sdr_torch.ops import channelizer as chan
from tpu_sdr_torch.ops import fm as F
from tpu_sdr_torch.ops import fused_channelizer as FC
from tpu_sdr_torch.utils import design, graphs, profiling

READ_SPAN = "WidebandStreamer.demodulate"  # the root span of a read
JOIN_SPAN = "WidebandStreamer.join"        # the residual's bookkeeping


@dataclass(frozen=True)
class WidebandConfig:
    """Field for field the JAX ``WidebandConfig``, with the same defaults."""

    num_channels: int = 64
    taps_per_branch: int = 8
    # WBFM fills nearly the whole critically sampled channel (Carson
    # bandwidth ~165 kHz of 170 kHz), so the prototype cuts off near the
    # channel edge.
    pfb_cutoff_frac: float = 0.95
    channels: tuple[int, ...] = (0,)          # selected station channels
    channel_rate: int = 170_000               # = capture_rate / K
    rate_resample: int = 32_000
    resample_taps_per_phase: int = 48
    resample_cutoff_frac: float = 0.8
    # Also return every station's multiplex (discriminator output), the
    # tap per-station RDS decoders consume.
    emit_mpx: bool = False

    @property
    def capture_rate(self) -> int:
        return self.num_channels * self.channel_rate

    @property
    def resample_up(self) -> int:
        g = math.gcd(self.channel_rate, self.rate_resample)
        return self.rate_resample // g

    @property
    def resample_down(self) -> int:
        g = math.gcd(self.channel_rate, self.rate_resample)
        return self.channel_rate // g


class WidebandState(NamedTuple):
    pfb: chan.PfbState                # the plain front's frame history
    quad: F.QuadState                 # (S,) previous samples
    resamp: F.AlignedResampleState    # (S, T-1) histories


class WidebandParams(nn.Module):
    """The receiver's weights as buffers: the PFB branch matrix, the plain
    front's M2 = [M_re | M_im], K3's tap table, the M2 of K3's plain
    version (split-bf16 pair summed, ÷255), the resampler frame matrix,
    and the selected channels."""

    def __init__(self, config: WidebandConfig, device: str | torch.device):
        super().__init__()
        h_poly = design.design_pfb(config.num_channels, config.taps_per_branch,
                                   cutoff_frac=config.pfb_cutoff_frac)
        V = design.make_aligned_poly_matrix(design.resampler_poly(config),
                                            config.resample_up,
                                            config.resample_down)
        self.register_buffer("h_poly", torch.from_numpy(h_poly).to(device))
        self.register_buffer("pfb_m2", chan.packed_matrix(h_poly, device=device))
        self.register_buffer("kernel_taps", FC.kernel_taps(h_poly).to(device))
        self.register_buffer("kernel_m2", FC.kernel_matrix(h_poly).to(device))
        self.register_buffer("resamp_V", torch.from_numpy(V).to(device))
        self.register_buffer("channels", torch.tensor(
            config.channels, dtype=torch.long, device=device))


def make_params(config: WidebandConfig, *, device: str | torch.device
                ) -> WidebandParams:
    return WidebandParams(config, torch.device(device))


def init_state(config: WidebandConfig, params: WidebandParams) -> WidebandState:
    n_st = len(config.channels)
    dev = params.h_poly.device
    Tm1 = config.resample_taps_per_phase - 1
    return WidebandState(
        chan.pfb_init(params.h_poly, dev),
        F.QuadState(torch.ones(n_st, device=dev), torch.zeros(n_st, device=dev)),
        F.AlignedResampleState(torch.zeros(n_st, Tm1, device=dev)))


def fused_spec(config: WidebandConfig) -> FC.PfbSpec:
    """K3's geometry on this path: chunks of ``8*down`` frames (a multiple
    of 8 and of the resampler's ``down``)."""
    spec = FC.PfbSpec(config.num_channels, config.taps_per_branch + 1,
                      8 * config.resample_down)
    spec.validate()
    return spec


def _tail(y_re: torch.Tensor, y_im: torch.Tensor, quad: F.QuadState,
          resamp_hist: torch.Tensor, params: WidebandParams,
          config: WidebandConfig):
    """Gather the selected channels of (m, K) frames to (S, m) stations on
    the device, then discriminator + resampler batched over stations.
    Returns (audio (S, m/down*up), mpx (S, m), quad, resampler state)."""
    zr = y_re.index_select(1, params.channels).T
    zi = y_im.index_select(1, params.channels).T
    mpx, quad = F.quadrature_demod(zr, zi, quad)
    audio, rs = F.aligned_resample(mpx, params.resamp_V, config.resample_up,
                                   config.resample_down,
                                   F.AlignedResampleState(resamp_hist))
    return audio, mpx, quad, rs


def demodulate_block(buf: torch.Tensor, state: WidebandState,
                     params: WidebandParams, config: WidebandConfig):
    """Plain front: one wideband u8 block (a multiple of ``2*K*down``
    bytes) -> (audio (S, m), [mpx (S, m'),] new state)."""
    quantum = 2 * config.num_channels * config.resample_down
    if buf.numel() % quantum:
        raise ValueError(f"block of {buf.numel()} bytes is not a multiple of "
                         f"{quantum}")
    re, im = F.u8_to_f32(buf)
    y_re, y_im, pfb = chan.pfb_analyze(re, im, params.pfb_m2, state.pfb)
    audio, mpx, quad, rs = _tail(y_re, y_im, state.quad, state.resamp.hist,
                                 params, config)
    new_state = WidebandState(pfb, quad, rs)
    if config.emit_mpx:
        return audio, mpx, new_state
    return audio, new_state


def demodulate_block_fused(data_u8: torch.Tensor, pfb_carry: torch.Tensor,
                           quad: F.QuadState, resamp_hist: torch.Tensor,
                           params: WidebandParams, config: WidebandConfig,
                           spec: FC.PfbSpec):
    """K3 front: whole chunks of u8 bytes with K3's (2H, K) carry ->
    (audio, [mpx,] new carry, quad, resampler history), as the JAX
    ``demodulate_block_pallas`` returns them."""
    if data_u8.numel() % spec.chunk_bytes:
        raise ValueError(f"block of {data_u8.numel()} bytes is not whole "
                         f"chunks of {spec.chunk_bytes}")
    y_re, y_im, new_carry = FC.channelize(data_u8, pfb_carry,
                                          params.kernel_taps, spec)
    audio, mpx, quad, rs = _tail(y_re, y_im, quad, resamp_hist, params, config)
    out_state = (new_carry, quad, rs.hist)
    if config.emit_mpx:
        return (audio, mpx) + out_state
    return (audio,) + out_state


class WidebandStreamer:
    """Feed wideband u8 blocks of any size, get (stations, m) audio.

    ``use_fused=True`` runs K3 as the channelizer (on a CUDA device; the
    plain version of K3 on the CPU).  The fused front keeps its carry in
    ``pfb_carry`` and leaves ``state.pfb`` as it was, as the JAX streamer
    does.  Either front's step (the channelizer and the tail) runs through
    ``utils.graphs``, keyed on the block's length: one CUDA graph replay a
    call on the card."""

    def __init__(self, config: WidebandConfig | None = None,
                 use_fused: bool = False, *, device: str | torch.device):
        self.config = config or WidebandConfig()
        self.device = torch.device(device)
        self.params = make_params(self.config, device=self.device)
        self.state = init_state(self.config, self.params)
        self.use_fused = use_fused
        self._pending = np.zeros(0, dtype=np.uint8)
        self._quantum = 2 * self.config.num_channels * self.config.resample_down
        self.last_mpx: np.ndarray | None = None  # set when config.emit_mpx
        if use_fused:
            self.spec = fused_spec(self.config)
            self._quantum = self.spec.chunk_bytes
            self.pfb_carry = FC.init_carry(self.spec, self.device)
        self.graphs = graphs.StepGraphs("WidebandStreamer", self._step,
                                        self.device)

    def _step(self, _static, inputs, carries):
        """The graphed step.  Carries: the fused front's K3 carry, or the
        plain front's two frame histories, then the tail's previous
        samples and resampler histories."""
        block = inputs[0]
        if self.use_fused:
            pfb_carry, pre_re, pre_im, hist = carries
            audio, *mpx, pfb_carry, quad, hist = demodulate_block_fused(
                block, pfb_carry, F.QuadState(pre_re, pre_im), hist,
                self.params, self.config, self.spec)
            return [audio, *mpx], [pfb_carry, *quad, hist], None
        state = WidebandState(chan.PfbState(*carries[:2]),
                              F.QuadState(*carries[2:4]),
                              F.AlignedResampleState(carries[4]))
        audio, *mpx, state = demodulate_block(block, state, self.params,
                                              self.config)
        return [audio, *mpx], [*state.pfb, *state.quad, state.resamp.hist], \
            None

    def demodulate(self, buf: np.ndarray) -> np.ndarray:
        """The residual and the read's whole quanta go to the step as two
        pieces, written straight into its staging buffer; the read's tail
        under one quantum is kept as the next residual.  ``buf`` may be
        read-only, and is the caller's again when this returns."""
        t0 = profiling.clock()
        block, self._pending, copied = graphs.split_residual(
            self._pending, np.asarray(buf, np.uint8), self._quantum)
        profiling.span(JOIN_SPAN, t0, profiling.clock(), copied)
        audio = self._demodulate(block)
        profiling.read_span(READ_SPAN, t0, profiling.clock(), self.last_mpx)
        return audio

    def _demodulate(self, block: tuple) -> np.ndarray:
        n_st = len(self.config.channels)
        if not block:
            if self.config.emit_mpx:
                self.last_mpx = np.zeros((n_st, 0), np.float32)
            return np.zeros((n_st, 0), np.float32)
        tail = [*self.state.quad, self.state.resamp.hist]
        front = [self.pfb_carry] if self.use_fused else list(self.state.pfb)
        (audio, *mpx), carries, _ = self.graphs((), [block], front + tail)
        pfb = self.state.pfb
        if self.use_fused:
            self.pfb_carry = carries[0]
        else:
            pfb = chan.PfbState(*carries[:2])
        self.state = WidebandState(pfb, F.QuadState(*carries[-3:-1]),
                                   F.AlignedResampleState(carries[-1]))
        if mpx:
            self.last_mpx = mpx[0]
        return audio
