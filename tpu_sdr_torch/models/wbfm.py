"""WBFM float chain in plain PyTorch — the counterpart of
``tpu_sdr/models/wbfm.py``, every mode:

    u8 I/Q -> f32 -> fs/4 rotate -> decimate ÷6 -> quadrature discriminator
           -> (de-emphasis) -> 16/85 resampler -> audio

``filter_mode="fir"``: the 72-tap FIR (banded matmul), the exact atan2 and
the 48-tap polyphase resampler; ``"boxcar"``: the float twins of the
reference's boxcar filters and fast atan, which track the exact integer
chain to >= 60 dB.  A block of whole resampler frames (``len %
(2*decim*down) == 0``) runs the frame matmul (polyphase or boxcar window,
the aligned path); any other multiple of ``2*decim`` bytes the unaligned
resamplers, whose carries are not interchangeable with the aligned path's.
``deemphasis_tau`` adds the single-pole de-emphasis, ``emit_mpx`` returns
the 170 kHz multiplex (the discriminator output before de-emphasis).

All arithmetic is float32 (``mxu_precision`` is accepted and ignored).  It
is the port's oracle for the fused kernels and what ``simple_fm --mode
fir|boxcar`` runs.  Every function takes an optional leading station axis
(``models.wbfm_batched``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tpu_sdr_torch.ops import fm as F
from tpu_sdr_torch.utils import design, graphs
from tpu_sdr_torch.utils.design import WbfmConfig


class WbfmState(NamedTuple):
    """The six carries of the JAX ``WbfmState``."""

    rot: int  # fs/4 phase of the next block's first sample
    fir: F.FirState
    quad: F.QuadState
    resamp: F.ResampleState
    box_resamp: F.BoxcarResampleState
    deemph: F.DeemphState


class WbfmParams(nn.Module):
    """The chain's filter banks as buffers: the decimator's banded matrix,
    the resampler's polyphase bank and frame matrix, and the boxcar frame
    matrix."""

    def __init__(self, config: WbfmConfig, device: torch.device):
        super().__init__()
        h_poly = design.resampler_poly(config)
        W = design.make_banded_decim_matrix(design.decimator_taps(config),
                                            config.decim)
        V = design.make_aligned_poly_matrix(h_poly, config.resample_up,
                                            config.resample_down)
        box_V, _, _ = design.make_aligned_boxcar_matrix(config.rate_out,
                                                        config.rate_resample)
        for name, x in (("decim_W", W), ("resamp_poly", h_poly),
                        ("resamp_V", V), ("box_V", box_V)):
            self.register_buffer(name, torch.from_numpy(x).to(device))


def init_state(config: WbfmConfig, device: torch.device) -> WbfmState:
    T = config.resample_taps_per_phase
    return WbfmState(0, F.fir_init(config.num_taps, device),
                     F.quad_init(device), F.resample_init(T, device),
                     F.boxcar_resample_init(device), F.deemph_init(device))


def demodulate_block(buf: torch.Tensor, state: WbfmState, params: WbfmParams,
                     config: WbfmConfig, index: torch.Tensor | None = None):
    """One u8 I/Q block (its byte length a positive multiple of
    ``2*decim``; a leading station axis with a stacked state runs a batch)
    -> (audio f32, new_state), or (audio, mpx, new_state) with
    ``config.emit_mpx``.  ``index``: the state's ``(resamp.t0,
    box_resamp.acc)`` as a (2,) int64 tensor on the device, which the
    unaligned resamplers' index arithmetic then reads (the graphed
    streamers' input: those ints move every unaligned block)."""
    nbytes = buf.shape[-1]
    if nbytes == 0 or nbytes % (2 * config.decim):
        raise ValueError(f"block of {nbytes} bytes is not a positive "
                         f"multiple of {2 * config.decim}")
    boxcar = config.filter_mode == "boxcar"
    if not boxcar and config.filter_mode != "fir":
        raise ValueError(f"filter_mode {config.filter_mode!r} is not fir or "
                         "boxcar")
    re, im = F.u8_to_f32(buf)
    re, im, rot = F.rotate_fs4(re, im, state.rot)
    if boxcar:
        re, im = F.boxcar_decimate_f32(re, im, config.decim)
        fir = state.fir
        y, quad = F.quadrature_demod(re, im, state.quad, atan_mode="fast")
    else:
        re, im, fir = F.fir_decimate_mxu(re, im, params.decim_W,
                                         config.num_taps, config.decim,
                                         state.fir)
        y, quad = F.quadrature_demod(re, im, state.quad)
    mpx = y  # before de-emphasis: the subcarriers must not be rolled off
    deemph = state.deemph
    if config.deemphasis_tau > 0:
        y, deemph = F.deemphasis(
            y, F.deemph_alpha(config.rate_out, config.deemphasis_tau), deemph)

    up, down = config.resample_up, config.resample_down
    aligned = y.shape[-1] % down == 0
    resamp, box_resamp = state.resamp, state.box_resamp
    if boxcar and aligned:
        # every frame's emissions lie in the frame: no history
        audio, _ = F.aligned_resample(y, params.box_V, up, down,
                                      F.AlignedResampleState(
                                          y.new_zeros(*y.shape[:-1], 0)))
    elif boxcar:
        audio, box_resamp = F.boxcar_resample_f32(
            y, box_resamp, config.rate_out, config.rate_resample,
            None if index is None else index[1])
    elif aligned:
        audio, rs = F.aligned_resample(y, params.resamp_V, up, down,
                                       F.AlignedResampleState(resamp.hist))
        resamp = F.ResampleState(rs.hist, resamp.t0)
    else:
        audio, resamp = F.polyphase_resample(y, params.resamp_poly, up, down,
                                             resamp,
                                             None if index is None else index[0])
    new_state = WbfmState(rot, fir, quad, resamp, box_resamp, deemph)
    if config.emit_mpx:
        return audio, mpx, new_state
    return audio, new_state


class WbfmStreamer:
    """Feed u8 blocks of any size, receive float audio.  Each block is cut
    to a multiple of ``2*decim*resample_down`` bytes so every call stays on
    the aligned resampler path; the residual bytes lead the next call.
    With ``config.emit_mpx`` each call also leaves the block's multiplex
    in ``last_mpx``.

    The step runs through ``utils.graphs``: one CUDA graph replay a call
    on the card, keyed on the block's length, the fs/4 phase and the
    unaligned resamplers' output counts.  Their indices (``t0``, the
    boxcar accumulator) move with every unaligned block, so they go in as
    a device input, not into the key; each moves by an amount the key
    fixes, which the host adds."""

    _demodulate = staticmethod(demodulate_block)

    def __init__(self, config: WbfmConfig | None = None, *,
                 device: str | torch.device):
        self.config = config or WbfmConfig()
        self.device = torch.device(device)
        self.params = WbfmParams(self.config, self.device)
        self.state = init_state(self.config, self.device)
        self._quantum = 2 * self.config.decim * self.config.resample_down
        self._pending = np.zeros(0, dtype=np.uint8)
        self.last_mpx: np.ndarray | None = None  # set when config.emit_mpx
        self.graphs = graphs.StepGraphs(type(self).__name__, self._step,
                                        self.device)

    def _step(self, _key, inputs, carries):
        """The graphed step: ``demodulate_block`` on the state rebuilt from
        the calling block's ints and the carries; its aux is the ints
        before and after."""
        ints = graphs.split_state(self.state)[0]
        state = graphs.join_state(self.state, ints, carries)
        *outputs, new = self._demodulate(
            inputs[0], state, self.params, self.config,
            inputs[1] if len(inputs) > 1 else None)
        new_ints, new_carries = graphs.split_state(new)
        return outputs, new_carries, (ints, new_ints)

    def _run(self, block) -> list[np.ndarray]:
        st, cfg = self.state, self.config
        n = graphs.width(block) // (2 * cfg.decim)
        inputs = [block]
        count = None
        if n % cfg.resample_down:  # the unaligned resamplers
            inputs.append(np.array([st.resamp.t0, st.box_resamp.acc],
                                   np.int64))
            count = (F.boxcar_count(n, st.box_resamp.acc, cfg.rate_out,
                                    cfg.rate_resample)
                     if cfg.filter_mode == "boxcar" else
                     F.polyphase_count(n, cfg.resample_up, cfg.resample_down,
                                       st.resamp.t0))
        ints, carries = graphs.split_state(st)
        outputs, carries, (before, after) = self.graphs(
            (st.rot, count), inputs, carries)
        ints = tuple(i + b - a for i, a, b in zip(ints, before, after))
        self.state = graphs.join_state(st, ints, carries)
        return outputs

    def demodulate(self, buf: np.ndarray) -> np.ndarray:
        block, self._pending, _ = graphs.split_residual(
            self._pending, buf, self._quantum)
        if graphs.width(block) == 0:
            empty = np.zeros(self._pending.shape[:-1] + (0,), np.float32)
            return self._outputs([empty, empty])
        return self._outputs(self._run(block))

    def _outputs(self, out: list[np.ndarray]) -> np.ndarray:
        """A call's audio; with ``config.emit_mpx`` its multiplex goes to
        ``last_mpx``."""
        if self.config.emit_mpx:
            self.last_mpx = out[1]
        return out[0]
