"""Reference-exact WBFM demodulator in plain PyTorch — the counterpart of
``tpu_sdr/models/wbfm_exact.py``, the conformance path::

    u8 I/Q -> fs/4 rotate -> signed complex -> boxcar decimate
           -> FM discriminator -> boxcar audio resample -> s16 audio

One block is a function of ``(block, state) -> (audio padded, count,
state)`` over the integer ops of :mod:`tpu_sdr_torch.ops.exact`; the
streamer trims.  The streamer runs the whole block as one step through
``utils.graphs`` (one CUDA graph replay a block on the card): where JAX
jits the four stages apart, for XLA-CPU's compile time, a graph has no
such cost.  ``WbfmExactConfig`` and ``optimal_settings`` live in
``utils.design``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_sdr_torch.ops import exact
from tpu_sdr_torch.utils import graphs
from tpu_sdr_torch.utils.design import WbfmExactConfig


class WbfmExactState(NamedTuple):
    """The whole streaming carry across blocks."""

    boxcar: exact.BoxcarState
    discr: exact.DiscriminatorState
    resamp: exact.ResamplerState


def init_state(device: str | torch.device) -> WbfmExactState:
    return WbfmExactState(exact.boxcar_init(device),
                          exact.discriminator_init(device),
                          exact.resampler_init(device))


def demodulate_block(buf: torch.Tensor, state: WbfmExactState,
                     config: WbfmExactConfig):
    """One block of the exact chain: ``(u8[n], state) -> (s16 audio padded,
    count, new_state)``; ``n`` must be a multiple of 8."""
    re, im = exact.u8_to_complex_i32(exact.rotate_90_u8(buf))
    lp_re, lp_im, lp_count, boxcar = exact.boxcar_decimate(
        re, im, state.boxcar, config.downsample)
    demod, demod_count, discr = exact.fm_discriminate(lp_re, lp_im, lp_count,
                                                      state.discr)
    audio, count, resamp = exact.boxcar_resample(
        demod, demod_count, state.resamp, config.rate_out,
        config.rate_resample)
    return audio, count, WbfmExactState(boxcar, discr, resamp)


class WbfmExactStreamer:
    """Feed u8 blocks (multiples of 8 bytes), receive trimmed s16 audio.

    The step is keyed on the block's length; its carries are the seven
    0-d int32 tensors of :class:`WbfmExactState`.  The padded audio and
    its count come to the host in one copy, and the host trims."""

    def __init__(self, config: WbfmExactConfig | None = None, *,
                 device: str | torch.device):
        self.config = config or WbfmExactConfig()
        self.device = torch.device(device)
        self.state = init_state(self.device)
        self.graphs = graphs.StepGraphs("WbfmExactStreamer", self._step,
                                        self.device)

    def _step(self, _static, inputs, carries):
        state = graphs.join_state(self.state, (), carries)
        audio, count, new = demodulate_block(inputs[0], state, self.config)
        return [audio, count], graphs.split_state(new)[1], None

    def demodulate(self, buf: np.ndarray) -> np.ndarray:
        block = np.asarray(buf, dtype=np.uint8).reshape(-1)
        (audio, count), carries, _ = self.graphs(
            (), [block], graphs.split_state(self.state)[1])
        self.state = graphs.join_state(self.state, (), carries)
        return audio[:int(count)]
