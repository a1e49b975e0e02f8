"""Batched multi-station WBFM: N receivers demodulated in one pass — the
counterpart of ``tpu_sdr/models/wbfm_batched.py``.

Where JAX vmaps the float chain, the port writes the station axis out:
every op of ``ops.fm`` runs along the last axis with the stations as a
leading one, so ``models.wbfm.demodulate_block`` on (stations, bytes) u8
and a stacked state IS the batch.  The filter banks are shared; the
stations share the block geometry, hence the fs/4 phase, the resampler's
``t0`` and the boxcar accumulator (ints, as in the one-station state) and
the output count.  The fused kernels' batch is
``ops.fused_fm.FusedWbfmBatchStreamer``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.models import wbfm
from tpu_sdr_torch.utils.design import WbfmConfig


def demodulate_batch(bufs: torch.Tensor, states: wbfm.WbfmState,
                     params: wbfm.WbfmParams, config: WbfmConfig,
                     index: torch.Tensor | None = None):
    """(stations, bytes) u8 + stacked states -> (audio (stations, m),
    stacked states), or (audio, mpx, states) with ``config.emit_mpx``
    (``index`` as in ``wbfm.demodulate_block``)."""
    if bufs.dim() != 2:
        raise ValueError(f"a station batch is (stations, bytes), not "
                         f"{tuple(bufs.shape)}")
    return wbfm.demodulate_block(bufs, states, params, config, index)


def init_batch_state(config: WbfmConfig, stations: int,
                     device: str | torch.device) -> wbfm.WbfmState:
    """The one-station initial state with every tensor stacked over
    ``stations``."""
    one = wbfm.init_state(config, torch.device(device))

    def stack(x):
        if isinstance(x, tuple):
            return type(x)(*(stack(v) for v in x))
        if torch.is_tensor(x):
            return x.expand(stations, *x.shape).clone()
        return x

    return stack(one)


class WbfmBatchStreamer(wbfm.WbfmStreamer):
    """The station batch's host wrapper: feed (stations, bytes) u8, receive
    (stations, m) float audio.  Blocks are cut to a multiple of
    ``2*decim`` bytes, as JAX's batch cuts them, so calls of other lengths
    run the unaligned resamplers; the residual leads the next call.  The
    step is the one-station streamer's on :func:`demodulate_batch`, graphed
    the same way: keyed on the block's shape, the fs/4 phase and the
    unaligned resamplers' output count, their indices a device input."""

    _demodulate = staticmethod(demodulate_batch)

    def __init__(self, stations: int, config: WbfmConfig | None = None, *,
                 device: str | torch.device):
        super().__init__(config, device=device)
        self.stations = stations
        self.state = init_batch_state(self.config, stations, self.device)
        self._quantum = 2 * self.config.decim
        self._pending = np.zeros((stations, 0), dtype=np.uint8)

    def _outputs(self, out: list[np.ndarray]) -> np.ndarray:
        return out[0]  # the batch keeps no multiplex
