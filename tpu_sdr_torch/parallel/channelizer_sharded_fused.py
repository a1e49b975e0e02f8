"""Channel-parallel PFB channelizer with K3 on every shard — the
counterpart of ``tpu_sdr/parallel/channelizer_sharded_pallas.py``.

Each shard of the axis frames the whole (replicated) wideband input and
runs K3 (``fused_channelizer.channelize``) with the full tap table on its
own contiguous block of channels, ``local_channels = K / n`` of them from
``channel_offset = i * K / n``.
The input framing is shared, so no collective runs in the steady state:
the channel blocks concatenate along the channel axis, and every shard
computes the same new carry (the raw input frames), of which shard 0's is
kept.

When every shard sits on one place the bank's call runs through
``utils.graphs``, as ``jax.jit`` runs JAX's: keyed on the input's length,
one CUDA graph replay a call on a card (a K3 launch a shard inside it),
Y_re, Y_im and the new carry handed out as tensors of their own.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_sdr_torch.ops import fused_channelizer as FC
from tpu_sdr_torch.parallel.mesh import Mesh, replicate
from tpu_sdr_torch.utils import design, graphs


@dataclass(frozen=True)
class ShardedFusedPfb:
    """``devices[i]`` computes channels ``[i*Ko, (i+1)*Ko)`` with its
    copy ``taps[i]`` of the tap table; ``spec.local_channels`` = Ko."""

    devices: list[torch.device]
    spec: FC.PfbSpec
    taps: list[torch.Tensor]
    graphs: graphs.StepGraphs = field(init=False, repr=False,
                                      compare=False)

    def __post_init__(self):
        object.__setattr__(self, "graphs", graphs.StepGraphs(
            "ShardedFusedPfb", self._step, self.devices[0]))

    def __call__(self, data_u8, carry: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """u8 bytes of whole frames and the (2H, K) carry -> (Y_re (m, K),
        Y_im (m, K), new carry) on the first shard's device."""
        if len(set(self.devices)) > 1:
            return self._eager(data_u8, carry)
        if isinstance(data_u8, np.ndarray):
            data_u8 = np.ascontiguousarray(data_u8, dtype=np.uint8)
        return tuple(self.graphs.on_device((), [data_u8, carry], [])[0])

    def _step(self, _static, inputs, _carries):
        return list(self._eager(*inputs)), [], None

    def _eager(self, data_u8, carry):
        home = self.devices[0]
        datas = replicate(self.devices, data_u8)
        carries = replicate(self.devices, carry)
        ko = self.spec.out_channels
        outs = [FC.channelize(d, c, taps, self.spec, channel_offset=i * ko)
                for i, (d, c, taps) in enumerate(zip(datas, carries,
                                                     self.taps))]
        y_re = torch.cat([o[0].to(home) for o in outs], dim=1)
        y_im = torch.cat([o[1].to(home) for o in outs], dim=1)
        return y_re, y_im, outs[0][2]


def make_sharded_pfb_fused(mesh: Mesh, num_channels: int = 64,
                           taps_per_branch: int = 8,
                           frames_per_chunk: int = 256) -> ShardedFusedPfb:
    """The channel-parallel fused channelizer over the first row of the
    mesh's ``sp`` axis."""
    devices = list(mesh.devices[0, :])
    n_dev = len(devices)
    if num_channels % n_dev:
        raise ValueError(f"{num_channels} channels do not split over "
                         f"{n_dev} shards")
    k_loc = num_channels // n_dev
    spec = FC.PfbSpec(num_channels, taps_per_branch + 1, frames_per_chunk,
                      local_channels=k_loc)
    spec.validate()
    h_poly = design.design_pfb(num_channels, taps_per_branch)
    taps = FC.kernel_taps(h_poly)
    return ShardedFusedPfb(devices=devices, spec=spec,
                           taps=[taps.to(d) for d in devices])


def sharded_pfb_fused_apply(bank: ShardedFusedPfb, buf: np.ndarray,
                            carry: torch.Tensor | None = None):
    """u8 wideband block -> (Y_re (m, K), Y_im (m, K), new carry), the
    carry zero for a fresh stream."""
    if carry is None:
        carry = FC.init_carry(bank.spec, bank.devices[0])
    return bank(np.ascontiguousarray(buf, dtype=np.uint8), carry)
