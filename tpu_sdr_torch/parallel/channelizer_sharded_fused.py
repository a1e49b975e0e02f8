"""Channel-parallel PFB channelizer with K3 on every shard — the
counterpart of ``tpu_sdr/parallel/channelizer_sharded_pallas.py``.

Each shard of the axis frames the whole (replicated) wideband input and
runs K3 (``fused_channelizer.channelize``) with its own contiguous column
block of the packed analysis matrix, ``local_channels = K / n`` channels.
The input framing is shared, so no collective runs in the steady state:
the channel blocks concatenate along the channel axis, and every shard
computes the same new carry (the raw input frames), of which shard 0's is
kept.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_sdr_torch.ops import fused_channelizer as FC
from tpu_sdr_torch.parallel.mesh import Mesh, replicate
from tpu_sdr_torch.utils import design


@dataclass(frozen=True)
class ShardedFusedPfb:
    """``devices[i]`` computes channels ``[i*Ko, (i+1)*Ko)`` with
    ``m2[i]``; ``spec.local_channels`` = Ko."""

    devices: list[torch.device]
    spec: FC.PfbSpec
    m2: list[torch.Tensor]

    def __call__(self, data_u8, carry: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """u8 bytes of whole frames and the (2H, K) carry -> (Y_re (m, K),
        Y_im (m, K), new carry) on the first shard's device."""
        home = self.devices[0]
        datas = replicate(self.devices, data_u8)
        carries = replicate(self.devices, carry)
        outs = [FC.channelize(d, c, m2, self.spec)
                for d, c, m2 in zip(datas, carries, self.m2)]
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
    m2 = [FC.kernel_matrix(h_poly, slice(i * k_loc, (i + 1) * k_loc)).to(d)
          for i, d in enumerate(devices)]
    return ShardedFusedPfb(devices=devices, spec=spec, m2=m2)


def sharded_pfb_fused_apply(bank: ShardedFusedPfb, buf: np.ndarray,
                            carry: torch.Tensor | None = None):
    """u8 wideband block -> (Y_re (m, K), Y_im (m, K), new carry), the
    carry zero for a fresh stream."""
    if carry is None:
        carry = FC.init_carry(bank.spec, bank.devices[0])
    return bank(np.ascontiguousarray(buf, dtype=np.uint8), carry)
