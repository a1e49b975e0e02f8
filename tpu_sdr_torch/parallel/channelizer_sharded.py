"""Time-sharded PFB channelizer + per-channel demod over a mesh — the
counterpart of ``tpu_sdr/parallel/channelizer_sharded.py``.

1. The wideband stream is time-sharded over ``sp``; each shard pulls a
   ``(rows-1)*K`` sample frame halo from its left neighbour (K4,
   ``cuda_halo.pull_left_halo_cuda``; the plain copy on a CPU mesh) and
   runs the plain ``pfb_analyze`` on its slice — the serial op's
   arithmetic.
2. The ``all_to_all`` re-shard, from time-sharded to channel-sharded:
   shard s gathers channel block s of every shard's frames, in time order,
   through ``cuda_halo.all_to_all`` (n-1 steps of K5 on a CUDA mesh).
   After it each shard owns all frames of K/S channels.
3. The per-channel quadrature FM demod runs on each channel block.

On a mesh whose shards all sit on one place (``Mesh.single_place``) the
whole pipeline runs through ``utils.graphs``, as ``jax.jit`` runs JAX's:
keyed on the input's length, one CUDA graph replay a call on a card, with
K4's two launches and K5's n-1 inside it; the demod is handed out as a
tensor of its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tpu_sdr_torch.ops import channelizer as chan
from tpu_sdr_torch.ops import fm as F
from tpu_sdr_torch.parallel import cuda_halo as CH
from tpu_sdr_torch.parallel.mesh import Mesh
from tpu_sdr_torch.utils import design, graphs


@dataclass(frozen=True)
class ShardedChannelizer:
    mesh: Mesh
    num_channels: int
    fn: Callable
    # the graphed fn's cache (a mesh on one place), else None
    graphs: graphs.StepGraphs | None = None

    def __call__(self, re, im) -> torch.Tensor:
        """(re, im): (n,) wideband f32 (numpy or torch) -> demod (K, n/K),
        channel-major, on ``mesh.home``."""
        return self.fn(re, im)


def make_sharded_channelizer(mesh: Mesh, num_channels: int,
                             taps_per_branch: int = 8) -> ShardedChannelizer:
    """The time-sharded channelize + demod pipeline over the first row of
    the mesh's ``sp`` axis."""
    K = num_channels
    h_poly = design.design_pfb(K, taps_per_branch)
    rows = h_poly.shape[0]
    devices = list(mesh.devices[0, :])
    sp = len(devices)
    if K % sp:
        raise ValueError(f"{K} channels not divisible by {sp} shards")
    k_loc = K // sp
    m2 = {d: chan.packed_matrix(h_poly, device=d) for d in set(devices)}

    def split(x) -> list[torch.Tensor]:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        n = x.shape[0]
        if n % (sp * K):
            raise ValueError(f"{n} samples do not split into {sp} shards of "
                             f"whole {K}-sample frames")
        n_loc = n // sp
        return [x[s * n_loc:(s + 1) * n_loc].to(d).contiguous()
                for s, d in enumerate(devices)]

    def eager(re, im) -> torch.Tensor:
        re_s, im_s = split(re), split(im)
        # local PFB from the left neighbour's frame halo
        h_re = CH.pull_left_halo_cuda(re_s, (rows - 1) * K)
        h_im = CH.pull_left_halo_cuda(im_s, (rows - 1) * K)
        ys = []
        for r, i, hr, hi in zip(re_s, im_s, h_re, h_im):
            state = chan.PfbState(hr.reshape(rows - 1, K),
                                  hi.reshape(rows - 1, K))
            y_re, y_im, _ = chan.pfb_analyze(r, i, m2[r.device], state)
            ys.append((y_re, y_im))
        # all_to_all: shard s takes channel block s of every shard's
        # frames, re and im packed as (sp, 2, m_loc, K/S) a shard
        blocks = [torch.stack([y_re, y_im]).reshape(2, -1, sp, k_loc)
                  .permute(2, 0, 1, 3).contiguous() for y_re, y_im in ys]
        out = []
        for recv, d in zip(CH.all_to_all(blocks), devices):
            c = torch.cat(recv, dim=1)  # (2, m, K/S): frames in time order
            c_re, c_im = c[0].T, c[1].T
            quad = F.QuadState(torch.ones(k_loc, device=d),
                               torch.zeros(k_loc, device=d))
            demod, _ = F.quadrature_demod(c_re, c_im, quad)  # (K/S, m)
            out.append(demod.to(mesh.home))
        return torch.cat(out)

    steps = (graphs.StepGraphs(
        "ShardedChannelizer",
        lambda _static, inputs, _carries: ([eager(*inputs)], [], None),
        mesh.home) if mesh.single_place else None)

    def fn(re, im) -> torch.Tensor:
        if steps is None:
            return eager(re, im)
        ins = [np.ascontiguousarray(x, dtype=np.float32)
               if isinstance(x, np.ndarray) else x for x in (re, im)]
        return steps.on_device((), ins, [])[0][0]

    return ShardedChannelizer(mesh=mesh, num_channels=K, fn=fn,
                              graphs=steps)
