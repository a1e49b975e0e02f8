"""Sharded WBFM with the fused kernels as the per-shard compute — the
counterpart of ``tpu_sdr/parallel/wbfm_sharded_pallas.py``.

The same (dp, sp) layout as ``wbfm_sharded``, but each shard's front end
(u8 unpack -> fs/4 rotate -> 72-tap FIR ÷6 -> discriminator) is K1
(``fused_fm.fm_front``) and its resampler K2.  A row of shards runs:

1. the halo records (``shard_halo``, one launch a device): from its last
   360 raw samples, each shard builds the (4, 128) carry it would hand a
   next chunk and its last T-1 discriminator outputs;
2. ONE halo exchange (K4) ships every record to the right neighbour;
   shard 0 gets the edge record ``[kernel_edge | rs_edge | 0]``, the
   global streaming carry (zeros and a previous sample of 1 + 0j for a
   fresh stream);
3. one K1 launch over each whole shard's stations from their received
   carries, phase 0;
4. one K2 launch over their outputs with the received T-1 outputs as
   their halos.

On a CUDA mesh the exchange is K4 (``cuda_halo.pull_left_halo_cuda``) and
the records the kernel; on a CPU mesh both are their plain versions, as
JAX runs the Pallas kernel on TPU meshes and ``ppermute`` elsewhere.  The
mesh's own devices decide.

:class:`ShardedFusedStreamer` replays the whole step as one CUDA graph when
every place of its mesh is the same CUDA device.

Constraints: ``filter_mode='fir'``; each shard's complex count is a whole
number of kernel chunks (65,280 by default).  Input is the u8 I/Q bytes,
which K1 takes as they are; the rotation runs in K1 (the JAX chain's
``rot_impl='broadcast'`` contract).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.ops import fused_fm as FF
from tpu_sdr_torch.parallel import cuda_halo as CH
from tpu_sdr_torch.parallel import mesh as mesh_mod
from tpu_sdr_torch.parallel import shard_halo as SH
from tpu_sdr_torch.parallel.mesh import Mesh
from tpu_sdr_torch.parallel.wbfm_sharded import (
    ShardedWbfm, check_not_boxcar, resample_shard, run_rows)
from tpu_sdr_torch.utils import graphs
from tpu_sdr_torch.utils.design import WbfmConfig

def initial_carry(stations: int, config: WbfmConfig | None = None, *,
                  device: str | torch.device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresh-stream ``(kernel_edge (stations, 4, 128), rs_edge (stations,
    T-1))``: zero FIR and resampler history, previous sample 1 + 0j."""
    config = config or WbfmConfig()
    kernel_edge = FF.init_carry(device).repeat(stations, 1, 1)
    rs_edge = torch.zeros(stations, config.resample_taps_per_phase - 1,
                          dtype=torch.float32, device=device)
    return kernel_edge, rs_edge


def make_sharded_wbfm_fused(mesh: Mesh, config: WbfmConfig | None = None,
                            carry_io: bool = False) -> ShardedWbfm:
    """The fused sharded chain on ``mesh``.

    ``carry_io``: block-to-block streaming.  ``fn`` becomes ``fn(shards,
    kernel_edge, rs_edge) -> (audio, counts, kernel_end, rs_end)``:
    ``kernel_edge`` (stations, 4, 128) seeds shard 0's kernel state,
    ``rs_edge`` (stations, T-1) its resampler halo, and the ``*_end``
    outputs (on ``mesh.home``) are the LAST time shard's end-of-block
    values (its record's carry, and K1's own last T-1 outputs) — feed them
    back as the next block's edges and the chain is sample-exact with one
    serial stream.  Start from :func:`initial_carry`.
    """
    config = config or WbfmConfig()
    check_not_boxcar(config)
    spec = FF.default_spec(config)
    T = spec.taps_per_phase
    places = set(mesh.devices.flat)
    banks = {dev: FF.make_kernel_params(config, device=dev) for dev in places}
    halo_params = {dev: SH.make_params(config, device=dev) for dev in places}
    record = halo_params[mesh.home].record
    pads: dict = {}  # the edge record's zero tail, per (place, stations)

    def edge_record(kernel_edge, rs_edge):
        st, dev = rs_edge.shape[0], rs_edge.device
        if (dev, st) not in pads:
            pads[dev, st] = torch.zeros(st, record - SH.END - (T - 1),
                                        dtype=torch.float32, device=dev)
        return torch.cat([kernel_edge.reshape(st, SH.END), rs_edge,
                          pads[dev, st]], dim=1)

    def row_fn(blocks, carry):
        st = blocks[0].shape[0]
        for b in blocks:
            if b.shape[1] % spec.chunk_bytes:
                raise ValueError(f"a time shard of {b.shape[1]} bytes is not "
                                 f"a whole number of kernel chunks "
                                 f"({spec.chunk_bytes} bytes)")
        if carry is None:
            kernel_edge, rs_edge = initial_carry(st, config,
                                                 device=blocks[0].device)
        else:
            kernel_edge, rs_edge = carry
        records = SH.shard_halo(blocks, halo_params)

        # one exchange ships every record to its right neighbour
        recv = CH.pull_left_halo_cuda(
            [r.reshape(-1) for r in records], st * record,
            edge_record(kernel_edge, rs_edge).reshape(-1))

        # one K1 launch over each whole shard's stations from their
        # received carries, phase 0, then one K2 launch with the received
        # outputs as their halos (both read the records where they lie)
        audio, counts, demods = [], [], []
        for s, (b, r) in enumerate(zip(blocks, recv)):
            taps, h_poly = banks[b.device]
            r = r.reshape(st, record)
            demod, _ = FF.fm_front(b, 0, r[:, :SH.END].reshape(
                st, FF.STATE_ROWS, FF.LANES), taps, spec.decim)
            a, c = resample_shard(demod, r[:, SH.END:SH.END + T - 1], s,
                                  config, h_poly, kernel=True)
            audio.append(a)
            counts.append(c)
            demods.append(demod)
        if carry is None:
            return audio, counts, None
        # the end-of-block carries: the LAST shard's record carry and K1's
        # own last T-1 outputs there
        return audio, counts, (
            records[-1][:, :SH.END].reshape(st, FF.STATE_ROWS, FF.LANES),
            demods[-1][:, -(T - 1):])

    def fn(shards, kernel_edge=None, rs_edge=None):
        if carry_io != (kernel_edge is not None and rs_edge is not None):
            raise ValueError("pass kernel_edge and rs_edge exactly when the "
                             "chain was built with carry_io=True")
        return run_rows(mesh, shards,
                        (kernel_edge, rs_edge) if carry_io else None, row_fn)

    return ShardedWbfm(mesh=mesh, config=config, fn=fn)


class ShardedFusedStreamer:
    """Streaming host wrapper around the ``carry_io`` fused sharded chain:
    a multi-shard receiver with the ``(carry, block)`` discipline of the
    serial streamers — the counterpart of ``ShardedPallasStreamer``.

    ``demodulate`` takes (stations, bytes) u8 blocks whose per-shard slice
    is a whole number of kernel chunks, returns the assembled audio as
    numpy, and carries the stream across calls (sample-exact with one
    serial stream).  The carries keep the JAX attribute names
    ``states``/``resamp_hists`` and shapes, on ``mesh.home``.

    When every place of the mesh is one CUDA device (``graphed``), the
    step runs through ``utils.graphs``: the first block of a shape runs it
    eagerly (which also builds the kernels) over static shard and carry
    buffers, then one step is captured as a CUDA graph over them; each
    later block of that shape is copied into the shard buffers and the
    graph replays.  The launch counters then add the captured step's
    launches at each replay.  A mesh over several cards, or on the CPU,
    runs every step eagerly."""

    def __init__(self, mesh: Mesh, stations: int,
                 config: WbfmConfig | None = None):
        self.config = config or WbfmConfig()
        self.chain = make_sharded_wbfm_fused(mesh, self.config, carry_io=True)
        self.states, self.resamp_hists = initial_carry(
            stations, self.config, device=mesh.home)
        self.graphed = mesh.is_cuda and len(set(mesh.devices.flat)) == 1
        self.graphs = graphs.StepGraphs("ShardedFusedStreamer", self._step,
                                        mesh.home)

    @property
    def step_graph(self) -> torch.cuda.CUDAGraph | None:
        """The last block's captured step (``None`` before the first block,
        or eager)."""
        return self.graphs.graph if self.graphed else None

    def _step(self, _static, inputs, carries):
        """The step on the shards of one block (row-major over the mesh),
        its audio assembled on the card."""
        dp, sp = self.chain.mesh.devices.shape
        shards = [inputs[d * sp:(d + 1) * sp] for d in range(dp)]
        audio, counts, kernel_end, rs_end = self.chain.fn(shards, *carries)
        return [self.chain.trim(audio, counts)], [kernel_end, rs_end], None

    def demodulate(self, blocks) -> np.ndarray:
        if isinstance(blocks, np.ndarray):
            blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
        if not self.graphed:
            audio, counts, self.states, self.resamp_hists = self.chain.fn(
                self.chain.shard(blocks), self.states, self.resamp_hists)
            return self.chain.assemble(audio, counts)
        # each shard into its static buffer: a view of a host block, or of
        # the caller's tensor, which the step never keeps
        shards = [x for row in mesh_mod.time_cuts(self.chain.mesh, blocks)
                  for x in row]
        if isinstance(blocks, np.ndarray):
            shards = [np.ascontiguousarray(x) for x in shards]
        (audio,), (self.states, self.resamp_hists), _ = self.graphs(
            (), shards, [self.states, self.resamp_hists])
        return audio

    def reset(self) -> None:
        self.states, self.resamp_hists = initial_carry(
            self.states.shape[0], self.config, device=self.states.device)
