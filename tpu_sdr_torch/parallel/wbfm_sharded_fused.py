"""Sharded WBFM with the fused kernels as the per-shard compute — the
counterpart of ``tpu_sdr/parallel/wbfm_sharded_pallas.py``.

The same (dp, sp) layout as ``wbfm_sharded``, but each shard's front end
(u8 unpack -> fs/4 rotate -> 72-tap FIR ÷6 -> discriminator) is K1
(``fused_fm.fm_front``) and its resampler K2.  The halos become K1's
initial carry:

Each shard decodes and rotates only its own last 128 samples and builds
from them the (4, 128) carry it would hand a next chunk — FIR history in
rows 0/1, its own last decimated sample (one 72-tap dot on the tail) in
rows 2/3 lane 127.  That end-of-shard carry is exactly what the RIGHT
neighbour must start from, so the whole (stations, 4, 128) block ships
right in ONE halo exchange and lands as the neighbour's initial state.
Shard 0 starts from the global streaming carry (zeros and a previous
sample of 1 + 0j for a fresh stream).

On a CUDA mesh the exchanges are K4 (``cuda_halo.pull_left_halo_cuda``);
on a CPU mesh they are the plain copy (``halo.pull_left_halo``), as JAX
runs the Pallas kernel on TPU meshes and ``ppermute`` elsewhere.  The
mesh's own devices decide.

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
from tpu_sdr_torch.parallel.mesh import Mesh
from tpu_sdr_torch.parallel.wbfm_sharded import (
    ShardedWbfm, check_not_boxcar, resample_shard, run_rows)
from tpu_sdr_torch.utils import design
from tpu_sdr_torch.utils.design import WbfmConfig

_TAIL = 128  # decoded tail samples per shard (>= L-1 + decim + 1)

# fs/4 rotation of sample k, j**(k % 4) * (i + jq): the (re, im) outputs'
# coefficients of (i, q)
_ROT = (((1, 0), (0, 1)), ((0, -1), (1, 0)), ((-1, 0), (0, -1)),
        ((0, 1), (-1, 0)))


def end_state_matrix(taps: np.ndarray, decim: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """``(A (2*_TAIL, 4*128), div (4*128,))``: a shard's end-of-shard
    carry, flattened, is ``(x @ A) / div`` for ``x`` its last _TAIL samples
    as interleaved I/Q in the x255 scale (2u - 255).  The tail starts at a
    local index 0 mod 4, so sample k rotates by k % 4.  Rows 0/1 take the
    rotated last L-1 samples (one +-1 entry a column: exact); rows 2/3
    lane 127 are the dot of the rotated last FIR window with the reversed
    f32 design ``taps``, then / 255 — the JAX chain's formula, not K1's
    split-bf16 taps."""
    L = len(taps)
    taps_rev = np.asarray(taps, dtype=np.float32)[::-1]
    w0 = _TAIL - decim - (L - 1)  # the tail's last FIR window
    lanes = FF.LANES
    A = np.zeros((2 * _TAIL, FF.STATE_ROWS * lanes), dtype=np.float32)
    for k in range(_TAIL):
        for row, coef in enumerate(_ROT[k % 4]):  # row 0: re, row 1: im
            for c, w in enumerate(coef):  # c 0: i, c 1: q
                if k >= _TAIL - (L - 1):
                    A[2 * k + c, row * lanes + k - (_TAIL - (L - 1))] = w
                if w0 <= k < w0 + L:
                    A[2 * k + c, (2 + row) * lanes + lanes - 1] = (
                        w * taps_rev[k - w0])
    div = np.ones(FF.STATE_ROWS * lanes, dtype=np.float32)
    div[[2 * lanes + lanes - 1, 3 * lanes + lanes - 1]] = 255.0
    return A, div


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
    values — feed them back as the next block's edges and the chain is
    sample-exact with one serial stream.  Start from :func:`initial_carry`.
    """
    config = config or WbfmConfig()
    check_not_boxcar(config)
    spec = FF.default_spec(config)
    T = spec.taps_per_phase
    A, div = end_state_matrix(design.decimator_taps(config), spec.decim)
    banks = {}
    for dev in set(mesh.devices.flat):
        taps, h_poly = FF.make_kernel_params(config, device=dev)
        banks[dev] = (taps, h_poly, torch.from_numpy(A).to(dev),
                      torch.from_numpy(div).to(dev))

    def end_state(block: torch.Tensor) -> torch.Tensor:
        """The (stations, 4, 128) carry at the end of this shard."""
        st, nbytes = block.shape
        _, _, A_dev, div_dev = banks[block.device]
        x = block[:, nbytes - 2 * _TAIL:].to(torch.float32) * 2.0 - 255.0
        return (x @ A_dev / div_dev).reshape(st, FF.STATE_ROWS, FF.LANES)

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
        ends = [end_state(b) for b in blocks]

        # one exchange ships every shard's end state to its right neighbour
        flats = [e.reshape(-1) for e in ends]
        recv = CH.pull_left_halo_cuda(flats, flats[0].numel(),
                                      kernel_edge.reshape(-1))

        # K1 over each whole shard from the received state, phase 0
        demods = []
        for b, r in zip(blocks, recv):
            taps = banks[b.device][0]
            states = r.reshape(st, FF.STATE_ROWS, FF.LANES)
            demod = torch.empty(st, b.shape[1] // 2 // spec.decim,
                                dtype=torch.float32, device=b.device)
            for j in range(st):
                FF.fm_front(b[j], 0, states[j], taps, spec.decim,
                            out=demod[j])
            demods.append(demod)

        # the resampler's T-1 halo: a second exchange, of each shard's
        # demodulated tail (JAX sends this one with lax.ppermute)
        tails = [d[:, -(T - 1):].reshape(-1) for d in demods]
        rs_halo = CH.pull_left_halo_cuda(tails, tails[0].numel(),
                                         rs_edge.reshape(-1))
        audio, counts = [], []
        for s, (demod, h) in enumerate(zip(demods, rs_halo)):
            a, c = resample_shard(demod, h.reshape(st, T - 1), s, config,
                                  banks[demod.device][1], kernel=True)
            audio.append(a)
            counts.append(c)
        if carry is None:
            return audio, counts, None
        # the end-of-block carries: the LAST shard's end state and tail
        return audio, counts, (ends[-1], tails[-1].reshape(st, T - 1))

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
    ``states``/``resamp_hists`` and shapes, on ``mesh.home``."""

    def __init__(self, mesh: Mesh, stations: int,
                 config: WbfmConfig | None = None):
        self.config = config or WbfmConfig()
        self.chain = make_sharded_wbfm_fused(mesh, self.config, carry_io=True)
        self.states, self.resamp_hists = initial_carry(
            stations, self.config, device=mesh.home)

    def demodulate(self, blocks) -> np.ndarray:
        if isinstance(blocks, np.ndarray):
            blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
        audio, counts, self.states, self.resamp_hists = self.chain.fn(
            self.chain.shard(blocks), self.states, self.resamp_hists)
        return self.chain.assemble(audio, counts)

    def reset(self) -> None:
        self.states, self.resamp_hists = initial_carry(
            self.states.shape[0], self.config, device=self.states.device)

