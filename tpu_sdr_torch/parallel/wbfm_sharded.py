"""Sharded WBFM float chain: stations x time over a (dp, sp) mesh — the
counterpart of ``tpu_sdr/parallel/wbfm_sharded.py``.

Stations shard over ``dp``; time over ``sp``, where each shard demodulates
its slice after pulling a small halo from its left neighbour
(``parallel.halo``, the counterpart of ``lax.ppermute``): the overlap-save
form of the serial chain's streaming carries.  Halo sizes: the FIR needs
``taps-1`` rotated samples, the discriminator 1 decimated sample, the
audio resampler ``T-1`` demodulated samples.

Where JAX runs one function per shard under ``shard_map``, the port runs
one row of ``sp`` shards at a time: every stage loops over the row's
shards, each on its own place, and the exchanges sit between the stages.
The one-hot ``psum`` that hands the JAX chain its end-of-block carry
becomes "take the last shard's tails".

Audio emission counts are data-independent closed forms of the global
shard offset; per-shard outputs are padded to a static maximum as in JAX,
and ``ShardedWbfm.assemble`` trims them.

On a mesh whose shards all sit on one place (``Mesh.single_place``) the
chain's ``fn`` runs through ``utils.graphs`` as ``jax.jit`` runs JAX's:
keyed on the shards' shapes, one CUDA graph replay a call on a card, its
audio and new carry handed out as tensors of their own; the counts, moved
by the key alone, are the step's aux.  A mesh over several cards or
processes runs eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from tpu_sdr_torch.models import wbfm as M
from tpu_sdr_torch.ops import fm as F
from tpu_sdr_torch.ops import fused_fm as FF
from tpu_sdr_torch.parallel import halo as H
from tpu_sdr_torch.parallel import mesh as mesh_mod
from tpu_sdr_torch.parallel.mesh import Mesh
from tpu_sdr_torch.utils import graphs
from tpu_sdr_torch.utils.design import WbfmConfig


class XlaStreamCarry(NamedTuple):
    """Block-to-block streaming carry of the sharded float chain (per
    station row): the rotated FIR history, the discriminator's previous
    decimated sample and the demodulated resampler history — the sharded
    form of the serial ``WbfmState`` minus the rotator phase (shard and
    block lengths are multiples of 4 samples, so it is 0 at every
    boundary)."""

    fir_re: torch.Tensor   # (stations, num_taps - 1)
    fir_im: torch.Tensor
    quad_re: torch.Tensor  # (stations, 1)
    quad_im: torch.Tensor
    rs: torch.Tensor       # (stations, T - 1)


def initial_xla_carry(stations: int, config: WbfmConfig | None = None, *,
                      device: str | torch.device) -> XlaStreamCarry:
    """Fresh-stream carry: zero histories, discriminator prev = 1 + 0j
    (the serial ``QuadState`` init)."""
    config = config or WbfmConfig()
    L = config.num_taps
    T = config.resample_taps_per_phase

    def zeros(n):
        return torch.zeros(stations, n, dtype=torch.float32, device=device)

    return XlaStreamCarry(zeros(L - 1), zeros(L - 1),
                          torch.ones(stations, 1, dtype=torch.float32,
                                     device=device),
                          zeros(1), zeros(T - 1))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def check_not_boxcar(config: WbfmConfig) -> None:
    """The fused chain's kernels are the FIR chain's (JAX's Pallas chain is
    FIR-only too)."""
    if config.filter_mode == "boxcar":
        raise NotImplementedError(
            "the fused sharded chain runs the fir mode only; the boxcar "
            "mode runs in make_sharded_wbfm")


def resample_halo(config: WbfmConfig, n_out: int) -> int:
    """The demodulated samples a shard's resampler needs from its left
    neighbour: T-1 for the polyphase bank; for the boxcar window none on
    whole frames, else ceil(rate_out / rate_resample)."""
    if config.filter_mode == "boxcar":
        if n_out % config.resample_down == 0:
            return 0
        return _cdiv(config.rate_out, config.rate_resample)
    return config.resample_taps_per_phase - 1


@dataclass(frozen=True)
class ShardedWbfm:
    """A sharded chain on ``mesh``.  ``fn(shards, *carry)`` takes the
    ``shards[d][s]`` of :meth:`shard` and returns ``(audio, counts, *new
    carry)``: ``audio[d][s]`` the (stations_loc, m_max) padded audio of
    each shard (``None`` for rows another process computes), ``counts[s]``
    the valid samples of time shard s."""

    mesh: Mesh
    config: WbfmConfig
    fn: Callable
    # the graphed fn's cache (the float chain on one place), else None
    graphs: graphs.StepGraphs | None = None

    def shard(self, blocks) -> list[list[torch.Tensor | None]]:
        """(stations, n) blocks -> per-shard tensors on their places."""
        return mesh_mod.shard_time(self.mesh, blocks)

    def __call__(self, shards, *carry):
        return self.fn(shards, *carry)

    def trim(self, audio, counts) -> torch.Tensor:
        """Trim per-shard padding, concatenate time shards and stack the
        rows this process computed, on ``mesh.home``."""
        home = self.mesh.home
        rows = [torch.cat([a[:, :c].to(home) for a, c in zip(row, counts)],
                          dim=1)
                for row in audio if row is not None]
        return torch.cat(rows)

    def assemble(self, audio, counts) -> np.ndarray:
        """:meth:`trim` as numpy."""
        return self.trim(audio, counts).cpu().numpy()


def _row_carry(carry, i: int, st: int, device: torch.device):
    """Local row i's slice of global (stations, ...) carry tensors."""
    return [c[i * st:(i + 1) * st].to(device) for c in carry]


def _gather(ends, device: torch.device) -> list[torch.Tensor]:
    """Per-row end-of-block tensors -> global (stations, ...) on ``device``."""
    return [torch.cat([row[k].to(device) for row in ends])
            for k in range(len(ends[0]))]


def run_rows(mesh: Mesh, shards, carry, row_fn):
    """Run ``row_fn(row, row_carry) -> (audio, counts, ends)`` over the rows
    this process computes; returns (audio, counts[, *gathered ends])."""
    audio: list = [None] * mesh.devices.shape[0]
    ends, counts = [], None
    for i, d in enumerate(mesh.local_rows()):
        row = shards[d]
        st = row[0].shape[0]
        row_carry = (None if carry is None
                     else _row_carry(carry, i, st, row[0].device))
        audio[d], counts, end = row_fn(row, row_carry)
        ends.append(end)
    if carry is None:
        return audio, counts
    return (audio, counts, *_gather(ends, mesh.home))


def resample_shard(demod: torch.Tensor, halo: torch.Tensor, shard: int,
                   config: WbfmConfig, h_poly: torch.Tensor,
                   V: torch.Tensor | None = None, kernel: bool = False
                   ) -> tuple[torch.Tensor, int]:
    """Per-shard audio resampler with global-phase closed forms.

    ``demod``: (stations_loc, n_out) discriminator output of time shard
    ``shard``; ``halo``: its left neighbour's last
    :func:`resample_halo` samples (the previous block's tail on shard 0).
    Returns (audio (stations_loc, m_max), count).  When every shard starts
    on a frame boundary (n_out % down == 0) it is the serial aligned
    resampler with the halo as history: the frame matmul with ``V`` (the
    polyphase bank's, or the boxcar window's with no halo), or one K2
    launch over the stations (``fused_fm.resample``) when ``kernel``.
    Otherwise each output's global phase is computed from the shard
    offset: the polyphase windows, or the boxcar sums as differences of
    one cumsum."""
    st, n_out = demod.shape
    up, down = config.resample_up, config.resample_down
    T = h_poly.shape[1]
    halo_len = resample_halo(config, n_out)
    if n_out < halo_len:
        raise ValueError(f"time shard too small for the single-neighbour "
                         f"resampler halo: n_out={n_out} needs >= {halo_len} "
                         f"demodulated samples")
    if n_out % down == 0:
        count = n_out // down * up
        if not kernel:
            audio, _ = F.aligned_resample(demod, V, up, down,
                                          F.AlignedResampleState(halo))
            return audio, count
        return FF.resample(demod, halo, h_poly, down)[0], count

    start = shard * n_out  # global index of the shard's first sample
    buf = torch.cat([halo, demod], dim=1)
    dev = demod.device
    if config.filter_mode == "boxcar":
        fast, slow = config.rate_out, config.rate_resample
        cs = torch.cumsum(buf, dim=1)
        j0 = (start * slow) // fast
        count = ((start + n_out) * slow) // fast - j0
        j = j0 + torch.arange((n_out * slow) // fast + 1, device=dev)
        e = ((j + 1) * fast + slow - 1) // slow - 1  # global emission index
        e_prev = (j * fast + slow - 1) // slow - 1
        le = torch.clamp(e - start + halo_len, 0, buf.shape[1] - 1)
        lp = torch.clamp(e_prev - start + halo_len, -1, buf.shape[1] - 1)
        cs_p = torch.where(lp >= 0, cs[:, lp.clamp(min=0)], 0.0)
        return (cs[:, le] - cs_p) / float(fast // slow), count
    m_max = (n_out * up) // down + 1
    j0 = _cdiv(start * up, down)
    count = _cdiv((start + n_out) * up, down) - j0
    m = j0 + torch.arange(m_max, device=dev)
    tt = m * down
    q = tt // up  # global input index of the newest window sample
    p = tt % up
    t_idx = torch.arange(T, device=dev)
    win = torch.clamp(q[:, None] - t_idx[None, :] - start + (T - 1), 0,
                      buf.shape[1] - 1)
    windows = buf[:, win]  # (st, m_max, T)
    audio = torch.einsum("smt,mt->sm", windows, h_poly[p])
    return audio, count


def _rotated_samples(block: torch.Tensor):
    """u8 (stations, 2n) -> fs/4-rotated (re, im), (stations, n) each,
    centred as ``F.u8_to_f32``; phase 0 (shards are 0 mod 4 samples)."""
    x = block.to(torch.float32) * (1.0 / 127.5) - 1.0
    re, im, _ = F.rotate_fs4(x[:, 0::2], x[:, 1::2], 0)
    return re, im


def make_sharded_wbfm(mesh: Mesh, config: WbfmConfig | None = None,
                      carry_io: bool = False) -> ShardedWbfm:
    """The sharded float chain on ``mesh``, ``fir`` or ``boxcar`` mode (the
    boxcar decimator's groups align with the shards: no FIR halo; the fast
    atan; the boxcar resampler).

    ``carry_io``: block-to-block streaming.  ``fn`` becomes ``fn(shards,
    carry: XlaStreamCarry) -> (audio, counts, new_carry)``: the carry of
    the stations this process computes seeds shard 0's FIR, discriminator
    and resampler halos, and the LAST time shard's end-of-block values come
    back (on ``mesh.home``) — feed them forward and the chain is
    sample-exact with one serial stream across blocks.  Start from
    :func:`initial_xla_carry`.  As in JAX, streaming is defined for the
    ``fir`` mode only."""
    config = config or WbfmConfig()
    boxcar = config.filter_mode == "boxcar"
    if carry_io and boxcar:
        raise ValueError("carry_io streaming is defined for the fir mode")
    decim = config.decim
    L = config.num_taps
    T = config.resample_taps_per_phase
    banks = {}
    for dev in set(mesh.devices.flat):
        params = M.WbfmParams(config, dev)
        banks[dev] = (params.decim_W,
                      params.box_V if boxcar else params.resamp_V,
                      params.resamp_poly)

    def row_fn(blocks, carry):
        edge = None if carry is None else XlaStreamCarry(*carry)
        st = blocks[0].shape[0]
        rot = []
        for b in blocks:
            n_loc = b.shape[1] // 2
            if b.shape[1] % 2 or n_loc % (4 * decim):
                raise ValueError("a time shard must be a multiple of 4 "
                                 "samples (rotation phase) and of the "
                                 f"decimation {decim}")
            if not boxcar and n_loc < L - 1:
                raise ValueError(f"time shard of {n_loc} samples is too "
                                 "small for the single-neighbour FIR halo")
            rot.append(_rotated_samples(b))

        if boxcar:  # groups align with the shards: no halo
            dec = [F.boxcar_decimate_f32(re, im, decim) for re, im in rot]
        else:  # FIR: the left neighbour's last L-1 rotated samples
            hre = H.pull_left_halo([r.T for r, _ in rot], L - 1,
                                   None if edge is None else edge.fir_re.T)
            him = H.pull_left_halo([i.T for _, i in rot], L - 1,
                                   None if edge is None else edge.fir_im.T)
            dec = []
            for (re, im), h_re, h_im in zip(rot, hre, him):
                W = banks[re.device][0]
                xext = torch.cat([torch.cat([h_re.T, re], dim=1),
                                  torch.cat([h_im.T, im], dim=1)])
                y = F.banded_decim_apply(xext, W, decim, re.shape[1] // decim)
                dec.append((y[:st], y[st:]))

        # discriminator: a 1-sample halo at the decimated rate; the global
        # left edge is seeded (1, 0) like the serial QuadState init
        pre_re = H.pull_left_halo(
            [d.T for d, _ in dec], 1,
            torch.ones(1, st, device=blocks[0].device) if edge is None
            else edge.quad_re.T)
        pre_im = H.pull_left_halo([d.T for _, d in dec], 1,
                                  None if edge is None else edge.quad_im.T)
        demods = [F.quadrature_demod(d_re, d_im,
                                     F.QuadState(p_re[0], p_im[0]),
                                     atan_mode="fast" if boxcar else "exact")[0]
                  for (d_re, d_im), p_re, p_im in zip(dec, pre_re, pre_im)]

        halo_len = resample_halo(config, demods[0].shape[1])
        if halo_len:
            rs_halo = H.pull_left_halo([d.T for d in demods], halo_len,
                                       None if edge is None else edge.rs.T)
        else:
            rs_halo = [d[:, :0].T for d in demods]
        audio, counts = [], []
        for s, (demod, h) in enumerate(zip(demods, rs_halo)):
            _, V, h_poly = banks[demod.device]
            a, c = resample_shard(demod, h.T, s, config, h_poly, V)
            audio.append(a)
            counts.append(c)
        (re, im), (d_re, d_im) = rot[-1], dec[-1]
        ends = (re[:, re.shape[1] - (L - 1):], im[:, im.shape[1] - (L - 1):],
                d_re[:, -1:], d_im[:, -1:], demods[-1][:, -(T - 1):])
        return audio, counts, ends

    def eager(shards, carry: XlaStreamCarry | None = None):
        out = run_rows(mesh, shards, carry, row_fn)
        if carry is None:
            return out
        audio, counts, *ends = out
        return audio, counts, XlaStreamCarry(*ends)

    dp, sp = mesh.devices.shape

    def step(_static, inputs, carries):
        """``eager`` on the flattened shards: (the shards' audio, the new
        carry, the counts)."""
        rows = [inputs[d * sp:(d + 1) * sp] for d in range(dp)]
        audio, counts, *ends = eager(rows, XlaStreamCarry(*carries)
                                     if carries else None)
        return ([a for row in audio for a in row],
                list(ends[0]) if ends else [], counts)

    steps = (graphs.StepGraphs("ShardedWbfm", step, mesh.home)
             if mesh.single_place else None)

    def fn(shards, carry: XlaStreamCarry | None = None):
        if carry_io != (carry is not None):
            raise ValueError("pass a carry exactly when the chain was built "
                             "with carry_io=True")
        if steps is None:
            return eager(shards, carry)
        audio, new, counts = steps.on_device(
            (), [x for row in shards for x in row],
            [] if carry is None else list(carry))
        audio = [audio[d * sp:(d + 1) * sp] for d in range(dp)]
        if carry is None:
            return audio, counts
        return audio, counts, XlaStreamCarry(*new)

    return ShardedWbfm(mesh=mesh, config=config, fn=fn, graphs=steps)


def sharded_wbfm_apply(chain: ShardedWbfm, blocks, *carry):
    """Place (stations, bytes) u8 ``blocks`` on the mesh and run the chain."""
    return chain(chain.shard(blocks), *carry)


def expected_m_max(config: WbfmConfig, n_loc_out: int) -> int:
    if config.filter_mode == "boxcar":
        return (n_loc_out * config.rate_resample) // config.rate_out + 1
    return (n_loc_out * config.resample_up) // config.resample_down + 1
