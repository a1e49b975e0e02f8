"""The halo record of a time shard of the fused sharded chain, and the
kernel that builds it (``csrc/shard_halo.cu``).

A time shard hands its right neighbour two things: the (4, 128) K1 carry
at its end and its last T-1 discriminator outputs (the resampler's halo).
Both depend only on the shard's last :func:`tail_samples` raw samples (360
for the default chain: the last T = 48 decimated samples reach back
decim * T + L - 1 = 359 samples, rounded up to a rotation boundary), so
one record per (shard, station) carries both and one K4 exchange ships
them.  The record, ``record`` f32 (560 by default, 16-byte aligned):

* floats 0-511: the carry, as the JAX chain builds it
  (``tpu_sdr/parallel/wbfm_sharded_pallas.py`` ``shard_fn``): rows 0/1 the
  fs/4-rotated last L-1 samples in the x255 scale, rows 2/3 lane 127 the
  dot of the last FIR window with the reversed design taps, / 255;
* floats 512 to 512 + T - 2: the last T-1 outputs of K1's discriminator,
  from the last T decimated samples with K1's effective taps and the
  6-term atan (``fused_fm.atan2_poly6``);
* the rest: zeros.

:func:`shard_halo` builds the records of a row of shards: for CPU shards
the plain version (one numpy-built (2 tail, 512 + 2T) matrix applied to
the x255 tail gives the carry and the decimated samples in one product,
then the atan), for CUDA shards one launch of the kernel per device, or it
raises.  Each launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch

from tpu_sdr_torch import kernels
from tpu_sdr_torch.ops import fused_fm as FF
from tpu_sdr_torch.utils import design
from tpu_sdr_torch.utils.design import WbfmConfig

# Kernel launches: the main path's proof that it ran the kernel.  Only the
# wrapper's CUDA branch adds to it.
LAUNCHES = kernels.launch_counter("shard_halo")

# Shards one launch takes (kMaxShards in csrc/shard_halo.cu).
MAX_SHARDS = 32

END = FF.STATE_ROWS * FF.LANES  # the carry's floats at the record's head

# fs/4 rotation of sample k, j**(k % 4) * (i + jq): the (re, im) outputs'
# coefficients of (i, q)
_ROT = (((1, 0), (0, 1)), ((0, -1), (1, 0)), ((-1, 0), (0, -1)),
        ((0, 1), (-1, 0)))


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tail_samples(num_taps: int, decim: int, T: int) -> int:
    """Raw samples the record needs: back to the first sample of the
    window of the T-th last decimated sample, rounded up to a multiple of 4
    so that the tail starts at rotation phase 0."""
    return -(-(decim * T + num_taps - 1) // 4) * 4


def record_floats(T: int) -> int:
    """The record's length: the carry and T-1 outputs, padded to 16 bytes."""
    return -(-(END + T - 1) // 4) * 4


def end_state_matrix(taps: np.ndarray, decim: int, tail: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """``(A (2 tail, 512), div (512,))``: a shard's end-of-shard carry,
    flattened, is ``(x @ A) / div`` for ``x`` its last ``tail`` samples as
    interleaved I/Q in the x255 scale (2u - 255).  Rows 0/1 take the
    rotated last L-1 samples (one +-1 entry a column: exact); rows 2/3
    lane 127 are the dot of the rotated last FIR window with the reversed
    f32 design ``taps``, then / 255 — the JAX chain's formula, not K1's
    split-bf16 taps."""
    L = len(taps)
    taps_rev = np.asarray(taps, dtype=np.float32)[::-1]
    w0 = tail - decim - (L - 1)  # the tail's last FIR window
    lanes = FF.LANES
    A = np.zeros((2 * tail, END), dtype=np.float32)
    for k in range(tail):
        for row, coef in enumerate(_ROT[k % 4]):  # row 0: re, row 1: im
            for c, w in enumerate(coef):  # c 0: i, c 1: q
                if k >= tail - (L - 1):
                    A[2 * k + c, row * lanes + k - (tail - (L - 1))] = w
                if w0 <= k < w0 + L:
                    A[2 * k + c, (2 + row) * lanes + lanes - 1] = (
                        w * taps_rev[k - w0])
    div = np.ones(END, dtype=np.float32)
    div[[2 * lanes + lanes - 1, 3 * lanes + lanes - 1]] = 255.0
    return A, div


def record_matrix(design_taps: np.ndarray, eff_taps: np.ndarray, decim: int,
                  T: int) -> tuple[np.ndarray, np.ndarray]:
    """``([A | B] (2 tail, 512 + 2T), div)``: ``x @ [A | B] / div`` is the
    end-of-shard carry (:func:`end_state_matrix`) followed by the last T
    decimated samples, re then im, with K1's effective taps (which take
    x255 samples)."""
    L = len(eff_taps)
    tail = tail_samples(L, decim, T)
    A, div_a = end_state_matrix(design_taps, decim, tail)
    B = np.zeros((2 * tail, 2 * T), dtype=np.float32)
    eff = np.asarray(eff_taps, dtype=np.float32)
    y0 = tail - decim * T - (L - 1)  # window of the first of the T
    for r in range(T):
        for t in range(L):
            k = y0 + decim * r + t
            for row, coef in enumerate(_ROT[k % 4]):
                for c, w in enumerate(coef):
                    B[2 * k + c, row * T + r] += w * eff[t]
    div = np.concatenate([div_a, np.ones(2 * T, dtype=np.float32)])
    return np.concatenate([A, B], axis=1), div


class HaloParams(NamedTuple):
    """One device's tables: the plain version's matrix and divisor, the
    kernel's two tap sets, and the record's geometry."""

    matrix: torch.Tensor    # (2 tail, 512 + 2T)
    div: torch.Tensor       # (512 + 2T,)
    taps: torch.Tensor      # K1's effective taps (L,)
    end_taps: torch.Tensor  # the design taps reversed (L,)
    decim: int
    T: int
    tail: int
    record: int


def make_params(config: WbfmConfig | None = None, *,
                device: str | torch.device) -> HaloParams:
    config = config or WbfmConfig()
    spec = FF.default_spec(config)
    design_taps = design.decimator_taps(config)
    eff, _ = FF.make_kernel_params(config, device="cpu")
    m, div = record_matrix(design_taps, eff.numpy(), spec.decim,
                           spec.taps_per_phase)
    T = spec.taps_per_phase
    end_taps = np.ascontiguousarray(
        np.asarray(design_taps, dtype=np.float32)[::-1])
    return HaloParams(
        torch.from_numpy(m).to(device), torch.from_numpy(div).to(device),
        eff.to(device), torch.from_numpy(end_taps).to(device), spec.decim, T,
        tail_samples(len(eff), spec.decim, T), record_floats(T))


def records_reference(shard: torch.Tensor, p: HaloParams) -> torch.Tensor:
    """Plain version: the (stations, record) records of one (stations,
    bytes) u8 shard."""
    st, nbytes = shard.shape
    x = shard[:, nbytes - 2 * p.tail:].to(torch.float32) * 2.0 - 255.0
    out = x @ p.matrix / p.div
    y_re = out[:, END:END + p.T]
    y_im = out[:, END + p.T:]
    b_re, b_im = y_re[:, :-1], y_im[:, :-1]
    c_re = y_re[:, 1:] * b_re + y_im[:, 1:] * b_im
    c_im = y_im[:, 1:] * b_re - y_re[:, 1:] * b_im
    z = FF.atan2_poly6(c_im, c_re) * (1.0 / math.pi)
    pad = out.new_zeros(st, p.record - END - (p.T - 1))
    return torch.cat([out[:, :END], z, pad], dim=1)


def _check_shards(shards: Sequence[torch.Tensor], p: HaloParams) -> None:
    x0 = shards[0]
    if x0.dim() != 2:
        raise ValueError(f"a shard is (stations, bytes), got {tuple(x0.shape)}")
    for i, x in enumerate(shards):
        if x.shape != x0.shape or x.dtype != torch.uint8:
            raise ValueError(f"shard {i} ({tuple(x.shape)}, {x.dtype}) does "
                             f"not match shard 0's u8 {tuple(x0.shape)}")
    nbytes = x0.shape[1]
    if nbytes % 8 or nbytes < 2 * p.tail:
        raise ValueError(f"a shard of {nbytes} bytes a station is not a whole "
                         f"number of 4-sample groups of at least {p.tail} "
                         f"samples")


def shard_halo(shards: Sequence[torch.Tensor],
               params: Mapping[torch.device, HaloParams]
               ) -> list[torch.Tensor]:
    """The (stations, record) halo record of each (stations, bytes) u8
    shard of a row, on the shard's own place; ``params`` holds each place's
    tables.  CUDA shards: one kernel launch per device, at most
    :data:`MAX_SHARDS` shards a device."""
    if not shards:
        raise ValueError("an empty row of shards")
    p0 = params[shards[0].device]
    _check_shards(shards, p0)
    if not kernels.on_cuda(shards[0]):
        return [records_reference(x, params[x.device]) for x in shards]
    st, nbytes = shards[0].shape
    by_device: dict[torch.device, list[int]] = {}
    for i, x in enumerate(shards):
        if x.device.type != "cuda":
            raise ValueError(f"shard {i} is on {x.device}; the row is on CUDA")
        kernels.check_tensor(x, f"shard {i}", torch.uint8, x.device)
        by_device.setdefault(x.device, []).append(i)
    lib = kernels.load().cdll
    out: list = [None] * len(shards)
    for dev, idx in by_device.items():
        if len(idx) > MAX_SHARDS:
            raise ValueError(f"{len(idx)} shards on {dev}; one launch takes at "
                             f"most {MAX_SHARDS}")
        p = params[dev]
        for name, t in (("taps", p.taps), ("end_taps", p.end_taps)):
            kernels.check_tensor(t, name, torch.float32, dev, (t.numel(),))
        rec = torch.empty(len(idx), st, p.record, dtype=torch.float32,
                          device=dev)
        ptrs = (ctypes.c_void_p * len(idx))(*[shards[i].data_ptr()
                                              for i in idx])
        with torch.cuda.device(dev):
            status = lib.tsdr_shard_halo(
                len(idx), ptrs, st, nbytes, p.tail, p.taps.data_ptr(),
                p.end_taps.data_ptr(), p.taps.numel(), p.decim, p.T, p.record,
                rec.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(status, "shard_halo")
        LAUNCHES["shard_halo"] += 1
        for k, i in enumerate(idx):
            out[i] = rec[k]
    return out
