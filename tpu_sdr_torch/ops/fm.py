"""WBFM float ops in plain PyTorch — the counterpart of ``tpu_sdr/ops/fm.py``.

The stages of the float receive chain, each a function of tensors with an
explicit carry:

* u8 I/Q -> centred float32,
* fs/4 rotation by the sign/swap pattern ``j**(k+phase)``,
* the decimating FIR as chunked banded matmuls (float32),
* the quadrature discriminator with the exact ``atan2``,
* the phase-aligned frame-matmul polyphase resampler.

These are the port's executable specification: the float chain
(``models.wbfm``) is built from them, and ``aligned_resample`` is the plain
version of the resampler kernel.  Nothing here goes through ``conv1d``
(cuDNN would run it in TF32 on a GPU); the FIR is an unfold + matmul.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def u8_to_f32(buf: torch.Tensor, scale: float = 1.0 / 127.5
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """u8 interleaved I/Q -> (re, im) float32 centred at 0, ~[-1, 1]."""
    iq = buf.reshape(-1, 2).to(torch.float32)
    offset = 127.5 * scale
    return iq[:, 0] * scale - offset, iq[:, 1] * scale - offset


def rotate_fs4(re: torch.Tensor, im: torch.Tensor, phase: int
               ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Multiply sample k (along the last axis) by ``j**(k+phase)`` (shifts
    the spectrum by fs/4); returns the rotated pair and the phase of the
    next block's first sample."""
    n = re.shape[-1]
    k = (torch.arange(n, device=re.device) + phase) % 4
    # j**k: 0 -> (re, im); 1 -> (-im, re); 2 -> (-re, -im); 3 -> (im, -re)
    out_re = torch.where(k == 0, re, torch.where(
        k == 1, -im, torch.where(k == 2, -re, im)))
    out_im = torch.where(k == 0, im, torch.where(
        k == 1, re, torch.where(k == 2, -im, -re)))
    return out_re, out_im, (phase + n) % 4


class FirState(NamedTuple):
    """Last ``taps-1`` input samples (re, im): the overlap-save history."""

    hist_re: torch.Tensor
    hist_im: torch.Tensor


def fir_init(num_taps: int, device: torch.device) -> FirState:
    z = torch.zeros(num_taps - 1, dtype=torch.float32, device=device)
    return FirState(z, z.clone())


def banded_decim_apply(xext: torch.Tensor, W: torch.Tensor, decim: int,
                       m: int, chunk_out: int = 128) -> torch.Tensor:
    """``y[b, k] = sum_j taps_rev[j] * xext[b, k*decim + j]`` for k < m, as
    frames (B, nchunks, row_len) @ W (row_len, chunk_out), float32."""
    B = xext.shape[0]
    row_len = W.shape[0]
    step = chunk_out * decim
    nchunks = -(-m // chunk_out)
    need = (nchunks - 1) * step + row_len
    if xext.shape[1] < need:
        xext = torch.nn.functional.pad(xext, (0, need - xext.shape[1]))
    frames = xext.unfold(1, row_len, step)[:, :nchunks]  # (B, nchunks, row_len)
    y = torch.matmul(frames, W)
    return y.reshape(B, nchunks * chunk_out)[:, :m]


def fir_decimate_mxu(re: torch.Tensor, im: torch.Tensor, W: torch.Tensor,
                     num_taps: int, decim: int, state: FirState,
                     chunk_out: int = 128):
    """Streaming decimating FIR as chunked banded matmuls; block length
    must be a multiple of ``decim``.  Returns (re, im, new_state)."""
    n = re.shape[0]
    if n % decim:
        raise ValueError(f"block of {n} samples is not a multiple of {decim}")
    x = torch.stack([torch.cat([state.hist_re, re]),
                     torch.cat([state.hist_im, im])])  # (2, n + L - 1)
    y = banded_decim_apply(x, W, decim, n // decim, chunk_out)
    return y[0], y[1], FirState(x[0, n:], x[1, n:])


class QuadState(NamedTuple):
    """Previous complex sample of the discriminator."""

    pre_re: torch.Tensor
    pre_im: torch.Tensor


def quad_init(device: torch.device) -> QuadState:
    return QuadState(torch.tensor(1.0, device=device),
                     torch.tensor(0.0, device=device))


def quadrature_demod(re: torch.Tensor, im: torch.Tensor, state: QuadState,
                     gain: float = 1.0):
    """``y[k] = gain * angle(x[k] * conj(x[k-1])) / pi`` with the exact
    ``atan2`` and the carried previous sample, along the last axis: x of
    shape (n,) with a scalar state, or (S, n) stations with (S,) states.
    Returns (y, new_state)."""
    b_re = torch.cat([state.pre_re[..., None], re[..., :-1]], dim=-1)
    b_im = torch.cat([state.pre_im[..., None], im[..., :-1]], dim=-1)
    c_re = re * b_re + im * b_im
    c_im = im * b_re - re * b_im
    y = torch.atan2(c_im, c_re) * (gain / math.pi)
    return y, QuadState(re[..., -1], im[..., -1])


class AlignedResampleState(NamedTuple):
    hist: torch.Tensor  # (T-1,) trailing inputs; (S, T-1) for S stations


def aligned_resample_init(T: int, device: torch.device) -> AlignedResampleState:
    return AlignedResampleState(
        torch.zeros(T - 1, dtype=torch.float32, device=device))


def aligned_resample(x: torch.Tensor, V: torch.Tensor, up: int, down: int,
                     state: AlignedResampleState):
    """Frame-matmul resampler along the last axis of x ((n,), or (S, n)
    stations with an (S, T-1) history): n must be a multiple of the frame
    span (``down`` times V's frames per row); emits ``n//down*up`` samples
    per station in frame-major order.  Returns (audio, new_state)."""
    F_ = V.shape[1] // up
    span = down * F_
    Tm1 = V.shape[0] - span
    n = x.shape[-1]
    if n % span:
        raise ValueError(f"block of {n} not divisible by span={span}")
    xe = torch.cat([state.hist, x], dim=-1)
    frames = xe.unfold(-1, span + Tm1, span)  # (..., R, Tm1 + span) windows
    y = torch.matmul(frames, V)
    return y.flatten(-2), AlignedResampleState(xe[..., n:])
