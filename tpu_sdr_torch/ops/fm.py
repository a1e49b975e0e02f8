"""WBFM float ops in plain PyTorch — the counterpart of ``tpu_sdr/ops/fm.py``.

The stages of the float receive chain, each a function of tensors with an
explicit carry, and each along the last axis with any leading (station)
axes:

* u8 I/Q -> centred float32,
* fs/4 rotation by the sign/swap pattern ``j**(k+phase)``,
* the decimating FIR as chunked banded matmuls (float32), or the boxcar
  sum of the reference (``boxcar_decimate_f32``),
* the quadrature discriminator with the exact ``atan2`` or the reference's
  fast approximation (``atan_mode``),
* the phase-aligned frame-matmul resampler (the polyphase bank or the
  boxcar window), and the unaligned ones: the polyphase resampler with its
  output phase ``t0`` and the boxcar resampler with its index carry,
* single-pole de-emphasis as a log-depth scan,
* the decim-1 FIR of one real signal and the integer delay line of the
  stereo and RDS decoders.

These are the port's executable specification: the float chain
(``models.wbfm``) is built from them, and ``aligned_resample`` is the plain
version of the resampler kernel.  Nothing here goes through ``conv1d``
(cuDNN would run it in TF32 on a GPU); the FIR is an unfold + matmul.
Where the JAX carry holds an index that only the block sizes move (the
resampler's ``t0``, the boxcar resampler's accumulator), the port keeps it
as a Python int, so output counts are known without waiting for the
device; data carries are tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def u8_to_f32(buf: torch.Tensor, scale: float = 1.0 / 127.5
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """u8 interleaved I/Q (along the last axis) -> (re, im) float32 centred
    at 0, ~[-1, 1]."""
    iq = buf.reshape(*buf.shape[:-1], -1, 2).to(torch.float32)
    offset = 127.5 * scale
    return iq[..., 0] * scale - offset, iq[..., 1] * scale - offset


def rotate_fs4(re: torch.Tensor, im: torch.Tensor, phase
               ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Multiply sample k (along the last axis) by ``j**(k+phase)`` (shifts
    the spectrum by fs/4); returns the rotated pair and the phase of the
    next block's first sample.  ``phase``: an int, or an (S,) integer tensor
    of one phase a station for (S, n) samples."""
    n = re.shape[-1]
    if torch.is_tensor(phase):
        phase = phase.to(re.device)[..., None]
    k = (torch.arange(n, device=re.device) + phase) % 4
    # j**k: 0 -> (re, im); 1 -> (-im, re); 2 -> (-re, -im); 3 -> (im, -re)
    out_re = torch.where(k == 0, re, torch.where(
        k == 1, -im, torch.where(k == 2, -re, im)))
    out_im = torch.where(k == 0, im, torch.where(
        k == 1, re, torch.where(k == 2, -im, -re)))
    if torch.is_tensor(phase):
        phase = phase[..., 0]
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
    n = re.shape[-1]
    if n % decim:
        raise ValueError(f"block of {n} samples is not a multiple of {decim}")
    xr = torch.cat([state.hist_re, re], dim=-1)
    xi = torch.cat([state.hist_im, im], dim=-1)
    x = torch.stack([xr, xi])  # (2, ..., n + L - 1)
    y = banded_decim_apply(x.reshape(-1, x.shape[-1]), W, decim, n // decim,
                           chunk_out).reshape(*x.shape[:-1], -1)
    return y[0], y[1], FirState(xr[..., n:], xi[..., n:])


def fir_filter_mxu(x: torch.Tensor, W: torch.Tensor, state: FirState,
                   chunk_out: int = 128):
    """Streaming decim-1 FIR of a real signal as chunked banded matmuls:
    the JAX ``_fir1`` of the stereo and RDS models, which run the complex
    pair with a zero second row.  Only the real row is computed; the
    state's ``hist_im`` (all zeros there) is carried as it is.  Returns
    (y, new_state)."""
    n = x.shape[-1]
    xr = torch.cat([state.hist_re, x], dim=-1)
    y = banded_decim_apply(xr.reshape(-1, xr.shape[-1]), W, 1, n,
                           chunk_out).reshape(*xr.shape[:-1], n)
    return y, FirState(xr[..., n:], state.hist_im)


class DelayState(NamedTuple):
    """Last ``D`` samples: a streaming integer delay line."""

    hist: torch.Tensor


def delay_init(d: int, device: torch.device) -> DelayState:
    return DelayState(torch.zeros(d, dtype=torch.float32, device=device))


def delay(x: torch.Tensor, state: DelayState):
    """``out[k] = x[k - D]`` along the last axis, across block boundaries
    (the group-delay match of a multi-arm filter graph).  Returns (out,
    new_state)."""
    d = state.hist.shape[-1]
    xx = torch.cat([state.hist, x], dim=-1)
    return xx[..., :x.shape[-1]], DelayState(xx[..., xx.shape[-1] - d:])


def boxcar_decimate_f32(re: torch.Tensor, im: torch.Tensor, decim: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Float twin of the reference's ``low_pass_complex``: the sum of each
    group of ``decim`` samples (gain = decim, no divide).  The length must
    be a multiple of ``decim``, so no carry is needed."""
    n = re.shape[-1]
    if n % decim:
        raise ValueError(f"block of {n} samples is not a multiple of {decim}")
    return (re.reshape(*re.shape[:-1], n // decim, decim).sum(dim=-1),
            im.reshape(*im.shape[:-1], n // decim, decim).sum(dim=-1))


def fast_atan2_f32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Float twin of the reference's integer ``fast_atan2``, in radians: one
    divide, no transcendental; (0, 0) maps to 0."""
    pi4, pi34 = math.pi / 4, 3 * math.pi / 4
    yabs = y.abs()
    den_pos = x + yabs
    den_neg = yabs - x
    den_pos = torch.where(den_pos == 0, 1.0, den_pos)
    den_neg = torch.where(den_neg == 0, 1.0, den_neg)
    angle = torch.where(x >= 0, pi4 - pi4 * (x - yabs) / den_pos,
                        pi34 - pi4 * (x + yabs) / den_neg)
    angle = torch.where(y < 0, -angle, angle)
    return torch.where((x == 0) & (y == 0), 0.0, angle)


class QuadState(NamedTuple):
    """Previous complex sample of the discriminator."""

    pre_re: torch.Tensor
    pre_im: torch.Tensor


def quad_init(device: torch.device) -> QuadState:
    return QuadState(torch.tensor(1.0, device=device),
                     torch.tensor(0.0, device=device))


def quadrature_demod(re: torch.Tensor, im: torch.Tensor, state: QuadState,
                     gain: float = 1.0, atan_mode: str = "exact"):
    """``y[k] = gain * angle(x[k] * conj(x[k-1])) / pi`` with the carried
    previous sample, along the last axis: x of shape (n,) with a scalar
    state, or (S, n) stations with (S,) states.  ``atan_mode``: ``exact``
    (``atan2``) or ``fast`` (the reference's approximation, the boxcar
    chain's).  Returns (y, new_state)."""
    b_re = torch.cat([state.pre_re[..., None], re[..., :-1]], dim=-1)
    b_im = torch.cat([state.pre_im[..., None], im[..., :-1]], dim=-1)
    c_re = re * b_re + im * b_im
    c_im = im * b_re - re * b_im
    if atan_mode == "fast":
        ang = fast_atan2_f32(c_im, c_re)
    elif atan_mode == "exact":
        # rows padded to whole vectors: on the CPU the vectorised atan2 and
        # its scalar tail differ in the last bit, so a station's samples
        # take the vector path wherever they sit in a batch
        n = c_re.shape[-1]
        pad = (0, -n % 64)
        ang = torch.atan2(torch.nn.functional.pad(c_im, pad),
                          torch.nn.functional.pad(c_re, pad))[..., :n]
    else:
        raise ValueError(f"atan_mode {atan_mode!r} is not exact or fast")
    y = ang * (gain / math.pi)
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


class ResampleState(NamedTuple):
    """The polyphase resampler's carry: the last ``T-1`` inputs and the
    output phase ``t0`` (the next output's place on the up-sampled grid,
    relative to the next block's start; 0 on the aligned path)."""

    hist: torch.Tensor  # (T-1,), or (S, T-1)
    t0: int


def resample_init(T: int, device: torch.device) -> ResampleState:
    return ResampleState(torch.zeros(T - 1, dtype=torch.float32,
                                     device=device), 0)


def polyphase_count(n: int, up: int, down: int, t0: int) -> int:
    """The outputs :func:`polyphase_resample` gives for n inputs from
    output phase ``t0``."""
    return max((n * up - t0 + down - 1) // down, 0)


def polyphase_resample(x: torch.Tensor, h_poly: torch.Tensor, up: int,
                       down: int, state: ResampleState,
                       t0_index: torch.Tensor | None = None):
    """Rational ``up/down`` resampler for any block length, along the last
    axis.  ``h_poly[p, t] = h[p + t*up]``; output m lands at up-sampled
    time ``t0 + m*down`` with ``q = time // up``, ``p = time % up``::

        y[m] = sum_t h_poly[p, t] * x[q - t]

    One gather of every output's window and one contraction.  Returns
    (y, new_state): y holds exactly this block's outputs.  ``t0_index``:
    ``state.t0`` as a 0-d int64 tensor on x's device, which the index
    arithmetic then reads (the same values): a graphed step replays for
    any ``t0`` that gives the same output count."""
    up_, T = h_poly.shape
    if up_ != up:
        raise ValueError(f"h_poly has {up_} phases, not {up}")
    n = x.shape[-1]
    t0 = state.t0
    count = polyphase_count(n, up, down, t0)
    xx = torch.cat([state.hist, x], dim=-1)  # (..., T-1+n)
    tt = (t0 if t0_index is None else t0_index) + torch.arange(
        count, device=x.device) * down
    q, p = tt // up, tt % up
    win = q[:, None] + (T - 1) - torch.arange(T, device=x.device)[None, :]
    windows = xx[..., win]  # (..., count, T)
    y = (windows * h_poly[p]).sum(dim=-1)
    return y, ResampleState(xx[..., n:], t0 + count * down - n * up)


class BoxcarResampleState(NamedTuple):
    """Float twin of the reference resampler's carry: the running sum and
    the fractional index accumulator in [0, rate_out)."""

    now: torch.Tensor  # f32 scalar, or (S,)
    acc: int


def boxcar_resample_init(device: torch.device) -> BoxcarResampleState:
    return BoxcarResampleState(torch.zeros((), dtype=torch.float32,
                                           device=device), 0)


def boxcar_count(n: int, acc: int, rate_out: int, rate_resample: int
                 ) -> int:
    """The outputs :func:`boxcar_resample_f32` gives for n inputs from the
    accumulator ``acc``."""
    return (acc + n * int(rate_resample)) // int(rate_out)


def boxcar_resample_f32(x: torch.Tensor, state: BoxcarResampleState,
                        rate_out: int, rate_resample: int,
                        acc_index: torch.Tensor | None = None):
    """Float twin of the reference's ``low_pass_real`` along the last axis:
    accumulate ``slow`` a sample, emit the mean (sum / (fast // slow)) at
    each ``fast`` crossing, through the same closed-form emission indices
    as the exact chain (cumsum + gather).  Returns (y, new_state), y
    exactly this block's outputs.  ``acc_index``: ``state.acc`` as a 0-d
    int64 tensor on x's device for the index arithmetic, as
    :func:`polyphase_resample`'s ``t0_index``."""
    fast, slow = int(rate_out), int(rate_resample)
    n = x.shape[-1]
    a = state.acc
    total = a + n * slow
    count = boxcar_count(n, a, fast, slow)
    cs = state.now[..., None] + torch.cumsum(x.to(torch.float32), dim=-1)
    j = torch.arange(count, device=x.device)
    e = (((j + 1) * fast - (a if acc_index is None else acc_index))
         + slow - 1) // slow - 1
    cs_at_e = cs[..., e]
    prev = torch.cat([torch.zeros_like(cs[..., :1]), cs_at_e[..., :-1]],
                     dim=-1)
    y = (cs_at_e - prev) / float(fast // slow)
    consumed = cs_at_e[..., -1] if count else torch.zeros_like(cs[..., 0])
    return y, BoxcarResampleState(cs[..., -1] - consumed, total - count * fast)


class DeemphState(NamedTuple):
    y_prev: torch.Tensor  # f32 scalar, or (S,)


def deemph_init(device: torch.device) -> DeemphState:
    return DeemphState(torch.zeros((), dtype=torch.float32, device=device))


def deemphasis(x: torch.Tensor, alpha: float, state: DeemphState):
    """``y[k] = y[k-1] + alpha*(x[k] - y[k-1])`` along the last axis, as a
    log-depth scan with no loop over samples: the first-order recurrence
    ``y[k] = a*y[k-1] + b[k]`` composes associatively, ``(a1, b1)`` then
    ``(a2, b2)`` is ``(a1*a2, a2*b1 + b2)``, so ``log2 n`` doubling steps
    (Hillis-Steele) give every prefix; the products of ``a`` only shrink
    toward 0, never divide.  Its sums run in another order than JAX's
    ``associative_scan``: the two agree to a tolerance, not bit for bit."""
    a = torch.full_like(x, float(np.float32(1.0 - alpha)))
    b = x * float(np.float32(alpha))
    n, d = x.shape[-1], 1
    while d < n:
        b = torch.cat([b[..., :d], b[..., d:] + a[..., d:] * b[..., :-d]],
                      dim=-1)
        a = torch.cat([a[..., :d], a[..., d:] * a[..., :-d]], dim=-1)
        d *= 2
    y = a * state.y_prev[..., None] + b
    return y, DeemphState(y[..., -1])


def deemph_alpha(fs: float, tau: float = 75e-6) -> float:
    """De-emphasis coefficient for time constant ``tau`` at rate ``fs``."""
    return float(1.0 - np.exp(-1.0 / (fs * tau)))
