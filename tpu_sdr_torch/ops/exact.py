"""Bit-exact integer WBFM ops in plain PyTorch — the counterpart of
``tpu_sdr/ops/exact.py``, the conformance path.

Sample for sample the integer DSP of the reference ``simple_fm``
(``rtl_fm``'s chain):

* fs/4 rotation as the u8 byte map with ``255 - x`` negation,
* the stateful boxcar decimator (``low_pass_complex``),
* the quadrature discriminator: the exact atan2 (float64) on the first
  sample of every block, the integer ``fast_atan2`` on the rest,
* the stateful boxcar audio resampler with its fractional-index carry
  (``low_pass_real``).

As in the JAX package every op is a function of tensors with an explicit
carry of 0-d int32 tensors, and outputs are padded to a static maximum
with the valid count beside them as a 0-d tensor: nothing waits for the
device until a caller trims.  The golden vectors of the original C
``rtl_fm`` (``tests/golden_vectors.py``) hold each stage bit for bit.

Nothing here reads a device value on the host: an element picked by a
0-d index tensor is gathered (:func:`_at`), never indexed with Python's
``[]``, which would turn the index into a host int.  So a block is one
CUDA graph capture (``models.wbfm_exact.WbfmExactStreamer``).

The integer semantics are made explicit rather than left to a dtype: the
products and sums that may pass 2^31 run in int64 and are wrapped to the
int32 range arithmetically (:func:`wrap_i32`), as a Rust ``as i32`` or a
two's-complement int32 op wraps; divisions truncate toward zero
(:func:`trunc_div`); ``as i16`` is :func:`wrap_i16`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_I64 = torch.int64


def wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to the int32 range (two's complement), int64."""
    return ((v + 2 ** 31) & (2 ** 32 - 1)) - 2 ** 31


def wrap_i16(v: torch.Tensor) -> torch.Tensor:
    """Integer values wrapped to int16 (``as i16``), as int16."""
    return (((v.to(_I64) + 2 ** 15) & (2 ** 16 - 1)) - 2 ** 15).to(torch.int16)


def trunc_div(a: torch.Tensor, b) -> torch.Tensor:
    """Integer division truncating toward zero (Rust ``/`` on i32)."""
    return torch.div(a, b, rounding_mode="trunc")


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, as a 0-d tensor, without a sync."""
    return x.index_select(0, i.reshape(1)).reshape(())


def rotate_90_u8(buf: torch.Tensor) -> torch.Tensor:
    """The reference's fs/4 shift on raw u8 I/Q bytes: over each group of 8
    bytes (4 complex samples), with negation the u8 map ``255 - x``::

        out = [b0, b1, 255-b3, b2, 255-b4, 255-b5, b7, 255-b6]

    The length must be a multiple of 8."""
    if buf.dtype != torch.uint8:
        raise TypeError(f"rotate_90_u8 takes uint8 bytes, not {buf.dtype}")
    n = buf.shape[0]
    if n % 8:
        raise ValueError(f"{n} bytes is not a multiple of 8")
    g = buf.reshape(n // 8, 8)
    neg = 255 - g
    return torch.stack([g[:, 0], g[:, 1], neg[:, 3], g[:, 2], neg[:, 4],
                        neg[:, 5], g[:, 7], neg[:, 6]], dim=1).reshape(n)


def u8_to_complex_i32(buf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """u8 interleaved I/Q -> (re, im) int32, offset by -127 (``*val as i16
    - 127``)."""
    s = buf.to(torch.int32) - 127
    return s[0::2], s[1::2]


class BoxcarState(NamedTuple):
    """Carry of the complex boxcar decimator (``prev_index``, ``lp_now``):
    ``lp_*`` sums the last ``prev_index`` unconsumed samples."""

    prev_index: torch.Tensor  # int32, in [0, downsample)
    lp_re: torch.Tensor       # int32
    lp_im: torch.Tensor       # int32


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def boxcar_init(device: str | torch.device) -> BoxcarState:
    return BoxcarState(_zero(device), _zero(device), _zero(device))


def boxcar_decimate(re: torch.Tensor, im: torch.Tensor, state: BoxcarState,
                    downsample: int):
    """Sum groups of ``downsample`` consecutive complex samples, one output
    a group (gain = downsample), carrying the partial group across blocks.

    The carried partial sum sits at position 0 of a zero buffer, the block
    at offset ``prev_index``; one reshape-sum gives every group.  Returns
    ``(out_re, out_im, count, new_state)``: the outputs padded to the
    static number of groups, ``out[:count]`` valid."""
    n = re.shape[0]
    d = int(downsample)
    n_groups = -(-(n + d - 1) // d)
    offset = state.prev_index.to(_I64)
    pos = torch.arange(n_groups * d, device=re.device)
    k = pos - offset
    inside = (k >= 0) & (k < n)
    k = k.clamp(0, max(n - 1, 0))

    def place(x, carry_sum):
        v = torch.where(inside, x[k].to(_I64),
                        torch.where(pos == 0, carry_sum.to(_I64), 0))
        return wrap_i32(v.reshape(n_groups, d).sum(dim=1))

    groups_re = place(re, state.lp_re)
    groups_im = place(im, state.lp_im)
    total = offset + n
    count = total // d
    new_prev = total - count * d
    # the trailing partial group's sum (zeros beyond the data)
    last = count.clamp(max=n_groups - 1)
    tail_re = torch.where(new_prev > 0, _at(groups_re, last), 0)
    tail_im = torch.where(new_prev > 0, _at(groups_im, last), 0)
    i32 = torch.int32
    return (groups_re.to(i32), groups_im.to(i32), count.to(i32),
            BoxcarState(new_prev.to(i32), tail_re.to(i32), tail_im.to(i32)))


class DiscriminatorState(NamedTuple):
    """``demod_pre``: the last complex sample of the previous block."""

    pre_re: torch.Tensor  # int32
    pre_im: torch.Tensor  # int32


def discriminator_init(device: str | torch.device) -> DiscriminatorState:
    return DiscriminatorState(_zero(device), _zero(device))


_PI_SCALE = 1 << 14  # pi == 2^14 in the reference's fixed point


def fast_atan2_i32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference's integer ``fast_atan2``, exactly: pi is 2^14 (pi/4 =
    4096, 3pi/4 = 12288); the product ``pi4 * (x -/+ |y|)`` is formed in
    int64 and wrapped to int32 BEFORE the truncating division; (0, 0) maps
    to 0.  Takes and returns int32."""
    pi4, pi34 = 1 << 12, 3 * (1 << 12)
    x64, y64 = x.to(_I64), y.to(_I64)
    yabs = wrap_i32(y64.abs())
    num_pos = wrap_i32(pi4 * wrap_i32(x64 - yabs))
    num_neg = wrap_i32(pi4 * wrap_i32(x64 + yabs))
    den_pos = wrap_i32(x64 + yabs)
    den_neg = wrap_i32(yabs - x64)
    # zero denominators only in the (0, 0) lane, masked below
    den_pos = torch.where(den_pos == 0, 1, den_pos)
    den_neg = torch.where(den_neg == 0, 1, den_neg)
    angle = torch.where(x64 >= 0, pi4 - trunc_div(num_pos, den_pos),
                        pi34 - trunc_div(num_neg, den_neg))
    angle = torch.where(y64 < 0, -angle, angle)
    angle = torch.where((x64 == 0) & (y64 == 0), 0, angle)
    return wrap_i32(angle).to(torch.int32)


def exact_atan2_scaled(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``(atan2(y, x) / pi * 2^14) as i32`` in float64, truncated toward
    zero, as the reference's f64 path (and the JAX chain under x64)."""
    f64 = torch.float64
    scaled = torch.atan2(y.to(f64), x.to(f64)) / math.pi * _PI_SCALE
    return torch.trunc(scaled).to(torch.int32)


def fm_discriminate(re: torch.Tensor, im: torch.Tensor, count: torch.Tensor,
                    state: DiscriminatorState):
    """Polar discriminant ``angle(a * conj(b))`` over a block: the first
    sample against the carried ``demod_pre`` with the exact atan2, the rest
    with ``fast_atan2``.  ``count`` valid samples of the padded re/im; the
    int16 output is padded alike.  Returns ``(out, count, new_state)``."""
    b_re = torch.cat([state.pre_re[None], re[:-1]]).to(_I64)
    b_im = torch.cat([state.pre_im[None], im[:-1]]).to(_I64)
    a_re, a_im = re.to(_I64), im.to(_I64)
    c_re = wrap_i32(a_re * b_re + a_im * b_im)
    c_im = wrap_i32(a_im * b_re - a_re * b_im)
    out = fast_atan2_i32(c_im, c_re)
    out = torch.cat([exact_atan2_scaled(c_im[:1], c_re[:1]), out[1:]])
    last = (count.to(_I64) - 1).clamp(min=0)
    return wrap_i16(out), count, DiscriminatorState(_at(re, last),
                                                      _at(im, last))


class ResamplerState(NamedTuple):
    """``now_lpr`` / ``prev_lpr_index``: the running sum and the fractional
    index accumulator."""

    now_lpr: torch.Tensor         # int32
    prev_lpr_index: torch.Tensor  # int32, in [0, rate_out)


def resampler_init(device: str | torch.device) -> ResamplerState:
    return ResamplerState(_zero(device), _zero(device))


def boxcar_resample(x: torch.Tensor, count: torch.Tensor,
                    state: ResamplerState, rate_out: int, rate_resample: int):
    """Square-window resampler ``rate_out -> rate_resample`` with the
    fractional index carry: accumulate ``slow`` a sample and emit (sum /
    (fast // slow), truncated) at each ``fast`` crossing.  Emission j ends
    at ``e_j = ceil(((j+1)*fast - a) / slow) - 1``, so the op is one cumsum
    and two gathers.  Only ``x[:count]`` is consumed; returns ``(out
    (int16, padded), out_count, new_state)``."""
    fast, slow = int(rate_out), int(rate_resample)
    n_max = x.shape[0]
    m_max = (n_max * slow) // fast + 1
    dev = x.device
    a = state.prev_lpr_index.to(_I64)
    count = count.to(_I64)
    x64 = torch.where(torch.arange(n_max, device=dev) < count, x.to(_I64), 0)
    cs = state.now_lpr.to(_I64) + torch.cumsum(x64, dim=0)
    total_acc = a + count * slow
    out_count = total_acc // fast
    new_a = total_acc - out_count * fast
    j = torch.arange(m_max, device=dev)
    e = (((j + 1) * fast - a) + slow - 1) // slow - 1
    cs_at_e = cs[e.clamp(0, n_max - 1)]
    prev_cs = torch.cat([torch.zeros(1, dtype=_I64, device=dev), cs_at_e[:-1]])
    sums = wrap_i32(cs_at_e - prev_cs)
    out = wrap_i16(trunc_div(sums, fast // slow))
    last_total = torch.where(count > 0, _at(cs, (count - 1).clamp(min=0)),
                             state.now_lpr.to(_I64))
    consumed = torch.where(out_count > 0,
                           _at(cs_at_e, (out_count - 1).clamp(min=0)), 0)
    new_now = wrap_i32(last_total - consumed)
    i32 = torch.int32
    return out, out_count.to(i32), ResamplerState(new_now.to(i32),
                                                  new_a.to(i32))
