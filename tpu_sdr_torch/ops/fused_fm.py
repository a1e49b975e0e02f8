"""Fused single-station WBFM chain: two CUDA kernels and their plain
versions — the counterpart of the single-station half of
``tpu_sdr/ops/pallas_fm.py``.

    u8 bytes --K1 fm_front--> z (170 kHz discriminator output)
             --K2 fm_resample--> audio (32 kHz)

K1 (``csrc/fm_front.cu``) unpacks, rotates by fs/4 from a phase argument,
runs the 72-tap ÷6 FIR with the TPU kernel's effective taps and the
discriminator with its 6-term atan.  K2 (``csrc/fm_resample.cu``) is the
16/85 polyphase resampler.  Each wrapper launches its kernel for a CUDA
tensor (or raises), takes its plain PyTorch version for a CPU tensor, and
counts its launches in :data:`LAUNCHES`.

State keeps the JAX package's layout so it converts 1:1: the (4, 128) f32
carry of :func:`pack_state`, the (T-1,) resampler history and the fs/4
phase of the next byte.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tpu_sdr_torch import kernels
from tpu_sdr_torch.models import wbfm as M
from tpu_sdr_torch.ops import fm as F
from tpu_sdr_torch.utils import design
from tpu_sdr_torch.utils.design import WbfmConfig

STATE_ROWS = 4
LANES = 128

# Kernel launches per wrapper: the main path's proof that it ran the
# kernels.  Only the wrappers' CUDA branches add to these.
LAUNCHES = {"fm_front": 0, "fm_resample": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class FusedWbfmSpec(NamedTuple):
    """Static geometry of the fused chain."""

    decim: int
    num_taps: int
    up: int
    down: int
    taps_per_phase: int  # resampler T

    @property
    def chunk_complex(self) -> int:
        """Complex samples per streaming chunk (128*down decimated outputs,
        the JAX kernel's grid step; 65,280 by default)."""
        return 128 * self.down * self.decim

    @property
    def chunk_bytes(self) -> int:
        return 2 * self.chunk_complex

    @property
    def audio_per_chunk(self) -> int:
        return 128 * self.up

    def validate(self) -> None:
        if self.num_taps - 1 > LANES:
            raise ValueError(f"FIR history of {self.num_taps - 1} samples "
                             f"exceeds the carry's {LANES} lanes")


def default_spec(config: WbfmConfig | None = None) -> FusedWbfmSpec:
    config = config or WbfmConfig()
    spec = FusedWbfmSpec(config.decim, config.num_taps, config.resample_up,
                         config.resample_down, config.resample_taps_per_phase)
    spec.validate()
    return spec


def effective_taps(w_hi, w_lo, num_taps: int) -> torch.Tensor:
    """The TPU kernel's split-bf16 banded weights as one set of f32 taps:
    column 0, rows [0, num_taps) of W_hi + W_lo (the sum is exact in f32),
    i.e. the reversed FIR scaled by 1/255 for samples in the x255 scale."""
    return design.split_bf16_sum(w_hi, w_lo)[:num_taps, 0].contiguous()


def make_kernel_params(config: WbfmConfig | None = None, *,
                       device: str | torch.device
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(taps (L,), h_poly (up, T)) f32 on ``device``."""
    config = config or WbfmConfig()
    W = design.make_banded_decim_matrix(design.decimator_taps(config),
                                        config.decim)
    w_hi, w_lo = design.make_split_bf16(W)
    taps = effective_taps(w_hi, w_lo, config.num_taps)
    h_poly = torch.from_numpy(design.resampler_poly(config))
    return taps.to(device), h_poly.to(device)


def init_carry(device: str | torch.device) -> torch.Tensor:
    """Fresh stream: zero FIR history, previous sample 1 + 0j."""
    carry = torch.zeros(STATE_ROWS, LANES, dtype=torch.float32, device=device)
    carry[2, LANES - 1] = 1.0
    return carry


def pack_state(state: M.WbfmState, spec: FusedWbfmSpec) -> torch.Tensor:
    """Float-chain state -> (4, 128) carry (FIR history in the x255 scale)."""
    Lm1 = spec.num_taps - 1
    carry = torch.zeros(STATE_ROWS, LANES, dtype=torch.float32,
                        device=state.fir.hist_re.device)
    carry[0, :Lm1] = state.fir.hist_re * 255.0
    carry[1, :Lm1] = state.fir.hist_im * 255.0
    carry[2, LANES - 1] = state.quad.pre_re
    carry[3, LANES - 1] = state.quad.pre_im
    return carry


def unpack_state(carry: torch.Tensor, rot_phase: int,
                 resamp_hist: torch.Tensor, spec: FusedWbfmSpec) -> M.WbfmState:
    """(4, 128) carry + phase + resampler history -> float-chain state."""
    Lm1 = spec.num_taps - 1
    return M.WbfmState(
        int(rot_phase),
        F.FirState(carry[0, :Lm1] / 255.0, carry[1, :Lm1] / 255.0),
        F.QuadState(carry[2, LANES - 1], carry[3, LANES - 1]),
        F.AlignedResampleState(resamp_hist))


# 6-term equioscillating fit of atan(t)/t on [0, 1] (the TPU kernel's
# _ATAN6_COEFFS; max error 9.9e-6 rad).
ATAN6_COEFFS = (
    9.9999125472e-01, -3.3295015732e-01, 1.9558953030e-01, -1.2155903309e-01,
    5.8200158710e-02, -1.3883453812e-02,
)


def atan2_poly6(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Full-quadrant atan2 from the range-reduced 6-term polynomial."""
    ax, ay = x.abs(), y.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    t = lo / torch.where(hi == 0, 1.0, hi)
    s = t * t
    p = torch.full_like(s, ATAN6_COEFFS[-1])
    for c in ATAN6_COEFFS[-2::-1]:
        p = p * s + c
    r = p * t
    r = torch.where(ay > ax, math.pi / 2 - r, r)
    r = torch.where(x < 0, math.pi - r, r)
    r = torch.where(y < 0, -r, r)
    return torch.where((x == 0) & (y == 0), 0.0, r)


def fm_front_reference(data_u8: torch.Tensor, phase: int, carry: torch.Tensor,
                       taps: torch.Tensor, decim: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: 2n bytes -> (z (n/decim,) f32, new carry)."""
    n = data_u8.numel() // 2
    L = taps.numel()
    x = data_u8.reshape(n, 2).to(torch.float32) * 2.0 - 255.0  # x255 scale
    re, im, _ = F.rotate_fs4(x[:, 0], x[:, 1], phase)
    xr = torch.cat([carry[0, :L - 1], re])
    xi = torch.cat([carry[1, :L - 1], im])
    y_re = torch.matmul(xr.unfold(0, L, decim), taps)  # (n/decim,)
    y_im = torch.matmul(xi.unfold(0, L, decim), taps)
    b_re = torch.cat([carry[2, LANES - 1:], y_re[:-1]])
    b_im = torch.cat([carry[3, LANES - 1:], y_im[:-1]])
    c_re = y_re * b_re + y_im * b_im
    c_im = y_im * b_re - y_re * b_im
    z = atan2_poly6(c_im, c_re) * (1.0 / math.pi)
    new = carry.clone()
    new[0, :L - 1] = xr[n:]
    new[1, :L - 1] = xi[n:]
    new[2] = torch.cat([carry[2], y_re])[-LANES:]
    new[3] = torch.cat([carry[3], y_im])[-LANES:]
    return z, new


def _output(out: torch.Tensor | None, numel: int, device) -> torch.Tensor:
    """``out`` checked as a contiguous f32 vector of ``numel`` on ``device``,
    or a new one."""
    if out is None:
        return torch.empty(numel, dtype=torch.float32, device=device)
    kernels.check_tensor(out, "out", torch.float32, device, (numel,))
    return out


def fm_front(data_u8: torch.Tensor, phase: int, carry: torch.Tensor,
             taps: torch.Tensor, decim: int, out: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: u8 I/Q (2n bytes, n % decim == 0) at fs/4 ``phase`` with the
    (4, 128) ``carry`` and effective ``taps`` -> (z, new carry).  ``out``:
    an (n/decim,) f32 tensor to write z into (a row of a station batch)."""
    n = data_u8.numel() // 2
    if data_u8.numel() % 2 or n == 0 or n % decim:
        raise ValueError(f"{data_u8.numel()} bytes is not a positive whole "
                         f"number of {decim}-sample groups of I/Q pairs")
    if not 0 <= phase <= 3:
        raise ValueError(f"fs/4 phase {phase} not in 0..3")
    if not kernels.on_cuda(data_u8):
        z, new = fm_front_reference(data_u8, phase, carry, taps, decim)
        if out is not None:
            z = _output(out, z.numel(), z.device).copy_(z)
        return z, new
    dev = data_u8.device
    kernels.check_tensor(data_u8, "data", torch.uint8, dev)
    kernels.check_tensor(carry, "carry", torch.float32, dev, (STATE_ROWS, LANES))
    kernels.check_tensor(taps, "taps", torch.float32, dev, (taps.numel(),))
    if taps.numel() - 1 > LANES or data_u8.data_ptr() % 2:
        raise ValueError("taps exceed the carry, or data is not 2-byte aligned")
    lib = kernels.load().cdll
    z = _output(out, n // decim, dev)
    new = torch.empty_like(carry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.tsdr_fm_front(
            data_u8.data_ptr(), n, phase, carry.data_ptr(), taps.data_ptr(),
            taps.numel(), decim, z.data_ptr(), new.data_ptr(), stream)
    kernels.check(status, "fm_front")
    LAUNCHES["fm_front"] += 1
    return z, new


def aligned_poly_matrix(h_poly: torch.Tensor, down: int) -> torch.Tensor:
    """The frame matrix V (down + T - 1, up) of ``design.make_aligned_poly_matrix``
    built on ``h_poly``'s device."""
    up, T = h_poly.shape
    dev = h_poly.device
    s = torch.arange(up, device=dev)
    t = torch.arange(T, device=dev)
    rows = (T - 1) + (s * down // up)[:, None] - t[None, :]  # (up, T)
    V = torch.zeros(down + T - 1, up, dtype=h_poly.dtype, device=dev)
    V[rows, s[:, None].expand(up, T)] = h_poly[s * down % up]
    return V


def resample_reference(z: torch.Tensor, hist: torch.Tensor,
                       h_poly: torch.Tensor, down: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: the frame-matmul ``aligned_resample``."""
    up = h_poly.shape[0]
    audio, rs = F.aligned_resample(z, aligned_poly_matrix(h_poly, down), up,
                                   down, F.AlignedResampleState(hist))
    return audio, rs.hist


def resample(z: torch.Tensor, hist: torch.Tensor, h_poly: torch.Tensor,
             down: int, out: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: z (multiple of ``down``) with (T-1,) history -> (audio
    (len(z)/down*up,), new history).  ``out``: an f32 tensor of the audio's
    length to write it into."""
    up, T = h_poly.shape
    if z.dim() != 1 or z.numel() == 0 or z.numel() % down:
        raise ValueError(f"z of shape {tuple(z.shape)} is not a 1-D whole "
                         f"number of {down}-sample frames")
    if not kernels.on_cuda(z):
        audio, new = resample_reference(z, hist, h_poly, down)
        if out is not None:
            audio = _output(out, audio.numel(), audio.device).copy_(audio)
        return audio, new
    dev = z.device
    kernels.check_tensor(z, "z", torch.float32, dev)
    kernels.check_tensor(hist, "hist", torch.float32, dev, (T - 1,))
    kernels.check_tensor(h_poly, "h_poly", torch.float32, dev, (up, T))
    lib = kernels.load().cdll
    audio = _output(out, z.numel() // down * up, dev)
    new = torch.empty_like(hist)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.tsdr_fm_resample(
            z.data_ptr(), z.numel(), hist.data_ptr(), h_poly.data_ptr(), up,
            down, T, audio.data_ptr(), new.data_ptr(), stream)
    kernels.check(status, "fm_resample")
    LAUNCHES["fm_resample"] += 1
    return audio, new


def demodulate_fused(data_u8: torch.Tensor, phase: int, carry: torch.Tensor,
                     resamp_hist: torch.Tensor, taps: torch.Tensor,
                     h_poly: torch.Tensor, spec: FusedWbfmSpec):
    """K1 then K2 over one block of whole chunks (one station).  Returns
    (audio, new carry, new resampler history)."""
    z, carry = fm_front(data_u8, phase, carry, taps, spec.decim)
    audio, resamp_hist = resample(z, resamp_hist, h_poly, spec.down)
    return audio, carry, resamp_hist


class FusedWbfm(nn.Module):
    """The fused chain's filter banks as buffers; ``forward`` is
    :func:`demodulate_fused`."""

    def __init__(self, config: WbfmConfig | None = None, *,
                 device: str | torch.device):
        super().__init__()
        self.spec = default_spec(config)
        taps, h_poly = make_kernel_params(config, device=device)
        self.register_buffer("taps", taps)
        self.register_buffer("h_poly", h_poly)

    def forward(self, data_u8: torch.Tensor, phase: int, carry: torch.Tensor,
                resamp_hist: torch.Tensor):
        return demodulate_fused(data_u8, phase, carry, resamp_hist, self.taps,
                                self.h_poly, self.spec)


class FusedWbfmStreamer:
    """Feed u8 blocks of any size, receive float audio: whole chunks
    (``spec.chunk_bytes``) go through the kernels, the residual leads the
    next call, and the fs/4 phase advances by the samples consumed."""

    def __init__(self, config: WbfmConfig | None = None, *,
                 device: str | torch.device):
        self.device = torch.device(device)
        self.model = FusedWbfm(config, device=self.device)
        self.spec = self.model.spec
        self.state = init_carry(self.device)
        self.resamp_hist = torch.zeros(self.spec.taps_per_phase - 1,
                                       dtype=torch.float32, device=self.device)
        self.phase = 0
        self._pending = np.zeros(0, dtype=np.uint8)

    def demodulate(self, buf: np.ndarray) -> np.ndarray:
        data = np.concatenate([self._pending, np.asarray(buf, dtype=np.uint8)])
        usable = len(data) - (len(data) % self.spec.chunk_bytes)
        self._pending = data[usable:]
        if usable == 0:
            return np.zeros(0, dtype=np.float32)
        block = torch.from_numpy(data[:usable]).to(self.device)
        audio, self.state, self.resamp_hist = self.model(
            block, self.phase, self.state, self.resamp_hist)
        self.phase = (self.phase + usable // 2) % 4
        return audio.cpu().numpy()
