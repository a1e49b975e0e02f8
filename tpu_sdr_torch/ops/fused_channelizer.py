"""Fused PFB channelizer: one CUDA kernel and its plain version — the
counterpart of ``tpu_sdr/ops/pallas_channelizer.py``.

    u8 I/Q bytes --K3 pfb_channelize--> (m, 2*Ko) f32 = [Y_re | Y_im]

K3 (``csrc/pfb_channelize.cu``) unpacks the bytes to the x255 integer
scale (``2*u8 - 255``), runs the R = taps_per_branch + 1 tap branch filter
``G = h_poly`` down the frame axis of each of the K branches and a K-point
DFT across them (a radix-8 x 8 FFT at K = 64, a direct DFT otherwise),
with the 1/255 that divides the x255 scale back out folded into its
twiddle table (:func:`twiddles`).  It takes the (R, K) f32 tap table of
:func:`kernel_taps` and writes the columns ``[channel_offset,
channel_offset + Ko)``, ``Ko = spec.out_channels`` (< K under
channel-parallel sharding).

The plain version, :func:`channelize_reference`, is the function the TPU
kernel computes: the frame windows ``X_win[m, t*K + p] = X[m - t, p]``
times the packed analysis matrix M2 = [M_re | M_im] / 255, the TPU
kernel's split-bf16 pair ``M2_hi + M2_lo`` summed in float32
(:func:`kernel_matrix`).  The two agree to the bf16 rounding of M2 (K3 is
the closer to the exact PFB).  The wrapper launches the kernel for a CUDA
tensor (or raises), takes the plain version for a CPU tensor, and counts
launches in :data:`LAUNCHES`.

The carry keeps the JAX kernel's layout, so it converts 1:1: (2H, K) f32,
the last H = R - 1 input frames in the x255 scale, re rows then im rows.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tpu_sdr_torch import kernels
from tpu_sdr_torch.ops import channelizer as chan
from tpu_sdr_torch.utils import design, graphs

# Kernel launches of the wrapper: the main path's proof that it ran K3.
# Only the wrapper's CUDA branch adds to it.
LAUNCHES = kernels.launch_counter("pfb_channelize")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class PfbSpec(NamedTuple):
    """Static geometry of the fused channelizer (field for field the JAX
    ``PallasPfbSpec``; :meth:`validate` keeps its conditions but one, so
    that a spec valid in the JAX package is valid here)."""

    num_channels: int      # K (input frame width = total channels)
    branch_rows: int       # R = taps_per_branch + 1
    frames_per_chunk: int  # C: frames per streaming chunk
    # Output channels (column block of M2); < num_channels under
    # channel-parallel sharding.
    local_channels: int | None = None

    @property
    def out_channels(self) -> int:
        return self.local_channels or self.num_channels

    @property
    def chunk_complex(self) -> int:
        return self.frames_per_chunk * self.num_channels

    @property
    def chunk_bytes(self) -> int:
        return 2 * self.chunk_complex

    def validate(self) -> None:
        """The JAX spec's conditions but its 2*Ko <= 512, which is the TPU
        matmul's lane width and not a limit of K3: here any Ko <= K.  The
        last one is a limit of the TPU compiler (an 8-row sublane roll),
        not of K3; it stays so that specs stay interchangeable."""
        if self.num_channels % 2:
            raise ValueError(f"num_channels={self.num_channels} must be even")
        if not 0 < self.out_channels <= self.num_channels:
            raise ValueError(f"{self.out_channels} output channels of "
                             f"{self.num_channels}")
        if self.frames_per_chunk % 8:
            raise ValueError(f"frames_per_chunk={self.frames_per_chunk} is "
                             "not a multiple of 8")
        if self.branch_rows - 1 > self.frames_per_chunk:
            raise ValueError("history longer than a chunk")
        if (self.frames_per_chunk + self.branch_rows - 1) % 8:
            raise ValueError("taps_per_branch must be a multiple of 8 "
                             "(the TPU kernel's sublane roll)")


def default_spec(num_channels: int = 64, taps_per_branch: int = 8,
                 frames_per_chunk: int = 256) -> PfbSpec:
    spec = PfbSpec(num_channels, taps_per_branch + 1, frames_per_chunk)
    spec.validate()
    return spec


def make_packed_matrices(h_poly: np.ndarray, scale: float = 255.0,
                         channel_slice: slice | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M2_hi, M2_lo) bf16 pair of [M_re | M_im] / ``scale``, rounded from
    float64 as the JAX package rounds it.  ``channel_slice`` selects a
    column block of M_re and M_im."""
    M_re, M_im = design.pfb_mxu_matrices(h_poly)
    if channel_slice is not None:
        M_re = M_re[:, channel_slice]
        M_im = M_im[:, channel_slice]
    return design.make_split_bf16(np.concatenate([M_re, M_im], axis=1), scale)


def kernel_matrix(h_poly: np.ndarray, channel_slice: slice | None = None
                  ) -> torch.Tensor:
    """The plain version's f32 weights: the packed pair summed,
    ``M2_hi + M2_lo``."""
    return design.split_bf16_sum(*make_packed_matrices(
        h_poly, channel_slice=channel_slice))


def kernel_taps(h_poly: np.ndarray) -> torch.Tensor:
    """K3's (R, K) f32 tap table: the branch matrix G = ``h_poly`` itself
    (the 1/255 lives in :func:`twiddles`)."""
    return torch.from_numpy(np.array(h_poly, dtype=np.float32))


def twiddles(num_channels: int) -> torch.Tensor:
    """K3's (K, 2) f32 table ``exp(-2 pi i n / K) / 255``, n < K, rounded
    once from float64: the FFT's twiddles (K = 64) or the direct DFT's."""
    w = np.exp(-2j * np.pi * np.arange(num_channels) / num_channels) / 255.0
    return torch.from_numpy(np.stack([w.real, w.imag], axis=1)
                            .astype(np.float32))


@functools.lru_cache(maxsize=16)
def _device_twiddles(num_channels: int, device: torch.device) -> torch.Tensor:
    return twiddles(num_channels).to(device)


def init_carry(spec: PfbSpec, device: str | torch.device) -> torch.Tensor:
    H = spec.branch_rows - 1
    return torch.zeros(2 * H, spec.num_channels, dtype=torch.float32,
                       device=device)


def carry_from_pfb_state(state: chan.PfbState) -> torch.Tensor:
    """Plain front's state (normalised scale) -> (2H, K) carry (x255)."""
    return torch.cat([state.hist_re, state.hist_im]) * 255.0


def pfb_state_from_carry(carry: torch.Tensor) -> chan.PfbState:
    """(2H, K) carry (x255) -> plain front's state (normalised scale)."""
    H = carry.shape[0] // 2
    return chan.PfbState(carry[:H] / 255.0, carry[H:] / 255.0)


def _frames_x255(data_u8: torch.Tensor, K: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    x = data_u8.reshape(-1, K, 2).to(torch.float32) * 2.0 - 255.0
    return x[..., 0], x[..., 1]


def channelize_reference(data_u8: torch.Tensor, carry: torch.Tensor,
                         m2: torch.Tensor, spec: PfbSpec
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: 2*m*K bytes, the (2H, K) carry and the f32 M2
    (R*K, 2*Ko) -> ((m, 2*Ko) [Y_re | Y_im], new carry)."""
    H = spec.branch_rows - 1
    re, im = _frames_x255(data_u8, spec.num_channels)
    ext_re = torch.cat([carry[:H], re])
    ext_im = torch.cat([carry[H:], im])
    y_re, y_im = chan.analyze_frames(ext_re, ext_im, m2)
    return (torch.cat([y_re, y_im], dim=1),
            torch.cat([ext_re[-H:], ext_im[-H:]]))


def channelize(data_u8: torch.Tensor, carry: torch.Tensor,
               taps: torch.Tensor, spec: PfbSpec, *, channel_offset: int = 0
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: u8 I/Q of m whole frames (2*m*K bytes) with the (2H, K) carry
    and the (R, K) f32 tap table of :func:`kernel_taps` -> (Y_re (m, Ko),
    Y_im (m, Ko), new carry) for the channels ``[channel_offset,
    channel_offset + Ko)``.  Y_re and Y_im are column views of one
    (m, 2*Ko) tensor.  On the CPU: :func:`channelize_reference` with the
    M2 built from the same taps."""
    K, R, Ko = spec.num_channels, spec.branch_rows, spec.out_channels
    H, c0 = R - 1, channel_offset
    frame_bytes = 2 * K
    if data_u8.numel() == 0 or data_u8.numel() % frame_bytes:
        raise ValueError(f"{data_u8.numel()} bytes is not a positive whole "
                         f"number of {K}-channel frames of I/Q pairs")
    if not 0 <= c0 <= K - Ko:
        raise ValueError(f"channels [{c0}, {c0 + Ko}) are not within the "
                         f"{K} channels")
    if not kernels.on_cuda(data_u8):
        m2 = kernel_matrix(taps.numpy(), slice(c0, c0 + Ko))
        y, new = channelize_reference(data_u8, carry, m2, spec)
        return y[:, :Ko], y[:, Ko:], new
    dev = data_u8.device
    kernels.check_tensor(data_u8, "data", torch.uint8, dev)
    kernels.check_tensor(carry, "carry", torch.float32, dev, (2 * H, K))
    kernels.check_tensor(taps, "taps", torch.float32, dev, (R, K))
    if data_u8.data_ptr() % 2:
        raise ValueError("the data must be 2-byte aligned")
    lib = kernels.load().cdll
    tw = _device_twiddles(K, dev)
    m = data_u8.numel() // frame_bytes
    y = torch.empty(m, 2 * Ko, dtype=torch.float32, device=dev)
    new = torch.empty_like(carry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.tsdr_pfb_channelize(
            data_u8.data_ptr(), m, K, R, c0, Ko, carry.data_ptr(),
            taps.data_ptr(), tw.data_ptr(), y.data_ptr(), new.data_ptr(),
            stream)
    kernels.check(status, "pfb_channelize")
    LAUNCHES["pfb_channelize"] += 1
    return y[:, :Ko], y[:, Ko:], new


class FusedPfb(nn.Module):
    """K3's tap table as a buffer; ``forward`` is :func:`channelize`."""

    def __init__(self, h_poly: np.ndarray, spec: PfbSpec, *,
                 device: str | torch.device):
        super().__init__()
        self.spec = spec
        self.register_buffer("taps", kernel_taps(h_poly).to(device))

    def forward(self, data_u8: torch.Tensor, carry: torch.Tensor):
        return channelize(data_u8, carry, self.taps, self.spec)


class FusedPfbStreamer:
    """Feed u8 blocks of any size, receive (m, K) channel frames: whole
    chunks (``spec.chunk_bytes``) go through K3, the residual leads the
    next call.  Output scale is ``pfb_analyze``'s on normalised samples.

    K3 is the step, run through ``utils.graphs`` (one CUDA graph replay a
    call on the card), keyed on the number of chunks; Y_re and Y_im come
    to the host in one copy."""

    def __init__(self, num_channels: int = 64, taps_per_branch: int = 8,
                 frames_per_chunk: int = 256, *, device: str | torch.device):
        self.device = torch.device(device)
        self.spec = default_spec(num_channels, taps_per_branch,
                                 frames_per_chunk)
        self.h_poly = design.design_pfb(num_channels, taps_per_branch)
        self.model = FusedPfb(self.h_poly, self.spec, device=self.device)
        self.state = init_carry(self.spec, self.device)
        self._pending = np.zeros(0, dtype=np.uint8)
        self.graphs = graphs.StepGraphs("FusedPfbStreamer", self._step,
                                        self.device)

    def _step(self, _static, inputs, carries):
        y_re, y_im, new = self.model(inputs[0], carries[0])
        return [y_re, y_im], [new], None

    def channelize(self, buf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        block, self._pending, _ = graphs.split_residual(
            self._pending, buf, self.spec.chunk_bytes)
        if graphs.width(block) == 0:
            z = np.zeros((0, self.spec.out_channels), np.float32)
            return z, z
        (y_re, y_im), (self.state,), _ = self.graphs((), [block],
                                                     [self.state])
        return y_re, y_im
