"""Fused WBFM chain: two CUDA kernels and their plain versions, for one
station or a station batch — the counterpart of ``tpu_sdr/ops/pallas_fm.py``.

    u8 bytes --K1 fm_front--> z (170 kHz discriminator output)
             --K2 fm_resample--> audio (32 kHz)

K1 (``csrc/fm_front.cu``) unpacks, rotates by fs/4 from a phase argument,
runs the 72-tap ÷6 FIR with the TPU kernel's effective taps and the
discriminator with its 6-term atan.  K2 (``csrc/fm_resample.cu``) is the
16/85 polyphase resampler.  Each takes an optional leading station axis
and runs a batch in one launch (``demodulate_fused_batch``,
``FusedWbfmBatchStreamer``; the TPU kernel's (stations, nchunks) grid).
Each wrapper launches its kernel for a CUDA tensor (or raises), takes its
plain PyTorch version for a CPU tensor, and counts its launches (not its
stations) in :data:`LAUNCHES`.

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
from tpu_sdr_torch.utils import design, graphs, profiling
from tpu_sdr_torch.utils.design import WbfmConfig

STATE_ROWS = 4
LANES = 128

# the spans of a read (utils.profiling): its root, and the residual's join
READ_SPAN = "FusedWbfmStreamer.demodulate"
JOIN_SPAN = "FusedWbfmStreamer.join"
BATCH_READ_SPAN = "FusedWbfmBatchStreamer.demodulate"
BATCH_JOIN_SPAN = "FusedWbfmBatchStreamer.join"

# Kernel launches per wrapper: the main path's proof that it ran the
# kernels.  Only the wrappers' CUDA branches add to these.
LAUNCHES = kernels.launch_counter("fm_front", "fm_resample")


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
    """(4, 128) carry + phase + resampler history -> float-chain state (on
    the aligned resampler path; fresh boxcar and de-emphasis carries)."""
    Lm1 = spec.num_taps - 1
    return M.WbfmState(
        int(rot_phase),
        F.FirState(carry[0, :Lm1] / 255.0, carry[1, :Lm1] / 255.0),
        F.QuadState(carry[2, LANES - 1], carry[3, LANES - 1]),
        F.ResampleState(resamp_hist, 0),
        F.boxcar_resample_init(carry.device), F.deemph_init(carry.device))


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


def station_phases(phase, stations: int) -> int | list[int]:
    """``phase`` for a batch of ``stations``: one int for all, or a
    sequence of one a station (returned as a list, or as one int when they
    agree), each in 0..3."""
    if isinstance(phase, (int, np.integer)):
        phases = [int(phase)]
    else:
        phases = [int(p) for p in (phase.tolist() if hasattr(phase, "tolist")
                                   else phase)]
        if len(phases) != stations:
            raise ValueError(f"{len(phases)} phases for {stations} stations")
    if any(not 0 <= p <= 3 for p in phases):
        raise ValueError(f"fs/4 phases {phases} not in 0..3")
    return phases[0] if len(set(phases)) == 1 else phases


def fm_front_reference(data_u8: torch.Tensor, phase, carry: torch.Tensor,
                       taps: torch.Tensor, decim: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: 2n bytes -> (z (n/decim,) f32, new carry); with
    a leading station axis, (S, 2n) bytes, a phase for all or one a
    station, and (S, 4, 128) carries -> (S, n/decim) z and (S, 4, 128)
    carries.  The FIR runs a tap at a time over every station, so a
    station's outputs are the same bits in any batch."""
    n = data_u8.shape[-1] // 2
    L = taps.numel()
    M = n // decim
    x = data_u8.reshape(*data_u8.shape[:-1], n, 2).to(torch.float32) * 2.0 - 255.0
    if not isinstance(phase, int):
        phase = torch.as_tensor(phase, dtype=torch.int64)
    re, im, _ = F.rotate_fs4(x[..., 0], x[..., 1], phase)
    xs = torch.stack([torch.cat([carry[..., 0, :L - 1], re], dim=-1),
                      torch.cat([carry[..., 1, :L - 1], im], dim=-1)])
    y = taps[0] * xs[..., 0:decim * (M - 1) + 1:decim]
    for j in range(1, L):
        y = y + taps[j] * xs[..., j:j + decim * (M - 1) + 1:decim]
    y_re, y_im = y[0], y[1]
    b_re = torch.cat([carry[..., 2, LANES - 1:], y_re[..., :-1]], dim=-1)
    b_im = torch.cat([carry[..., 3, LANES - 1:], y_im[..., :-1]], dim=-1)
    c_re = y_re * b_re + y_im * b_im
    c_im = y_im * b_re - y_re * b_im
    z = atan2_poly6(c_im, c_re) * (1.0 / math.pi)
    new = carry.clone()
    new[..., 0, :L - 1] = xs[0, ..., n:]
    new[..., 1, :L - 1] = xs[1, ..., n:]
    new[..., 2, :] = torch.cat([carry[..., 2, :], y_re], dim=-1)[..., -LANES:]
    new[..., 3, :] = torch.cat([carry[..., 3, :], y_im], dim=-1)[..., -LANES:]
    return z, new


def _output(out: torch.Tensor | None, shape: tuple, device) -> torch.Tensor:
    """``out`` checked as an f32 tensor of ``shape`` on ``device`` whose rows
    are contiguous, or a new one."""
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    rows = out if len(shape) == 2 else out[None]
    kernels.check_rows(rows, "out", torch.float32, device,
                       shape if len(shape) == 2 else (1, *shape))
    return out


def _rows(t: torch.Tensor, batched: bool) -> torch.Tensor:
    return t if batched else t[None]


def fm_front(data_u8: torch.Tensor, phase, carry: torch.Tensor,
             taps: torch.Tensor, decim: int, out: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: u8 I/Q (2n bytes, n % decim == 0) at fs/4 ``phase`` with the
    (4, 128) ``carry`` and effective ``taps`` -> (z (n/decim,), new carry).
    With a leading station axis -- (S, 2n) bytes, ``phase`` one for all, a
    sequence of one a station, or an (S,) int32 tensor on the card (taken
    mod 4 there), (S, 4, 128) carries, the rows of each at
    any stride (the sharded chain's carries are slices of its halo
    records) -- ONE launch runs every station and returns (S, n/decim) z
    and (S, 4, 128) carries.  ``out``: a tensor of z's shape to write z
    into (its rows too at any stride)."""
    batched = data_u8.dim() == 2
    S = data_u8.shape[0] if batched else 1
    nbytes = data_u8.shape[-1]
    n = nbytes // 2
    if data_u8.dim() not in (1, 2) or nbytes % 2 or n == 0 or n % decim \
            or S == 0:
        raise ValueError(f"data of shape {tuple(data_u8.shape)} is not rows "
                         f"of a positive whole number of {decim}-sample "
                         f"groups of I/Q pairs")
    # a phase tensor on the card goes to K1 as it is (each taken mod 4)
    on_card = torch.is_tensor(phase) and phase.device.type == "cuda"
    phases = phase if on_card else station_phases(phase, S)
    M = n // decim
    z_shape = (S, M) if batched else (M,)
    if not kernels.on_cuda(data_u8):
        z, new = fm_front_reference(data_u8, phases, carry, taps, decim)
        if out is not None:
            z = _output(out, z_shape, z.device).copy_(z)
        return z, new
    dev = data_u8.device
    rows = _rows(data_u8, batched)
    iq_stride = kernels.check_rows(rows, "data", torch.uint8, dev, (S, nbytes))
    carries = _rows(carry, batched)
    c_stride = kernels.check_rows(carries, "carry", torch.float32, dev,
                                  (S, STATE_ROWS, LANES))
    kernels.check_tensor(taps, "taps", torch.float32, dev, (taps.numel(),))
    if taps.numel() - 1 > LANES or rows.data_ptr() % 2 or iq_stride % 2:
        raise ValueError("taps exceed the carry, or data is not 2-byte aligned")
    z = _output(out, z_shape, dev)
    z_rows = _rows(z, batched)
    new = torch.empty((S, STATE_ROWS, LANES) if batched else
                      (STATE_ROWS, LANES), dtype=torch.float32, device=dev)
    lib = kernels.load().cdll
    with torch.cuda.device(dev):
        if isinstance(phases, int):
            phase_ptr, uniform = None, phases
        else:
            if on_card:
                kernels.check_tensor(phases, "phase", torch.int32, dev, (S,))
            else:
                phases = torch.tensor(phases, dtype=torch.int32, device=dev)
            phase_ptr, uniform = phases.data_ptr(), 0
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.tsdr_fm_front_batch(
            rows.data_ptr(), iq_stride, S, n, phase_ptr, uniform,
            carries.data_ptr(), c_stride, taps.data_ptr(), taps.numel(),
            decim, z_rows.data_ptr(), z_rows.stride(0), new.data_ptr(),
            STATE_ROWS * LANES, stream)
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
    """Plain version of K2: the frame-matmul ``aligned_resample``, along the
    last axis of z ((n,) with a (T-1,) history, or (S, n) with (S, T-1))."""
    up = h_poly.shape[0]
    audio, rs = F.aligned_resample(z, aligned_poly_matrix(h_poly, down), up,
                                   down, F.AlignedResampleState(hist))
    return audio, rs.hist


def resample(z: torch.Tensor, hist: torch.Tensor, h_poly: torch.Tensor,
             down: int, out: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: z (multiple of ``down``) with (T-1,) history -> (audio
    (len(z)/down*up,), new history).  With a leading station axis -- (S, n)
    z and (S, T-1) histories, the rows of each at any stride -- ONE launch
    runs every station and returns (S, n/down*up) audio and (S, T-1)
    histories.  ``out``: an f32 tensor of the audio's shape to write it
    into (its rows at any stride)."""
    up, T = h_poly.shape
    batched = z.dim() == 2
    S = z.shape[0] if batched else 1
    n = z.shape[-1]
    if z.dim() not in (1, 2) or n == 0 or n % down or S == 0:
        raise ValueError(f"z of shape {tuple(z.shape)} is not rows of a "
                         f"whole number of {down}-sample frames")
    a_shape = (S, n // down * up) if batched else (n // down * up,)
    if not kernels.on_cuda(z):
        audio, new = resample_reference(z, hist, h_poly, down)
        if out is not None:
            audio = _output(out, a_shape, audio.device).copy_(audio)
        return audio, new
    dev = z.device
    z_rows = _rows(z, batched)
    z_stride = kernels.check_rows(z_rows, "z", torch.float32, dev, (S, n))
    hists = _rows(hist, batched)
    h_stride = kernels.check_rows(hists, "hist", torch.float32, dev,
                                  (S, T - 1))
    kernels.check_tensor(h_poly, "h_poly", torch.float32, dev, (up, T))
    audio = _output(out, a_shape, dev)
    a_rows = _rows(audio, batched)
    new = torch.empty((S, T - 1) if batched else (T - 1,),
                      dtype=torch.float32, device=dev)
    lib = kernels.load().cdll
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.tsdr_fm_resample_batch(
            z_rows.data_ptr(), z_stride, S, n, hists.data_ptr(), h_stride,
            h_poly.data_ptr(), up, down, T, a_rows.data_ptr(),
            a_rows.stride(0), new.data_ptr(), T - 1, stream)
    kernels.check(status, "fm_resample")
    LAUNCHES["fm_resample"] += 1
    return audio, new


def demodulate_fused(data_u8: torch.Tensor, phase, carry: torch.Tensor,
                     resamp_hist: torch.Tensor, taps: torch.Tensor,
                     h_poly: torch.Tensor, spec: FusedWbfmSpec):
    """K1 then K2 over one block of whole chunks (one station, or a batch
    with a leading station axis).  Returns (audio, new carry, new
    resampler history)."""
    z, carry = fm_front(data_u8, phase, carry, taps, spec.decim)
    audio, resamp_hist = resample(z, resamp_hist, h_poly, spec.down)
    return audio, carry, resamp_hist


def demodulate_fused_batch(data_u8: torch.Tensor, phases,
                           carries: torch.Tensor, resamp_hists: torch.Tensor,
                           taps: torch.Tensor, h_poly: torch.Tensor,
                           spec: FusedWbfmSpec):
    """The station batch, one K1 and one K2 launch over every station (the
    counterpart of ``pallas_fm.demodulate_fused_batch``): (S, bytes) u8 of
    whole chunks, ``phases`` one a station (or one for all), (S, 4, 128)
    carries and (S, T-1) histories -> (audio (S, m), new carries, new
    histories).  Stations may differ in phase: K1 rotates each at its own."""
    if data_u8.dim() != 2:
        raise ValueError(f"a station batch is (stations, bytes), not "
                         f"{tuple(data_u8.shape)}")
    return demodulate_fused(data_u8, phases, carries, resamp_hists, taps,
                            h_poly, spec)


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
    next call, and the fs/4 phase advances by the samples consumed.  A
    block may be a numpy array or a u8 tensor on the streamer's device
    (the residual then stays on the device); the audio is the same bits.

    The step (K1, then K2) runs through ``utils.graphs``: one CUDA graph
    replay a call on the card, keyed on the block's chunks and the phase
    (a chunk is a multiple of 4 samples, so the phase never moves here)."""

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
        self.graphs = graphs.StepGraphs("FusedWbfmStreamer", self._step,
                                        self.device)

    def _step(self, phase, inputs, carries):
        audio, carry, hist = self.model(inputs[0], phase, *carries)
        return [audio], [carry, hist], None

    def demodulate(self, buf: np.ndarray | torch.Tensor) -> np.ndarray:
        t0 = profiling.clock()
        block, self._pending, copied = graphs.split_residual(
            self._pending, buf, self.spec.chunk_bytes, self.device)
        profiling.span(JOIN_SPAN, t0, profiling.clock(), copied)
        audio = self._demodulate(block)
        profiling.read_span(READ_SPAN, t0, profiling.clock())
        return audio

    def _demodulate(self, block) -> np.ndarray:
        usable = graphs.width(block)
        if usable == 0:
            return np.zeros(0, dtype=np.float32)
        (audio,), (self.state, self.resamp_hist), _ = self.graphs(
            self.phase, [block], [self.state, self.resamp_hist])
        self.phase = (self.phase + usable // 2) % 4
        return audio


class FusedWbfmBatchStreamer:
    """The station batch over the kernels (the counterpart of
    ``PallasWbfmBatchStreamer``): feed (stations, bytes) u8 blocks, receive
    (stations, m) float audio.  Whole chunks of every row go through ONE K1
    and ONE K2 launch, one CUDA graph replay a call on the card; the
    residual leads the next call.  The carries keep the JAX attribute names
    and shapes: ``states`` (S, 4, 128), ``resamp_hists`` (S, T-1) and
    ``phases``, one a station (they may differ: K1 rotates each station at
    its own).  A chunk is 128 * down * decim samples, a multiple of 4, so
    the phases never move.  When they agree, K1 takes the one phase as a
    compile-time constant and the phase goes in the graph's key; when they
    differ, it reads the streamer's (S,) int32 tensor of them on the
    device.  ``phases`` reads them as a list of ints (as a checkpoint
    stores them) and takes a list, an array or a tensor."""

    def __init__(self, stations: int, config: WbfmConfig | None = None, *,
                 device: str | torch.device):
        self.device = torch.device(device)
        self.model = FusedWbfm(config, device=self.device)
        self.spec = self.model.spec
        self.stations = stations
        self.states = init_carry(self.device).repeat(stations, 1, 1)
        self.resamp_hists = torch.zeros(stations, self.spec.taps_per_phase - 1,
                                        dtype=torch.float32, device=self.device)
        self.phases = [0] * stations
        self._pending = np.zeros((stations, 0), dtype=np.uint8)
        self.graphs = graphs.StepGraphs("FusedWbfmBatchStreamer", self._step,
                                        self.device)

    @property
    def phases(self) -> list[int]:
        return list(self._phase_list)

    @phases.setter
    def phases(self, phases) -> None:
        phases = station_phases(phases, self.stations)
        self._uniform = phases if isinstance(phases, int) else None
        self._phase_list = [phases] * self.stations \
            if isinstance(phases, int) else phases
        self._phases = torch.tensor(self._phase_list, dtype=torch.int32,
                                    device=self.device)

    def _step(self, uniform, inputs, carries):
        states, hists, phases = carries
        audio, states, hists = demodulate_fused_batch(
            inputs[0], phases if uniform is None else uniform, states, hists,
            self.model.taps, self.model.h_poly, self.spec)
        return [audio], [states, hists, phases], None

    def demodulate(self, bufs: np.ndarray | torch.Tensor) -> np.ndarray:
        """A numpy read's rows go to the step as pieces (each row's residual,
        then its whole chunks), written straight into the staging buffer's
        strided rows; the join span holds the residual's bookkeeping.
        ``bufs`` may be read-only, and is the caller's again when this
        returns."""
        t0 = profiling.clock()
        block, self._pending, copied = graphs.split_residual(
            self._pending, bufs, self.spec.chunk_bytes, self.device)
        profiling.span(BATCH_JOIN_SPAN, t0, profiling.clock(), copied)
        audio = self._demodulate(block)
        profiling.read_span(BATCH_READ_SPAN, t0, profiling.clock())
        return audio

    def _demodulate(self, block) -> np.ndarray:
        if graphs.width(block) == 0:
            return np.zeros((self.stations, 0), dtype=np.float32)
        (audio,), carries, _ = self.graphs(
            self._uniform, [block],
            [self.states, self.resamp_hists, self._phases])
        self.states, self.resamp_hists, self._phases = carries
        return audio
