"""Streaming power-spectral-density estimation (Welch) in PyTorch — the
counterpart of ``tpu_sdr/ops/spectrum.py`` and the data plane of
``rtl_power``.

u8 I/Q blocks -> centred float32 (``ops.fm.u8_to_f32``) -> Hann-windowed
segments -> complex64 FFT (``torch.fft.fft``) -> |X|² summed over segments
into fftshifted bins.  The accumulator stays on the device across blocks;
:func:`psd_db` (numpy float64, copied from the JAX package) reads it back
once, when the hop is finalised.  The segment count, moved only by block
sizes, is a host int.

:class:`PsdStreamer` runs :func:`psd_accumulate` through ``utils.graphs``
in its form without outputs: on the card a block is one H2D copy and one
graph replay, and nothing waits for the device until ``finalize_db``.
``rtl_power`` keeps one streamer a scan and calls :meth:`PsdStreamer.reset`
between hops, so each block length is captured once a scan, as JAX's jit
cache compiles it once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_sdr_torch.ops.fm import u8_to_f32
from tpu_sdr_torch.utils import graphs


class PsdState(NamedTuple):
    """Accumulated (power-sum, segment-count) across blocks."""

    acc: torch.Tensor  # (n_fft,) f32: summed |X|^2 per bin, fftshifted
    count: int         # segments accumulated


def psd_init(n_fft: int, device: str | torch.device) -> PsdState:
    return PsdState(torch.zeros(n_fft, dtype=torch.float32, device=device), 0)


def hann(n_fft: int) -> np.ndarray:
    # periodic Hann (matches scipy.signal.welch's default family)
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
            ).astype(np.float32)


def psd_accumulate(buf: torch.Tensor, state: PsdState, window: torch.Tensor,
                   n_fft: int) -> PsdState:
    """Accumulate one u8 I/Q block (at least ``2*n_fft`` bytes; a trailing
    remainder that does not fill a segment is dropped) into the state."""
    re, im = u8_to_f32(buf)
    n_seg = re.shape[-1] // n_fft
    if n_seg == 0:
        raise ValueError(f"block of {buf.shape[-1]} bytes holds no "
                         f"{n_fft}-point segment")
    x = torch.complex(re[:n_seg * n_fft], im[:n_seg * n_fft]).reshape(
        n_seg, n_fft)
    X = torch.fft.fft(x * window, dim=-1)
    p = torch.fft.fftshift(X.abs().square().sum(dim=0))
    return PsdState(state.acc + p, state.count + n_seg)


def psd_db(state: PsdState, window: np.ndarray) -> np.ndarray:
    """Finalize: averaged, window-compensated power bins in dB (relative
    full scale; bin order is ascending frequency, -fs/2 .. +fs/2).  The
    one read-back of the accumulator."""
    acc = state.acc
    if torch.is_tensor(acc):
        acc = acc.cpu().numpy()
    acc = np.asarray(acc, np.float64)
    count = max(float(state.count), 1.0)
    scale = count * float(np.sum(np.asarray(window, np.float64) ** 2))
    return (10.0 * np.log10(np.maximum(acc / scale, 1e-20))).astype(
        np.float64)


class PsdStreamer:
    """Feed u8 blocks, read dB bins once at the end.

    The step is keyed on the usable block length; its one carry is
    ``acc``, and the segment count comes back as the step's aux.

    cuFFT under capture: a captured FFT runs the plan that the key's eager
    first call created and left in PyTorch's cuFFT plan cache
    (``torch.backends.cuda.cufft_plan_cache``), and a replay after that
    plan was destroyed would read freed memory.  The cache destroys plans
    only when it is cleared, shrunk, or full when a new plan comes in.  So
    before each block the streamer checks that the cache holds at least
    as many plans as after its last capture and is not full; if not, it
    drops its graphs (their next blocks run eagerly and capture again).
    Before it captures, it grows the cache's limit, if need be, past
    every plan its keys could add."""

    def __init__(self, n_fft: int = 1024, *, device: str | torch.device):
        self.n_fft = n_fft
        self.device = torch.device(device)
        self.window_np = hann(n_fft)
        self.window = torch.from_numpy(self.window_np).to(self.device)
        self.state = psd_init(n_fft, self.device)
        self._pending = np.zeros(0, np.uint8)
        self.graphs = graphs.StepGraphs("PsdStreamer", self._step,
                                        self.device)
        self._plans = 0  # the plan cache's size after the last capture

    def _step(self, _static, inputs, carries):
        new = psd_accumulate(inputs[0], PsdState(carries[0], 0),
                             self.window, self.n_fft)
        return [], [new.acc], new.count

    def _hold_plans(self) -> None:
        """Keep the cuFFT plans of the graphs alive (see the class
        docstring)."""
        if self.device.type != "cuda":
            return
        cache = torch.backends.cuda.cufft_plan_cache[self.graphs.device.index]
        if self.graphs.keys and not self._plans <= cache.size < \
                cache.max_size:
            self.graphs.clear()
        if cache.size + graphs.MAX_KEYS >= cache.max_size:
            cache.max_size = cache.size + 2 * graphs.MAX_KEYS

    def accumulate(self, buf: np.ndarray) -> None:
        block, self._pending, _ = graphs.split_residual(
            self._pending, np.asarray(buf, np.uint8).ravel(), 2 * self.n_fft)
        if graphs.width(block):
            self._hold_plans()
            captures = self.graphs.captures
            (acc,), n_seg = self.graphs.advance((), [block], [self.state.acc])
            self.state = PsdState(acc, self.state.count + n_seg)
            if self.graphs.captures != captures and \
                    self.device.type == "cuda":
                self._plans = torch.backends.cuda.cufft_plan_cache[
                    self.graphs.device.index].size

    def reset(self) -> None:
        """A new hop: the sums to zero in place (the graphs' carry) and the
        count to 0, keeping the captured graphs."""
        self.state.acc.zero_()
        self.state = PsdState(self.state.acc, 0)
        self._pending = np.zeros(0, np.uint8)

    @property
    def segments(self) -> float:
        return float(self.state.count)

    def finalize_db(self) -> np.ndarray:
        return psd_db(self.state, self.window_np)
