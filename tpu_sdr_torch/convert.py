"""Hand weights and streaming state between the JAX package and the port.

Everything crosses as numpy arrays (``np.asarray`` of a JAX array), so this
module never imports jax.  The fused chain's state has the JAX kernel's
layout, so the (4, 128) carry, the resampler history and the fs/4 phase
convert 1:1; the weights convert from the TPU kernel's forms — the
split-bf16 banded decimator ``(W_hi, W_lo)`` and the packed resampler
frame matrix ``V`` — to the port's effective taps and polyphase bank.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_sdr_torch.models import wbfm as M
from tpu_sdr_torch.ops import fm as F
from tpu_sdr_torch.ops.fused_fm import FusedWbfmSpec, effective_taps


def poly_from_matrix(V, up: int, down: int) -> torch.Tensor:
    """(up, T) polyphase bank read back from a frame matrix V of
    ``make_aligned_poly_matrix`` (any frames-per-row packing): frame 0's
    column s holds ``h_poly[p_s, t]`` at row ``(T-1) + o_s - t``."""
    V = np.asarray(V, dtype=np.float32)
    Tm1 = V.shape[0] - down * (V.shape[1] // up)
    h_poly = np.zeros((up, Tm1 + 1), dtype=np.float32)
    for s in range(up):
        o, p = (s * down) // up, (s * down) % up
        h_poly[p] = V[Tm1 + o - np.arange(Tm1 + 1), s]
    return torch.from_numpy(h_poly)


def params_from_jax(w_hi, w_lo, v, spec: FusedWbfmSpec, *,
                    device: str | torch.device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``pallas_fm.make_kernel_params`` output -> the port's (taps, h_poly)."""
    taps = effective_taps(w_hi, w_lo, spec.num_taps)
    h_poly = poly_from_matrix(v, spec.up, spec.down)
    return taps.to(device), h_poly.to(device)


def state_from_jax(carry, resamp_hist, phase, *, device: str | torch.device
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """A ``PallasWbfmStreamer``'s (state, resamp_hist, phase) -> the port's
    (carry, resampler history, phase)."""
    return (torch.from_numpy(np.array(carry, dtype=np.float32)).to(device),
            torch.from_numpy(np.array(resamp_hist, dtype=np.float32)).to(device),
            int(phase))


def state_to_jax(carry: torch.Tensor, resamp_hist: torch.Tensor, phase: int
                 ) -> tuple[np.ndarray, np.ndarray, int]:
    """The port's fused state -> numpy (state, resamp_hist, phase) for a
    ``PallasWbfmStreamer``."""
    return carry.cpu().numpy(), resamp_hist.cpu().numpy(), int(phase)


def wbfm_state_from_jax(state, *, device: str | torch.device) -> M.WbfmState:
    """A JAX float-chain ``WbfmState`` on the aligned resampler path (its
    fractional phase ``t0`` is 0) -> the port's float-chain state."""
    if int(np.asarray(state.resamp.t0)) != 0:
        raise ValueError("the port's float chain runs the aligned resampler "
                         "only (t0 must be 0)")

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    return M.WbfmState(
        int(np.asarray(state.rot.phase)),
        F.FirState(t(state.fir.hist_re), t(state.fir.hist_im)),
        F.QuadState(t(state.quad.pre_re), t(state.quad.pre_im)),
        F.AlignedResampleState(t(state.resamp.hist)))
