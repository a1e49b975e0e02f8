"""Polyphase filter-bank (PFB) channelizer in plain PyTorch — the
counterpart of ``tpu_sdr/ops/channelizer.py`` (the XLA front that
``multi_fm`` runs without its kernel).

Frame the stream into (m, K); channel k of frame m is

    Y[m, k] = sum_t sum_p X[m-t, p] * G[t, p] * exp(-2j pi k p / K)

with the (R, K) branch matrix G of ``design.design_pfb``.  Branch filter
and DFT fold into one real matrix M2 = [M_re | M_im] (R*K, 2K) of
``design.pfb_mxu_matrices``, so the analysis is two float32 matmuls of the
frame windows ``X_win[m, t*K + p] = X[m-t, p]``.  Windows are a strided
``unfold`` of the history-extended frames, never a ``conv1d`` (cuDNN would
run it in TF32 on a GPU).  The state carries the last R-1 input frames in
the input's own scale (``u8_to_f32``'s normalised one on this path).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_sdr_torch.utils import design


class PfbState(NamedTuple):
    """Last (branch_rows - 1) input frames (re, im), each of width K."""

    hist_re: torch.Tensor
    hist_im: torch.Tensor


def pfb_init(h_poly, device: str | torch.device) -> PfbState:
    """Zero state sized for the (rows, K) branch matrix."""
    rows, K = np.shape(h_poly)
    z = torch.zeros(rows - 1, K, dtype=torch.float32, device=device)
    return PfbState(z, z.clone())


def packed_matrix(h_poly: np.ndarray, *, device: str | torch.device
                  ) -> torch.Tensor:
    """M2 = [M_re | M_im] (rows*K, 2K) float32 on ``device``."""
    M_re, M_im = design.pfb_mxu_matrices(h_poly)
    return torch.from_numpy(np.concatenate([M_re, M_im], axis=1)).to(device)


def analyze_frames(ext_re: torch.Tensor, ext_im: torch.Tensor,
                   m2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """PFB analysis of history-extended frames ext (H + m, K), H = R - 1,
    with M2 (R*K, 2*Ko) -> (Y_re, Y_im), each (m, Ko).

    ``ext.reshape(-1).unfold(0, R*K, K)`` row m holds ext[m + r, p] at
    r*K + p, i.e. lag t = H - r; M2's row blocks are flipped to match."""
    K = ext_re.shape[1]
    R = m2.shape[0] // K
    Ko = m2.shape[1] // 2
    m2_rev = m2.reshape(R, K, 2 * Ko).flip(0).reshape(R * K, 2 * Ko)
    yr = torch.matmul(ext_re.reshape(-1).unfold(0, R * K, K), m2_rev)
    yi = torch.matmul(ext_im.reshape(-1).unfold(0, R * K, K), m2_rev)
    return yr[:, :Ko] - yi[:, Ko:], yr[:, Ko:] + yi[:, :Ko]


def pfb_analyze(re: torch.Tensor, im: torch.Tensor, m2: torch.Tensor,
                state: PfbState):
    """Channelize one block (length a multiple of K) with M2 of
    :func:`packed_matrix`.  Returns ``(Y_re, Y_im, new_state)``, Y of shape
    (m, K): frame m, channel k (critically sampled at fs/K, gain K at the
    channel centre)."""
    H, K = state.hist_re.shape
    n = re.shape[0]
    if n % K:
        raise ValueError(f"block of {n} not divisible by K={K}")
    ext_re = torch.cat([state.hist_re, re.reshape(n // K, K)])
    ext_im = torch.cat([state.hist_im, im.reshape(n // K, K)])
    y_re, y_im = analyze_frames(ext_re, ext_im, m2)
    return y_re, y_im, PfbState(ext_re[n // K:], ext_im[n // K:])
