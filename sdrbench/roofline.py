"""The table of peaks and the bytes and operations of the kernels whose
share of their roofline the benchmark reports.

A kernel's bound is the larger of its bytes at the card's memory
bandwidth and its operations at the card's float32 rate (outside the
tensor cores), counting each input byte read once and each output byte
written once; its share is that bound over its measured time.
"""

from __future__ import annotations

import math

# published peaks of the SXM part at its 700 W limit (NVIDIA's data sheet)
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "f32_flops_per_s": 67e12}}


def k3_work(num_channels: int, taps_per_branch: int, frames: int,
            out_channels: int) -> tuple[int, int]:
    """(bytes, operations) of one K3 launch over ``frames`` K-channel
    frames: the u8 I/Q in, the (frames, 2 Ko) float32 out, the (2H, K)
    carry in and out, the (R, K) taps and the (K, 2) twiddles; the R-tap
    branch filters on re and im, then a K-point FFT a frame (5 K log2 K)."""
    K, R = num_channels, taps_per_branch + 1
    H = R - 1
    nbytes = (2 * frames * K + 8 * frames * out_channels
              + 2 * (2 * H * K * 4) + R * K * 4 + K * 2 * 4)
    ops = frames * (2 * 2 * R * K + 5 * K * math.log2(K))
    return nbytes, int(ops)


def bound_s(device_kind: str, nbytes: int, ops: int) -> float | None:
    """The least time the card could take, or None for a card not in
    :data:`PEAKS`."""
    peak = PEAKS.get(device_kind)
    if peak is None:
        return None
    return max(nbytes / peak["bytes_per_s"], ops / peak["f32_flops_per_s"])
