"""Host audio conversion — the port's copy of ``tpu_sdr.native.f32_to_s16``.

The JAX package runs it in C++ when its native library is built
(``csrc/tpusdr_io.cpp`` ``tsdr_f32_to_s16``) and in numpy otherwise; both
scale in float32, clamp to [-32768, 32767] and truncate toward zero, and
so does this numpy version, bit for bit.
"""

from __future__ import annotations

import numpy as np


def f32_to_s16(x: np.ndarray, scale: float = 0.9 * 32767.0) -> np.ndarray:
    """f32 audio -> clamped s16 PCM."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    return np.clip(x * np.float32(scale), -32768, 32767).astype(np.int16)
