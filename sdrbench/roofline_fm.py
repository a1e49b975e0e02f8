"""The bytes and operations of K1 (``fm_front``) and K2
(``fm_resample``), for their shares of the roofline
(``roofline.bound_s``): each input byte read once and each output byte
written once, at a launch's ``stations`` rows of ``samples`` complex
samples.  A launch's samples may be a mean (a streamer's calls take whole
chunks, so their lengths vary), hence floats."""

from __future__ import annotations

from sdrbench.roofline import PEAKS, bound_s

__all__ = ["PEAKS", "bound_s", "k1_work", "k2_work"]

CARRY_BYTES = 4 * 128 * 4  # a station's (4, 128) float32 carry
# a z output of the discriminator: y[m] conj(y[m-1]) (4 multiplies, 2
# adds), the atan's range reduction (1 divide, 1 multiply for t squared),
# its 6-term polynomial (5 multiply-adds, 10 operations; 1 multiply by t),
# the quadrant folds (2 subtracts) and the 1/pi scale (1 multiply)
DISCRIMINATOR_OPS = 6 + 2 + 10 + 1 + 2 + 1


def k1_work(stations: int, samples: float, decim: int, taps: int
            ) -> tuple[float, float]:
    """(bytes, operations) of one K1 launch: the u8 I/Q in, z (float32, one
    a ``decim`` samples) out, each station's carry in and out, the taps; the
    ``taps``-tap FIR on re and im and the discriminator a z output."""
    outputs = stations * samples / decim
    nbytes = (2 * stations * samples + 4 * outputs
              + 2 * stations * CARRY_BYTES + 4 * taps)
    return nbytes, outputs * (2 * 2 * taps + DISCRIMINATOR_OPS)


def k2_work(stations: int, inputs: float, up: int, down: int,
            taps_per_phase: int) -> tuple[float, float]:
    """(bytes, operations) of one K2 launch over ``inputs`` z samples a
    station: z in, the audio (``up`` a ``down`` inputs, float32) out, each
    station's (T-1,) history in and out, the (up, T) taps;
    ``taps_per_phase`` multiply-adds an output."""
    T = taps_per_phase
    outputs = stations * inputs / down * up
    nbytes = (4 * stations * inputs + 4 * outputs
              + 2 * stations * 4 * (T - 1) + 4 * up * T)
    return nbytes, outputs * 2 * T
