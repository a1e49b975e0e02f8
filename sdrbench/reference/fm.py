"""The one-station WBFM receiver of rtl-sdr-rs's ``simple_fm`` in plain
PyTorch, one row a dongle: u8 I/Q -> complex -> fs/4 rotation ->
÷``decim`` low-pass FIR -> quadrature discriminator -> ``up/down``
polyphase resampler -> s16, as the configuration states it, designed and
computed here from the configuration alone.

``precision="float64"`` is the reference.  ``precision="tf32"`` is the
control: the same computation in float32, with both operands of every
product of the FIR and of the resampler rounded to TF32 (10 mantissa bits,
round to nearest, as the tensor cores round them), the step below the
configuration's float32 that would tempt a later change.  TF32 is off in
PyTorch's own float32 products while either runs.

Where the chain departs from ``simple_fm.rs`` (which the configuration
states, as the port's float chain runs it):

- the bytes are centred at 127.5 (``simple_fm``: 127);
- the low pass is the configuration's Kaiser-windowed FIR of ``decim *
  fir_taps_per_phase`` taps, cut off at ``fir_cutoff_frac`` of the output
  Nyquist with ``fir_atten_db`` of stop band (``simple_fm``: a boxcar sum
  of ``decim`` samples);
- the discriminator is the exact ``atan2`` of ``y[n] conj(y[n-1]) / pi``
  (``simple_fm``: an integer ``fast_atan2``; the port's K1 uses a 6-term
  polynomial, which is the program's and not the reference's);
- the audio resampler is the ``up/down`` polyphase filter of
  ``up * resample_taps_per_phase`` Kaiser taps cut off at
  ``resample_cutoff_frac`` of the tighter Nyquist (``simple_fm``: a boxcar
  average with a fractional index);
- the audio is scaled by ``0.9 * 32767`` and truncated to s16.

The output of a span of a dongle's stream depends on the bytes before it
only through the filters' histories (``decim * fir_taps_per_phase - 1``
samples of the FIR, one output of the discriminator,
``resample_taps_per_phase - 1`` of the resampler), so :func:`audio_s16`
takes the span with enough of the bytes before it
(:func:`lookback_bytes`) and starts from the stream's own initial state
there: FIR history zero, previous sample ``1 + 0j``, resampler history
zero.  The fs/4 rotation is that of the stream's absolute sample index.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from sdrbench.reference.dsp import S16_SCALE, kaiser_lowpass, round_tf32


def resampler_ratio(cfg: dict) -> tuple[int, int]:
    g = math.gcd(int(cfg["rate_out"]), int(cfg["rate_resample"]))
    return int(cfg["rate_resample"]) // g, int(cfg["rate_out"]) // g


def fir_taps(cfg: dict) -> np.ndarray:
    """The ÷decim low pass, unit DC gain (float64)."""
    decim = int(cfg["decim"])
    return kaiser_lowpass(decim * int(cfg["fir_taps_per_phase"]),
                          cfg["fir_cutoff_frac"] / (2 * decim),
                          float(cfg["fir_atten_db"]))


def resampler_phases(cfg: dict) -> np.ndarray:
    """(up, T) phases ``h[p + t up]`` of the up*T-tap anti-alias filter cut
    off at ``resample_cutoff_frac`` of the tighter Nyquist, gain up."""
    up, down = resampler_ratio(cfg)
    T = int(cfg["resample_taps_per_phase"])
    h = kaiser_lowpass(up * T, cfg["resample_cutoff_frac"] / (2 * max(up, down)),
                       float(cfg["resample_atten_db"])) * up
    return h.reshape(T, up).T.copy()


def frame_bytes(cfg: dict) -> int:
    """Bytes of one resampler frame: ``down`` outputs of the FIR."""
    return 2 * int(cfg["decim"]) * resampler_ratio(cfg)[1]


def lookback_bytes(cfg: dict) -> int:
    """Bytes before a span that fix its output: whole resampler frames
    covering the FIR's, the discriminator's and the resampler's
    histories."""
    decim = int(cfg["decim"])
    need = (int(cfg["resample_taps_per_phase"]) + 1) * decim \
        + decim * int(cfg["fir_taps_per_phase"])
    return frame_bytes(cfg) * -(-2 * need // frame_bytes(cfg))


@contextlib.contextmanager
def _tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def audio_s16(cfg: dict, data: np.ndarray, skip_bytes: int, start_sample: int
              = 0, *, precision: str = "float64", device="cpu") -> np.ndarray:
    """(rows, bytes) u8 of each row's stream from its sample
    ``start_sample`` on, whole resampler frames, the stream's initial state
    at the first byte -> (rows, samples) s16 of the bytes after
    ``skip_bytes``."""
    if precision not in ("float64", "tf32"):
        raise ValueError(f"precision {precision!r}")
    with _tf32_off():
        return _audio_s16(cfg, data, skip_bytes, start_sample,
                          precision == "tf32", torch.device(device))


def _audio_s16(cfg, data, skip_bytes, start_sample, tf32, device):
    dt = torch.float32 if tf32 else torch.float64
    op = round_tf32 if tf32 else (lambda t: t)
    decim = int(cfg["decim"])
    up, down = resampler_ratio(cfg)
    fb = frame_bytes(cfg)
    u8 = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    if u8.dim() != 2 or u8.shape[1] % fb or skip_bytes % fb:
        raise ValueError("not rows of whole resampler frames")
    rows, n = u8.shape[0], u8.shape[1] // 2
    x = (u8.reshape(rows, n, 2).to(dt) - 127.5) / 127.5

    # fs/4: sample k of the stream times j**k, which brings a station at
    # -fs/4 (simple_fm tunes fs/4 above it) to DC
    k = (torch.arange(n, device=device) + start_sample) % 4
    re, im = x[..., 0], x[..., 1]
    rr = torch.where(k == 0, re, torch.where(k == 1, -im,
                                             torch.where(k == 2, -re, im)))
    ri = torch.where(k == 0, im, torch.where(k == 1, re,
                                             torch.where(k == 2, -im, -re)))

    # FIR, one output a decim samples: y[m] = sum_t h[t] x[decim m - t]
    h = op(torch.from_numpy(fir_taps(cfg)).to(device, dt))
    L = len(h)
    m = n // decim
    pad = torch.zeros(rows, L - 1, dtype=dt, device=device)
    yr, yi = (sum(h[t] * v[:, L - 1 - t::decim][:, :m] for t in range(L))
              for v in (op(torch.cat([pad, r], dim=1)) for r in (rr, ri)))

    # discriminator: angle(y[m] conj(y[m-1])) / pi, y[-1] = 1
    pr = torch.cat([torch.ones_like(yr[:, :1]), yr[:, :-1]], dim=1)
    pi_ = torch.cat([torch.zeros_like(yi[:, :1]), yi[:, :-1]], dim=1)
    z = torch.atan2(yi * pr - yr * pi_, yr * pr + yi * pi_) / math.pi

    # resampler up/down: a[j] = sum_t H[p, t] z[q - t], j down = q up + p
    H = torch.from_numpy(resampler_phases(cfg)).to(device, dt)
    T = H.shape[1]
    j = torch.arange(m // down * up, device=device)
    q, p = (j * down) // up, (j * down) % up
    zp = torch.cat([torch.zeros(rows, T - 1, dtype=dt, device=device), z],
                   dim=1)
    win = op(zp[:, q[:, None] + (T - 1) - torch.arange(T, device=device)])
    audio = (win * op(H[p])).sum(dim=-1)
    audio = audio[:, skip_bytes // fb * up:]
    s16 = torch.clamp(audio.to(torch.float64) * S16_SCALE, -32768, 32767)
    return torch.trunc(s16).to(torch.int16).cpu().numpy()
