"""The system under test for the dongle fleet: a library caller holding
one read of each of ``dongles`` RTL-SDR dongles hands them to
``FusedWbfmBatchStreamer`` as one (dongles, bytes) u8 array.

A read is ``FusedWbfmBatchStreamer(dongles, WbfmConfig(...)).demodulate``
(the residual's join, one K1 and one K2 launch over every dongle, one CUDA
graph replay) and the per-dongle s16 conversion.  Each harness read is
reshaped, as a view, into ``dongles`` rows: row d is dongle d's read, so a
dongle's stream is the pieces of the capture at d, d + dongles, d + 2
dongles, ... .  What the program gives back is kept for the check: the s16
of the reads sampled from the window.
"""

from __future__ import annotations

import numpy as np

from sdrbench.reference import fm
from sdrbench.trace import NO_SPANS


def chunk_bytes(config: dict) -> int:
    """The bytes of a row the streamer runs through the kernels at a time:
    128 resampler frames (``FusedWbfmSpec.chunk_bytes``)."""
    return 128 * fm.frame_bytes(config)


class Receiver:
    def __init__(self, config: dict, traffic: dict, device):
        from tpu_sdr_torch.native import f32_to_s16
        from tpu_sdr_torch.ops.fused_fm import FusedWbfmBatchStreamer
        from tpu_sdr_torch.utils.design import WbfmConfig

        self.f32_to_s16 = f32_to_s16
        self.dongles = int(config["dongles"])
        rb = int(config["dongle_read_bytes"])
        if int(traffic["read_bytes"]) != self.dongles * rb:
            raise ValueError(f"a read of {traffic['read_bytes']} bytes is not "
                             f"{self.dongles} dongles of {rb}")
        if config["num_channels"] * config["channel_rate"] != \
                config["capture_rate"]:
            raise ValueError("the capture's rate is not the chain's")
        self.wbfm = WbfmConfig(
            capture_rate=config["capture_rate"], decim=config["decim"],
            rate_out=config["rate_out"], rate_resample=config["rate_resample"],
            fir_taps_per_phase=config["fir_taps_per_phase"],
            fir_cutoff_frac=config["fir_cutoff_frac"],
            resample_taps_per_phase=config["resample_taps_per_phase"],
            resample_cutoff_frac=config["resample_cutoff_frac"],
            deemphasis_tau=config["deemphasis_tau"])
        self.streamer = FusedWbfmBatchStreamer(self.dongles, self.wbfm,
                                               device=device)

    def read(self, buf: np.ndarray, spans=NO_SPANS) -> list:
        """One read of every dongle; returns each dongle's s16 audio."""
        rows = buf.reshape(self.dongles, -1)
        with spans("demod"):
            audio = self.streamer.demodulate(rows)
        with spans("s16"):
            pcm = [self.f32_to_s16(a) for a in audio]
        return pcm

    def graph_keys(self) -> dict:
        return {"FusedWbfmBatchStreamer": len(self.streamer.graphs.keys)}

    def close(self) -> None:
        self.streamer = None


def stream_bytes(plan, ring: np.ndarray, dongles: int, dongle: int,
                 start: int, stop: int) -> np.ndarray:
    """Bytes ``[start, stop)`` of one dongle's stream: its read k is row
    ``dongle`` of harness read k, which cycles the ring."""
    rb = plan.read_bytes // dongles
    out = np.empty(stop - start, np.uint8)
    at = start
    while at < stop:
        k, off = divmod(at, rb)
        n = min(rb - off, stop - at)
        base = (k % plan.ring_reads) * plan.read_bytes + dongle * rb + off
        out[at - start:at - start + n] = ring[base:base + n]
        at += n
    return out


def span_of_read(config: dict, i: int, dongle_read_bytes: int
                 ) -> tuple[int, int]:
    """The bytes of a dongle's stream that read ``i`` puts through the
    kernels: from the residual left before it to the one left after it,
    whole chunks."""
    q = chunk_bytes(config)
    a, b = i * dongle_read_bytes, (i + 1) * dongle_read_bytes
    return a - a % q, b - b % q


def check(config: dict, plan, ring: np.ndarray, kept: dict, groups: list,
          reads_fed: int, *, device, control: str | None = None
          ) -> tuple[dict, list]:
    """Every reading, and the numbers compared, each ``(name, value,
    limit)``.

    ``kept``: read index -> the program's s16 of that read, one array a
    dongle.  Each is compared with the reference's audio of that dongle's
    own bytes.  With ``control`` the program's audio is replaced by the
    reference computed at that precision, which has to fail."""
    limits = config["limits"]
    S = int(config["dongles"])
    rb = plan.read_bytes // S
    look = fm.lookback_bytes(config)
    # nothing compared is no pass
    gap, rms = (0, 0.0) if kept else (1 << 16, float(1 << 16))
    for i, pcm in sorted(kept.items()):
        a, b = span_of_read(config, i, rb)
        skip = min(look, a)
        data = np.stack([stream_bytes(plan, ring, S, d, a - skip, b)
                         for d in range(S)])
        start = (a - skip) // 2
        ref = fm.audio_s16(config, data, skip, start, device=device)
        if control is not None:
            pcm = fm.audio_s16(config, data, skip, start, precision=control,
                               device=device)
        pcm = np.stack(pcm).astype(np.int64)
        if pcm.shape != ref.shape:
            gap, rms = 1 << 16, float(1 << 16)
            continue
        d = pcm - ref.astype(np.int64)
        gap = max(gap, int(np.abs(d).max()))
        rms = max(rms, float(np.sqrt((d * d).mean(axis=1)).max()))
    # the widest gap of any sample, and the largest RMS gap of one
    # dongle's audio in one read
    readings = {"audio_gap_lsb": gap, "audio_rms_lsb": rms}
    return readings, [(n, v, limits[n]) for n, v in readings.items()
                      if n in limits]
