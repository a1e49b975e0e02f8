"""The system under test for the wideband configurations: ``multi_fm
--fused [--rds]`` as its read loop drives the port.

A read is ``WidebandStreamer(config, use_fused=True).demodulate`` (K3,
then the tail over every selected station, one CUDA graph replay), the
per-station s16 conversion, and with RDS one ``RdsStreamDecoder`` a
station fed the read's multiplex (``last_mpx``).  What the program gives
back is kept for the check: the s16 of the reads sampled from the window,
and every RDS group each decoder emits.
"""

from __future__ import annotations

import numpy as np

from sdrbench.capture import RDS_BIT_RATE
from sdrbench.reference import dsp, rds as rds_ref
from sdrbench.trace import NO_SPANS


class Receiver:
    def __init__(self, config: dict, traffic: dict, device):
        from tpu_sdr_torch.models import wbfm_wideband as wb
        from tpu_sdr_torch.native import f32_to_s16

        self.f32_to_s16 = f32_to_s16
        rds_on = bool(traffic["rds"])
        self.wb_config = wb.WidebandConfig(
            num_channels=config["num_channels"],
            taps_per_branch=config["taps_per_branch"],
            pfb_cutoff_frac=config["pfb_cutoff_frac"],
            channels=tuple(config["channels"]),
            channel_rate=config["channel_rate"],
            rate_resample=config["rate_resample"],
            resample_taps_per_phase=config["resample_taps_per_phase"],
            resample_cutoff_frac=config["resample_cutoff_frac"],
            emit_mpx=rds_on)
        self.streamer = wb.WidebandStreamer(self.wb_config, use_fused=True,
                                            device=device)
        self.decoders = []
        self.groups: list[list] = [[] for _ in config["channels"]]
        if rds_on:
            from tpu_sdr_torch.models import rds

            for out in self.groups:
                dec = rds.RdsStreamDecoder(device=device)
                dec.sync.feed = _recording(dec.sync.feed, out)
                self.decoders.append(dec)

    def read(self, buf: np.ndarray, spans=NO_SPANS) -> list:
        """One read, as ``multi_fm``'s loop does it; returns the stations'
        s16 audio."""
        with spans("demod"):
            audio = self.streamer.demodulate(buf)
        with spans("s16"):
            pcm = [self.f32_to_s16(a) for a in audio]
        if self.decoders:
            with spans("rds"):
                mpx = self.streamer.last_mpx
                for s, dec in enumerate(self.decoders):
                    dec.feed_mpx(mpx[s])
        return pcm

    def graph_keys(self) -> dict:
        keys = {"WidebandStreamer": len(self.streamer.graphs.keys)}
        if self.decoders:
            keys["RdsReceiver"] = sum(len(d.rx.graphs.keys)
                                      for d in self.decoders)
        return keys

    def close(self) -> None:
        self.streamer = None
        self.decoders = []


def _recording(feed, out: list):
    def recorded(bits):
        got = feed(bits)
        out.extend(got)
        return got
    return recorded


def check(config: dict, plan, ring: np.ndarray, kept: dict, groups: list,
          reads_fed: int, *, device, control: str | None = None
          ) -> tuple[dict, list]:
    """Every reading, and the numbers compared, each ``(name, value,
    limit)``: those the configuration gives a limit.

    ``kept``: read index -> the program's s16 of that read (stations,
    samples).  With ``control`` the program's audio is replaced by the
    reference computed at that precision, which has to fail."""
    limits = config["limits"]
    rb = plan.read_bytes
    look = dsp.lookback_bytes(config)
    # nothing compared is no pass
    gap, rms = (0, 0.0) if kept else (1 << 16, float(1 << 16))
    for i, pcm in sorted(kept.items()):
        r, prev = i % plan.ring_reads, (i - 1) % plan.ring_reads
        data = np.concatenate([ring[prev * rb + rb - look: prev * rb + rb],
                               ring[r * rb: r * rb + rb]])
        ref = dsp.audio_s16(config, data, look, device=device)
        if control is not None:
            pcm = dsp.audio_s16(config, data, look, precision=control,
                                device=device)
        pcm = np.stack(pcm).astype(np.int64)
        if pcm.shape != ref.shape:
            gap, rms = 1 << 16, float(1 << 16)
            continue
        d = pcm - ref.astype(np.int64)
        gap = max(gap, int(np.abs(d).max()))
        rms = max(rms, float(np.sqrt((d * d).mean(axis=1)).max()))
    # the widest gap of any sample, and the largest RMS gap of one
    # station's audio in one read
    readings = {"audio_gap_lsb": gap, "audio_rms_lsb": rms}
    if plan.rds:
        bits = reads_fed * plan.read_samples / plan.capture_rate * RDS_BIT_RATE
        r = rds_ref.compare([s.groups for s in plan.stations], groups, bits)
        readings["rds_wrong_groups"] = r["wrong"]
        readings["rds_missed_groups"] = r["missed"]
        readings["rds_groups"] = sum(len(g) for g in groups)
    return readings, [(n, v, limits[n]) for n, v in readings.items()
                      if n in limits]
