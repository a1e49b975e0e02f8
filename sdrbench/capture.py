"""The benchmark's capture generator, frozen apart from the program.

A wideband u8 I/Q capture at ``K * channel_rate`` holding one WBFM
station in each selected channel, as an RTL-SDR delivers it: each
station a carrier at its channel's centre, frequency-modulated by
programme audio (a few tones), with a 19 kHz pilot and a 57 kHz RDS
subcarrier when the traffic carries RDS, plus complex Gaussian noise,
quantized to interleaved u8.  Rewritten from the port's
``utils/synth.py`` (``synth_multistation_u8``) and the RDS group
encoders of ``models/rds.py``, so that later changes to the program do
not move the yardstick.

The capture is a ring of ``ring_reads`` reads, built once on the device
and cycled by the run.  The ring is seamless: every component has a whole
number of periods in it (tones of whole cycles, the pilot and the 57 kHz
carrier at whole cycles, the RDS bit stream a whole number of groups of
even parity, so that its differential code repeats), and the FM phase is
written in closed form rather than as a running sum, so sample ``n`` of
the ring is sample ``n + ring length`` of an endless capture.  Phases
come from integer arithmetic (``c * n mod N``), exact at any length.

The seed sets the content (carrier phases, programme audio, RDS payload,
noise) and none of the work: bytes a read, stations, RDS groups a second
and the ring's length depend on the configuration and the traffic only
(:func:`signature`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

RDS_BIT_RATE = 1187.5          # bit/s, locked to the pilot: 57 kHz / 48
GROUP_BITS = 104
PILOT_HZ = 19_000
RDS_HZ = 57_000
# the multiplex levels of a station that carries RDS (as the port's synth)
AUDIO_LEVEL_RDS, PILOT_LEVEL, RDS_LEVEL = 0.6, 0.1, 0.06
AUDIO_LEVEL_MONO = 0.9
CHUNK = 1 << 22                # samples synthesized at a time


@dataclass(frozen=True)
class Station:
    channel: int                       # index into the K channels
    carrier_phase: float
    tones: tuple                       # (cycles in the ring, amplitude, phase)
    groups: tuple | None               # RDS groups of one ring, 4 words each


@dataclass(frozen=True)
class Plan:
    capture_rate: int
    num_channels: int
    read_bytes: int
    ring_reads: int
    deviation: float
    amplitude: float
    noise_std: float
    seed: int
    stations: tuple

    @property
    def read_samples(self) -> int:
        return self.read_bytes // 2

    @property
    def ring_samples(self) -> int:
        return self.ring_reads * self.read_samples

    @property
    def ring_seconds(self) -> float:
        return self.ring_samples / self.capture_rate

    @property
    def rds(self) -> bool:
        return self.stations[0].groups is not None


# -- RDS groups (IEC 62106): 26-bit blocks, CRC-10 checkword + offset word --

_G_POLY = 0b10110111001
OFFSET_WORDS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "C'": 0x350, "D": 0x1B4}


def crc10(info: int) -> int:
    reg = info << 10
    for bit in range(25, 9, -1):
        if reg & (1 << bit):
            reg ^= _G_POLY << (bit - 10)
    return reg & 0x3FF


def group_bits(words) -> np.ndarray:
    """Four 16-bit words -> the 104 transmitted bits (offsets A, B, C, D)."""
    bits = []
    for w, off in zip(words, ("A", "B", "C", "D")):
        word = (w << 10) | (crc10(w) ^ OFFSET_WORDS[off])
        bits.extend((word >> (25 - i)) & 1 for i in range(26))
    return np.array(bits, np.uint8)


def _station_groups(rng: np.random.Generator, n_groups: int, pi: int
                    ) -> tuple:
    """One ring of groups for a station: 0A (PS, two characters, and an
    AF pair unique to its place) and 2A (RadioText, four characters)
    alternately, every group distinct within the ring, the ring's bits of
    even parity."""
    if n_groups > 2 * 204:
        raise ValueError(f"{n_groups} groups a ring: too many to keep distinct")
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ 0123456789"))
    ps = "".join(rng.choice(letters[:26], 8))
    rt = "".join(rng.choice(letters, 64))
    pty = int(rng.integers(1, 32))
    af_lo = int(rng.integers(1, 205))
    groups = []
    for g in range(n_groups):
        x = g // 2
        if g % 2 == 0:
            seg = x % 4
            b = (pty << 5) | seg
            c = ((1 + x) << 8) | af_lo
            d = (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])
        else:
            seg, flag = x % 16, (x // 16) % 2
            b = (2 << 12) | (pty << 5) | (flag << 4) | seg
            c = (ord(rt[4 * seg]) << 8) | ord(rt[4 * seg + 1])
            d = (ord(rt[4 * seg + 2]) << 8) | ord(rt[4 * seg + 3])
        groups.append((pi, b, c, d))
    # even parity, so that the differential code repeats with the ring:
    # move the last 0A group's AF code until the ring's bits sum even
    last = (n_groups - 1) & ~1
    others = sum(int(group_bits(w).sum()) for w in groups[:last]
                 + groups[last + 1:])
    for code in range(1, 205):
        pi_, b, c, d = groups[last]
        groups[last] = (pi_, b, (c & 0xFF00) | code, d)
        if (others + int(group_bits(groups[last]).sum())) % 2 == 0:
            break
    else:
        raise ValueError("no AF code gives the ring's RDS bits even parity")
    if len(set(groups)) != n_groups:
        raise ValueError("RDS groups of a ring are not distinct")
    return tuple(groups)


def plan(config: dict, traffic: dict, seed: int) -> Plan:
    """The content of a cell's capture, drawn from the seed."""
    K = int(config["num_channels"])
    fs = K * int(config["channel_rate"])
    read_bytes, ring_reads = int(traffic["read_bytes"]), int(traffic["ring_reads"])
    if read_bytes % (2 * K):
        raise ValueError(f"reads of {read_bytes} bytes are not whole frames")
    n_ring = ring_reads * read_bytes // 2
    rds = bool(traffic["rds"])
    if rds:
        for hz in (PILOT_HZ, RDS_HZ):
            if (hz * n_ring) % fs:
                raise ValueError(f"{hz} Hz has no whole cycles in the ring")
        bits = n_ring * RDS_BIT_RATE / fs
        if bits != int(bits) or int(bits) % GROUP_BITS:
            raise ValueError(f"the ring holds {bits} RDS bits, not whole groups")
    rng = np.random.default_rng(seed % 2**63)
    lo, hi = traffic["audio_hz"]
    ring_s = n_ring / fs
    channels = [int(c) for c in config["channels"]]
    pis = rng.choice(np.arange(0x1000, 0xFFFF), len(channels), replace=False)
    stations = []
    for ch, pi in zip(channels, pis):
        cycles = rng.integers(math.ceil(lo * ring_s), int(hi * ring_s) + 1,
                              int(traffic["tones"]))
        amps = rng.uniform(0.5, 1.0, len(cycles))
        amps = amps / amps.sum() * (AUDIO_LEVEL_RDS if rds else AUDIO_LEVEL_MONO)
        tones = tuple((int(c), float(a), float(p)) for c, a, p in
                      zip(cycles, amps, rng.uniform(0, 2 * np.pi, len(cycles))))
        groups = (_station_groups(rng, int(round(ring_s * RDS_BIT_RATE))
                                  // GROUP_BITS, int(pi)) if rds else None)
        stations.append(Station(ch, float(rng.uniform(0, 2 * np.pi)), tones,
                                groups))
    return Plan(fs, K, read_bytes, ring_reads, float(traffic["deviation_hz"]),
                0.85 / len(channels), float(traffic["noise_std"]), int(seed),
                tuple(stations))


def signature(p: Plan, graph_keys: dict | None = None) -> dict:
    """The work a run does, which no seed may change."""
    sig = {"read_bytes": p.read_bytes, "stations": len(p.stations),
           "channels": [s.channel for s in p.stations],
           "rds_groups_per_s_per_station":
               (len(p.stations[0].groups) / p.ring_seconds) if p.rds else 0.0,
           "ring_reads": p.ring_reads, "ring_bytes": p.ring_reads * p.read_bytes}
    if graph_keys is not None:
        sig["graph_keys"] = graph_keys
    return sig


def _cycle(num: int, n: torch.Tensor, den: int) -> torch.Tensor:
    """``2 pi ((num * n) mod den) / den`` in float64, exact for int64 n."""
    return (torch.remainder(n * num, den).to(torch.float64)
            * (2 * math.pi / den))


def synthesize(p: Plan, device: str | torch.device) -> torch.Tensor:
    """The ring as interleaved u8 I/Q bytes on ``device`` (float64 phase,
    a chunk of samples at a time, noise from a ``torch.Generator`` there
    seeded with the plan's seed)."""
    device = torch.device(device)
    K, fs, N = p.num_channels, p.capture_rate, p.ring_samples
    gen = torch.Generator(device=device)
    gen.manual_seed(p.seed % 2**63)
    out = torch.empty(2 * N, dtype=torch.uint8, device=device)
    sym = []
    for st in p.stations:
        if st.groups is None:
            sym.append(None)
            continue
        b = np.concatenate([group_bits(w) for w in st.groups])
        d = np.bitwise_xor.accumulate(b)
        sym.append(torch.from_numpy(1.0 - 2.0 * d).to(device))
    dev = p.deviation
    for start in range(0, N, CHUNK):
        n = torch.arange(start, min(N, start + CHUNK), device=device,
                         dtype=torch.int64)
        re = torch.zeros(len(n), dtype=torch.float64, device=device)
        im = torch.zeros_like(re)
        for st, s in zip(p.stations, sym):
            # channel k sits at k fs / K (k > K/2: the same as k - K)
            ph = _cycle(st.channel, n, K) + st.carrier_phase
            for cycles, amp, theta in st.tones:
                # 2 pi dev * integral of amp sin(2 pi f t + theta)
                f = cycles * fs / N
                ph -= (dev * amp / f) * torch.cos(_cycle(cycles, n, N) + theta)
            if s is not None:
                ph += (dev * PILOT_LEVEL / PILOT_HZ) * torch.sin(
                    _cycle(PILOT_HZ, n, fs))
                # the symbol holds over each half bit, and each half bit is
                # 24 whole cycles of 57 kHz, so the phase is continuous
                half = torch.div(n * int(2 * RDS_BIT_RATE), fs,
                                 rounding_mode="floor")
                sign = s[torch.remainder(half // 2, len(s))] * (
                    1.0 - 2.0 * torch.remainder(half, 2).to(torch.float64))
                ph += (dev * RDS_LEVEL / RDS_HZ) * sign * torch.sin(
                    _cycle(RDS_HZ, n, fs))
            re += p.amplitude * torch.cos(ph)
            im += p.amplitude * torch.sin(ph)
        if p.noise_std > 0:
            noise = torch.randn(2, len(n), generator=gen, device=device,
                                dtype=torch.float32).to(torch.float64)
            re += p.noise_std * noise[0]
            im += p.noise_std * noise[1]
        iq = torch.stack([re, im], dim=1).reshape(-1)
        out[2 * start: 2 * start + len(iq)] = torch.clamp(
            torch.round(iq * 127.0 + 127.5), 0, 255).to(torch.uint8)
    return out
