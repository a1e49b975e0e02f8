"""The station batch as a fleet of dongles (``FusedWbfmBatchStreamer``,
the benchmark's ``fleet16.reads256k``), on the CPU with the kernels'
plain versions: against the benchmark's plain reference
(``sdrbench/reference/fm.py``), the reference's fs/4 sign against the
capture's tones, and the read's spans and bytes copied on the host."""

import json
import os
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdrbench import capture
from sdrbench.reference import fm
from tpu_sdr_torch.native import f32_to_s16
from tpu_sdr_torch.ops import fused_fm as FF
from tpu_sdr_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DONGLES = 4
CHUNK = FF.default_spec().chunk_bytes  # 130,560 bytes
# a row's reads: a residual kept at each, a call with one chunk, one with
# none (the residual and the read under a chunk), one with three
READS = (300_000, 100_000, 20_000, 400_000, 262_144)
# The program is float32 with K1's 6-term atan (9.9e-6 rad) and the FIR's
# split-bf16 taps: errors well under one LSB of s16, which truncation turns
# into at most 1 LSB where a sample lies near a step, and an RMS over a
# dongle's audio far under 0.1 LSB.  The TF32 control's products carry 10
# mantissa bits and miss both by several times.
GAP_LSB, RMS_LSB = 1, 0.1


def _config() -> dict:
    with open(os.path.join(REPO, "sdrbench", "configs", "wbfm_fleet16.json")) as f:
        return json.load(f)


def _plan(read_bytes: int, ring_reads: int, seed: int):
    with open(os.path.join(REPO, "sdrbench", "traffic", "fleet16.json")) as f:
        traffic = json.load(f)
    traffic.update(read_bytes=read_bytes, ring_reads=ring_reads)
    return capture.plan(_config(), traffic, seed)


@pytest.fixture(scope="module")
def rows():
    """(DONGLES, bytes) of seeded FM captures, one a dongle."""
    n = sum(READS)
    ring = capture.synthesize(_plan(DONGLES * n, 1, 2**31 + 17), CPU).numpy()
    return ring.reshape(DONGLES, n)


def _gaps(pcm: np.ndarray, ref: np.ndarray) -> tuple[int, float]:
    d = pcm.astype(np.int64) - ref.astype(np.int64)
    return int(np.abs(d).max()), float(np.sqrt((d * d).mean(axis=1)).max())


def test_the_batch_streamer_agrees_with_the_reference(rows):
    streamer = FF.FusedWbfmBatchStreamer(DONGLES, device=CPU)
    audio, at, chunks = [], 0, []
    for n in READS:
        before = streamer._pending.shape[-1]
        out = streamer.demodulate(rows[:, at:at + n])
        audio.append(out)
        chunks.append((before + n) // CHUNK)
        at += n
    assert chunks == [2, 1, 0, 3, 2]
    audio = np.concatenate(audio, axis=1)
    used = sum(chunks) * CHUNK
    assert streamer._pending.shape == (DONGLES, sum(READS) - used)
    pcm = np.stack([f32_to_s16(a) for a in audio])
    cfg = _config()
    ref = fm.audio_s16(cfg, rows[:, :used], 0)
    assert pcm.shape == ref.shape
    gap, rms = _gaps(pcm, ref)
    assert gap <= GAP_LSB and rms < RMS_LSB, (gap, rms)
    control = fm.audio_s16(cfg, rows[:, :used], 0, precision="tf32")
    gap, rms = _gaps(control, ref)
    assert gap > GAP_LSB and rms > RMS_LSB, (gap, rms)


def test_a_span_after_a_lookback_is_the_whole_streams(rows):
    """The reference from a lookback of whole frames, from zero state and
    at the stream's absolute fs/4 phase, gives the bits of the whole
    stream's reference: the harness's check compares each read so."""
    cfg = _config()
    look, frame = fm.lookback_bytes(cfg), fm.frame_bytes(cfg)
    a, b = 2 * CHUNK, 3 * CHUNK
    whole = fm.audio_s16(cfg, rows[:, :b], a)
    # start one frame in from a multiple of 4 samples, to test the phase
    skip = look + frame if (a - look) % 8 == 0 else look
    part = fm.audio_s16(cfg, rows[:, a - skip:b], skip, (a - skip) // 2)
    assert np.array_equal(part, whole)


def _tone_share(audio: np.ndarray, tones_hz, rate: int) -> float:
    x = audio.astype(np.float64)
    x = (x - x.mean()) * np.hanning(len(x))
    power = np.abs(np.fft.rfft(x)) ** 2
    f = np.fft.rfftfreq(len(x), 1 / rate)
    near = np.zeros_like(power, dtype=bool)
    for hz in tones_hz:
        near |= np.abs(f - hz) <= 4 * rate / len(x)
    return float(power[near].sum() / power.sum())


@pytest.mark.parametrize("channel, holds", [(3, True), (1, False)])
def test_a_dongles_piece_holds_the_plans_tones(channel, holds):
    """A station at -fs/4 (channel 3 of 4, where simple_fm's offset tuning
    leaves it) comes out as the plan's three tones; the same at +fs/4
    (the wrong sign) does not."""
    cfg = _config()
    plan = _plan(DONGLES * 262_144, 2, 2**31 + 29)
    plan = replace(plan, stations=(replace(plan.stations[0],
                                           channel=channel),))
    ring = capture.synthesize(plan, CPU).numpy()
    frame = fm.frame_bytes(cfg)
    d, k = 2, 1                                # dongle 2's read 1
    piece = ring.reshape(-1, DONGLES, 262_144)[k, d]
    piece = piece[:len(piece) - len(piece) % frame]
    audio = fm.audio_s16(cfg, piece[None], 0, k * 131_072)[0]
    tones = [c * plan.capture_rate / plan.ring_samples
             for c, _, _ in plan.stations[0].tones]
    share = _tone_share(audio[300:], tones, cfg["rate_resample"])
    assert (share > 0.9) if holds else (share < 0.2), share


def _expected_copies(streamer, reads) -> tuple[list[int], int, int]:
    """The join's bytes a call, every byte copied on the host, and the
    calls of the graphed step.  A numpy read goes to the step in pieces:
    its join copies the read's tail under one chunk, kept as the residual,
    or, where the residual and the read hold no whole chunk, the two
    joined; a tensor read is joined where a residual leads it.  Then the
    copy into the CPU's static input (once, whole or in pieces) and the
    float32 audio unpacked."""
    rows = getattr(streamer, "stations", 1)
    up, down = streamer.spec.up, streamer.spec.down
    frame = 2 * streamer.spec.decim * down
    joins, total, steps, pending = [], 0, 0, 0
    for buf in reads:
        joined = pending + buf.shape[-1]
        usable = joined - joined % CHUNK
        pending = joined - usable
        if torch.is_tensor(buf):
            join = 0 if joined == buf.shape[-1] else rows * joined
        else:
            join = rows * (pending if usable else joined)
        joins.append(join)
        total += join + rows * (usable + usable // frame * up * 4)
        steps += usable > 0
    return joins, total, steps


def _cases(rows):
    one = rows[0]
    return {
        "batch": (lambda: FF.FusedWbfmBatchStreamer(DONGLES, device=CPU),
                  [rows[:, :300_000], rows[:, 300_000:320_000],
                   rows[:, 320_000:700_000]],
                  FF.BATCH_READ_SPAN, FF.BATCH_JOIN_SPAN),
        "one": (lambda: FF.FusedWbfmStreamer(device=CPU),
                [one[:300_000], one[300_000:320_000], one[320_000:700_000]],
                FF.READ_SPAN, FF.JOIN_SPAN),
        # a tensor read of whole chunks with no residual is not joined
        "tensor": (lambda: FF.FusedWbfmStreamer(device=CPU),
                   [torch.from_numpy(one[:2 * CHUNK].copy()),
                    torch.from_numpy(one[2 * CHUNK:2 * CHUNK + 50_000].copy()),
                    torch.from_numpy(one[2 * CHUNK + 50_000:600_000].copy())],
                   FF.READ_SPAN, FF.JOIN_SPAN),
    }


@pytest.mark.parametrize("case", ["batch", "one", "tensor"])
def test_a_read_records_its_spans_and_the_joins_bytes(rows, case):
    make, reads, root, join = _cases(rows)[case]
    name = "FusedWbfmBatchStreamer" if case == "batch" else "FusedWbfmStreamer"
    joins, total, steps = _expected_copies(make(), reads)

    profiling.reset()
    streamer = make()
    plain = [streamer.demodulate(r) for r in reads]
    spans = profiling.totals()["spans"]
    assert spans[root][0] == spans[join][0] == len(reads)
    assert sum(spans.get(f"{name}.{part}", (0, 0))[0]
               for part in ("replay", "capture")) == steps
    assert profiling.totals()["counters"][profiling.COPIED] == total

    # under a profiler: the same audio, and each join's bytes in the timeline
    profiling.reset()
    streamer = make()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = [streamer.demodulate(r) for r in reads]
    timeline = profiling.timeline()
    assert [s.copied for s in timeline if s.name == join] == joins
    assert sum(s.name == root for s in timeline) == len(reads)
    assert all(s.read is not None for s in timeline if s.name == join)
    for a, b in zip(plain, traced):
        assert np.array_equal(a, b)
    assert sum(s.copied for s in timeline) == total
    profiling.reset()
