"""``utils.profiling``'s spans and counters in the port's read path, on
the CPU: a fused ``WidebandStreamer`` with ``emit_mpx`` over 16 channels
and 8 stations, each fed to an ``RdsStreamDecoder``, as ``multi_fm
--fused --rds`` drives them.

Without a profiler the spans go to the totals; under one, to the
timeline alone, stamped on the profiler's clock: the aten operations a
step launches lie inside its spans, and an RDS decoder's spans carry the
read whose multiplex they consumed.  The counts are the reads', the
bytes copied on the host the sizes of the residuals kept, what was
staged and unpacked, and the outputs the same with the timeline on and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_sdr_torch.models import rds as R
from tpu_sdr_torch.models import wbfm_wideband as WB
from tpu_sdr_torch.ops import fused_fm as FF
from tpu_sdr_torch.ops import spectrum as SP
from tpu_sdr_torch.utils import profiling, synth

K, CH = 16, 170_000
CHANNELS = (1, 2, 3, 5, 11, 13, 14, 15)
CONFIG = WB.WidebandConfig(num_channels=K, channels=CHANNELS, emit_mpx=True)
QUANTUM = WB.fused_spec(CONFIG).chunk_bytes  # 21,760 bytes
READ = 2 * QUANTUM
ROOT, JOIN = WB.READ_SPAN, WB.JOIN_SPAN
STEP = ("stage", "replay", "sync", "unpack", "capture")
WIDE = tuple(f"WidebandStreamer.{p}" for p in STEP)
RDS_STEP = tuple(f"RdsReceiver.{p}" for p in STEP)
RDS_OWN = (R.JOIN_SPAN, R.BITS_SPAN, R.GROUPS_SPAN)


@pytest.fixture(scope="module")
def capture():
    groups = [R.make_group_0a(0xC0DE, 7, seg, "TRACING!"[2 * seg:2 * seg + 2])
              for seg in range(4)]
    bits = np.concatenate(groups * 2)
    n = int(0.45 * K * CH)
    n -= n % (QUANTUM // 2)
    freqs = [(c if c < K // 2 else c - K) * CH for c in CHANNELS]
    u8, _ = synth.synth_multistation_u8(
        n, K * CH, station_freqs=freqs,
        audio_freqs=[1000.0 + 150.0 * s for s in range(len(CHANNELS))],
        rds_bits=[bits] * len(CHANNELS))
    return np.asarray(u8, dtype=np.uint8)


def _receive(capture, read: int = READ) -> dict:
    """Every read through the streamer, then its multiplex through the
    decoders, one a station."""
    streamer = WB.WidebandStreamer(CONFIG, use_fused=True, device="cpu")
    decoders = [R.RdsStreamDecoder(device="cpu") for _ in CHANNELS]
    audio, events = [], [[] for _ in CHANNELS]
    for at in range(0, len(capture), read):
        audio.append(streamer.demodulate(capture[at:at + read]))
        for s, dec in enumerate(decoders):
            events[s].extend(dec.feed_mpx(streamer.last_mpx[s]))
    return {"audio": np.concatenate(audio, axis=1), "events": events,
            "streamer": streamer, "decoders": decoders, "reads": len(audio)}


@pytest.fixture(scope="module")
def untraced(capture):
    profiling.reset()
    run = _receive(capture)
    run["totals"] = profiling.totals()
    run["timeline"] = profiling.timeline()
    return run


@pytest.fixture(scope="module")
def traced(capture):
    """The same reads under a CPU profiler: the timeline, the aten
    operations' start stamps, the totals after."""
    from torch.autograd import DeviceType

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run = _receive(capture)
    run["totals"] = profiling.totals()
    run["timeline"] = profiling.timeline()
    run["aten"] = [e.start_ns() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CPU
                   and e.name().startswith("aten::")]
    return run


def test_spans_nest_and_count_the_reads(untraced):
    spans = untraced["totals"]["spans"]
    reads, n_st = untraced["reads"], len(CHANNELS)
    streamer, decoders = untraced["streamer"], untraced["decoders"]
    assert untraced["events"][0] and untraced["timeline"] == []
    assert spans[ROOT][0] == spans[JOIN][0] == reads
    for name in RDS_OWN + (R.FEED_SPAN,):
        assert spans[name][0] == n_st * reads, name
    g = streamer.graphs
    assert spans["WidebandStreamer.capture"][0] == g.captures
    for name in WIDE[:4]:
        assert spans[name][0] == g.replays == reads - g.captures, name
    captures = sum(d.rx.graphs.captures for d in decoders)
    assert spans["RdsReceiver.capture"][0] == captures
    for name in RDS_STEP[:4]:
        assert spans[name][0] == n_st * reads - captures, name
    # children within their parents
    assert sum(spans[n][1] for n in (JOIN,) + WIDE) <= spans[ROOT][1]
    assert sum(spans[n][1] for n in RDS_OWN + RDS_STEP) <= \
        spans[R.FEED_SPAN][1]
    assert all(ns > 0 for _, ns in spans.values())


@pytest.mark.parametrize("kind", ["fused_fm", "psd"])
def test_replay_spans_count_the_replays(kind):
    """Every graphed streamer's cache gets the spans: a replay span a
    replay, the sync and unpack spans only where outputs come back."""
    profiling.reset()
    if kind == "fused_fm":
        streamer = FF.FusedWbfmStreamer(device="cpu")
        chunk = streamer.spec.chunk_bytes
        u8, _ = synth.synth_wbfm_u8(6 * chunk, capture_rate=1_020_000,
                                    seed=3)
        u8 = np.asarray(u8, np.uint8)
        for at in range(0, len(u8), 2 * chunk + 7):
            streamer.demodulate(u8[at:at + 2 * chunk + 7])
        name, parts = "FusedWbfmStreamer", STEP[:4]
    else:
        streamer = SP.PsdStreamer(256, device="cpu")
        for k in range(5):
            streamer.accumulate(np.full(2048, k, np.uint8))
        name, parts = "PsdStreamer", STEP[:2]
    spans = profiling.totals()["spans"]
    g = streamer.graphs
    assert g.replays > 0
    assert spans[f"{name}.capture"][0] == g.captures
    for part in STEP[:4]:
        got = spans.get(f"{name}.{part}", (0, 0))[0]
        assert got == (g.replays if part in parts else 0), part


@pytest.mark.parametrize("residual", [0, 1000, QUANTUM - 1, "short"])
def test_host_copy_bytes_are_the_joins_the_staging_and_the_unpack(
        capture, residual):
    """Without decoders: each read's new residual (its tail under one
    quantum, copied once), its staging copy (the residual and the read's
    whole chunks, written once into the static input) and its outputs
    unpacked (the audio and the multiplex).  A read that leaves no whole
    chunk with the residual is joined to it instead ("short": a third of
    a chunk a read)."""
    profiling.reset()
    read = QUANTUM // 3 if residual == "short" else READ + residual
    streamer = WB.WidebandStreamer(CONFIG, use_fused=True, device="cpu")
    want, pending, outputs = 0, 0, 0
    for at in range(0, 8 * read, read):
        audio = streamer.demodulate(capture[at:at + read])
        total = pending + read
        usable = total - total % QUANTUM
        want += total if usable == 0 else total - usable
        pending = total - usable
        if usable:
            want += usable + audio.nbytes + streamer.last_mpx.nbytes
            outputs += 1
    assert outputs >= 2 and len(streamer._pending) == pending
    assert profiling.totals()["counters"] == {profiling.COPIED: want}


def test_profiled_spans_go_to_the_timeline_not_the_totals(untraced, traced):
    assert traced["totals"] == {"spans": {}, "counters": {}}
    counts: dict = {}
    copied = 0
    for s in traced["timeline"]:
        counts[s.name] = counts.get(s.name, 0) + 1
        copied += s.copied
    assert counts == {k: c for k, (c, _) in untraced["totals"]["spans"].items()}
    assert copied == untraced["totals"]["counters"][profiling.COPIED]
    profiling.reset()
    assert profiling.timeline() == [] and profiling.totals()["spans"] == {}


def test_timeline_spans_hold_the_aten_ops_their_step_launched(traced):
    """On the profiler's clock: every aten operation of the reads starts
    inside a span of the graphed step that launched it, and each replay
    (on the CPU the step itself) holds some."""
    tl = traced["timeline"]
    steps = sorted((s.start_ns, s.end_ns) for s in tl
                   if s.name in WIDE + RDS_STEP)
    starts = np.array([a for a, _ in steps])
    first, last = tl[0].start_ns, max(s.end_ns for s in tl)
    aten = np.sort([t for t in traced["aten"] if first <= t <= last])
    assert len(aten) > 100
    held = np.searchsorted(starts, aten, side="right") - 1
    assert (held >= 0).all()
    assert all(t <= steps[i][1] for t, i in zip(aten, held))
    for s in tl:
        if s.name.endswith(".replay"):
            a, b = np.searchsorted(aten, [s.start_ns, s.end_ns + 1])
            assert b > a, s


def test_rds_spans_carry_the_read_whose_multiplex_they_consumed(traced):
    tl = traced["timeline"]
    roots = [s for s in tl if s.name == ROOT]
    assert [s.read for s in roots] == list(range(1, traced["reads"] + 1))
    for i, s in enumerate(tl):
        if s.parent is not None:
            p = tl[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            assert (s.read, s.station) == (p.read, p.station), (s, p)
        else:
            assert s.name in (ROOT, R.FEED_SPAN), s
    read, station = 0, None
    for s in tl:
        if s.name == ROOT:
            read, station = s.read, -1
            assert s.station is None
        elif s.name == R.FEED_SPAN:
            station += 1
            assert (s.read, s.station) == (read, station)
    assert station == len(CHANNELS) - 1


def test_outputs_are_the_same_with_the_timeline_on_and_off(untraced, traced):
    assert np.array_equal(untraced["audio"], traced["audio"])
    assert untraced["events"] == traced["events"]
    assert any("PS: 'TRACING!'" in e for e in untraced["events"][0])


def test_chrome_events_put_the_spans_on_their_own_track():
    spans = [profiling.Span("A.replay", 5_000, 9_000, None, 3, 1, 0),
             profiling.Span("A.unpack", 9_000, 9_500, None, None, None, 64)]
    events = profiling._chrome_events(spans, 1_000)
    assert events[0]["args"]["name"] == profiling.TRACK
    assert [(e["ts"], e["dur"], e["args"]) for e in events[1:]] == [
        (4.0, 4.0, {"read": 3, "station": 1}),
        (8.0, 0.5, {profiling.COPIED: 64})]
    assert len({(e["pid"], e["tid"]) for e in events}) == 1
