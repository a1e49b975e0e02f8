"""The records of a ``--trace 1`` run: the harness's own host spans
around its calls into the program, timed over the whole window, and one
``torch.profiler`` trace of a stretch of reads after it, read whole.

Each read runs inside host spans named after what the harness is doing
(``feed``, ``demod``, ``s16``, ``rds``; anything else is
``between_reads``).  In the window they are timed on the host clock
alone; in the profiled stretch they are drawn into the trace as
``record_function`` ranges.  The profiler slows the host (by a third to
twice over, more the more operations a read launches), so host times come
from the window and device times from the trace.  A device record belongs to the span in which
the host made the call that launched it (its correlation id).  The trace
must be whole: every host call that puts work on the device (a launch, a
memcpy, a memset) made inside the traced range has a device record.  A
trace opens with pad launches and a pause outside that range (a trace's
first device records have come back missing on the H100), and one that is
not whole is taken again with a longer opening, up to :data:`TRIES` times.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

SPANS = ("feed", "demod", "s16", "rds")
RANGE = "sdrbench traced reads"
PAD_LAUNCHES = 64
TRIES = 3
CALL_KINDS = ("Launch", "Memcpy", "Memset", "Synchronize", "Event")


class TraceNotWhole(RuntimeError):
    pass


@dataclass
class TraceRecord:
    """What the metric readers read."""

    cell: object                       # manifest.Cell
    device_kind: str
    reads: int = 0                     # reads in the profiled stretch
    wall_s: float = 0.0                # its host wall
    # the window's reads, timed by the host clock with the profiler off
    spans: dict = field(default_factory=dict)       # name -> [seconds a read]
    read_s: float = 0.0                # the window's wall a read
    busy_s: float | None = None        # union of device intervals (None: no device)
    ops: list = field(default_factory=list)         # (name, seconds, span)
    host_calls: dict = field(default_factory=dict)  # CUDA runtime calls by name
    idle_by_span: dict = field(default_factory=dict)

    def span_mean_s(self, name: str) -> float | None:
        v = self.spans.get(name)
        return sum(v) / len(v) if v else None


class Spans:
    """The harness's spans of one read: host seconds, and a range in the
    trace when one is being taken."""

    def __init__(self, sink: dict | None = None, profiled: bool = False):
        self.sink = sink
        self.profiled = profiled
        self._open: dict = {}

    @contextmanager
    def __call__(self, name: str):
        if self.sink is None:
            yield
            return
        from torch.profiler import record_function

        t0 = time.perf_counter()
        if self.profiled:
            with record_function(name):
                yield
        else:
            yield
        self._open[name] = self._open.get(name, 0.0) + time.perf_counter() - t0

    def close_read(self) -> None:
        if self.sink is None:
            return
        for k, v in self._open.items():
            self.sink.setdefault(k, []).append(v)
        self._open = {}


NO_SPANS = Spans()


def _is_call(name: str) -> bool:
    return "Launch" in name or name.startswith(
        ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset"))


def _capture_spans(events) -> list:
    spans, begin = [], None
    for name, t0, t1 in sorted(events, key=lambda e: e[1]):
        if name.startswith(("cudaStreamBeginCapture", "cuStreamBeginCapture")):
            begin = t0
        elif begin is not None and name.startswith(
                ("cudaStreamEndCapture", "cuStreamEndCapture")):
            spans.append((begin, t1))
            begin = None
    return spans


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def take(read_once, n_reads: int, cell, device: torch.device) -> TraceRecord:
    """Trace ``read_once(spans)`` over ``n_reads`` reads."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    pad = torch.zeros(1, device=device)
    for attempt in range(1, TRIES + 1):
        sync()
        spans = Spans({}, profiled=True)
        with profile(activities=acts) as prof:
            for _ in range(PAD_LAUNCHES * attempt):
                pad.add_(1)
            sync()
            time.sleep(0.02 * attempt)
            with record_function(RANGE):
                t0 = time.perf_counter()
                for _ in range(n_reads):
                    read_once(spans)
                    spans.close_read()
                sync()
                wall = time.perf_counter() - t0
        raw = prof.profiler.kineto_results.events()
        host = [e for e in raw if e.device_type() != DeviceType.CUDA]
        rng = [e for e in host if e.name() == RANGE]
        if len(rng) != 1:
            raise TraceNotWhole(f"{len(rng)} traced ranges")
        lo, hi = rng[0].start_ns(), rng[0].end_ns()
        inside = [e for e in host if lo <= e.start_ns() <= hi]
        captured = _capture_spans((e.name(), e.start_ns(), e.end_ns())
                                  for e in inside)
        calls = {e.correlation_id(): e for e in inside if _is_call(e.name())
                 and not any(a <= e.start_ns() <= b for a, b in captured)}
        # (the profiler draws the harness's ranges on the device too)
        records = [e for e in raw if e.device_type() == DeviceType.CUDA
                   and e.correlation_id() in calls
                   and e.name() not in SPANS + (RANGE,)]
        lost = set(calls) - {e.correlation_id() for e in records}
        if not lost:
            break
        print(f"trace: {len(lost)} of {len(calls)} host calls without a device "
              f"record (attempt {attempt}); tracing again", file=sys.stderr,
              flush=True)
    else:
        raise TraceNotWhole(f"{len(lost)} of {len(calls)} host calls without a "
                            f"device record in each of {TRIES} traces")

    rec = TraceRecord(cell=cell, device_kind=(torch.cuda.get_device_name(device)
                                              if cuda else "cpu"),
                      reads=n_reads, wall_s=wall)
    # the harness's spans on the trace's clock, for the device records
    marks = sorted((e.start_ns(), e.end_ns(), e.name()) for e in inside
                   if e.name() in SPANS)
    starts = [m[0] for m in marks]

    def span_at(t_ns: int) -> str:
        i = bisect.bisect_right(starts, t_ns) - 1
        # spans nest nowhere, so the last one opened before t holds it or none
        if i >= 0 and marks[i][0] <= t_ns <= marks[i][1]:
            return marks[i][2]
        return "between_reads"

    for e in inside:
        name = e.name()
        if name.startswith(("cuda", "cu")) and any(k in name for k in CALL_KINDS):
            rec.host_calls[name] = rec.host_calls.get(name, 0) + 1
    intervals = []
    for e in records:
        t0, t1 = e.start_ns(), e.end_ns()
        intervals.append((t0, t1))
        rec.ops.append((e.name(), (t1 - t0) / 1e9,
                        span_at(calls[e.correlation_id()].start_ns())))
    if not records:
        return rec
    busy = _union(intervals)
    rec.busy_s = sum(b - a for a, b in busy) / 1e9
    # device idle time inside the range, by the host span it fell in
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
    if at < hi:
        gaps.append((at, hi))
    idle = defaultdict(float)
    for a, b in gaps:
        covered = 0
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(marks) and marks[i][0] < b:
            s0, s1, name = marks[i]
            ov = min(b, s1) - max(a, s0)
            if ov > 0:
                idle[name] += ov / 1e9
                covered += ov
            i += 1
        idle["between_reads"] += (b - a - covered) / 1e9
    rec.idle_by_span = dict(idle)
    return rec


def breakdown(rec: TraceRecord) -> dict:
    """The device operations that took most time and the device's idle
    time by what the host was doing, ten of each, in seconds."""
    by_op = defaultdict(float)
    for name, sec, _ in rec.ops:
        by_op[name[:96]] += sec
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(rec.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}
