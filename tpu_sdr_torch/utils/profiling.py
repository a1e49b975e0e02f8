"""Tracing and per-block throughput metrics — the counterpart of
``tpu_sdr/utils/profiling.py`` — and the port's own spans and counters.

The reference's only instrumentation is a per-block wall-clock average in
the demod thread plus a buffer-latency log line (simple_fm.rs:101-104,
143-168).  Here:

* :class:`BlockStats`, a copy of the JAX package's running samples/s /
  latency meter with the same running-average semantics;
* the program's spans and counters, taken at the layer boundaries of the
  read path (``WidebandStreamer.demodulate`` and its residual's
  bookkeeping; ``FusedWbfmStreamer.demodulate`` and
  ``FusedWbfmBatchStreamer.demodulate`` and their residual's join; each
  graphed step's staging, replay, device wait and unpack, the RDS
  decoders' residuals, bits and group layer) and kept in two records:

  - the totals (:func:`totals`): a count and the nanoseconds of each span
    name, and each counter's sum.  Always kept, at the cost of a few
    clock reads and dictionary updates a span.  Nothing that ends while a
    ``torch.profiler`` session is active is added: the profiler slows the
    host, so those times would not be the program's;
  - the timeline (:func:`timeline`): every span, kept only while a
    profiler session is active, stamped on the profiler's host clock
    (the ``start_ns()`` of its events) with its parent, the read it
    belongs to and, for an RDS decoder's spans, the station.  The spans
    are stamped with :data:`clock`, never drawn as ``record_function``
    ranges: the profiler would draw those on the device too, as work.

  One counter exists, :data:`COPIED`: the bytes the program copies on
  the host (each residual kept or join made, each copy of an input into
  a staging buffer, each output unpacked).  Both records are the process's and take no lock:
  spans come from one thread at a time, as the CLIs and the benchmark
  drive the streamers;
* :func:`trace`, on ``torch.profiler`` (where the JAX package uses
  ``jax.profiler``): a host and device trace of any streaming run,
  written as a Chrome trace with the timeline as a track of its own.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

@dataclass
class BlockStats:
    """Running per-block processing stats (ref simple_fm.rs:143-168).

    ``update(n_samples)`` wraps one block's processing; use as::

        with stats.block(n):
            ... process ...
        log.info(stats.summary())
    """

    blocks: int = 0
    samples: int = 0
    busy_s: float = 0.0
    dropped_blocks: int = 0
    latencies_ms: list = field(default_factory=list, repr=False)
    _t0: float = field(default=0.0, repr=False)
    _wall0: float = field(default_factory=time.monotonic, repr=False)

    @contextlib.contextmanager
    def block(self, n_samples: int):
        t = time.monotonic()
        yield
        self.busy_s += time.monotonic() - t
        self.blocks += 1
        self.samples += n_samples

    def drop(self, blocks: int = 1) -> None:
        self.dropped_blocks += blocks

    def latency(self, since: float | None) -> None:
        """Record one block's latency: from ``since`` (a
        ``time.monotonic()`` reading, e.g. the feeder's ``popped_at``) to
        now.  A port addition: the JAX meter has none."""
        if since is not None:
            self.latencies_ms.append(1000.0 * (time.monotonic() - since))

    @property
    def avg_block_ms(self) -> float:
        return 1000.0 * self.busy_s / self.blocks if self.blocks else 0.0

    @property
    def busy_samples_per_sec(self) -> float:
        """Throughput while actually processing (the compute bound)."""
        return self.samples / self.busy_s if self.busy_s > 0 else 0.0

    @property
    def wall_samples_per_sec(self) -> float:
        """End-to-end throughput including feed/idle time (the real-time
        margin the reference's ~128 ms bound expresses)."""
        wall = time.monotonic() - self._wall0
        return self.samples / wall if wall > 0 else 0.0

    def summary(self) -> str:
        return (
            f"{self.blocks} blocks, avg {self.avg_block_ms:.2f} ms/block, "
            f"{self.busy_samples_per_sec / 1e6:.2f} Msps busy "
            f"({self.wall_samples_per_sec / 1e6:.2f} Msps wall), "
            f"{self.dropped_blocks} dropped"
        )


# -- the program's spans and counters ----------------------------------------

clock = time.perf_counter_ns  # every span's stamps
COPIED = "host_copy_bytes"    # the counter of bytes copied on the host
TRACK = "tpu_sdr_torch spans"  # the timeline's track in a Chrome trace
_TRACK_TID = 0x7FFFFFFF


class Span(NamedTuple):
    """One span of the timeline, on the profiler's host clock."""

    name: str
    start_ns: int
    end_ns: int
    parent: int | None   # the index of the span that holds it
    read: int | None     # the read it belongs to: its demodulate call's id
    station: int | None  # the station whose multiplex an RDS span consumed
    copied: int          # bytes copied on the host inside it (COPIED)


# the totals: name -> [count, ns, bytes copied on the host inside]
_spans: dict[str, list[int]] = {}
_steps: dict[tuple, list] = {}  # step_spans's names -> their totals
# the timeline, each event a list: the fields of Span, then the index of
# the first event of its subtree (events are recorded as they end, so a
# span's descendants come right before it)
_events: list[list] = []
_orphans: list[int] = []  # events whose parent has not ended yet
_live = False             # the timeline belongs to an active session
_offset = 0               # the profiler's clock less clock()
_reads = 0                # the timeline's last read id
_mpx: tuple = (None, None)  # the last read's multiplex and its id


def span(name: str, t0: int, t1: int, copied: int = 0) -> None:
    """One span from ``t0`` to ``t1`` (:data:`clock` stamps) with
    ``copied`` bytes copied on the host inside it: into the totals, or
    into the timeline while a profiler session is active."""
    if _profiler._is_profiler_enabled or _live:
        _record(name, t0, t1, copied)
        return
    try:
        c = _spans[name]
    except KeyError:
        _spans[name] = [1, t1 - t0, copied]
        return
    c[0] += 1
    c[1] += t1 - t0
    c[2] += copied


def step_spans(names: tuple, t0: int, t1: int, t2: int, t3: int, t4: int,
               staged: int, unpacked: int) -> None:
    """The stage, replay, sync and unpack spans of one call of a graphed
    step (``names``, those four first), back to back from ``t0`` to
    ``t4``, with ``staged`` bytes copied in the first and ``unpacked`` in
    the last: four :func:`span` calls in one."""
    if _profiler._is_profiler_enabled or _live:
        span(names[0], t0, t1, staged)
        span(names[1], t1, t2)
        span(names[2], t2, t3)
        span(names[3], t3, t4, unpacked)
        return
    try:
        a, b, c, d = _steps[names]
    except KeyError:
        a, b, c, d = _steps[names] = [_spans.setdefault(n, [0, 0, 0])
                                      for n in names[:4]]
    a[0] += 1
    a[1] += t1 - t0
    a[2] += staged
    b[0] += 1
    b[1] += t2 - t1
    c[0] += 1
    c[1] += t3 - t2
    d[0] += 1
    d[1] += t4 - t3
    d[2] += unpacked


def read_span(name: str, t0: int, t1: int, mpx=None) -> None:
    """The root span of a read.  In the timeline it takes a new read id,
    which the spans inside it share; ``mpx``, the read's multiplex (one
    row a station), gives that id to the RDS decoders fed from it."""
    if _profiler._is_profiler_enabled or _live:
        _record(name, t0, t1, 0, "read", mpx)
    else:
        span(name, t0, t1)


def fed_span(name: str, t0: int, t1: int, mpx) -> None:
    """The root span of an RDS decoder's share of a read, fed ``mpx``: in
    the timeline it and the spans inside it carry the id of the read whose
    multiplex ``mpx`` is a row of, and that row's index (the station)."""
    if _profiler._is_profiler_enabled or _live:
        _record(name, t0, t1, 0, "fed", mpx)
    else:
        span(name, t0, t1)


def _begin() -> None:
    """A new timeline, for the profiler session just started."""
    global _live, _offset, _reads, _mpx
    _events.clear()
    _orphans.clear()
    _reads, _mpx, _live = 0, (None, None), True
    a = time.time_ns()
    p = clock()
    _offset = (a + time.time_ns()) // 2 - p


def _record(name, t0, t1, copied, root=None, mpx=None) -> None:
    global _live, _reads, _mpx
    if not _profiler._is_profiler_enabled:  # the session has ended
        _live = False
        span(name, t0, t1, copied)
        return
    if not _live:
        _begin()
    i = len(_events)
    start = t0 + _offset
    first = i
    while _orphans and _events[_orphans[-1]][1] >= start:
        child = _events[_orphans.pop()]
        child[3] = i
        first = min(first, child[7])
    read = station = None
    if root == "read":
        _reads += 1
        read = _reads
        _mpx = (mpx, read)
    elif root == "fed":
        base, known = _mpx
        if base is not None and getattr(mpx, "base", None) is base:
            read = known
            station = ((mpx.__array_interface__["data"][0]
                        - base.__array_interface__["data"][0])
                       // base.strides[0])
    if root is not None:
        for e in _events[first:i]:
            if e[4] is None:
                e[4], e[5] = read, station
    _events.append([name, start, t1 + _offset, None, read, station, copied,
                    first])
    _orphans.append(i)


def totals() -> dict:
    """The always-kept totals: ``{"spans": {name: (count, ns)},
    "counters": {name: sum}}``."""
    copied = sum(c[2] for c in _spans.values())
    return {"spans": {k: (c, ns) for k, (c, ns, _) in _spans.items()},
            "counters": {COPIED: copied} if copied else {}}


def timeline() -> list[Span]:
    """The spans of the last profiler session (or of the one active), in
    the order they ended."""
    return [Span(*e[:7]) for e in _events]


def reset() -> None:
    """Empty the totals and the timeline."""
    global _live, _reads, _mpx
    _spans.clear()
    _steps.clear()
    _events.clear()
    _orphans.clear()
    _live, _reads, _mpx = False, 0, (None, None)


def _chrome_events(spans: list[Span], base_ns: int) -> list[dict]:
    """The timeline as Chrome trace events on a track of its own of this
    process, ``ts`` in µs from ``base_ns``."""
    pid = os.getpid()
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": _TRACK_TID,
            "args": {"name": TRACK}}]
    for s in spans:
        args = {"read": s.read, "station": s.station}
        args = {k: v for k, v in args.items() if v is not None}
        if s.copied:
            args[COPIED] = s.copied
        out.append({"ph": "X", "cat": "program_span", "name": s.name,
                    "pid": pid, "tid": _TRACK_TID,
                    "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


# A CUDA trace opens with this many small launches and a pause, outside
# the TRACED_RANGE that then holds the traced code: the profiler may drop
# a session's first device records (on an H100, the first 0.6-2.2 ms of a
# process that traced before), so a reader counts only what lies inside.
PAD_LAUNCHES = 64
TRACED_RANGE = "traced run"


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Host + device trace via ``torch.profiler`` (the CPU activity, and
    the CUDA activity where a GPU is present), written on exit as a Chrome
    trace ``*.pt.trace.json`` into ``log_dir`` (view with Perfetto,
    chrome://tracing or TensorBoard's profiler plugin), with the program's
    spans of the session on a track of their own (:data:`TRACK`), on the
    same time axis as the host's calls and the device's records.  With a
    GPU the traced code runs inside a :data:`TRACED_RANGE` range, after
    :data:`PAD_LAUNCHES` pad launches.  A no-op when ``log_dir`` is
    falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=lambda prof: _write_trace(prof, log_dir)):
        _begin()
        if cuda:
            pad = torch.zeros(1, device="cuda")
            for _ in range(PAD_LAUNCHES):
                pad.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.02)
        with torch.profiler.record_function(TRACED_RANGE):
            yield


def _write_trace(prof, log_dir: str) -> None:
    """The session's Chrome trace into ``log_dir``, named as
    ``tensorboard_trace_handler`` names it, with the timeline added."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                        f"{time.time_ns() // 1_000_000}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(_chrome_events(
        timeline(), int(doc.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(doc, f)
