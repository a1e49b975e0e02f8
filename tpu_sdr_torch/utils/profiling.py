"""Tracing and per-block throughput metrics — the counterpart of
``tpu_sdr/utils/profiling.py``.

The reference's only instrumentation is a per-block wall-clock average in
the demod thread plus a buffer-latency log line (simple_fm.rs:101-104,
143-168).  Here: (a) :class:`BlockStats`, a copy of the JAX package's
running samples/s / latency meter with the same running-average
semantics, and (b) :func:`trace` and :func:`annotate` on
``torch.profiler`` (where the JAX package uses ``jax.profiler``): a host
and device trace of any streaming run, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


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
    chrome://tracing or TensorBoard's profiler plugin).  With a GPU the
    traced code runs inside a :data:`TRACED_RANGE` range, after
    :data:`PAD_LAUNCHES` pad launches.  A no-op when ``log_dir`` is
    falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        if cuda:
            pad = torch.zeros(1, device="cuda")
            for _ in range(PAD_LAUNCHES):
                pad.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.02)
        with torch.profiler.record_function(TRACED_RANGE):
            yield


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the trace (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield
