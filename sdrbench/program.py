"""The program's own span and counter totals
(``tpu_sdr_torch.utils.profiling.totals``) a read, for the readers of the
``program_span`` and ``program_counter`` metrics.

The totals hold every read the program made with no profiler active: the
warm-up and the window of a ``--trace 1`` run, not its profiled stretch.
A read is one ``WidebandStreamer.demodulate``.  Where the program keeps no
totals, or they hold no such span or none of the names asked for, a reader
finds nothing to read and returns ``None``."""

from __future__ import annotations

ROOT = "WidebandStreamer.demodulate"


def _totals() -> dict | None:
    try:
        from tpu_sdr_torch.utils import profiling
    except ImportError:
        return None
    get = getattr(profiling, "totals", None)
    totals = get() if callable(get) else None
    if not totals or not totals["spans"].get(ROOT, (0, 0))[0]:
        return None
    return totals


def span_ms(*names: str) -> float | None:
    """Host ms a read in the spans ``names`` together."""
    totals = _totals()
    if totals is None:
        return None
    got = [totals["spans"][n][1] for n in names if n in totals["spans"]]
    if not got:
        return None
    return sum(got) / totals["spans"][ROOT][0] / 1e6


def counter_per_read(name: str) -> float | None:
    """The counter ``name`` a read."""
    totals = _totals()
    if totals is None or name not in totals["counters"]:
        return None
    return totals["counters"][name] / totals["spans"][ROOT][0]
