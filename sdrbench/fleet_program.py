"""The program's own span and counter totals
(``tpu_sdr_torch.utils.profiling.totals``) a read of the station batch,
for the readers of the fleet's ``program_span`` and ``program_counter``
metrics: as ``program.py``, with a read being one
``FusedWbfmBatchStreamer.demodulate``.  Where the program keeps no totals,
or they hold no such span (a program older than it) or none of the names
asked for, a reader finds nothing to read and returns ``None``."""

from __future__ import annotations

ROOT = "FusedWbfmBatchStreamer.demodulate"


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


def span_ms(name: str) -> float | None:
    """Host ms a read in the span ``name``."""
    totals = _totals()
    if totals is None or name not in totals["spans"]:
        return None
    return totals["spans"][name][1] / totals["spans"][ROOT][0] / 1e6


def counter_per_read(name: str) -> float | None:
    """The counter ``name`` a read."""
    totals = _totals()
    if totals is None or name not in totals["counters"]:
        return None
    return totals["counters"][name] / totals["spans"][ROOT][0]
