"""device_idle_pct: the share of a read in which no operation runs on the
card, in percent: 100 less the union of the card's intervals a read in the
profiled stretch over the window's host wall a read (the profiler slows
the host, so the profiled stretch's own wall would overstate it)."""


def read(rec):
    if rec.busy_s is None or not rec.reads or rec.read_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.reads / rec.read_s)
