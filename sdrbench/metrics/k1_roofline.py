"""k1_roofline: K1's (``fm_front``) share of its roofline, in percent: the
least time the card could take for a launch's bytes and operations
(``sdrbench.roofline_fm``) over K1's mean device time a launch in the
trace.  A launch takes one read of every dongle: its whole chunks, so a
read's bytes in the long run (a read and its residual give 2 or 3 chunks a
row), which is the mean a launch is counted at."""

from sdrbench import roofline_fm

KERNEL = "fm_front_kernel"


def read(rec):
    times = [dt for name, dt, _ in rec.ops if KERNEL in name]
    if not times:
        return None
    cfg = rec.cell.config
    samples = int(cfg["dongle_read_bytes"]) / 2
    taps = int(cfg["decim"]) * int(cfg["fir_taps_per_phase"])
    nbytes, ops = roofline_fm.k1_work(int(cfg["dongles"]), samples,
                                      int(cfg["decim"]), taps)
    bound = roofline_fm.bound_s(rec.device_kind, nbytes, ops)
    if bound is None:
        return None
    return 100.0 * bound / (sum(times) / len(times))
