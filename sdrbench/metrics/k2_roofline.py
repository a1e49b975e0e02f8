"""k2_roofline: K2's (``fm_resample``) share of its roofline, in percent:
the least time the card could take for a launch's bytes and operations
(``sdrbench.roofline_fm``) over K2's mean device time a launch in the
trace, a launch counted at a read's z samples in the long run (as
``k1_roofline``)."""

from sdrbench import roofline_fm
from sdrbench.reference.fm import resampler_ratio

KERNEL = "fm_resample_kernel"


def read(rec):
    times = [dt for name, dt, _ in rec.ops if KERNEL in name]
    if not times:
        return None
    cfg = rec.cell.config
    up, down = resampler_ratio(cfg)
    inputs = int(cfg["dongle_read_bytes"]) / 2 / int(cfg["decim"])
    nbytes, ops = roofline_fm.k2_work(int(cfg["dongles"]), inputs, up, down,
                                      int(cfg["resample_taps_per_phase"]))
    bound = roofline_fm.bound_s(rec.device_kind, nbytes, ops)
    if bound is None:
        return None
    return 100.0 * bound / (sum(times) / len(times))
