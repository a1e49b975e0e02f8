"""k3_roofline: K3's share of its roofline, in percent: the least time
the card could take for one launch's bytes and operations
(``sdrbench.roofline``) over K3's mean device time a launch in the trace."""

from sdrbench import roofline

K3_KERNELS = ("pfb64_kernel", "pfb_direct_kernel")


def read(rec):
    times = [dt for name, dt, _ in rec.ops
             if any(k in name for k in K3_KERNELS)]
    if not times:
        return None
    cfg, traffic = rec.cell.config, rec.cell.traffic
    K = cfg["num_channels"]
    frames = traffic["read_bytes"] // (2 * K)
    nbytes, ops = roofline.k3_work(K, cfg["taps_per_branch"], frames, K)
    bound = roofline.bound_s(rec.device_kind, nbytes, ops)
    if bound is None:
        return None
    return 100.0 * bound / (sum(times) / len(times))
