"""tail_ms: device ms a traced read of the wideband step's kernels other
than K3 (the gather of the selected channels, the discriminator, the
resampler's frame matmul, the carry copies' kernels and the output
packing), launched from the ``demod`` span; copies are left out."""

K3_KERNELS = ("pfb64_kernel", "pfb_direct_kernel")


def read(rec):
    if not rec.reads or rec.busy_s is None:
        return None
    sec = sum(dt for name, dt, span in rec.ops
              if span == "demod" and "memcpy" not in name.lower()
              and "memset" not in name.lower()
              and not any(k in name for k in K3_KERNELS))
    return sec / rec.reads * 1e3
