"""Where a kernel's time goes: build variants of the kernel sources with one
part taken out or one size changed, and time them against the kernel as it
is, on one GPU.  Run from the repository root:

    python3 chip_variants.py

Each variant is a copy of ``tpu_sdr_torch/csrc`` with text patches applied
(``VARIANTS``; a patch that no longer matches the source fails the run:
the list follows the sources of the commit it is in), built like the real
library (all builds at once) and called through the same C entry point on
the 25 MB block (12,533,760 samples) of random bytes.  A variant that takes
a part out computes wrong outputs on purpose: only its time means
something.  ``copy`` is a yardstick, not a kernel: one device-to-device
copy that moves K2's bytes (half of them read, half written).  Two timings
of each, both CUDA events, the card's name and power limit printed:

* ``cold``: one launch after the L2 cache is flushed and the stream held
  busy while it is enqueued (``chip_smoke.py``'s method; it includes a
  launch's fixed cost);
* ``stream``: back-to-back launches cycling over copies of the input that
  together exceed the 50 MB L2, averaged (the launch cost overlaps).

The last line of stdout is one JSON object with every time.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

BLOCK = 12_533_760
REPS = 7

_K1_MMA = ("for (int kk = 0; kk < kFastKS; ++kk) kstep(kk, breg[kk]);", "")
_K1_LOADS = ("        mbar_expect_bytes(&bars[slot], 2 * a.span);\n"
             "        bulk_copy(dst, a.iq + 2 * k0, 2 * a.span, &bars[slot]);",
             "        mbar_arrive(&bars[slot]);")
_K1_STORES = ("      if (r > 0) *reinterpret_cast<float2*>(zt) = make_float2(zz[0], zz[1]);\n"
              "      *reinterpret_cast<float2*>(zt + 64) = make_float2(zz[2], zz[3]);",
              "      if (zz[0] == 12345.0f) zt[0] = zz[1] + zz[2] + zz[3];")
_K2_TILE32 = ("for (int tile = 128; tile >= 1; tile >>= 1)",
              "for (int tile = 32; tile >= 1; tile >>= 1)")


def _k2_walk(n: int) -> tuple[str, str]:
    return ("if (grid > tiles) grid = tiles;",
            f"if (grid > (tiles + {n - 1}) / {n}) grid = (tiles + {n - 1}) / {n};")



# name -> (kernel, file, [(old, new), ...])
VARIANTS = {
    "fm_front/no_mma": ("fm_front", "fm_front.cu", [_K1_MMA]),
    "fm_front/no_loads": ("fm_front", "fm_front.cu", [_K1_LOADS]),
    "fm_front/no_z_stores": ("fm_front", "fm_front.cu", [_K1_STORES]),
    "fm_front/skeleton": ("fm_front", "fm_front.cu",
                          [_K1_MMA, _K1_LOADS, _K1_STORES]),
    "fm_front/ring4": ("fm_front", "fm_front.cu",
                       [("constexpr int kRing = 3;", "constexpr int kRing = 4;")]),
    "fm_front/half_grid": ("fm_front", "fm_front.cu", [(
        "long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);",
        "long long grid = (long long)sms;")]),
    # blocks that walk several tiles of the block (the second buffer
    # engaged): fewer blocks, or 32-frame tiles
    "fm_resample/walk2": ("fm_resample", "fm_resample.cu", [_k2_walk(2)]),
    "fm_resample/walk4": ("fm_resample", "fm_resample.cu", [_k2_walk(4)]),
    "fm_resample/tile32": ("fm_resample", "fm_resample.cu", [_K2_TILE32]),
    "fm_resample/tile32_walk4": ("fm_resample", "fm_resample.cu",
                                 [_K2_TILE32, _k2_walk(4)]),
    "fm_resample/no_compute": ("fm_resample", "fm_resample.cu", [(
        "        switch (quad) {", "        v = make_float4(x[0], 0.0f, 0.0f, 0.0f);\n"
        "        if (x[1] == 12345.0f) switch (quad) {")]),
}


def build_variant(kernels, name: str, root: str):
    """The bound library of variant ``name``, built under ``root``."""
    _, fname, patches = VARIANTS[name]
    d = os.path.join(root, name.replace("/", "_"))
    os.makedirs(d)
    for f in os.listdir(kernels.SRC_DIR):
        shutil.copy(os.path.join(kernels.SRC_DIR, f), d)
    path = os.path.join(d, fname)
    with open(path) as f:
        src = f.read()
    for old, new in patches:
        if old not in src:
            raise RuntimeError(f"variant {name}: a patch no longer matches "
                               f"{fname}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return kernels.build(d, os.path.join(d, "out"))[0]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_sdr_torch import kernels
    from tpu_sdr_torch.ops import fused_fm as FF

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    spec = FF.default_spec()
    taps, h_poly = FF.make_kernel_params(device=dev)
    up, T = h_poly.shape
    rng = np.random.default_rng(0)
    copies = [torch.from_numpy(rng.integers(0, 256, 2 * BLOCK, dtype=np.uint8)
                               ).to(dev) for _ in range(4)]     # 100 MB
    carry = FF.init_carry(dev)
    zs = [FF.fm_front_reference(c, 0, carry, taps, spec.decim)[0]
          for c in copies]
    zs += [z.clone() for z in zs]                                # 67 MB
    hist = torch.zeros(T - 1, device=dev)
    z_out = torch.empty(BLOCK // spec.decim, device=dev)
    c_out = torch.empty_like(carry)
    a_out = torch.empty(BLOCK // spec.decim // spec.down * up, device=dev)
    h_out = torch.empty_like(hist)
    n_copy = (zs[0].numel() + a_out.numel()) // 2  # K2's bytes, half each way
    c_dst = torch.empty(n_copy, device=dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def call(lib, kernel, i):
        if kernel == "copy":
            c_dst.copy_(zs[i % len(zs)][:n_copy])
            return
        if kernel == "fm_front":
            d = copies[i % len(copies)]
            status = lib.tsdr_fm_front(
                d.data_ptr(), BLOCK, 1, carry.data_ptr(), taps.data_ptr(),
                taps.numel(), spec.decim, z_out.data_ptr(), c_out.data_ptr(),
                stream())
        else:
            z = zs[i % len(zs)]
            status = lib.tsdr_fm_resample(
                z.data_ptr(), z.numel(), hist.data_ptr(), h_poly.data_ptr(), up,
                spec.down, T, a_out.data_ptr(), h_out.data_ptr(), stream())
        kernels.check(status, kernel)

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as root:
        lib = kernels.load().cdll
        runs = {"fm_front/as_is": ("fm_front", lib),
                "fm_resample/as_is": ("fm_resample", lib),
                "copy": ("copy", None)}
        with ThreadPoolExecutor(len(VARIANTS)) as pool:
            paths = pool.map(lambda n: build_variant(kernels, n, root), VARIANTS)
            for name, path in zip(VARIANTS, paths):
                runs[name] = (VARIANTS[name][0], kernels.bind(path))
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        cold = {n: [] for n in runs}
        streamed = {n: [] for n in runs}
        for kernel, lib in runs.values():
            call(lib, kernel, 0)  # warm-up
        for rep in range(REPS):
            for name, (kernel, lib) in (list(runs.items()) if rep % 2 == 0
                                        else list(runs.items())[::-1]):
                flush.zero_()
                torch.cuda._sleep(5_000_000)
                start.record()
                call(lib, kernel, 0)
                end.record()
                end.synchronize()
                cold[name].append(start.elapsed_time(end))
                n = 4 * (len(copies) if kernel == "fm_front" else len(zs))
                torch.cuda._sleep(5_000_000)
                start.record()
                for i in range(n):
                    call(lib, kernel, i)
                end.record()
                end.synchronize()
                streamed[name].append(start.elapsed_time(end) / n)
    result = {name: {"cold_ms": statistics.median(cold[name]),
                     "stream_ms": statistics.median(streamed[name])}
              for name in runs}
    for name, t in result.items():
        print(f"{name}: cold {t['cold_ms']:.4f} ms, stream {t['stream_ms']:.4f} "
              f"ms ({card})", flush=True)
    print(json.dumps({"card": card, "block_complex": BLOCK, "reps": REPS,
                      "copy_bytes": 2 * 4 * n_copy, "variants": result}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
