"""Where a kernel's time goes: build variants of the kernel sources with one
part taken out, one size changed or one form tried, and time them against
the kernel as it is, on one GPU.  Run from the repository root:

    python3 chip_variants.py

``python3 chip_variants.py fm_front`` runs only the variants whose names
start with ``fm_front`` (any prefix), beside the kernels as they are.

Each variant is a copy of ``tpu_sdr_torch/csrc`` with text patches applied
(``VARIANTS``; a patch that no longer matches the source fails the run:
the list follows the sources of the commit it is in), built like the real
library (eight variants at a time) and called through the same C entry point on
the 25 MB block (12,533,760 samples) of random bytes (K3: 195,840 frames
of 64 channels, all 64 written).  A variant that takes a part out computes
wrong outputs on purpose: only its time means something.  ``copy`` is a
yardstick, not a kernel: one device-to-device copy that moves K2's bytes
(half of them read, half written); ``copy_k3`` one that moves K3's 125 MB
(25 MB read, 100 MB written).  Two timings
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
             "        bulk_copy(dst, row.iq + 2 * k0, 2 * a.span, &bars[slot]);",
             "        mbar_arrive(&bars[slot]);")
_K1_STORES = ("      if (r > 0) *reinterpret_cast<float2*>(zt) = make_float2(zz[0], zz[1]);\n"
              "      *reinterpret_cast<float2*>(zt + 64) = make_float2(zz[2], zz[3]);",
              "      if (zz[0] == 12345.0f) zt[0] = zz[1] + zz[2] + zz[3];")
# K1's phase: the kernel that reads each station's at run time for one
# phase too (the form for a phase a station), and that kernel with a switch
# into four constant-phase bodies instead
_K1_RUNTIME_PHASE = ("  if (a.phases != nullptr) {\n    return launch<-1, FAST>",
                     "  if (true) {\n    return launch<-1, FAST>")
_K1_FOUR_BODIES = (
    """  front<FAST>(a, row, PHASE >= 0 ? PHASE
                          : a.phases != nullptr ? (a.phases[s] & 3) : a.phase);""",
    """  switch (a.phases != nullptr ? (a.phases[s] & 3) : a.phase) {
    case 0: front<FAST>(a, row, 0); break;
    case 1: front<FAST>(a, row, 1); break;
    case 2: front<FAST>(a, row, 2); break;
    default: front<FAST>(a, row, 3); break;
  }""")
_K2_TILE32 = ("for (int tile = 128; tile >= 1; tile >>= 1)",
              "for (int tile = 32; tile >= 1; tile >>= 1)")


_K3_STORES = ("        if (lane < 2 * q4 && fw + fr < m) {",
              "        if (lane < 2 * q4 && fw + fr < m && wrows[0] == 12345.0f) {")
_K3_FFT = ("    dft8(a);                                            // over q: index k1\n"
           "#pragma unroll\n"
           "    for (int k1 = 0; k1 < 8; ++k1) a[k1] = cmul(a[k1], wj[k1]);\n"
           "    transpose8(a, j);                                   // lane j: k1 = j\n"
           "    dft8(a);                                            // over j: index k2\n",
           "")
_K3_FIR = ("        for (int i = 0; i < kFastR; ++i) fir_tap(a, g[i], x[r + kFastR - 1 - i]);",
           "        a = x[r + kFastR - 1];")
_K3_TILE8 = ("if ((m + 15) / 16 >= 2LL * sms) {", "if (false) {")


# K2's station axis: one station through the batch form (its rows at
# blockIdx.y's offsets), and that form with its row pointers restricted
_K2_BATCH_FORM = ("    if (stations > 1) {\n      return fast ? launch<true, true>",
                  "    if (true) {\n      return fast ? launch<true, true>")
_K2_RESTRICT = ("""struct Row {
  const float* z;
  const float* hist;
  float* audio;
  float* hist_out;""", """struct Row {
  const float* __restrict__ z;
  const float* __restrict__ hist;
  float* __restrict__ audio;
  float* __restrict__ hist_out;""")


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
    "fm_front/runtime_phase": ("fm_front", "fm_front.cu", [_K1_RUNTIME_PHASE]),
    "fm_front/four_bodies": ("fm_front", "fm_front.cu",
                             [_K1_RUNTIME_PHASE, _K1_FOUR_BODIES]),
    # blocks that walk several tiles of the block (the second buffer
    # engaged): fewer blocks, or 32-frame tiles
    "fm_resample/walk2": ("fm_resample", "fm_resample.cu", [_k2_walk(2)]),
    "fm_resample/walk4": ("fm_resample", "fm_resample.cu", [_k2_walk(4)]),
    "fm_resample/tile32": ("fm_resample", "fm_resample.cu", [_K2_TILE32]),
    "fm_resample/tile32_walk4": ("fm_resample", "fm_resample.cu",
                                 [_K2_TILE32, _k2_walk(4)]),
    "fm_resample/batch_form": ("fm_resample", "fm_resample.cu",
                               [_K2_BATCH_FORM]),
    "fm_resample/batch_form_restrict": ("fm_resample", "fm_resample.cu",
                                        [_K2_BATCH_FORM, _K2_RESTRICT]),
    "fm_resample/no_compute": ("fm_resample", "fm_resample.cu", [(
        "        switch (quad) {", "        v = make_float4(x[0], 0.0f, 0.0f, 0.0f);\n"
        "        if (x[1] == 12345.0f) switch (quad) {")]),
    # K3: each part taken out in turn (without its FIR the history loads
    # go too; without its stores the rows still return through shared
    # memory) and together; then the forms tried and dropped, each against
    # the kernel as it is
    "pfb_channelize/no_stores": ("pfb_channelize", "pfb_channelize.cu",
                                 [_K3_STORES]),
    "pfb_channelize/no_fft": ("pfb_channelize", "pfb_channelize.cu",
                              [_K3_FFT]),
    "pfb_channelize/no_fir": ("pfb_channelize", "pfb_channelize.cu",
                              [_K3_FIR]),
    "pfb_channelize/stores_only": ("pfb_channelize", "pfb_channelize.cu",
                                   [_K3_FFT, _K3_FIR]),
    "pfb_channelize/skeleton": ("pfb_channelize", "pfb_channelize.cu",
                                [_K3_STORES, _K3_FFT, _K3_FIR]),
    "pfb_channelize/tile8": ("pfb_channelize", "pfb_channelize.cu",
                             [_K3_TILE8]),
    "pfb_channelize/tile32": ("pfb_channelize", "pfb_channelize.cu", [(
        "if ((m + 15) / 16 >= 2LL * sms) {\n      return (int)launch64<16>",
        "if ((m + 31) / 32 >= 2LL * sms) {\n      return (int)launch64<32>")]),
    "pfb_channelize/run16": ("pfb_channelize", "pfb_channelize.cu", [(
        "constexpr int kRun = 8; ", "constexpr int kRun = 16; ")]),
    "pfb_channelize/regs64": ("pfb_channelize", "pfb_channelize.cu", [(
        "__launch_bounds__(8 * TM)\npfb64", "__launch_bounds__(8 * TM, 8)\npfb64")]),
    "pfb_channelize/magic_unpack": ("pfb_channelize", "pfb_channelize.cu", [(
        "  return make_float2(2.0f * (float)(v & 0xFFu) - 255.0f,\n"
        "                     2.0f * (float)((v >> 8) & 0xFFu) - 255.0f);",
        "  const float re = __uint_as_float(__byte_perm(v, 0x4B00u, 0x5440u)) - 8388608.0f;\n"
        "  const float im = __uint_as_float(__byte_perm(v, 0x4B00u, 0x5441u)) - 8388608.0f;\n"
        "  return make_float2(fmaf(2.0f, re, -255.0f), fmaf(2.0f, im, -255.0f));")]),
    "pfb_channelize/smem_transpose": ("pfb_channelize", "pfb_channelize.cu", [(
        "    transpose8(a, j);                                   // lane j: k1 = j\n",
        "    __syncwarp();\n"
        "#pragma unroll\n"
        "    for (int k1 = 0; k1 < 8; ++k1)\n"
        "      *reinterpret_cast<float2*>(row + 2 * (8 * k1 + ((j + (k1 >> 1)) & 7))) = a[k1];\n"
        "    __syncwarp();\n"
        "#pragma unroll\n"
        "    for (int s = 0; s < 8; ++s)\n"
        "      a[s] = *reinterpret_cast<const float2*>(row + 2 * (8 * j + ((s + (j >> 1)) & 7)));\n")]),
    "pfb_channelize/plain_stores": ("pfb_channelize", "pfb_channelize.cu", [(
        "          __stcs(reinterpret_cast<float4*>(y + (fw + fr) * 2 * Ko) + lane,\n"
        "                 *reinterpret_cast<const float4*>(wrows + fr * kRowFloats + src));",
        "          reinterpret_cast<float4*>(y + (fw + fr) * 2 * Ko)[lane] =\n"
        "              *reinterpret_cast<const float4*>(wrows + fr * kRowFloats + src);")]),
}


def build_variant(kernels, name: str, root: str):
    """Variant ``name`` built under ``root``: (library path, compiler
    output)."""
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
    path, _, log = kernels.build(d, os.path.join(d, "out"))
    return path, log


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    p = argparse.ArgumentParser(description="Time variants of the kernel "
                                "sources against the kernels as they are.")
    p.add_argument("prefix", nargs="?", default="",
                   help="run only the variants whose names start with it")
    args = p.parse_args(argv)
    variants = {k: v for k, v in VARIANTS.items() if k.startswith(args.prefix)}

    if not torch.cuda.is_available():
        print("chip_variants: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_sdr_torch import kernels
    from tpu_sdr_torch.ops import fused_channelizer as FC
    from tpu_sdr_torch.ops import fused_fm as FF
    from tpu_sdr_torch.utils import design

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
    K, R = 64, 9
    pfb_taps = FC.kernel_taps(design.design_pfb(K, R - 1, cutoff_frac=0.95)
                              ).to(dev)
    pfb_tw = FC.twiddles(K).to(dev)
    pfb_carry = torch.zeros(2 * (R - 1), K, device=dev)
    pfb_carry_out = torch.empty_like(pfb_carry)
    pfb_y = torch.empty(BLOCK // K, 2 * K, device=dev)
    n_copy_k3 = (2 * BLOCK + pfb_y.numel() * 4) // 8  # floats, half each way
    k3_src = torch.empty(n_copy_k3, device=dev)
    k3_dst = torch.empty(n_copy_k3, device=dev)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def call(lib, kernel, i):
        if kernel == "copy":
            c_dst.copy_(zs[i % len(zs)][:n_copy])
            return
        if kernel == "copy_k3":
            k3_dst.copy_(k3_src)
            return
        if kernel == "pfb_channelize":
            d = copies[i % len(copies)]
            status = lib.tsdr_pfb_channelize(
                d.data_ptr(), BLOCK // K, K, R, 0, K, pfb_carry.data_ptr(),
                pfb_taps.data_ptr(), pfb_tw.data_ptr(), pfb_y.data_ptr(),
                pfb_carry_out.data_ptr(), stream())
        elif kernel == "fm_front":
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
                "pfb_channelize/as_is": ("pfb_channelize", lib),
                "copy": ("copy", None), "copy_k3": ("copy_k3", None)}
        with ThreadPoolExecutor(max(1, min(8, len(variants)))) as pool:
            paths = pool.map(lambda n: build_variant(kernels, n, root),
                             variants)
            for name, (path, log) in zip(variants, paths):
                runs[name] = (VARIANTS[name][0], kernels.bind(path))
                # the first source's kernels (fm_front.cu) lead the log
                regs = [line.split(":")[-1].strip() for line in
                        log.splitlines() if "registers" in line][:2]
                print(f"{name}: first kernels {regs}", flush=True)
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
                n = 4 * (len(copies) if kernel in ("fm_front",
                                                   "pfb_channelize")
                         else len(zs))
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
                      "copy_bytes": 2 * 4 * n_copy,
                      "copy_k3_bytes": 2 * 4 * n_copy_k3, "variants": result}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
