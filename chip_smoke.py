#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``tpu_sdr_torch/csrc``, holds each
against its plain PyTorch version at the main path's real block size
(12,533,760 complex samples, 25 MB of u8 I/Q, all four fs/4 phases),
drives the main path once through its user entry point
(``tpu_sdr_torch.apps.simple_fm --mode fused`` on a 10.24 s synthetic
station), checks that both kernels ran and that the audio is right, and
times the kernels and their plain versions with CUDA events, the streamer
and the CLI with the host clock.

The last two lines of stdout are a JSON line describing the kernels and
``{"ok": true, "device": {...}}``; any failure raises (non-zero exit, no
result line).  It exits non-zero without a CUDA device.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# TPU_SDR_PLATFORM makes tpu_sdr/__init__.py import jax; the port never does.
os.environ.pop("TPU_SDR_PLATFORM", None)

BLOCK_COMPLEX = 12_533_760   # 192 chunks of 65,280: the 25 MB main-path block
PATH_CHUNKS = 160            # 10.24 s at 1.02 Msps
REALTIME_SPS = 1_020_000     # one station
SNR_KERNEL_DB = 100.0
SNR_TONE_DB = 45.0
SNR_FIR_DB = 80.0
REPS = 11
SPIN_CYCLES = 5_000_000      # ~2.5 ms of GPU clock: longer than any enqueue


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def snr_db(ref, got) -> float:
    import numpy as np

    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return float(10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30)))


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms(fns: dict, flush) -> dict:
    """Median device time (CUDA events) of each callable over REPS rounds,
    the order reversed every other round.  Before each timed call L2 is
    flushed and the stream is held busy by a spin kernel, so the call is
    wholly enqueued before its start event fires: the wrappers' host work
    stays out of the interval."""
    import torch

    for fn in fns.values():  # warm-up
        fn()
    times = {name: [] for name in fns}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for rep in range(REPS):
        names = list(fns) if rep % 2 == 0 else list(fns)[::-1]
        for name in names:
            flush()
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def host_ms(fn) -> float:
    """Median wall time of a call that ends synchronised with the device."""
    import torch

    fn()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_app(argv: list[str]):
    """Run the port's simple_fm CLI in-process; returns its s16 stdout."""
    import numpy as np

    from tpu_sdr_torch.apps import simple_fm

    raw = io.BytesIO()
    saved = sys.stdout
    sys.stdout = io.TextIOWrapper(raw, write_through=True)
    try:
        rc = simple_fm.main(argv)
        sys.stdout.flush()
        pcm = np.frombuffer(raw.getvalue(), dtype="<i2").copy()
    finally:
        sys.stdout.detach()
        sys.stdout = saved
    require(rc == 0, f"simple_fm {' '.join(argv)} returned {rc}")
    return pcm


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import numpy as np

    from tpu_sdr import native
    from tpu_sdr.utils import synth
    from tpu_sdr_torch import kernels
    from tpu_sdr_torch.ops import fused_fm as FF

    smi = gpu_name_and_power()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)

    # ---- build --------------------------------------------------------
    t0 = time.monotonic()
    lib = kernels.load()
    print(f"kernels: {lib.path} built in {lib.build_seconds:.1f} s "
          f"(load {time.monotonic() - t0:.1f} s)", flush=True)
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    # A plain version used as an oracle computes in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    spec = FF.default_spec()
    taps, h_poly = FF.make_kernel_params(device=dev)
    require(BLOCK_COMPLEX % spec.chunk_complex == 0, "block is not whole chunks")

    u8, _ = synth.synth_wbfm_u8(BLOCK_COMPLEX, capture_rate=REALTIME_SPS)
    u8 = np.ascontiguousarray(u8, dtype=np.uint8)
    data = torch.from_numpy(u8).to(dev)

    # ---- kernel phase: each kernel against its plain version ------------
    # a mid-stream carry: the state after the block's own last chunk
    _, carry = FF.fm_front_reference(data[-spec.chunk_bytes:], 0,
                                     FF.init_carry(dev), taps, spec.decim)
    err_front, snrs = 0.0, []
    for phase in range(4):
        z_k, c_k = FF.fm_front(data, phase, carry, taps, spec.decim)
        z_r, c_r = FF.fm_front_reference(data, phase, carry, taps, spec.decim)
        torch.cuda.synchronize()
        s = snr_db(z_r.cpu().numpy(), z_k.cpu().numpy())
        snrs.append(s)
        err_front = max(err_front, float((z_k - z_r).abs().max()))
        carry_err = float((c_k - c_r).abs().max())
        require(s >= SNR_KERNEL_DB,
                f"fm_front phase {phase}: {s:.1f} dB < {SNR_KERNEL_DB}")
        require(carry_err <= 1e-3, f"fm_front phase {phase}: carry off by "
                f"{carry_err}")
        print(f"fm_front phase {phase}: {s:.1f} dB vs plain, max |dz| "
              f"{float((z_k - z_r).abs().max()):.3g}, max |dcarry| "
              f"{carry_err:.3g}", flush=True)

    hist = z_r[-(spec.taps_per_phase - 1):].contiguous()  # a mid-stream history
    a_k, h_k = FF.resample(z_r, hist, h_poly, spec.down)
    a_r, h_r = FF.resample_reference(z_r, hist, h_poly, spec.down)
    torch.cuda.synchronize()
    s_rs = snr_db(a_r.cpu().numpy(), a_k.cpu().numpy())
    err_resample = float((a_k - a_r).abs().max())
    require(s_rs >= SNR_KERNEL_DB, f"fm_resample: {s_rs:.1f} dB")
    require(torch.equal(h_k, h_r), "fm_resample: history differs")
    require(a_k.numel() == BLOCK_COMPLEX // spec.decim // spec.down * spec.up,
            "fm_resample: wrong audio length")
    print(f"fm_resample: {s_rs:.1f} dB vs plain, max |da| {err_resample:.3g}",
          flush=True)

    # ---- path phase: the user entry point on a 10.24 s station --------
    # set-up the CLI pays once per checkout: the host library's first build
    t0 = time.monotonic()
    print(f"host s16 library: native={native.available()}, set-up "
          f"{time.monotonic() - t0:.3f} s", flush=True)
    n_path = PATH_CHUNKS * spec.chunk_complex
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "station.u8")
        u8[: 2 * n_path].tofile(path)
        FF.reset_launch_counts()
        t0 = time.monotonic()
        pcm = run_app(["--file", path, "--mode", "fused"])
        torch.cuda.synchronize()
        app_s = time.monotonic() - t0
        launches = dict(FF.LAUNCHES)
        pcm_fir = run_app(["--file", path, "--mode", "fir"])
    for name, count in launches.items():
        require(count > 0, f"the main path never launched {name}")
    expect = n_path * spec.up // (spec.decim * spec.down)
    require(abs(len(pcm) - expect) <= spec.audio_per_chunk,
            f"audio length {len(pcm)}, expected {expect}")
    tone = synth.tone_snr(pcm.astype(np.float64), 1_000.0, 32_000, skip=1500)
    require(tone >= SNR_TONE_DB, f"tone SNR {tone:.1f} dB < {SNR_TONE_DB}")
    n = min(len(pcm), len(pcm_fir))
    s_fir = snr_db(pcm_fir[:n], pcm[:n])
    require(s_fir >= SNR_FIR_DB, f"fused vs fir: {s_fir:.1f} dB < {SNR_FIR_DB}")
    print(f"path: {len(pcm)} samples (expected {expect}), tone {tone:.1f} dB, "
          f"vs fir {s_fir:.1f} dB, launches {launches}, wall {app_s:.3f} s "
          f"= {n_path / app_s / 1e6:.3f} Msps = "
          f"{n_path / app_s / REALTIME_SPS:.2f}x real time", flush=True)

    # ---- timing on the 25 MB block --------------------------------------
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    z_r = z_r.contiguous()
    ms = device_ms({
        "fm_front_plain": lambda: FF.fm_front_reference(data, 1, carry, taps,
                                                        spec.decim),
        "fm_front": lambda: FF.fm_front(data, 1, carry, taps, spec.decim),
        "fm_resample_plain": lambda: FF.resample_reference(z_r, hist, h_poly,
                                                           spec.down),
        "fm_resample": lambda: FF.resample(z_r, hist, h_poly, spec.down),
        "fused_path_device": lambda: FF.demodulate_fused(
            data, 1, carry, hist, taps, h_poly, spec),
    }, flush=flush_buf.zero_)
    streamer = FF.FusedWbfmStreamer(device=dev)
    ms["streamer_block"] = host_ms(lambda: streamer.demodulate(u8))
    for name, t in ms.items():
        print(f"time {name}: {t:.4f} ms = {BLOCK_COMPLEX / t / 1e3:.1f} Msps "
              f"({smi})", flush=True)
    print("metrics " + json.dumps({
        "card": smi, "block_complex": BLOCK_COMPLEX, "reps": REPS, "ms": ms,
        "snr_fm_front_db": snrs, "snr_fm_resample_db": s_rs,
        "path": {"complex": n_path, "tone_db": tone, "vs_fir_db": s_fir,
                 "wall_s": app_s, "realtime_x": n_path / app_s / REALTIME_SPS},
    }), flush=True)

    print(json.dumps({"kernels": [
        {"name": "fm_front", "route": "cuda",
         "source": "tpu_sdr_torch/csrc/fm_front.cu",
         "replaces": "tpu_sdr/ops/pallas_fm.py:177",
         "launches": launches["fm_front"], "max_abs_err": err_front,
         "ms": ms["fm_front"], "plain_ms": ms["fm_front_plain"]},
        {"name": "fm_resample", "route": "cuda",
         "source": "tpu_sdr_torch/csrc/fm_resample.cu",
         "replaces": "tpu_sdr/ops/pallas_fm.py:760",
         "launches": launches["fm_resample"], "max_abs_err": err_resample,
         "ms": ms["fm_resample"], "plain_ms": ms["fm_resample_plain"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
