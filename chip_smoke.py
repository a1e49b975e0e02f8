#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``tpu_sdr_torch/csrc`` and drives
both ported paths through their user entry points:

* single station: K1 (``fm_front``, all four fs/4 phases) and K2
  (``fm_resample``) against their plain PyTorch versions on a 25 MB block
  (12,533,760 complex samples), then ``tpu_sdr_torch.apps.simple_fm --mode
  fused`` on a 10.24 s synthetic station;
* wideband: K3 (``pfb_channelize``) against its plain version on a 25 MB
  block of an 8-station capture at 10.88 Msps (all 64 channels and a
  16-channel column slice), then ``tpu_sdr_torch.apps.multi_fm --fused``
  on 1.024 s of it, against the plain front.

Each path's launch counts are zeroed just before it runs and read just
after; the audio is checked (length, tone SNR, agreement with the plain
PyTorch chain).  The kernels and their plain versions are timed with CUDA
events, the streamer and the CLIs with the host clock.

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

# wideband: channels of 170 kHz at 10.88 Msps; four positive offsets, four negative
WB_CHANNELS = (3, 9, 15, 21, 43, 49, 55, 60)
WB_TONES = (700.0, 1_000.0, 1_400.0, 1_800.0, 2_200.0, 2_600.0, 3_000.0,
            3_300.0)
WB_BLOCK_CHUNKS = 288        # x 43,520 complex = the same 25 MB block
WB_PATH_READS = 32           # x 696,320 bytes = 1.024 s at 10.88 Msps
WB_READ_BYTES = 696_320
SNR_STATION_DB = 25.0        # tests/test_wideband.py's bar
SNR_FRONTS_DB = 70.0         # fused vs plain front, tests/test_wideband.py


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


def wideband(dev, flush) -> dict:
    """The wideband path: (a) K3 against its plain version on the 25 MB
    block, (b) ``multi_fm --fused`` on 1.024 s of 8 stations against the
    plain front, (c) device timings.  Returns the numbers for the result
    lines."""
    import numpy as np
    import torch

    from tpu_sdr.utils import synth
    from tpu_sdr_torch.apps import multi_fm
    from tpu_sdr_torch.models import wbfm_wideband as WB
    from tpu_sdr_torch.ops import fused_channelizer as FC

    config = WB.WidebandConfig(channels=WB_CHANNELS)
    spec = WB.fused_spec(config)
    params = WB.make_params(config, device=dev)
    K = config.num_channels
    n_block = WB_BLOCK_CHUNKS * spec.chunk_complex
    t0 = time.monotonic()
    u8, _ = synth.synth_multistation_u8(
        n_block, config.capture_rate,
        station_freqs=[(k if k <= K // 2 else k - K) * config.channel_rate
                       for k in WB_CHANNELS],
        audio_freqs=list(WB_TONES), deviation=45_000.0)
    u8 = np.ascontiguousarray(u8, dtype=np.uint8)
    data = torch.from_numpy(u8).to(dev)
    print(f"wideband capture: {n_block} complex, {len(WB_CHANNELS)} stations "
          f"at {config.capture_rate / 1e6:.2f} Msps, made in "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    # ---- (a) K3 against its plain version ------------------------------
    # a mid-stream carry: the state after the block's own last chunk
    _, carry = FC.channelize_reference(data[-spec.chunk_bytes:],
                                       FC.init_carry(spec, dev),
                                       params.kernel_m2, spec)
    sliced = FC.kernel_matrix(params.h_poly.cpu().numpy(),
                              slice(16, 32)).to(dev)
    err, snrs = 0.0, {}
    for local, m2 in ((None, params.kernel_m2), (16, sliced)):
        sp = spec._replace(local_channels=local)
        y_re, y_im, c_k = FC.channelize(data, carry, m2, sp)
        y_r, c_r = FC.channelize_reference(data, carry, m2, sp)
        torch.cuda.synchronize()
        y_k = torch.cat([y_re, y_im], dim=1)
        require(y_k.shape == (n_block // K, 2 * sp.out_channels),
                f"pfb_channelize: output of shape {tuple(y_k.shape)}")
        s = snr_db(y_r.cpu().numpy(), y_k.cpu().numpy())
        e = float((y_k - y_r).abs().max())
        require(s >= SNR_KERNEL_DB, f"pfb_channelize Ko={sp.out_channels}: "
                f"{s:.1f} dB < {SNR_KERNEL_DB}")
        require(torch.equal(c_k, c_r), "pfb_channelize: carry differs")
        snrs[sp.out_channels] = s
        err = max(err, e)
        print(f"pfb_channelize Ko={sp.out_channels}: {s:.1f} dB vs plain, "
              f"max |dy| {e:.3g} (|y| up to "
              f"{float(y_r.abs().max()):.3g}), carry equal", flush=True)
    del y_re, y_im, y_k, y_r

    # ---- (b) the user entry point on 1.024 s of 8 stations ---------------
    n_path = WB_PATH_READS * WB_READ_BYTES // 2
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wideband.u8")
        u8[: 2 * n_path].tofile(path)
        argv = ["--file", path, "--channels", ",".join(map(str, WB_CHANNELS))]
        FC.reset_launch_counts()
        t0 = time.monotonic()
        rc = multi_fm.main(argv + ["--fused", "--out-dir",
                                   os.path.join(tmp, "fused")])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = FC.LAUNCHES["pfb_channelize"]
        require(rc == 0, f"multi_fm --fused returned {rc}")
        require(multi_fm.main(argv + ["--out-dir", os.path.join(tmp, "plain")])
                == 0, "multi_fm (plain front) failed")

        def station(front, ch):
            return np.fromfile(os.path.join(tmp, front, f"station_{ch}.raw"),
                               dtype="<i2").astype(np.float64)

        fused = [station("fused", ch) for ch in WB_CHANNELS]
        plain = [station("plain", ch) for ch in WB_CHANNELS]
    require(launches > 0, "the wideband path never launched pfb_channelize")
    expect = n_path // K // config.resample_down * config.resample_up
    tones = []
    for ch, tone, f, p in zip(WB_CHANNELS, WB_TONES, fused, plain):
        require(len(f) == len(p) == expect,
                f"station {ch}: {len(f)}/{len(p)} samples, expected {expect}")
        s = synth.tone_snr(f, tone, config.rate_resample, skip=400)
        require(s >= SNR_STATION_DB,
                f"station {ch}: tone SNR {s:.1f} dB < {SNR_STATION_DB}")
        tones.append(s)
    s_fronts = snr_db(np.stack(plain), np.stack(fused))
    require(s_fronts >= SNR_FRONTS_DB,
            f"multi_fm fused vs plain front: {s_fronts:.1f} dB")
    realtime_x = n_path / wall / config.capture_rate
    print(f"wideband path: {len(WB_CHANNELS)} stations x {expect} samples, "
          f"tones {', '.join(f'{t:.1f}' for t in tones)} dB, fused vs plain "
          f"{s_fronts:.1f} dB, launches {launches}, wall {wall:.3f} s = "
          f"{n_path / wall / 1e6:.3f} Msps = {realtime_x:.2f}x real time",
          flush=True)

    # ---- (c) device timings on the 25 MB block ---------------------------
    state = WB.init_state(config, params)
    ms = device_ms({
        "pfb_channelize_plain": lambda: FC.channelize_reference(
            data, carry, params.kernel_m2, spec),
        "pfb_channelize": lambda: FC.channelize(data, carry, params.kernel_m2,
                                                spec),
        "wideband_device": lambda: WB.demodulate_block_fused(
            data, carry, state.quad, state.resamp.hist, params, config, spec),
        "wideband_plain_device": lambda: WB.demodulate_block(
            data, state, params, config),
    }, flush=flush)
    return {"err": err, "snr_db": snrs, "launches": launches, "ms": ms,
            "path": {"complex": n_path, "stations": len(WB_CHANNELS),
                     "tone_db": tones, "fused_vs_plain_db": s_fronts,
                     "wall_s": wall, "realtime_x": realtime_x}}


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

    # ---- the wideband path: K3 and multi_fm --fused ---------------------
    wb = wideband(dev, flush_buf.zero_)
    ms.update(wb["ms"])
    for name, t in ms.items():
        print(f"time {name}: {t:.4f} ms = {BLOCK_COMPLEX / t / 1e3:.1f} Msps "
              f"({smi})", flush=True)
    print("metrics " + json.dumps({
        "card": smi, "block_complex": BLOCK_COMPLEX, "reps": REPS, "ms": ms,
        "snr_fm_front_db": snrs, "snr_fm_resample_db": s_rs,
        "path": {"complex": n_path, "tone_db": tone, "vs_fir_db": s_fir,
                 "wall_s": app_s, "realtime_x": n_path / app_s / REALTIME_SPS},
        "snr_pfb_channelize_db": wb["snr_db"], "wideband_path": wb["path"],
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
        {"name": "pfb_channelize", "route": "cuda",
         "source": "tpu_sdr_torch/csrc/pfb_channelize.cu",
         "replaces": "tpu_sdr/ops/pallas_channelizer.py:92",
         "launches": wb["launches"], "max_abs_err": wb["err"],
         "ms": ms["pfb_channelize"], "plain_ms": ms["pfb_channelize_plain"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
