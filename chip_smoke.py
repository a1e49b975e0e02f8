#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

(``--baseline-csrc DIR``, for an A/B measurement only and never needed by
the smoke test itself, also builds another commit's kernel sources and
times its K1 and K2 beside these, in the same rounds.)

It builds the port's CUDA kernels from ``tpu_sdr_torch/csrc`` and drives
the ported paths through their user entry points:

* single station: K1 (``fm_front``, all four fs/4 phases) and K2
  (``fm_resample``) against their plain PyTorch versions on a 25 MB block
  (12,533,760 complex samples) and at one ragged size each, then
  ``tpu_sdr_torch.apps.simple_fm --mode fused`` on a 10.24 s synthetic
  station;
* wideband: K3 (``pfb_channelize``) against its plain version on a 25 MB
  block of an 8-station capture at 10.88 Msps (all 64 channels and the
  16-channel window from channel 16) and against the float64 PFB on its
  first 8,192 frames; K3's direct DFT at the 1024-channel bank's read
  (5,440 frames; all 1,024 columns and the 256 from column 768) against
  its plain version and the float64 PFB; then
  ``tpu_sdr_torch.apps.multi_fm --fused``
  on 1.024 s of it, against the plain front,
  and the channel-parallel K3 bank on 4 logical shards of the card (a
  graphed call; then graphed against ``graphs.disabled()``, below);
* sharded: K4 (``halo_pull``) and K5 (``ring_shift``) against their plain
  versions (bit-equal) on rows of 1 and 4 shards and at the sharded paths'
  own shapes; the halo-record helper (``shard_halo``, no TPU kernel: the
  JAX chain's XLA end-state code) against its plain version and K1's own
  outputs, and K4 on its records; then the sharded receiver
  ``ShardedFusedStreamer`` on a (dp=2, sp=4) mesh of logical shards on
  ``cuda:0`` (4 stations, two consecutive 25 MB blocks each; one record
  build and one K4 exchange a row; the second block a CUDA graph replay)
  against the serial ``FusedWbfmStreamer`` and bit-equal to the same
  chain run eagerly, with K1 and K2 held against their plain versions at
  one of its shards; the sharded float chain's ``fn`` on the same mesh
  and blocks (fir with its streaming carry, and boxcar); on a machine
  with more than one GPU the same path again (eager) on a (1, n_gpu)
  mesh, one shard a card; then the time-sharded channelizer on (1, 4)
  logical shards (K4 frame halo, an all-to-all of K5 steps; its second
  call one graph replay holding all five launches) against the
  unsharded plain one.  The three sharded functions, graphed against
  ``graphs.disabled()`` at these 25 MB shapes: every output bit-equal, a
  kept result unchanged by later calls, one ``cudaGraphLaunch`` a call
  and the K3/K4+K5 runs the counters gained in a whole trace, device and
  host ms a call, the output copies' device ms, peak memory;
* the station batch: K1 and K2 over 8 stations of a 25 MB block each
  (phases 0..3 across them, carries and histories at a halo record's
  stride) in one launch each, against their plain versions and against
  one-station launches on the same rows, then
  ``FusedWbfmBatchStreamer`` on that batch (a second block replayed, the
  peak memory of the graphed batch);
* the exact chain and the float chain's modes: the exact integer chain on
  the card against the CPU (bit-equal) and the golden vectors, ``simple_fm
  --mode exact``, ``--mode boxcar`` and ``--mode fir --deemph 75`` on the
  10.24 s station (their real-time factors), the boxcar, de-emphasis and
  multiplex chains on the card against the CPU, and boxcar against exact;
* the receivers of the JAX package's other CLIs: ``simple_fm --mode
  stereo --rds`` on a 10.24 s stereo station carrying RDS (the sent PI,
  PS and RadioText decoded, separation, >= 1x real time, the streamer on
  the card against the CPU) and ``--mode stereo`` on 2.56 s without RDS
  (tone SNR); ``rtl_fm -M wbfm --rds`` on it; ``rtl_fm -M fm|am|usb|lsb``
  on 10.24 s narrowband captures (tone, card against CPU, >= 1x real
  time) and ``-l`` on noise; ``multi_fm --fused --rds`` on 1.024 s of 8
  stations, 4 of them with RDS (K3 launched; each station's text on its
  own channel only); ``rtl_power --file`` on a tone (its bin; card
  against CPU within 0.01 dB); checkpoint/resume on the card (stereo,
  multimode, fused, fused wideband, and the sharded streamer after a
  graph replay); ``simple_fm --mode fused --trace`` naming both kernels;
* ingest: the port's C++ runtime built with g++ and the feeder native on a
  file and on an rtl_tcp socket; the feed alone from a file (10 x 25 MB
  and 40 x 262,144 bytes: a bare pinned ``copy_`` loop, a pageable
  ``.to`` loop, ``device_blocks`` and ``blocks()`` then ``.to`` with a
  consumer that only waits); ``FusedWbfmStreamer`` fed by ``blocks()``
  and by ``device_blocks()`` (bit-equal; one ``torch.profiler`` trace of
  each: the busy share, and the host-to-device copies on a stream other
  than K1's and K2's); ``simple_fm --tcp --mode fused --blocks 38`` from
  the port's ``RtlTcpServer`` on a fake dongle paced at 1.02 Msps (no
  drops, one K1 and one K2 launch a read, tone >= 50 dB, bit-equal to
  ``--file`` on the same bytes, per-read latency, busy share from a
  ``--trace`` run), the unpaced ingest rate and its drops, and the
  server's counter test mode (2,000 reads, no break) and fan-out (two
  clients, each stream continuous);
* graphs: every graphed streamer (``tpu_sdr_torch.utils.graphs``) through
  its CLI's per-read work at its CLI's read (262,144 bytes; 696,320 for
  ``multi_fm``), 100 reads after 8 warm-up reads: ``simple_fm --mode
  fused|fir|boxcar``, ``--mode fir --deemph 75``, ``--mode stereo
  --rds``, ``multi_fm --fused`` with and without ``--rds``, ``rtl_fm -M
  fm|am``, ``simple_fm --mode exact``, ``rtl_power --file`` (the PSD's
  form without outputs: its bins read back once a round) and
  ``FusedPfbStreamer`` (K3 alone, at 696,320 bytes) in 5 interleaved
  rounds of each form, and ``rtl_fm -M usb|lsb``, ``-M wbfm --rds``,
  ``multi_fm``'s plain front and both station batches in one: the
  default (a CUDA graph replay a read after the first read of a key)
  bit-equal to ``graphs.disabled()`` on every output of every read, one
  ``cudaGraphLaunch`` a streamer a read and no kernel launch after
  warm-up (a profiler trace of each form), K1/K2/K3 counters equal to
  the eager run's and one a read with a chunk, and in each whole trace
  the K1/K2/K3/K4+K5 runs the counters gained; the PSD's graphed reads
  with no D2H copy and no synchronize; host ms a read, real-time factor,
  device operations and launch calls a read, busy share and peak memory
  of each form; then ``rtl_power`` scanning 5 hops over rtl_tcp from
  the port's server on a fake dongle: one PSD streamer reset at each
  hop, one capture for its one key, every other block a replay.

Each path's launch counts are zeroed just before it runs and read just
after; the audio is checked (length, tone SNR, agreement with the plain
PyTorch chain).  The kernels, their plain versions and the one-call
library yardsticks (K2 and K3 a strided ``conv1d``, K3 also a batched
``matmul`` of its unfolded windows, the faster of the two reported; K4 a
``cat``, K5 a ``roll``; K1 has none) are timed with CUDA events (K3 also
at the ``multi_fm`` read of 696,320 bytes; the sp=4 sharded step eager and
as a graph replay, beside the unsharded chain), the streamer and the
CLIs with the host clock; the sp=4 step's launches and device operations
are counted from one whole ``torch.profiler`` trace of each form (every
trace here opens with pad launches outside the range it counts, and is
taken again until each host call in that range has its device record);
each kernel's
roofline bound is computed from its shapes and the H100's published peaks.

The last lines of stdout are the helper's JSON line (``{"helper":
...}``), a JSON line describing the five kernels that replace TPU kernels,
and ``{"ok": true, "device": {...}}``; any failure raises (non-zero exit, no
result line).  It exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

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
PFB64_FRAMES = 8_192         # K3 against the float64 PFB on these frames
BANK_K = 1_024               # the 1024-channel bank (wbfm_bank1024)
BANK_FRAMES = 5_440          # its multi_fm read: 11,141,120 bytes
SNR_PFB64_DB = 130.0         # f32 FIR + FFT against the exact PFB
SNR_FRONTS_DB = 70.0         # fused vs plain front, tests/test_wideband.py

# sharded: (dp, sp) mesh of logical shards on one card, 2 stations a row
SHARD_DP, SHARD_SP = 2, 4
SHARD_STATIONS = 4
SHARD_BLOCKS = 2             # consecutive 25 MB blocks per station
HALO_BIG_FLOATS = 1 << 20    # the multi-MB payload of the K4/K5 checks (4 MB)
SNR_SHARDED_DB = 150.0       # the (2, 4) path against the serial chain
RECORD_CARRY_REL = 1e-6      # the helper's carry against its plain version
RECORD_TAIL_ABS = 1e-5       # the helper's T-1 outputs against its plain version

# the station batch: K1 and K2 over 8 stations of a 25 MB block each
BATCH_STATIONS = 8
RECORD_FLOATS = 560          # the sharded chain's halo record: carries at its stride
PARENT_SLACK = 1.05          # one station's K1/K2 against the parent's sources

# the exact chain and the float chain's modes
CLI_READ = 262_144           # the CLIs' read, the reference's block
MODE_CHUNKS = 40             # 2.56 s of the path's capture, card against CPU
SNR_BOXCAR_EXACT_DB = 60.0   # the float boxcar chain against the exact one

# the receivers: stereo + RDS, rtl_fm's modes, rtl_power, checkpoint, trace
RDS_PI, RDS_PS, RDS_RT = 0xC0DE, "TPU SDR!", "HELLO FROM THE H100"
SNR_STEREO_TONE_DB = 50.0    # tests/test_stereo.py's bars
SEP_STEREO_DB = 30.0
SNR_MODE_TONE_DB = {"fm": 30.0, "am": 30.0, "usb": 25.0, "lsb": 25.0}
MODE_SKIP = 32               # the channel filter's start-up, left out
REALTIME_MIN = 1.0           # a live receiver must keep up
WB_RDS = {3: (0xA003, "CH 3 RDS"), 15: (0xA015, "CH15 RDS"),
          43: (0xA043, "CH43 RDS"), 55: (0xA055, "CH55 RDS")}
PSD_RATE = 2_048_000
PSD_DB_TOL = 0.01

# the host-to-device feed and the network path (the ingest phase)
INGEST_BLOCKS = 10           # x the 25 MB block, from a file
INGEST_READS = 40            # x the CLI's 262,144-byte read, from a file
TCP_SECONDS = 10.24          # the fake dongle's station: longer than is read
TCP_BLOCKS = 38              # simple_fm --tcp --blocks
TCP_QUEUE = 32               # the server's queue, blocks
SNR_TCP_DB = 50.0            # the tone over the network path
UNPACED_BLOCKS = 100         # the unpaced ingest (the JAX bench_ingest shape)
COUNTER_READS = 2_000        # counter test mode: reads of COUNTER_READ bytes
COUNTER_READ = 65_536
FANOUT_BLOCKS = 200          # per fan-out client, 262,144 bytes each
# the graphs phase: each graphed streamer at its CLI's read
GRAPH_READS = 100            # reads a round
GRAPH_ROUNDS = 5             # interleaved rounds of each form (CLI paths)
GRAPH_WARM = 8               # reads before the rounds (the keys' captures)
GRAPH_TRACE_READS = 10       # reads in each form's profiler trace
TRACE_PAD_LAUNCHES = 64      # device work that opens a trace, left out of it
TRACE_TRIES = 3              # traces taken until one holds every device record
GRAPH_WB_READS = 32          # the wideband capture's reads, cycled
GRAPH_BATCH_STATIONS = 8
PSD_FFT = 1024               # rtl_power's n_fft at 2.048 Msps
PFB_FRAMES = 256             # K3's frames a chunk (multi_fm's spec)
SCAN_HOPS = 5                # rtl_power's scan over the fake dongle
SCAN_BLOCKS = 8              # reads a hop (-b)
# the device kernels behind the counted wrappers, by counter names joined
# with "+": a trace must see as many of them as the counters gained.  K4
# and K5 launch one device kernel, shard_copy_kernel (csrc/halo.cu), so a
# trace holds the sum of their counters against its runs
KERNEL_EVENTS = {"fm_front": ("fm_front_kernel",),
                 "fm_resample": ("fm_resample_kernel",),
                 "pfb_channelize": ("pfb64_kernel", "pfb_direct_kernel"),
                 "halo_pull+ring_shift": ("shard_copy_kernel",)}
SHARDED_CALLS = 3            # calls in each form's trace of a sharded function


def counted(counts: dict, key: str) -> int:
    """The launches a ``KERNEL_EVENTS`` key stands for: the sum of its
    counters in ``counts``."""
    return sum(counts.get(name, 0) for name in key.split("+"))


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, by name."""
    from tpu_sdr_torch.ops import fused_channelizer as FC
    from tpu_sdr_torch.ops import fused_fm as FF
    from tpu_sdr_torch.parallel import cuda_halo as CH

    return {**FF.LAUNCHES, **FC.LAUNCHES, **CH.LAUNCHES}


def reset_launch_counts() -> None:
    from tpu_sdr_torch.ops import fused_channelizer as FC
    from tpu_sdr_torch.ops import fused_fm as FF
    from tpu_sdr_torch.parallel import cuda_halo as CH

    FF.reset_launch_counts()
    FC.reset_launch_counts()
    CH.reset_launch_counts()


# Published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit):
# the least time a kernel could take is the larger of its bytes over HBM
# and its operations over the f32 rate (each input read once, each output
# written once).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound(nbytes: float, flops: float) -> dict:
    """The roofline bound of a kernel's work: ms, and what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes", "peak": "hbm"}
    return {"bound_ms": t_ops, "bound_by": "operations", "peak": "f32"}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def snr_db(ref, got) -> float:
    import numpy as np

    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return float(10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30)))


def angle_err(ref, got):
    """``got - ref`` for angles in units of pi (K1's z), taken modulo 2 into
    [-1, 1): z = +1 and z = -1 are one angle, and an output at that edge
    may land on either side in two FIR summation orders."""
    import torch

    return torch.remainder(got - ref + 1, 2) - 1


def snr_angle_db(ref, got) -> float:
    """:func:`snr_db` of K1's z with the error taken by :func:`angle_err`."""
    return snr_db(ref.cpu().numpy(), (ref + angle_err(ref, got)).cpu().numpy())


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


def run_cli(app: str, argv: list[str]) -> tuple[bytes, str]:
    """Run one of the port's CLIs in-process; returns its stdout bytes and
    what it printed to stderr (its log lines go to the real stderr)."""
    import importlib

    module = importlib.import_module(f"tpu_sdr_torch.apps.{app}")
    raw, err = io.BytesIO(), io.StringIO()
    saved = sys.stdout, sys.stderr
    sys.stdout = io.TextIOWrapper(raw, write_through=True)
    sys.stderr = err
    try:
        rc = module.main(argv)
        sys.stdout.flush()
    finally:
        sys.stdout.detach()
        sys.stdout, sys.stderr = saved
    require(rc == 0, f"{app} {' '.join(argv)} returned {rc}")
    return raw.getvalue(), err.getvalue()


def run_app(argv: list[str], app: str = "simple_fm"):
    """Run a port CLI that writes s16 audio; returns the audio."""
    import numpy as np

    return np.frombuffer(run_cli(app, argv)[0], dtype="<i2").copy()


def pfb_float64(data, carry, h_poly, spec, frames: int):
    """The exact PFB of the first ``frames`` frames of ``data`` after the
    (2H, K) x255 ``carry``, in float64 on the card: the R-tap FIR down the
    frames of each branch, the K-point DFT across them, / 255.  Returns
    (frames, 2K) [Y_re | Y_im] as numpy."""
    import torch

    K, H = spec.num_channels, spec.branch_rows - 1
    x = data[:2 * K * frames].reshape(frames, K, 2).to(torch.float64) * 2 - 255
    c = carry.to(torch.float64)
    ext = torch.cat([torch.complex(c[:H], c[H:]),
                     torch.complex(x[..., 0], x[..., 1])])
    G = h_poly.to(torch.float64)
    fir = sum(G[t] * ext[H - t:H - t + frames] for t in range(H + 1))
    y = torch.fft.fft(fir, dim=1) / 255.0
    return torch.cat([y.real, y.imag], dim=1).cpu().numpy()


def bank1024_k3(dev) -> dict:
    """K3's direct DFT at the 1024-channel bank's read (``multi_fm``'s
    11,141,120 bytes, 5,440 frames) after a mid-stream carry: all 1,024
    columns and the window of 256 from column 768, each against the plain
    version (>= SNR_KERNEL_DB, carry equal), and all 1,024 against the
    float64 PFB (>= SNR_PFB64_DB).  Returns the SNRs."""
    import torch

    from tpu_sdr_torch.ops import fused_channelizer as FC
    from tpu_sdr_torch.utils import design

    K, frames = BANK_K, BANK_FRAMES
    h = design.design_pfb(K, 8, cutoff_frac=0.95)
    spec = FC.PfbSpec(K, 9, 680)
    taps = FC.kernel_taps(h).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1024)
    data = torch.randint(0, 256, (2 * K * frames,), dtype=torch.uint8,
                         device=dev, generator=gen)
    warm = torch.randint(0, 256, (spec.chunk_bytes,), dtype=torch.uint8,
                         device=dev, generator=gen)
    _, carry = FC.channelize_reference(warm, FC.init_carry(spec, dev),
                                       FC.kernel_matrix(h).to(dev), spec)
    snrs = {}
    for local, c0 in ((None, 0), (256, 768)):
        sp = spec._replace(local_channels=local)
        Ko = sp.out_channels
        m2 = FC.kernel_matrix(h, slice(c0, c0 + Ko)).to(dev)
        y_re, y_im, c_k = FC.channelize(data, carry, taps, sp,
                                        channel_offset=c0)
        y_r, c_r = FC.channelize_reference(data, carry, m2, sp)
        torch.cuda.synchronize()
        y_k = torch.cat([y_re, y_im], dim=1)
        require(y_k.shape == (frames, 2 * Ko),
                f"pfb_channelize K={K}: output of shape {tuple(y_k.shape)}")
        s = snr_db(y_r.cpu().numpy(), y_k.cpu().numpy())
        require(s >= SNR_KERNEL_DB, f"pfb_channelize K={K} Ko={Ko} c0={c0}: "
                f"{s:.1f} dB < {SNR_KERNEL_DB}")
        require(torch.equal(c_k, c_r), f"pfb_channelize K={K}: carry differs")
        snrs[f"k{K}_ko{Ko}"] = s
        print(f"pfb_channelize K={K} Ko={Ko} c0={c0}, {frames} frames: "
              f"{s:.1f} dB vs plain, carry equal", flush=True)
        if local is None:
            s64 = snr_db(pfb_float64(data, carry,
                                     torch.from_numpy(h).to(dev), spec,
                                     frames), y_k.cpu().numpy())
            require(s64 >= SNR_PFB64_DB, f"pfb_channelize K={K} vs float64 "
                    f"PFB: {s64:.1f} dB < {SNR_PFB64_DB}")
            snrs[f"k{K}_float64"] = s64
            print(f"pfb_channelize K={K} vs the float64 PFB on {frames} "
                  f"frames: {s64:.1f} dB", flush=True)
    return snrs


def wideband(dev, flush, smi: str) -> dict:
    """The wideband path: (a) K3 against its plain version on the 25 MB
    block, (b) ``multi_fm --fused`` on 1.024 s of 8 stations against the
    plain front, (c) device timings.  Returns the numbers for the result
    lines."""
    import numpy as np
    import torch

    from tpu_sdr_torch.apps import multi_fm
    from tpu_sdr_torch.models import wbfm_wideband as WB
    from tpu_sdr_torch.ops import fused_channelizer as FC
    from tpu_sdr_torch.parallel import channelizer_sharded_fused as CSF
    from tpu_sdr_torch.parallel import mesh as PM
    from tpu_sdr_torch.utils import design, synth

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
    for local, c0, m2 in ((None, 0, params.kernel_m2), (16, 16, sliced)):
        sp = spec._replace(local_channels=local)
        y_re, y_im, c_k = FC.channelize(data, carry, params.kernel_taps, sp,
                                        channel_offset=c0)
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
        print(f"pfb_channelize Ko={sp.out_channels} c0={c0}: {s:.1f} dB vs "
              f"plain, max |dy| {e:.3g} (|y| up to "
              f"{float(y_r.abs().max()):.3g}), carry equal", flush=True)
        if local is None:
            s64 = snr_db(pfb_float64(data, carry, params.h_poly, spec,
                                     PFB64_FRAMES),
                         y_k[:PFB64_FRAMES].cpu().numpy())
            require(s64 >= SNR_PFB64_DB, f"pfb_channelize vs float64 PFB: "
                    f"{s64:.1f} dB < {SNR_PFB64_DB}")
            snrs["float64"] = s64
            print(f"pfb_channelize vs the float64 PFB on the first "
                  f"{PFB64_FRAMES} frames: {s64:.1f} dB", flush=True)
    del y_re, y_im, y_k, y_r
    snrs.update(bank1024_k3(dev))

    # the channel-parallel bank: K3 with the full taps and a 16-channel
    # window (c0 = 16 i) on each of 4 logical shards of the card, against
    # the plain full-width K3
    bank = CSF.make_sharded_pfb_fused(PM.make_mesh(1, 4, devices=[dev] * 4),
                                      K, config.taps_per_branch,
                                      spec.frames_per_chunk)
    before = FC.LAUNCHES["pfb_channelize"]
    y_re, y_im, c_k = bank(data, carry)
    m2_full = FC.kernel_matrix(design.design_pfb(
        K, config.taps_per_branch)).to(dev)  # the bank's design, all of it
    y_r, c_r = FC.channelize_reference(data, carry, m2_full, spec)
    torch.cuda.synchronize()
    require(FC.LAUNCHES["pfb_channelize"] == before + 4,
            "the channel-parallel bank did not launch K3 on every shard")
    y_k = torch.cat([y_re, y_im], dim=1)
    s = snr_db(y_r.cpu().numpy(), y_k.cpu().numpy())
    require(s >= SNR_KERNEL_DB, f"channel-parallel K3 bank: {s:.1f} dB")
    require(torch.equal(c_k, c_r), "channel-parallel K3 bank: carry differs")
    err = max(err, float((y_k - y_r).abs().max()))
    snrs["bank_4x16"] = s
    print(f"channel-parallel K3 bank (1, 4) on {dev}: {s:.1f} dB vs the plain "
          f"full width, carry equal", flush=True)
    del y_re, y_im, y_k, y_r, bank

    def make_bank():
        b = CSF.make_sharded_pfb_fused(PM.make_mesh(1, 4, devices=[dev] * 4),
                                       K, config.taps_per_branch,
                                       spec.frames_per_chunk)
        state = [carry]

        def call(x):
            out = b(x, state[0])
            state[0] = out[2]
            return out
        return call, b.graphs

    bank_graphs = graph_forms("channel-parallel K3 bank (1, 4)", make_bank,
                              [data, data.flip(0), data],
                              {"pfb_channelize": 4}, flush, smi)

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
    # the library yardstick: one strided convolution over the x255 I/Q
    # stream as 2 channels with the history prepended (the u8 unpack is
    # left out of the call), weights (2 Ko, 2, R K) folding M2's complex
    # recombination; the port never calls it
    H, R = spec.branch_rows - 1, spec.branch_rows
    Ko = params.kernel_m2.shape[1] // 2
    m2_rev = params.kernel_m2.reshape(R, K, 2 * Ko).flip(0).reshape(R * K,
                                                                      2 * Ko)
    w_conv = torch.stack([
        torch.cat([m2_rev[:, :Ko].T, m2_rev[:, Ko:].T]),
        torch.cat([-m2_rev[:, Ko:].T, m2_rev[:, :Ko].T])], dim=1).contiguous()
    x255 = data.reshape(-1, K, 2).to(torch.float32) * 2.0 - 255.0
    x_conv = torch.stack([torch.cat([carry[:H], x255[..., 0]]).reshape(-1),
                          torch.cat([carry[H:], x255[..., 1]]).reshape(-1)]
                         )[None].contiguous()
    del x255

    def library():
        return torch.nn.functional.conv1d(x_conv, w_conv, stride=K)

    # the second: one batched matmul of the unfolded x255 windows (re and
    # im a batch of 2, history prepended) by the plain version's M2; the
    # u8 unpack and the complex recombination are left out of the call
    x_win = x_conv[0].unfold(1, R * K, K)        # (2, m, R K), a view

    def library_matmul():
        return torch.matmul(x_win, m2_rev)

    y_r, _ = FC.channelize_reference(data, carry, params.kernel_m2, spec)
    s_lib = snr_db(y_r.cpu().numpy(), library()[0].T.cpu().numpy())
    yw = library_matmul()
    s_mm = snr_db(y_r.cpu().numpy(), torch.cat(
        [yw[0, :, :Ko] - yw[1, :, Ko:], yw[0, :, Ko:] + yw[1, :, :Ko]],
        dim=1).cpu().numpy())
    print(f"pfb_channelize library yardsticks: conv1d (stride {K}) "
          f"{s_lib:.1f} dB, batched matmul {s_mm:.1f} dB vs the plain "
          f"version", flush=True)
    del y_r, yw
    read = data[:WB_READ_BYTES]
    state = WB.init_state(config, params)
    ms = device_ms({
        "pfb_channelize_library_conv1d": library,
        "pfb_channelize_library_matmul": library_matmul,
        "pfb_channelize_plain": lambda: FC.channelize_reference(
            data, carry, params.kernel_m2, spec),
        "pfb_channelize": lambda: FC.channelize(data, carry,
                                                params.kernel_taps, spec),
        "pfb_channelize_read": lambda: FC.channelize(
            read, carry, params.kernel_taps, spec),
        "wideband_device": lambda: WB.demodulate_block_fused(
            data, carry, state.quad, state.resamp.hist, params, config, spec),
        "wideband_plain_device": lambda: WB.demodulate_block(
            data, state, params, config),
    }, flush=flush)
    # the bound counts the function, not M2's dense product: per frame an
    # R-tap branch filter on each of K branches (complex samples, real
    # taps: 4 R K FLOP) and a K-point DFT (~5 K log2 K); bytes: the u8
    # block, the complex f32 output, the carry both ways, the R K taps
    def k3_bound(m):
        return bound(2 * m * K + 4 * m * 2 * Ko + 2 * 4 * carry.numel()
                     + 4 * R * K, m * (4 * R * K + 5 * K * math.log2(K)))

    b = k3_bound(n_block // K)
    ms["pfb_channelize_library"] = min(ms["pfb_channelize_library_conv1d"],
                                       ms["pfb_channelize_library_matmul"])
    b_read = k3_bound(WB_READ_BYTES // (2 * K))
    print(f"pfb_channelize at the CLI read ({WB_READ_BYTES} bytes, "
          f"{WB_READ_BYTES // (2 * K)} frames): {ms['pfb_channelize_read']:.4f}"
          f" ms, bound {b_read['bound_ms']:.5f} ms ({b_read['bound_by']})",
          flush=True)
    return {"err": err, "snr_db": snrs, "launches": launches, "ms": ms,
            "bound": b, "bound_read": b_read, "bank_graphs": bank_graphs,
            "library_snr_db": {"conv1d": s_lib, "matmul": s_mm},
            "path": {"complex": n_path, "stations": len(WB_CHANNELS),
                     "tone_db": tones, "fused_vs_plain_db": s_fronts,
                     "wall_s": wall, "realtime_x": realtime_x}}


def halo_kernels(dev) -> float:
    """K4 and K5 against their plain versions on ``dev``, bit-equal each
    time: rows of 1 and 4 shards of a 2 KB carry block and a 4 MB buffer,
    with and without the left edge, K4 forced on the one-shard row; then
    the exchanges at the shapes the sharded paths give them: the end-state
    carries (4 shards of 2 stations x (4, 128) f32 and the edge), the
    resampler tails (4 x 2 x 47 f32, a ragged 376 B), the channelizer's
    frame halo (8 x 64 of a 3,133,440-sample shard) and its all-to-all
    (4 shards of (4, 2, 48960, 16) f32, three K5 steps).  Returns the max
    |error|."""
    import numpy as np
    import torch

    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.parallel import halo as H

    rng = np.random.default_rng(7)

    def row(n, numel):
        return [torch.from_numpy(rng.standard_normal(numel).astype(
            np.float32)).to(dev) for _ in range(n)]

    err = 0.0

    def same(name, got, exp):
        nonlocal err
        require(all(torch.equal(g, x) for g, x in zip(got, exp)),
                f"{name} differs from its plain version")
        err = max(err, max(float((g - x).abs().max())
                           for g, x in zip(got, exp)))

    for numel in (512, HALO_BIG_FLOATS):
        edge = row(1, numel)[0]
        for n in (1, 4):
            xs = row(n, numel)
            got = {"ring_shift": (CH.ring_shift_cuda(xs), H.ring_shift(xs))}
            for e in (None, edge):
                got[f"halo_pull edge={e is not None}"] = (
                    CH.pull_left_halo_cuda(xs, numel, e, force_kernel=True),
                    H.pull_left_halo(xs, numel, e))
            torch.cuda.synchronize()
            for name, (g, x) in got.items():
                same(f"{name} on {n} shards of {4 * numel} B", g, x)
            forced = " (K4 forced)" if n == 1 else ""
            print(f"halo_pull{forced}, ring_shift: {n} shard(s) of "
                  f"{4 * numel} B, with and without the edge: bit-equal to "
                  f"the plain versions", flush=True)

    # the sharded paths' own shapes
    for what, numel, halo, with_edge in (
            ("end-state carries", 2 * 512, 2 * 512, True),
            ("resampler tails", 2 * 47, 2 * 47, True),
            ("channelizer frame halo", BLOCK_COMPLEX // SHARD_SP, 8 * 64,
             False)):
        xs = row(SHARD_SP, numel)
        edge = row(1, halo)[0] if with_edge else None
        same(f"halo_pull ({what})", CH.pull_left_halo_cuda(xs, halo, edge),
             H.pull_left_halo(xs, halo, edge))
        print(f"halo_pull ({what}): {SHARD_SP} shards of {4 * numel} B, a "
              f"{4 * halo} B halo: bit-equal to the plain version",
              flush=True)
    m_loc = BLOCK_COMPLEX // SHARD_SP // 64
    xs = [x.reshape(SHARD_SP, 2, m_loc, 16)
          for x in row(SHARD_SP, SHARD_SP * 2 * m_loc * 16)]
    steps = [torch.cat([x[i + 1:], x[:i]]) for i, x in enumerate(xs)]
    same("ring_shift (all-to-all step)", CH.ring_shift_cuda(steps),
         H.ring_shift(steps))
    got = CH.all_to_all(xs)
    require(all(torch.equal(got[j][i], xs[i][j]) for i in range(SHARD_SP)
                for j in range(SHARD_SP)), "all_to_all misplaced a block")
    print(f"ring_shift (all-to-all step): {SHARD_SP} shards of "
          f"{steps[0].numel() * 4} B: bit-equal to the plain version; the "
          f"all-to-all of {xs[0].numel() * 4} B a shard places every block",
          flush=True)
    return err


def step_ops(fn) -> dict:
    """One whole ``torch.profiler`` trace of ``fn`` (after one untraced
    call), taken as :func:`trace_reads` takes one: the device operations it
    ran by kind, their device µs by name (cut to 40 characters), the span
    from the first one's start to the last one's end, and the host's
    launch calls by name (kernel, graph, copy and fill launches of the
    runtime)."""
    import torch

    fn()
    torch.cuda.synchronize()
    tr = trace_reads(lambda _: fn(), [None])
    return {"device_ops": tr["device_ops_a_read"], "device": tr["device"],
            "device_us": tr["device_us"], "device_busy_us": tr["busy_us"],
            "device_span_us": tr["span_us"],
            "host_launch_calls": sum(tr["host"].values()),
            "host": tr["host"], "attempts": tr["attempts"]}


def halo_records(dev, block) -> dict:
    """The halo-record helper (``shard_halo``) against its plain version
    at the (2, 4) path's shapes (stations 0 and 1 of ``block`` over its 4
    time shards) and at one station: the carry rows 0/1 bit-equal, rows
    2/3 within RECORD_CARRY_REL of their scale, the T-1 outputs within
    RECORD_TAIL_ABS, and those outputs against K1's own last T-1 on the
    same shard at >= 100 dB; then K4 on the records with an edge record,
    bit-equal to its plain version.  Returns the errors."""
    import numpy as np
    import torch

    from tpu_sdr_torch.ops import fused_fm as FF
    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.parallel import halo as H
    from tpu_sdr_torch.parallel import shard_halo as SH

    p = SH.make_params(device=dev)
    T, end = p.T, SH.END
    taps, _ = FF.make_kernel_params(device=dev)
    n_bytes = block.shape[1] // SHARD_SP
    err = rel = 0.0
    snrs = []
    for st in (2, 1):
        row = [torch.from_numpy(np.ascontiguousarray(
            block[0:st, s * n_bytes:(s + 1) * n_bytes])).to(dev)
            for s in range(SHARD_SP)]
        got = SH.shard_halo(row, {dev: p})
        torch.cuda.synchronize()
        for x, g in zip(row, got):
            e = SH.records_reference(x, p)
            require(torch.equal(g[:, :256], e[:, :256]),
                    "shard_halo: carry rows 0/1 differ from the plain version")
            d_end = float((g[:, 256:end] - e[:, 256:end]).abs().max())
            r = d_end / float(e[:, 256:end].abs().max())
            d_tail = float((g[:, end:] - e[:, end:]).abs().max())
            require(r <= RECORD_CARRY_REL, f"shard_halo: carry rows 2/3 off "
                    f"by {r:.3g} of their scale")
            require(d_tail <= RECORD_TAIL_ABS,
                    f"shard_halo: T-1 outputs off by {d_tail:.3g}")
            err, rel = max(err, d_end, d_tail), max(rel, r)
            for j in range(st):
                z, _ = FF.fm_front(x[j], 0, FF.init_carry(dev), taps, p.decim)
                snrs.append(snr_db(z[-(T - 1):].cpu().numpy(),
                                   g[j, end:end + T - 1].cpu().numpy()))
        require(min(snrs) >= SNR_KERNEL_DB, f"shard_halo: T-1 outputs "
                f"{min(snrs):.1f} dB against K1's own")
        # K4 on the records; shard 0 gets a mid-stream edge record (the
        # last shard's own)
        flats = [g.reshape(-1) for g in got]
        edge = got[-1].reshape(-1).clone()
        require(all(torch.equal(a, b) for a, b in zip(
            CH.pull_left_halo_cuda(flats, flats[0].numel(), edge),
            H.pull_left_halo(flats, flats[0].numel(), edge))),
            "halo_pull of the records differs from its plain version")
        print(f"shard_halo ({st} station(s) x {SHARD_SP} shards of "
              f"{n_bytes} B): carry rows 0/1 bit-equal, rows 2/3 within "
              f"{rel:.3g} of their scale, T-1 outputs within {err:.3g} of "
              f"the plain version and {min(snrs):.1f} dB against K1's own; "
              f"halo_pull of the records with the edge record bit-equal",
              flush=True)
    return {"err": err, "carry_rel": rel, "vs_fm_front_db": min(snrs)}


def sharded_path(devices, dp: int, sp: int, blocks, serial):
    """``ShardedFusedStreamer`` on a (dp, sp) mesh of ``devices`` over the
    consecutive ``blocks``, launch counts zeroed before and read after,
    held against the ``serial`` audio of the per-station streamers.
    Returns (numbers, audio)."""
    import numpy as np
    import torch

    from tpu_sdr_torch.ops import fused_fm as FF
    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.parallel import mesh as PM
    from tpu_sdr_torch.parallel import shard_halo as SH
    from tpu_sdr_torch.parallel import wbfm_sharded_fused as WSF
    from tpu_sdr_torch.utils import synth

    mesh = PM.make_mesh(dp, sp, devices=devices)
    stations = blocks[0].shape[0]
    streamer = WSF.ShardedFusedStreamer(mesh, stations)
    FF.reset_launch_counts()
    CH.reset_launch_counts()
    SH.reset_launch_counts()
    t0 = time.monotonic()
    got = np.concatenate([streamer.demodulate(b) for b in blocks], axis=1)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {**FF.LAUNCHES, "halo_pull": CH.LAUNCHES["halo_pull"],
                **SH.LAUNCHES}
    for name, count in launches.items():
        require(count > 0, f"the sharded path never launched {name}")
    if streamer.graphed:
        require(streamer.step_graph is not None,
                "the one-card sharded path captured no CUDA graph")
        for name in ("halo_pull", "shard_halo"):
            require(launches[name] == dp * len(blocks),
                    f"{name}: {launches[name]} launches, one a row a block "
                    f"is {dp * len(blocks)}")
        # one K1 and one K2 launch a shard, over its stations
        for name in ("fm_front", "fm_resample"):
            require(launches[name] == dp * sp * len(blocks),
                    f"{name}: {launches[name]} launches, one a shard a block "
                    f"is {dp * sp * len(blocks)}")
    # the same chain run eagerly through chain.fn must give the same bits
    chain = streamer.chain
    ke, rs = WSF.initial_carry(stations, device=mesh.home)
    eager = []
    for b in blocks:
        audio, counts, ke, rs = chain.fn(chain.shard(b), ke, rs)
        eager.append(chain.assemble(audio, counts))
    require(np.array_equal(got, np.concatenate(eager, axis=1)),
            "the graph-replayed sharded path differs from the eager chain")
    del eager
    require(got.shape == serial.shape,
            f"sharded audio {got.shape}, serial {serial.shape}")
    require(np.allclose(got, serial, rtol=1e-4, atol=1e-5),
            f"sharded vs serial: max |d| {np.abs(got - serial).max()}")
    s = snr_db(serial, got)
    require(s >= SNR_SHARDED_DB, f"sharded vs serial: {s:.1f} dB")
    tone = synth.tone_snr(got[0].astype(np.float64), 1_000.0, 32_000,
                          skip=1500)
    require(tone >= SNR_TONE_DB, f"sharded station 0 tone {tone:.1f} dB")
    n = sum(b.shape[1] // 2 for b in blocks) * blocks[0].shape[0]
    form = ("eager first block, CUDA graph replays after" if streamer.graphed
            else "eager")
    print(f"sharded path ({dp}, {sp}) on {sorted({str(d) for d in devices})}"
          f" ({form}): {got.shape[0]} stations x {got.shape[1]} samples, vs "
          f"serial {s:.1f} dB (max |d| {np.abs(got - serial).max():.3g}), "
          f"bit-equal to the eager chain, station 0 tone {tone:.1f} dB, "
          f"launches {launches}, wall {wall:.3f} s = {n / wall / 1e6:.3f} "
          f"Msps", flush=True)
    return {"mesh": [dp, sp], "stations": got.shape[0],
            "samples": got.shape[1], "vs_serial_db": s, "tone_db": tone,
            "graphed": streamer.graphed, "equal_to_eager": True,
            "launches": launches, "wall_s": wall}, got


def shard_kernels(dev, block, got, shard: int = 2) -> None:
    """K1 and K2 at one shard of the (dp, sp) path's first block: dp row 0
    (stations 0 and 1), time shard ``shard``, from the carry and the
    resampler halo of the record K4 brings it.  Each is held against its
    plain version on the same bytes and state, and K2's audio against the
    path's own audio of that shard."""
    import numpy as np
    import torch

    from tpu_sdr_torch.ops import fused_fm as FF
    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.parallel import halo as H
    from tpu_sdr_torch.parallel import shard_halo as SH
    from tpu_sdr_torch.parallel import wbfm_sharded_fused as WSF

    spec = FF.default_spec()
    T = spec.taps_per_phase
    taps, h_poly = FF.make_kernel_params(device=dev)
    p = SH.make_params(device=dev)
    n_bytes = block.shape[1] // SHARD_SP
    row = [torch.from_numpy(np.ascontiguousarray(
        block[0:2, s * n_bytes:(s + 1) * n_bytes])).to(dev)
        for s in range(SHARD_SP)]
    records = [r.reshape(-1) for r in SH.shard_halo(row, {dev: p})]
    ke, rs = WSF.initial_carry(2, device=dev)
    edge = torch.cat([ke.reshape(2, -1), rs, torch.zeros(
        2, p.record - SH.END - (T - 1), device=dev)], dim=1).reshape(-1)
    recv = CH.pull_left_halo_cuda(records, records[0].numel(), edge)
    require(all(torch.equal(r, q) for r, q in zip(
        recv, H.pull_left_halo(records, records[0].numel(), edge))),
        "halo_pull of the records differs from its plain version")
    worst = []
    for j in range(2):
        rec = recv[shard].reshape(2, p.record)[j]
        state = rec[:SH.END].reshape(FF.STATE_ROWS, FF.LANES)
        hist = rec[SH.END:SH.END + T - 1]
        z_k, _ = FF.fm_front(row[shard][j], 0, state, taps, spec.decim)
        z_r, _ = FF.fm_front_reference(row[shard][j], 0, state, taps,
                                       spec.decim)
        a_k, _ = FF.resample(z_k, hist, h_poly, spec.down)
        a_r, _ = FF.resample_reference(z_k, hist, h_poly, spec.down)
        torch.cuda.synchronize()
        s_front = snr_db(z_r.cpu().numpy(), z_k.cpu().numpy())
        s_rs = snr_db(a_r.cpu().numpy(), a_k.cpu().numpy())
        require(s_front >= SNR_KERNEL_DB and s_rs >= SNR_KERNEL_DB,
                f"station {j} shard {shard}: fm_front {s_front:.1f} dB, "
                f"fm_resample {s_rs:.1f} dB against the plain versions")
        count = a_k.numel()
        path = got[j, shard * count:(shard + 1) * count]
        require(np.allclose(a_k.cpu().numpy(), path, rtol=1e-4, atol=1e-5),
                f"station {j} shard {shard}: K2's audio differs from the "
                f"path's")
        worst.append((s_front, s_rs))
    print(f"shard {shard} of dp row 0 from its K4-received record: fm_front "
          f"{min(w[0] for w in worst):.1f} dB, fm_resample "
          f"{min(w[1] for w in worst):.1f} dB vs plain, and K2's audio "
          f"matches the path's", flush=True)


def _tensors(x) -> list:
    """The tensors of a nested result (lists and tuples), in order."""
    import torch

    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


def graph_forms(name: str, make, inputs, per_call: dict, flush,
                smi: str) -> dict:
    """A sharded function at its 25 MB shapes, graphed (the default: the
    first call eager and captured, each later call one replay and a copy
    of each output) against ``graphs.disabled()`` (eager).  ``make()``
    gives a fresh (call(x) -> result, its ``StepGraphs``), the stream's
    carry (if any) from its start.  Gates: every output of every call
    bit-equal to eager, the launches equal and ``per_call`` a call, a
    result kept from the first call unchanged by the later ones, one
    capture, and in a whole trace of SHARDED_CALLS calls one
    ``cudaGraphLaunch`` a call and the K3/K4+K5 runs the counters gained.
    Measured: device ms a call (CUDA events, L2 flushed) and host ms a
    call in each form, the device ms of the output copies alone, device
    operations and host launch calls a call, the peak memory."""
    import torch

    from tpu_sdr_torch.utils import graphs

    dev = torch.device("cuda", torch.cuda.current_device())
    with graphs.disabled():
        call, _ = make()
        reset_launch_counts()
        exp = [_tensors(call(x)) for x in inputs]
        eager = launch_counts()
    del call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    call, steps = make()
    reset_launch_counts()
    got = [_tensors(call(x)) for x in inputs]
    graphed = launch_counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    kept = [t.clone() for t in got[0]]
    bad = [i for i, (e, g) in enumerate(zip(exp, got))
           if len(e) != len(g) or not all(torch.equal(a, b)
                                          for a, b in zip(e, g))]
    require(not bad, f"graphs {name}: calls {bad} differ from "
            f"graphs.disabled()")
    require(graphed == eager and all(
        eager.get(k, 0) == n * len(inputs) for k, n in per_call.items()),
        f"graphs {name}: launches {graphed} graphed, {eager} eager, "
        f"{per_call} a call")
    require(steps.captures == 1 and steps.replays == len(inputs) - 1,
            f"graphs {name}: {steps.captures} captures, {steps.replays} "
            f"replays")
    del exp
    last = got[-1]
    ms = device_ms({"eager": lambda: _eager(call, inputs[0]),
                    "graphed": lambda: call(inputs[0]),
                    "copies": lambda: [t.clone() for t in last]}, flush)
    host = {"eager": host_ms(lambda: _eager(call, inputs[0])),
            "graphed": host_ms(lambda: call(inputs[0]))}
    require(all(torch.equal(t, k) for t, k in zip(got[0], kept)),
            f"graphs {name}: a result kept from the first call changed")
    trace = {}
    for form in ("eager", "graphed"):
        ctx = graphs.disabled() if form == "eager" else \
            contextlib.nullcontext()
        with ctx:
            trace[form] = trace_reads(call, [inputs[0]] * SHARDED_CALLS,
                                      reset_launch_counts)
        gained = launch_counts()
        seen = trace[form]["kernels"]
        require(all(seen[k] == counted(gained, k) for k in KERNEL_EVENTS),
                f"graphs {name} {form}: the trace saw kernels {seen}, the "
                f"counters gained {gained}")
    tg = trace["graphed"]
    require(tg["graph_launches"] == SHARDED_CALLS,
            f"graphs {name}: {tg['graph_launches']} graph launches for "
            f"{SHARDED_CALLS} calls ({tg['host']})")
    res = {"calls": len(inputs), "launches": graphed, "peak_mib":
           peak / 2 ** 20, "output_mib": sum(t.numel() * t.element_size()
                                             for t in last) / 2 ** 20,
           "copies_ms": ms["copies"]}
    for form in ("eager", "graphed"):
        t = trace[form]
        res[form] = {"device_ms": ms[form], "host_ms": host[form],
                     "device_ops_a_call": t["device_ops_a_read"],
                     "host_launch_calls_a_call":
                         t["host_launch_calls_a_read"],
                     "host": t["host"], "kernels": t["kernels"],
                     "busy_share": t["busy_share"]}
    e, g = res["eager"], res["graphed"]
    print(f"graphs {name}: {len(inputs)} calls bit-equal to "
          f"graphs.disabled(), a kept result unchanged; device ms a call "
          f"eager {e['device_ms']:.4f} / graphed {g['device_ms']:.4f} (of "
          f"it the output copies, {res['output_mib']:.1f} MiB, "
          f"{ms['copies']:.4f}); host ms {e['host_ms']:.4f} / "
          f"{g['host_ms']:.4f}; device ops a call "
          f"{e['device_ops_a_call']:.1f} / {g['device_ops_a_call']:.1f}; "
          f"host launch calls a call {e['host_launch_calls_a_call']:.1f} / "
          f"{g['host_launch_calls_a_call']:.1f} ({g['host']}); launches "
          f"{graphed} (kernels seen in the graphed trace {g['kernels']}); "
          f"peak {res['peak_mib']:.1f} MiB ({smi})", flush=True)
    return res


def _eager(call, x):
    from tpu_sdr_torch.utils import graphs

    with graphs.disabled():
        return call(x)


def float_chain_graphs(dev, blocks, flush, smi: str) -> dict:
    """The sharded float chain's ``fn`` (``make_sharded_wbfm``) on the
    (2, 4) mesh of logical shards of ``dev`` over the sharded path's
    blocks (4 stations x 25 MB each): the fir mode with its streaming
    carry (``XlaStreamCarry``), the boxcar mode without one;
    :func:`graph_forms` on each."""
    from tpu_sdr_torch.parallel import mesh as PM
    from tpu_sdr_torch.parallel import wbfm_sharded as WS
    from tpu_sdr_torch.utils.design import WbfmConfig

    mesh = PM.make_mesh(SHARD_DP, SHARD_SP,
                        devices=[dev] * (SHARD_DP * SHARD_SP))
    stations = blocks[0].shape[0]
    inputs = [PM.shard_time(mesh, b) for b in (blocks[0], blocks[1],
                                               blocks[0])]
    out = {}
    for mode in ("fir", "boxcar"):
        carry_io = mode == "fir"

        def make():
            chain = WS.make_sharded_wbfm(mesh, WbfmConfig(filter_mode=mode),
                                         carry_io=carry_io)
            state = [WS.initial_xla_carry(stations, device=dev)]

            def call(x):
                if not carry_io:
                    return chain.fn(x)
                audio, counts, state[0] = chain.fn(x, state[0])
                return audio, counts, state[0]
            return call, chain.graphs

        out[mode] = graph_forms(
            f"sharded float chain --mode {mode} ({SHARD_DP}, {SHARD_SP}), "
            f"{stations} stations", make, inputs, {}, flush, smi)
    return out


def channelizer_path(dev, flush, smi: str) -> dict:
    """The time-sharded channelizer (``make_sharded_channelizer``, K=64,
    8 taps a branch) on a (1, 4) mesh of logical shards of ``dev``, over a
    25 MB-block's worth of samples (12,533,760 complex, a tone 0.05 of a
    channel above every channel centre): its first call runs eagerly and
    captures the step, the second, with the launch counts zeroed before
    and read after, is one graph replay (two K4 and three K5 launches in
    it) and gives the same bits; held against the unsharded plain PFB +
    demod, and each channel's steady demod against its tone's phase step;
    then :func:`graph_forms` on it."""
    import torch

    from tpu_sdr_torch.ops import channelizer as chan
    from tpu_sdr_torch.ops import fm as F
    from tpu_sdr_torch.parallel import channelizer_sharded as CS
    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.parallel import mesh as PM
    from tpu_sdr_torch.utils import design

    K, T = 64, 8
    n = BLOCK_COMPLEX
    gen = torch.Generator(device=dev).manual_seed(5)
    t = torch.arange(n, dtype=torch.float64, device=dev)
    x = 0.05 * torch.randn(n, dtype=torch.complex128, device=dev,
                           generator=gen)
    for k in range(K):
        x += torch.exp(2j * torch.pi * ((k + 0.05) / K) * t)
    re, im = x.real.to(torch.float32), x.imag.to(torch.float32)
    del t, x
    mesh = PM.make_mesh(1, SHARD_SP, devices=[dev] * SHARD_SP)
    chain = CS.make_sharded_channelizer(mesh, K, taps_per_branch=T)
    m2 = chan.packed_matrix(design.design_pfb(K, T), device=dev)
    zero = torch.zeros(T, K, device=dev)

    def unsharded():
        y_re, y_im, _ = chan.pfb_analyze(re, im, m2, chan.PfbState(zero, zero))
        return F.quadrature_demod(y_re.T, y_im.T, F.QuadState(
            torch.ones(K, device=dev), torch.zeros(K, device=dev)))[0]

    t0 = time.monotonic()
    first = chain(re, im)  # eager, then captured
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    CH.reset_launch_counts()
    got = chain(re, im)
    torch.cuda.synchronize()
    launches = dict(CH.LAUNCHES)
    require(chain.graphs.captures == chain.graphs.replays == 1,
            "the channelizer's second call was no graph replay")
    require(launches == {"halo_pull": 2, "ring_shift": SHARD_SP - 1},
            f"the channelizer's replay launched {launches}")
    require(torch.equal(first, got), "the channelizer's replay differs "
            "from its eager first call")
    del first
    exp = unsharded()
    require(got.shape == exp.shape == (K, n // K),
            f"channelizer demod {tuple(got.shape)}, expected (K, n/K)")
    # phases in units of pi, compared modulo 2
    err = float(torch.remainder(got - exp + 1, 2).sub(1).abs().max())
    require(err <= 2e-3, f"sharded vs unsharded channelizer: {err:.3g}")
    step = float((got[:, 100:].mean(dim=1) - 0.1).abs().max())
    require(step <= 1e-3, f"a channel's tone step is off by {step:.3g}")
    ms = device_ms({"channelizer_sharded": lambda: chain(re, im),
                    "channelizer_unsharded": unsharded}, flush=flush)
    print(f"channelizer path (1, {SHARD_SP}) on {dev}: {K} channels x "
          f"{n // K} frames, vs unsharded max |d phase| {err:.3g} pi, tone "
          f"steps within {step:.3g} of 0.1, launches in one replay "
          f"{launches}, first call (eager + capture) wall {wall:.3f} s",
          flush=True)
    del got, chain

    def make():
        c = CS.make_sharded_channelizer(mesh, K, taps_per_branch=T)
        return (lambda x: c(*x)), c.graphs

    forms = graph_forms(f"time-sharded channelizer (1, {SHARD_SP})", make,
                        [(re, im), (im, re), (re, im)],
                        {"halo_pull": 2, "ring_shift": SHARD_SP - 1}, flush,
                        smi)
    return {"launches": launches, "err": err, "ms": ms, "wall_s": wall,
            "graphs": forms}


def sharded(dev, flush, u8_two, smi: str) -> dict:
    """The sharded paths: (a) K4/K5 against their plain versions, (b) the
    (dp=2, sp=4) receiver on logical shards of ``dev`` against the serial
    chain, with K1/K2 held at one of its shards, (c) the peer path across
    cards where there are several, (d) the time-sharded channelizer, (e)
    device timings.  ``u8_two``: station 0's two consecutive blocks."""
    import numpy as np
    import torch

    from tpu_sdr_torch.ops import fused_fm as FF
    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.parallel import halo as H
    from tpu_sdr_torch.parallel import mesh as PM
    from tpu_sdr_torch.parallel import shard_halo as SH
    from tpu_sdr_torch.parallel import wbfm_sharded_fused as WSF

    # ---- (a) K4/K5 against their plain versions --------------------------
    err = halo_kernels(dev)

    # ---- (b) the main path: ShardedFusedStreamer on (2, 4) ---------------
    n = BLOCK_COMPLEX
    rng = np.random.default_rng(2024)
    rows = [u8_two] + [rng.integers(0, 256, 2 * SHARD_BLOCKS * n,
                                    dtype=np.uint8)
                       for _ in range(SHARD_STATIONS - 1)]
    blocks = [np.stack([r[2 * k * n:2 * (k + 1) * n] for r in rows])
              for k in range(SHARD_BLOCKS)]
    del rows
    serial = []
    for i in range(SHARD_STATIONS):
        st = FF.FusedWbfmStreamer(device=dev)
        serial.append(np.concatenate([st.demodulate(b[i]) for b in blocks]))
    serial = np.stack(serial)
    records = halo_records(dev, blocks[0])
    path, got = sharded_path([dev] * (SHARD_DP * SHARD_SP), SHARD_DP,
                             SHARD_SP, blocks, serial)
    shard_kernels(dev, blocks[0], got)
    float_graphs = float_chain_graphs(dev, blocks, flush, smi)
    # the helper's timing row: dp row 0 of the first block, as the path
    # gives it (2 stations x 4 shards)
    n_bytes = blocks[0].shape[1] // SHARD_SP
    rec_row = [torch.from_numpy(np.ascontiguousarray(
        blocks[0][0:2, s * n_bytes:(s + 1) * n_bytes])).to(dev)
        for s in range(SHARD_SP)]

    # ---- (c) the peer path: one shard a card ----------------------------
    n_gpu = torch.cuda.device_count()
    if n_gpu > 1:
        peer, _ = sharded_path([torch.device("cuda", i) for i in range(n_gpu)],
                               1, n_gpu, blocks, serial)
    else:
        peer = None
        print("peer path: not run (1 CUDA device; the (1, n_gpu) mesh of "
              "one shard a card needs at least 2)", flush=True)
    del blocks, serial, got

    # ---- (d) the time-sharded channelizer: K4 halo, K5 all-to-all --------
    chan = channelizer_path(dev, flush, smi)

    # ---- (e) device timings ----------------------------------------------
    # K4 at the exchange of the sp=4 step (4 one-station records and the
    # edge record) and, for comparison, at the two exchanges of the
    # previous form of a (2, 4) row (4 shards of (2, 4, 128) end states
    # with the edge; 4 of (2, 47) resampler tails); K5 at the channelizer's
    # first all-to-all step; both also at 4 MB a shard
    def row(n_shards, numel):
        return [torch.randn(numel, device=dev) for _ in range(n_shards)]

    ends, edge = row(SHARD_SP, 2 * 512), row(1, 2 * 512)[0]
    tails, tail_edge = row(SHARD_SP, 2 * 47), row(1, 2 * 47)[0]
    step = row(SHARD_SP, 3 * 2 * (n // SHARD_SP // 64) * 16)
    big, big_edge = row(SHARD_SP, HALO_BIG_FLOATS), row(1, HALO_BIG_FLOATS)[0]
    # the sp=4 step on logical shards and the unsharded chain on one
    # station's 25 MB block
    data = torch.from_numpy(u8_two[:2 * n]).to(dev)
    taps, h_poly = FF.make_kernel_params(device=dev)
    spec = FF.default_spec()
    carry, hist = FF.init_carry(dev), torch.zeros(spec.taps_per_phase - 1,
                                                  device=dev)
    ke, rs = WSF.initial_carry(1, device=dev)
    mesh4 = PM.make_mesh(1, SHARD_SP, devices=[dev] * SHARD_SP)
    chain = WSF.make_sharded_wbfm_fused(mesh4, carry_io=True)
    shards = chain.shard(data[None])
    # the same step as a CUDA graph: the streamer's first block runs it
    # eagerly and captures it, the second replays it
    graphed = WSF.ShardedFusedStreamer(mesh4, 1)
    for _ in range(2):
        graphed.demodulate(u8_two[None, :2 * n])
    step_graph = graphed.step_graph
    require(step_graph is not None, "the sp=4 streamer captured no graph")
    # the step's exchange: the records of its 4 shards and an edge record
    params = {dev: SH.make_params(device=dev)}
    step_recs = [r.reshape(-1) for r in SH.shard_halo(shards[0], params)]
    record = step_recs[0].numel()
    step_edge = torch.cat([ke.reshape(1, -1), rs, torch.zeros(
        1, record - SH.END - rs.shape[1], device=dev)], dim=1).reshape(-1)
    step_stacked = torch.stack(step_recs)
    # the library yardsticks, on the shards stacked on one card: K4's
    # non-circular shift with its edge is one cat of the edge and the
    # left neighbours' tails; K5's circular shift one roll
    ends_stacked, ring_stacked = torch.stack(ends), torch.stack(step)

    def halo_library():
        return torch.cat((edge.view(1, -1), ends_stacked[:-1, -1024:]))

    def ring_library():
        return torch.roll(ring_stacked, 1, 0)

    def step_library():
        return torch.cat((step_edge.view(1, -1), step_stacked[:-1]))

    require(torch.equal(halo_library(), torch.stack(
        H.pull_left_halo(ends, 1024, edge))), "the K4 yardstick differs")
    require(torch.equal(ring_library(), torch.stack(H.ring_shift(step))),
            "the K5 yardstick differs")
    require(torch.equal(step_library(), torch.stack(
        H.pull_left_halo(step_recs, record, step_edge))),
        "the K4 step yardstick differs")
    ms = device_ms({
        "shard_halo_plain": lambda: [SH.records_reference(x, params[dev])
                                     for x in rec_row],
        "shard_halo": lambda: SH.shard_halo(rec_row, params),
        "halo_pull_step_library": step_library,
        "halo_pull_step_plain": lambda: H.pull_left_halo(step_recs, record,
                                                         step_edge),
        "halo_pull_step": lambda: CH.pull_left_halo_cuda(step_recs, record,
                                                         step_edge),
        "halo_pull_library": halo_library,
        "ring_shift_library": ring_library,
        "halo_pull_plain": lambda: H.pull_left_halo(ends, 1024, edge),
        "halo_pull": lambda: CH.pull_left_halo_cuda(ends, 1024, edge),
        "halo_pull_tails_plain": lambda: H.pull_left_halo(tails, 94,
                                                          tail_edge),
        "halo_pull_tails": lambda: CH.pull_left_halo_cuda(tails, 94,
                                                          tail_edge),
        "ring_shift_plain": lambda: H.ring_shift(step),
        "ring_shift": lambda: CH.ring_shift_cuda(step),
        "halo_pull_4mb_plain": lambda: H.pull_left_halo(
            big, HALO_BIG_FLOATS, big_edge),
        "halo_pull_4mb": lambda: CH.pull_left_halo_cuda(
            big, HALO_BIG_FLOATS, big_edge),
        "ring_shift_4mb_plain": lambda: H.ring_shift(big),
        "ring_shift_4mb": lambda: CH.ring_shift_cuda(big),
        "sharded_sp4": lambda: chain.fn(shards, ke, rs),
        "sharded_sp4_graph": step_graph.replay,
        "unsharded": lambda: FF.demodulate_fused(data, 0, carry, hist, taps,
                                                 h_poly, spec),
    }, flush=flush)
    ms.update(chan["ms"])
    # the step on the host clock (enqueue included), and its launches and
    # device operations from one profiler trace of each form
    host = {"sharded_sp4": host_ms(lambda: chain.fn(shards, ke, rs)),
            "sharded_sp4_graph": host_ms(step_graph.replay)}
    ops = {"sharded_sp4": step_ops(lambda: chain.fn(shards, ke, rs)),
           "sharded_sp4_graph": step_ops(step_graph.replay)}
    require(ops["sharded_sp4_graph"]["host_launch_calls"] == 1,
            f"the replayed sp=4 step took "
            f"{ops['sharded_sp4_graph']['host']} host launch calls, not one "
            f"graph launch")
    for name, o in ops.items():
        print(f"profile {name}: {o['device_ops']} device operations "
              f"{o['device']}, busy {o['device_busy_us']:.1f} of a "
              f"{o['device_span_us']} us span, {o['host_launch_calls']} host "
              f"launch calls {o['host']}; host clock {host[name]:.4f} ms; "
              f"device us by name {o['device_us']}", flush=True)
    del ends_stacked, ring_stacked, step_stacked
    # the bounds: K4 reads each received record (or edge) once and writes
    # it once; K5 its shards; the helper reads each tail and both tap sets
    # and writes each record (its operations: 2 T + 2 dots of L taps, 2
    # FLOP a tap, and ~30 a discriminator output, a record)
    p = params[dev]
    L, n_rec = p.taps.numel(), len(rec_row) * rec_row[0].shape[0]
    bounds = {"halo_pull": bound(2 * 4 * SHARD_SP * record, 0),
              "ring_shift": bound(2 * 4 * SHARD_SP * step[0].numel(), 0),
              "shard_halo": bound(n_rec * (2 * p.tail + 4 * p.record)
                                  + 2 * 4 * L,
                                  n_rec * ((2 * p.T + 2) * 2 * L
                                           + 30 * (p.T - 1)))}
    return {"err": err, "records": records, "path": path, "peer": peer,
            "chan": chan, "float_graphs": float_graphs, "ms": ms,
            "bounds": bounds, "host_ms": host,
            "ops": ops, "helper_launches": path["launches"]["shard_halo"],
            "halo_us": ms["halo_pull_step"] * 1e3,
            "halo_us_two_exchanges": (ms["halo_pull"]
                                      + ms["halo_pull_tails"]) * 1e3,
            "sharded_overhead_ratio": ms["sharded_sp4"] / ms["unsharded"],
            "sharded_graph_ratio": ms["sharded_sp4_graph"] / ms["unsharded"]}


def batch(dev, flush, data, taps, h_poly, spec) -> dict:
    """The station batch: K1 and K2 over BATCH_STATIONS stations of a 25 MB
    block each (station 0 ``data``, the others random bytes; fs/4 phases
    0..3 across them; mid-stream carries and histories as slices of
    560-float records), one launch each, held per station against the
    plain versions (>= 100 dB, K1's angles compared modulo 2: random bytes
    put some outputs at the +-pi edge; the carry within 1e-3, the history
    equal)
    and bit-equal to a one-station launch on the same row; then the user
    entry point ``FusedWbfmBatchStreamer`` on the batch (counts zeroed
    before, read after: one launch of each), station 0 bit-equal to the
    one-station streamer; then CUDA-event times of the batched launches
    against 8 one-station launches.  Returns the numbers."""
    import numpy as np
    import torch

    from tpu_sdr_torch.ops import fused_fm as FF
    from tpu_sdr_torch.utils import synth

    S, T = BATCH_STATIONS, spec.taps_per_phase
    gen = torch.Generator(device=dev).manual_seed(8)
    rows = torch.empty(S, data.numel(), dtype=torch.uint8, device=dev)
    rows[0] = data
    rows[1:] = torch.randint(0, 256, (S - 1, data.numel()), generator=gen,
                             dtype=torch.uint8, device=dev)
    phases = [j % 4 for j in range(S)]
    phases_dev = torch.tensor(phases, dtype=torch.int32, device=dev)
    # mid-stream carries (each row's own last chunk) and histories, in
    # records as the sharded chain hands them to K1 and K2
    records = torch.zeros(S, RECORD_FLOATS, device=dev)
    _, c_mid = FF.fm_front_reference(rows[:, -spec.chunk_bytes:], phases,
                                     FF.init_carry(dev).repeat(S, 1, 1),
                                     taps, spec.decim)
    records[:, :512] = c_mid.reshape(S, 512)
    carries = records[:, :512].reshape(S, FF.STATE_ROWS, FF.LANES)
    FF.reset_launch_counts()
    z_k, c_k = FF.fm_front(rows, phases_dev, carries, taps, spec.decim)
    z_r, c_r = FF.fm_front_reference(rows, phases, carries, taps, spec.decim)
    records[:, 512:512 + T - 1] = z_r[:, -(T - 1):]
    hists = records[:, 512:512 + T - 1]
    a_k, h_k = FF.resample(z_r, hists, h_poly, spec.down)
    a_r, h_r = FF.resample_reference(z_r, hists, h_poly, spec.down)
    torch.cuda.synchronize()
    require(FF.LAUNCHES == {"fm_front": 1, "fm_resample": 1},
            f"the batch ran {FF.LAUNCHES}, not one launch of each")
    require(torch.equal(h_k, h_r), "batched fm_resample: histories differ")
    worst = {"fm_front": 1e9, "fm_resample": 1e9, "carry": 0.0}
    err = {"fm_front": 0.0, "fm_resample": 0.0}
    for j in range(S):
        s_front = snr_angle_db(z_r[j], z_k[j])
        s_rs = snr_db(a_r[j].cpu().numpy(), a_k[j].cpu().numpy())
        c_err = float((c_k[j] - c_r[j]).abs().max())
        require(s_front >= SNR_KERNEL_DB and s_rs >= SNR_KERNEL_DB
                and c_err <= 1e-3, f"batch station {j} (phase {phases[j]}): "
                f"fm_front {s_front:.1f} dB, fm_resample {s_rs:.1f} dB, "
                f"carry off by {c_err:.3g}")
        z1, c1 = FF.fm_front(rows[j], phases[j], carries[j].contiguous(), taps,
                             spec.decim)
        a1, h1 = FF.resample(z_r[j], hists[j].contiguous(), h_poly, spec.down)
        require(torch.equal(z1, z_k[j]) and torch.equal(c1, c_k[j])
                and torch.equal(a1, a_k[j]) and torch.equal(h1, h_k[j]),
                f"batch station {j}: differs from a one-station launch")
        worst = {"fm_front": min(worst["fm_front"], s_front),
                 "fm_resample": min(worst["fm_resample"], s_rs),
                 "carry": max(worst["carry"], c_err)}
        err["fm_front"] = max(err["fm_front"],
                              float(angle_err(z_r[j], z_k[j]).abs().max()))
        err["fm_resample"] = max(err["fm_resample"],
                                 float((a_k[j] - a_r[j]).abs().max()))
    print(f"batch: fm_front and fm_resample over {S} stations x "
          f"{data.numel()} B (phases {phases}, carries and histories at a "
          f"{RECORD_FLOATS}-float stride), one launch each: worst station "
          f"{worst['fm_front']:.1f} / {worst['fm_resample']:.1f} dB vs plain, "
          f"carry within {worst['carry']:.3g}, history equal, bit-equal to "
          f"one-station launches", flush=True)
    del z_r, c_r, a_r, a_k, z1, a1

    # the user entry point on the batch
    host = rows.cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    streamer = FF.FusedWbfmBatchStreamer(S, device=dev)
    streamer.phases = list(phases)
    FF.reset_launch_counts()
    t0 = time.monotonic()
    audio = streamer.demodulate(host)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(FF.LAUNCHES)
    require(launches == {"fm_front": 1, "fm_resample": 1},
            f"FusedWbfmBatchStreamer ran {launches}")
    # the same block again (its carries moved on): the key's replay, and
    # the peak memory of the graphed batch
    streamer.demodulate(host)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    require(streamer.graphs.replays == 1 and FF.LAUNCHES == {
        "fm_front": 2, "fm_resample": 2},
        "the batch streamer's second block was no graph replay")
    one = FF.FusedWbfmStreamer(device=dev).demodulate(host[0])
    require(np.array_equal(audio[0], one), "the batch streamer's station 0 "
            "differs from the one-station streamer")
    tone = synth.tone_snr(audio[0].astype(np.float64), 1_000.0, 32_000,
                          skip=1500)
    require(tone >= SNR_TONE_DB, f"batch station 0 tone {tone:.1f} dB")
    print(f"batch path: FusedWbfmBatchStreamer, {S} stations x "
          f"{audio.shape[1]} samples, launches {launches}, station 0 "
          f"bit-equal to FusedWbfmStreamer, tone {tone:.1f} dB, wall "
          f"{wall:.3f} s (with the {host.nbytes / 1e6:.0f} MB host-to-device "
          f"copy and the capture); a second block a replay, peak "
          f"{peak / 2 ** 20:.1f} MiB graphed", flush=True)
    del host, audio

    carries_c = [carries[j].contiguous() for j in range(S)]
    hists_c = [hists[j].contiguous() for j in range(S)]
    ms = device_ms({
        "fm_front_batch8": lambda: FF.fm_front(rows, phases_dev, carries,
                                               taps, spec.decim),
        "fm_front_single8": lambda: [FF.fm_front(rows[j], phases[j],
                                                 carries_c[j], taps,
                                                 spec.decim)
                                     for j in range(S)],
        "fm_resample_batch8": lambda: FF.resample(z_k, hists, h_poly,
                                                  spec.down),
        "fm_resample_single8": lambda: [FF.resample(z_k[j], hists_c[j], h_poly,
                                                    spec.down)
                                        for j in range(S)],
    }, flush=flush)
    return {"stations": S, "snr_db": worst, "err": err, "launches": launches,
            "tone_db": tone, "wall_s": wall, "ms": ms,
            "graphed_peak_mib": peak / 2 ** 20}


def modes(dev, u8, spec) -> dict:
    """The exact chain and the float chain's modes.  (a) The exact integer
    chain on the card against the same chain on the CPU, bit for bit, on
    the 10.24 s station in 262,144-byte blocks, and stage by stage against
    the golden vectors; (b) ``simple_fm --mode exact`` (byte-equal to the
    streamer), ``--mode boxcar`` and ``--mode fir --deemph 75`` on it,
    their real-time factors on the host clock (set-up paid first on one
    read); (c) the boxcar, de-emphasis and multiplex chains on the card
    against the CPU on its first 2.56 s, >= 100 dB; (d) the boxcar chain
    against the exact one, >= 60 dB.  Returns the numbers."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from golden_vectors import BUF_SIGNED, DEMOD_EXPECTED, LOWPASS, RESULT

    from tpu_sdr_torch.models import wbfm as TW
    from tpu_sdr_torch.models import wbfm_exact as TE
    from tpu_sdr_torch.ops import exact as X
    from tpu_sdr_torch.ops import fused_fm as FF
    from tpu_sdr_torch.utils import synth
    from tpu_sdr_torch.utils.design import WbfmConfig

    n_path = PATH_CHUNKS * spec.chunk_complex
    capture = u8[:2 * n_path]

    def stream(streamer, data):
        return np.concatenate([streamer.demodulate(data[s:s + CLI_READ])
                               for s in range(0, len(data), CLI_READ)])

    # (a) the exact chain: card against CPU, and the golden vectors
    exact_dev = stream(TE.WbfmExactStreamer(device=dev), capture)
    exact_cpu = stream(TE.WbfmExactStreamer(device="cpu"), capture)
    expect = n_path * spec.up // (spec.decim * spec.down)
    require(exact_dev.dtype == np.int16 and abs(len(exact_dev) - expect) <= 2,
            f"exact chain: {len(exact_dev)} samples, expected {expect}")
    require(np.array_equal(exact_dev, exact_cpu),
            "the exact chain on the card differs from the CPU")
    a = np.asarray(BUF_SIGNED, dtype=np.int32)
    lp_re, lp_im, count, _ = X.boxcar_decimate(
        torch.from_numpy(a[0::2].copy()).to(dev),
        torch.from_numpy(a[1::2].copy()).to(dev), X.boxcar_init(dev), 6)
    lp = torch.stack([lp_re[:int(count)], lp_im[:int(count)]], 1).reshape(-1)
    demod, count, _ = X.fm_discriminate(
        torch.from_numpy(np.asarray(LOWPASS[0::2], np.int32)).to(dev),
        torch.from_numpy(np.asarray(LOWPASS[1::2], np.int32)).to(dev),
        torch.tensor(len(LOWPASS) // 2, device=dev),
        X.discriminator_init(dev))
    demod = demod[:int(count)]
    res, count, _ = X.boxcar_resample(
        torch.tensor(DEMOD_EXPECTED, dtype=torch.int16, device=dev),
        torch.tensor(len(DEMOD_EXPECTED), device=dev), X.resampler_init(dev),
        170_000, 32_000)
    require(lp.cpu().tolist() == list(LOWPASS)
            and demod.cpu().tolist() == list(DEMOD_EXPECTED)
            and res[:int(count)].cpu().tolist() == list(RESULT),
            "the exact chain on the card misses a golden vector")
    print(f"exact chain on {dev}: {len(exact_dev)} samples over "
          f"{len(capture)} B in {CLI_READ}-byte blocks, bit-equal to the CPU; "
          f"boxcar decimator, discriminator and resampler bit-equal to the "
          f"golden vectors", flush=True)

    # (b) the CLIs on the card
    runs = {"exact": ["--mode", "exact"], "boxcar": ["--mode", "boxcar"],
            "fir_deemph75": ["--mode", "fir", "--deemph", "75"]}
    cli, pcm = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "station.u8")
        capture[:CLI_READ].tofile(path)
        for argv in runs.values():  # set-up a process pays once a mode
            run_app(["--file", path, *argv])
        capture.tofile(path)
        for name, argv in runs.items():
            FF.reset_launch_counts()
            t0 = time.monotonic()
            pcm[name] = run_app(["--file", path, *argv])
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            cli[name] = {"wall_s": wall, "samples": len(pcm[name]),
                         "realtime_x": n_path / wall / REALTIME_SPS,
                         "launches": dict(FF.LAUNCHES)}
    require(pcm["exact"].tobytes() == exact_dev.tobytes(),
            "simple_fm --mode exact differs from the exact streamer")
    # the tone: the fir chain's bar; the boxcar filters alias (they are
    # held to the exact chain below, as the exact chain to its vectors)
    for name in runs:
        cli[name]["tone_db"] = synth.tone_snr(
            pcm[name].astype(np.float64), 1_000.0, 32_000, skip=1500)
    require(cli["fir_deemph75"]["tone_db"] >= SNR_TONE_DB,
            f"simple_fm --mode fir --deemph 75: tone "
            f"{cli['fir_deemph75']['tone_db']:.1f} dB")
    for name, c in cli.items():
        print(f"simple_fm {' '.join(runs[name])} on {dev}: {c['samples']} "
              f"samples, tone {c['tone_db']:.1f} dB, wall {c['wall_s']:.3f} "
              f"s = {c['realtime_x']:.2f}x real time (host clock), kernel "
              f"launches {c['launches']}", flush=True)

    # (c) the float chain's modes, card against CPU
    part = capture[:2 * MODE_CHUNKS * spec.chunk_complex]
    snrs = {}
    configs = {"boxcar": WbfmConfig(filter_mode="boxcar"),
               "fir_deemph75": WbfmConfig(deemphasis_tau=75e-6),
               "boxcar_deemph75_mpx": WbfmConfig(filter_mode="boxcar",
                                                 deemphasis_tau=75e-6,
                                                 emit_mpx=True),
               "fir_mpx": WbfmConfig(emit_mpx=True)}
    for name, config in configs.items():
        out, mpx = {}, {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            st = TW.WbfmStreamer(config, device=d)
            out[where] = stream(st, part)
            mpx[where] = st.last_mpx
        s = snr_db(out["cpu"], out["card"])
        require(out["card"].shape == out["cpu"].shape and s >= SNR_KERNEL_DB,
                f"{name} on the card vs the CPU: {s:.1f} dB")
        snrs[name] = s
        if config.emit_mpx:
            s_mpx = snr_db(mpx["cpu"], mpx["card"])
            require(s_mpx >= SNR_KERNEL_DB, f"{name}: multiplex {s_mpx:.1f} dB")
            snrs[f"{name}_tap"] = s_mpx

    # (d) boxcar against exact
    box = stream(TW.WbfmStreamer(configs["boxcar"], device=dev), capture)
    s_box, lag = synth.align_and_snr(exact_dev.astype(np.float64), box,
                                     max_lag=4, skip=50)
    require(lag == 0 and s_box >= SNR_BOXCAR_EXACT_DB,
            f"boxcar vs exact: {s_box:.1f} dB at lag {lag}")
    print(f"float modes on {dev} vs the CPU on {len(part)} B: "
          f"{', '.join(f'{k} {v:.1f} dB' for k, v in snrs.items())}; boxcar "
          f"vs exact {s_box:.1f} dB at lag 0", flush=True)
    return {"cli": cli, "card_vs_cpu_db": snrs, "boxcar_vs_exact_db": s_box,
            "exact_samples": len(exact_dev)}


def stereo_quality(audio, skip: int = 2000) -> dict:
    """(2, m) stereo audio carrying an 800 Hz tone in L and a 1,300 Hz tone
    in R (either may be absent): both tones are fitted in each channel;
    each channel's tone SNR is its own tone against what neither tone
    explains, and each tone's separation is its level in its channel over
    its level in the other (the crosstalk counts there, not as noise)."""
    import numpy as np

    a = np.asarray(audio, dtype=np.float64)[:, skip:]
    t = np.arange(a.shape[1]) / 32_000
    basis = np.stack([np.ones_like(t)] + [
        f(2 * np.pi * fr * t) for fr in (800.0, 1_300.0)
        for f in (np.sin, np.cos)], axis=1)
    amp, noise = [], []
    for ch in range(2):
        c, *_ = np.linalg.lstsq(basis, a[ch], rcond=None)
        res = a[ch] - basis @ c
        amp.append((np.hypot(c[1], c[2]), np.hypot(c[3], c[4])))
        noise.append(np.dot(res, res) / len(res))
    return {"snr_l_db": 10 * np.log10(amp[0][0] ** 2 / 2 / noise[0]),
            "snr_r_db": 10 * np.log10(amp[1][1] ** 2 / 2 / noise[1]),
            "sep_l_db": 20 * np.log10(amp[0][0] / max(amp[1][0], 1e-30)),
            "sep_r_db": 20 * np.log10(amp[1][1] / max(amp[0][1], 1e-30))}


def rds_lines(err: str, tag: str = "[rds]") -> dict:
    """The ``tag`` lines of a CLI's stderr by kind: {"PI": {...}, ...}."""
    kinds = {}
    for line in err.splitlines():
        if line.startswith(tag + " "):
            kind, _, value = line[len(tag) + 1:].partition(": ")
            kinds.setdefault(kind, set()).add(value)
    return kinds


def receivers(dev, spec, smi: str) -> dict:
    """The receivers of the JAX package's other CLIs, through their entry
    points on the card: (a) ``simple_fm --mode stereo --rds`` on a 10.24 s
    stereo station with RDS, and ``--mode stereo`` on 2.56 s without;
    (b) ``rtl_fm -M wbfm --rds`` on the RDS station; (c) ``rtl_fm -M
    fm|am|usb|lsb`` on 10.24 s narrowband captures and ``-l`` on noise;
    (d) ``multi_fm --fused --rds`` on 1.024 s of 8 stations, 4 with RDS;
    (e) ``rtl_power --file``; (f) checkpoint/resume on the card; (g)
    ``simple_fm --trace``.  Each against the same streamer on the CPU
    where the JAX tests' bars say so.  Returns the numbers."""
    import glob

    import numpy as np
    import torch

    from tpu_sdr_torch.models import multimode as TM
    from tpu_sdr_torch.models import rds as R
    from tpu_sdr_torch.models import wbfm_stereo as TS
    from tpu_sdr_torch.models import wbfm_wideband as WB
    from tpu_sdr_torch.ops import fused_channelizer as FC
    from tpu_sdr_torch.ops import fused_fm as FF
    from tpu_sdr_torch.ops import spectrum as SP
    from tpu_sdr_torch.parallel import mesh as PM
    from tpu_sdr_torch.parallel import wbfm_sharded_fused as WSF
    from tpu_sdr_torch.stream import checkpoint as C
    from tpu_sdr_torch.utils import synth

    cpu = torch.device("cpu")
    out = {}
    n_path = PATH_CHUNKS * spec.chunk_complex
    n_part = MODE_CHUNKS * spec.chunk_complex

    def stream(streamer, data):
        return np.concatenate([streamer.demodulate(data[s:s + CLI_READ])
                               for s in range(0, len(data), CLI_READ)],
                              axis=-1)

    def timed_cli(app, argv, path, n_complex, rate=REALTIME_SPS):
        """The CLI on ``path``: set-up paid first on one read, then timed
        (host clock) on the whole file."""
        with open(path, "rb") as f:
            head = f.read(CLI_READ)
        warm = path + ".head"
        with open(warm, "wb") as f:
            f.write(head)
        run_cli(app, [a if a != path else warm for a in argv])
        torch.cuda.synchronize()
        t0 = time.monotonic()
        raw, err = run_cli(app, argv)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        return raw, err, wall, n_complex / wall / rate

    with tempfile.TemporaryDirectory() as tmp:
        # ---- (a) stereo + RDS ---------------------------------------------
        rt = RDS_RT + "\r"
        rt += " " * (-len(rt) % 4)
        groups = ([R.make_group_0a(RDS_PI, 9, s, RDS_PS[2 * s:2 * s + 2])
                   for s in range(4)]
                  + [R.make_group_2a(RDS_PI, 9, s, rt[4 * s:4 * s + 4])
                     for s in range(len(rt) // 4)])
        one = np.concatenate(groups)
        n_bits = int(n_path / REALTIME_SPS * R.RDS_RATE) + 2
        bits = np.tile(one, n_bits // len(one) + 1)[:n_bits]
        t0 = time.monotonic()
        u8_st, _, _ = synth.synth_wbfm_stereo_u8(n_path, REALTIME_SPS,
                                                 rds_bits=bits)
        u8_plain, _, _ = synth.synth_wbfm_stereo_u8(n_part, REALTIME_SPS)
        print(f"stereo captures: {n_path} complex with RDS (PI {RDS_PI:04X}, "
              f"PS {RDS_PS!r}, RT {RDS_RT!r}), {n_part} without, made in "
              f"{time.monotonic() - t0:.1f} s", flush=True)
        st_path = os.path.join(tmp, "stereo_rds.u8")
        u8_st.tofile(st_path)
        raw, err, wall, rtf = timed_cli(
            "simple_fm", ["--file", st_path, "--mode", "stereo", "--rds"],
            st_path, n_path)
        pcm = np.frombuffer(raw, dtype="<i2").reshape(-1, 2).T
        expect = n_path // (3 * 85) * 8
        require(abs(pcm.shape[1] - expect) <= 8 * CLI_READ // 510,
                f"stereo: {pcm.shape[1]} samples a channel, expected {expect}")
        lines = rds_lines(err)
        want = {"PI": {f"{RDS_PI:04X}"}, "PS": {repr(RDS_PS)},
                "RT": {repr(RDS_RT)}}
        for kind, value in want.items():
            require(lines.get(kind) == value, f"simple_fm --mode stereo "
                    f"--rds: {kind} lines {lines.get(kind)}, sent {value}")
        q_rds = stereo_quality(pcm)
        for side in ("l", "r"):
            require(q_rds[f"sep_{side}_db"] >= SEP_STEREO_DB,
                    f"stereo separation {side}: {q_rds[f'sep_{side}_db']:.1f} dB")
        require(rtf >= REALTIME_MIN, f"stereo + RDS at {rtf:.2f}x real time")
        plain_path = os.path.join(tmp, "stereo.u8")
        u8_plain.tofile(plain_path)
        q = stereo_quality(np.frombuffer(run_cli(
            "simple_fm", ["--file", plain_path, "--mode", "stereo"])[0],
            dtype="<i2").reshape(-1, 2).T)
        for key, bar in (("snr_l_db", SNR_STEREO_TONE_DB),
                         ("snr_r_db", SNR_STEREO_TONE_DB),
                         ("sep_l_db", SEP_STEREO_DB),
                         ("sep_r_db", SEP_STEREO_DB)):
            require(q[key] >= bar, f"stereo without RDS: {key} {q[key]:.1f}")
        part = u8_st[:2 * n_part]
        st_out, st_mpx = {}, {}
        for where, d in (("card", dev), ("cpu", cpu)):
            s = TS.WbfmStereoStreamer(TS.StereoConfig(emit_mpx=True), device=d)
            st_out[where] = stream(s, part)
            st_mpx[where] = s.last_mpx
        s_card = min(snr_db(st_out["cpu"][ch], st_out["card"][ch])
                     for ch in range(2))
        s_mpx = snr_db(st_mpx["cpu"], st_mpx["card"])
        require(st_out["card"].shape == st_out["cpu"].shape
                and min(s_card, s_mpx) >= SNR_KERNEL_DB,
                f"stereo on the card vs the CPU: {s_card:.1f} dB, multiplex "
                f"{s_mpx:.1f} dB")
        out["stereo_rds"] = {"complex": n_path, "wall_s": wall,
                             "realtime_x": rtf, "rds": {k: sorted(v) for k, v
                                                        in lines.items()},
                             **q_rds, "card_vs_cpu_db": s_card,
                             "mpx_card_vs_cpu_db": s_mpx}
        out["stereo"] = {"complex": n_part, **q}
        print(f"simple_fm --mode stereo --rds on {dev}: {pcm.shape[1]} "
              f"samples a channel, RDS {', '.join(f'{k} {sorted(v)}' for k, v in lines.items())}, "
              f"separation L {q_rds['sep_l_db']:.1f} / R {q_rds['sep_r_db']:.1f}"
              f" dB, two-tone SNR L {q_rds['snr_l_db']:.1f} / R "
              f"{q_rds['snr_r_db']:.1f} dB (the RDS subcarrier's 19 kHz "
              f"product with the 38 kHz carrier aliases to 13 kHz), card vs "
              f"CPU {s_card:.1f} dB (multiplex {s_mpx:.1f}) over "
              f"{n_part / REALTIME_SPS:.2f} s, wall {wall:.3f} s = "
              f"{rtf:.2f}x real time ({smi})", flush=True)
        print(f"simple_fm --mode stereo on {dev} (no RDS): SNR L "
              f"{q['snr_l_db']:.1f} / R {q['snr_r_db']:.1f} dB, separation "
              f"L {q['sep_l_db']:.1f} / R {q['sep_r_db']:.1f} dB", flush=True)

        # ---- (b) rtl_fm -M wbfm --rds on the same capture -------------------
        raw, err, wall, rtf = timed_cli(
            "rtl_fm", ["-M", "wbfm", "--rds", "--file", st_path], st_path,
            n_path)
        lines = rds_lines(err)
        for kind in ("PI", "PS"):
            require(lines.get(kind) == want[kind], f"rtl_fm -M wbfm --rds: "
                    f"{kind} lines {lines.get(kind)}")
        require(rtf >= REALTIME_MIN, f"rtl_fm -M wbfm --rds at {rtf:.2f}x")
        out["rtl_fm"] = {"wbfm_rds": {"wall_s": wall, "realtime_x": rtf,
                                      "rds": {k: sorted(v)
                                              for k, v in lines.items()}}}
        print(f"rtl_fm -M wbfm --rds on {dev}: RDS "
              f"{', '.join(f'{k} {sorted(v)}' for k, v in lines.items())}, "
              f"wall {wall:.3f} s = {rtf:.2f}x real time ({smi})", flush=True)
        del u8_st, u8_plain, part

        # ---- (c) rtl_fm's narrowband modes, as tests/test_multimode.py -----
        t = np.arange(n_path) / REALTIME_SPS
        offset = np.choose(np.arange(n_path) % 4, [1 + 0j, -1j, -1 + 0j, 1j])

        def narrowband(mode):
            if mode == "fm":
                return np.asarray(synth.synth_wbfm_u8(
                    n_path, capture_rate=REALTIME_SPS, audio_freq=1_000.0,
                    deviation=5_000.0)[0], np.uint8)
            if mode == "am":
                bb = 0.45 * (1.0 + 0.8 * np.sin(2 * np.pi * 1_000.0 * t))
            else:
                sign = 1 if mode == "usb" else -1
                bb = 0.7 * np.exp(sign * 2j * np.pi * 1_000.0 * t)
            return synth._to_u8(bb * offset)

        mm_cfg = {"fm": "nbfm", "am": "am", "usb": "usb", "lsb": "lsb"}
        for mode, bar in SNR_MODE_TONE_DB.items():
            u8_m = narrowband(mode)
            path = os.path.join(tmp, f"{mode}.u8")
            u8_m.tofile(path)
            raw, _, wall, rtf = timed_cli(
                "rtl_fm", ["-M", mode, "--file", path], path, n_path)
            pcm = np.frombuffer(raw, dtype="<i2").astype(np.float64)
            tone = synth.tone_snr(pcm, 1_000.0, 32_000, skip=400)
            mm_out = {}
            for where, d in (("card", dev), ("cpu", cpu)):
                s = TM.MultimodeStreamer(TM.MultimodeConfig(
                    mode=mm_cfg[mode]), device=d)
                mm_out[where] = stream(s, u8_m[:2 * n_part])
            s_card = snr_db(mm_out["cpu"][MODE_SKIP:],
                            mm_out["card"][MODE_SKIP:])
            require(abs(len(pcm) - n_path * 16 // 510) <= 2 * CLI_READ // 510,
                    f"rtl_fm -M {mode}: {len(pcm)} samples")
            require(tone >= bar, f"rtl_fm -M {mode}: tone {tone:.1f} dB")
            require(s_card >= SNR_KERNEL_DB, f"rtl_fm -M {mode}: card vs CPU "
                    f"{s_card:.1f} dB")
            require(rtf >= REALTIME_MIN, f"rtl_fm -M {mode} at {rtf:.2f}x")
            out["rtl_fm"][mode] = {"tone_db": tone, "card_vs_cpu_db": s_card,
                                   "wall_s": wall, "realtime_x": rtf}
            print(f"rtl_fm -M {mode} on {dev}: {len(pcm)} samples, tone "
                  f"{tone:.1f} dB, card vs CPU {s_card:.1f} dB over "
                  f"{n_part / REALTIME_SPS:.2f} s, wall {wall:.3f} s = "
                  f"{rtf:.2f}x real time ({smi})", flush=True)
        rng = np.random.default_rng(9)
        n_noise = n_part // 4
        path = os.path.join(tmp, "noise.u8")
        synth._to_u8(rng.normal(0, 0.003, n_noise)
                     + 1j * rng.normal(0, 0.003, n_noise)).tofile(path)
        pcm = np.frombuffer(run_cli("rtl_fm", ["-M", "fm", "-l", "-35",
                                               "--file", path])[0], "<i2")
        require(len(pcm) > 1000 and not pcm.any(),
                "rtl_fm -M fm -l -35 did not mute a noise-only capture")
        out["rtl_fm"]["squelch_noise_muted_samples"] = len(pcm)
        print(f"rtl_fm -M fm -l -35 on noise: {len(pcm)} samples, all 0",
              flush=True)
        del t, offset

        # ---- (d) multi_fm --fused --rds: 8 stations, 4 with RDS --------------
        config = WB.WidebandConfig(channels=WB_CHANNELS)
        K = config.num_channels
        n_wb = WB_PATH_READS * WB_READ_BYTES // 2
        n_bits = int(n_wb / config.capture_rate * R.RDS_RATE) + 2
        rds_bits = []
        for ch in WB_CHANNELS:
            if ch in WB_RDS:
                pi, ps = WB_RDS[ch]
                g = np.concatenate([R.make_group_0a(pi, 5, s, ps[2 * s:2 * s + 2])
                                    for s in range(4)])
                rds_bits.append(np.tile(g, n_bits // len(g) + 1)[:n_bits])
            else:
                rds_bits.append(None)
        t0 = time.monotonic()
        u8_wb, _ = synth.synth_multistation_u8(
            n_wb, config.capture_rate,
            station_freqs=[(k if k <= K // 2 else k - K) * config.channel_rate
                           for k in WB_CHANNELS],
            audio_freqs=list(WB_TONES), deviation=60_000.0, rds_bits=rds_bits)
        path = os.path.join(tmp, "wideband_rds.u8")
        u8_wb.tofile(path)
        print(f"wideband RDS capture: {n_wb} complex, RDS on channels "
              f"{sorted(WB_RDS)}, made in {time.monotonic() - t0:.1f} s",
              flush=True)
        del u8_wb
        FC.reset_launch_counts()
        t0 = time.monotonic()
        _, err = run_cli("multi_fm", [
            "--file", path, "--channels", ",".join(map(str, WB_CHANNELS)),
            "--fused", "--rds", "--out-dir", os.path.join(tmp, "wb_out")])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = FC.LAUNCHES["pfb_channelize"]
        require(launches > 0, "multi_fm --fused --rds never launched K3")
        found = {}
        for ch in WB_CHANNELS:
            lines = rds_lines(err, f"[rds ch{ch}]")
            if ch in WB_RDS:
                pi, ps = WB_RDS[ch]
                require(lines.get("PI") == {f"{pi:04X}"}
                        and lines.get("PS") == {repr(ps)},
                        f"multi_fm --rds channel {ch}: {lines}")
            else:
                require(not lines, f"multi_fm --rds: channel {ch} carries no "
                        f"RDS but printed {lines}")
            found[ch] = {k: sorted(v) for k, v in lines.items()}
        rtf = n_wb / wall / config.capture_rate
        out["multi_fm_rds"] = {"complex": n_wb, "pfb_channelize_launches":
                               launches, "rds": found, "wall_s": wall,
                               "realtime_x": rtf}
        print(f"multi_fm --fused --rds on {dev}: K3 launches {launches}, "
              f"RDS {found}, wall {wall:.3f} s = {rtf:.2f}x real time "
              f"({smi})", flush=True)

        # ---- (e) rtl_power --file: a tone at +fs/8 ---------------------------
        n_psd = PSD_RATE * 5 // 4
        rng = np.random.default_rng(7)
        ph = 2 * np.pi * 0.125 * np.arange(n_psd)
        u8_psd = np.empty(2 * n_psd, np.uint8)
        u8_psd[0::2] = np.clip(np.round(127.5 + 100 * np.cos(ph)
                                        + rng.normal(0, 1.0, n_psd)), 0, 255)
        u8_psd[1::2] = np.clip(np.round(127.5 + 100 * np.sin(ph)
                                        + rng.normal(0, 1.0, n_psd)), 0, 255)
        path = os.path.join(tmp, "tone.u8")
        u8_psd.tofile(path)
        center = 100_000_000
        argv = ["-f", str(center), "-s", str(PSD_RATE), "--file", path]
        t0 = time.monotonic()
        text = run_cli("rtl_power", argv)[0].decode()
        wall = time.monotonic() - t0
        fields = [p.strip() for p in text.strip().split(",")]
        hz_low, step = int(fields[2]), float(fields[4])
        bins = np.array([float(v) for v in fields[6:]])
        peak_hz = hz_low + step * int(np.argmax(bins))
        require(abs(peak_hz - (center + PSD_RATE / 8)) <= step,
                f"rtl_power: peak at {peak_hz} Hz, tone at "
                f"{center + PSD_RATE / 8}")
        n_fft = len(bins)
        db = {}
        for where, d in (("card", dev), ("cpu", cpu)):
            ps = SP.PsdStreamer(n_fft, device=d)
            for s in range(0, len(u8_psd), CLI_READ):
                ps.accumulate(u8_psd[s:s + CLI_READ])
            db[where] = ps.finalize_db()
        above = db["cpu"] > -100.0
        d_db = float(np.abs(db["card"] - db["cpu"])[above].max())
        require(d_db <= PSD_DB_TOL, f"rtl_power: card vs CPU {d_db:.4f} dB")
        out["rtl_power"] = {"n_fft": n_fft, "peak_hz": peak_hz,
                            "max_card_vs_cpu_db": d_db, "wall_s": wall}
        print(f"rtl_power --file on {dev}: {n_fft} bins, peak at {peak_hz:.0f}"
              f" Hz (tone at {center + PSD_RATE / 8:.0f}), card vs CPU within "
              f"{d_db:.2e} dB over {int(above.sum())} bins above -100 dB, wall "
              f"{wall:.3f} s ({smi})", flush=True)
        del u8_psd, ph

        # ---- (f) checkpoint/resume on the card -------------------------------
        def roundtrip(make, data, split, axis=0):
            ref = make()
            full = np.concatenate([ref.demodulate(data[..., :split]),
                                   ref.demodulate(data[..., split:])],
                                  axis=axis)
            first = make()
            out1 = first.demodulate(data[..., :split])
            ck = os.path.join(tmp, "ck.npz")
            C.save_stream_state(ck, first)
            resumed = make()
            C.load_stream_state(ck, resumed)
            on_card = all(x.device == dev for x in C._flatten(
                getattr(resumed, "state", getattr(resumed, "states", None)))
                if torch.is_tensor(x))
            got = np.concatenate([out1, resumed.demodulate(data[..., split:])],
                                 axis=axis)
            return got.size > 0 and on_card and np.array_equal(got, full)

        rng = np.random.default_rng(21)
        u8_ck, _, _ = synth.synth_wbfm_stereo_u8(4 * spec.chunk_complex,
                                                 REALTIME_SPS)
        wb_ck = rng.integers(0, 256, 4 * WB_READ_BYTES, dtype=np.uint8)
        ck = {
            "stereo": roundtrip(lambda: TS.WbfmStereoStreamer(
                TS.StereoConfig(emit_mpx=True), device=dev), u8_ck, 150_001,
                axis=1),
            "multimode": roundtrip(lambda: TM.MultimodeStreamer(
                TM.MultimodeConfig(mode="usb", fine_tune_hz=120.0),
                device=dev), u8_ck, 150_001),
            "fused": roundtrip(lambda: FF.FusedWbfmStreamer(device=dev),
                               u8_ck, 2 * spec.chunk_bytes + 1_001),
            "fused_wideband": roundtrip(lambda: WB.WidebandStreamer(
                config, use_fused=True, device=dev), wb_ck,
                2 * WB_READ_BYTES + 1_001, axis=1),
        }
        mesh = PM.make_mesh(1, 2, devices=[dev] * 2)
        blocks = [rng.integers(0, 256, (2, 2 * spec.chunk_bytes),
                               dtype=np.uint8) for _ in range(3)]
        ref = WSF.ShardedFusedStreamer(mesh, 2)
        exp = [ref.demodulate(b) for b in blocks]
        first = WSF.ShardedFusedStreamer(mesh, 2)
        first.demodulate(blocks[0])
        C.save_stream_state(os.path.join(tmp, "sh.npz"), first)
        target = WSF.ShardedFusedStreamer(mesh, 2)
        for b in blocks[::-1]:  # eager, then capture, then a graph replay
            target.demodulate(b)
        require(target.step_graph is not None, "the sharded streamer did not "
                "capture its step")
        C.load_stream_state(os.path.join(tmp, "sh.npz"), target)
        ck["sharded_after_graph_replay"] = (
            np.array_equal(target.demodulate(blocks[1]), exp[1])
            and np.array_equal(target.demodulate(blocks[2]), exp[2]))
        for name, ok in ck.items():
            require(ok, f"checkpoint: {name} did not resume bit-equal")
        out["checkpoint_bit_equal"] = ck
        print(f"checkpoint on {dev}: {', '.join(ck)} resume bit-equal to an "
              f"uninterrupted run (sharded: loaded into a streamer whose "
              f"CUDA graph had replayed)", flush=True)

        # ---- (g) simple_fm --mode fused --trace ------------------------------
        path = os.path.join(tmp, "trace.u8")
        u8_ck.tofile(path)
        trace_dir = os.path.join(tmp, "trace")
        run_cli("simple_fm", ["--file", path, "--mode", "fused", "--trace",
                              trace_dir])
        traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
        require(len(traces) == 1, f"--trace wrote {traces}")
        with open(traces[0]) as f:
            text = f.read()
        named = {k: text.count(k) for k in ("fm_front", "fm_resample")}
        require(all(named.values()), f"the trace names {named}")
        out["trace"] = {"bytes": len(text), "names": named}
        print(f"simple_fm --mode fused --trace: {os.path.basename(traces[0])}"
              f", {len(text)} bytes, naming fm_front x{named['fm_front']}, "
              f"fm_resample x{named['fm_resample']}", flush=True)
    return out


def trace_device(path: str) -> dict:
    """A Chrome trace of ``utils.profiling.trace`` read back, counting only
    what lies inside its ``TRACED_RANGE`` range (opened after its pad
    launches): the host's launch and copy calls there, but for those made
    while a stream was capturing (a new key's graph), each of which must
    have its device record (``lost`` counts those without: a trace that
    is not whole is taken again); the device's busy share (the union of
    those records' intervals over the range's host wall); the CUDA
    streams that ran the host-to-device copies, and those that ran K1 and
    K2."""
    from tpu_sdr_torch.utils.profiling import TRACED_RANGE

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    span = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == TRACED_RANGE]
    require(len(span) == 1, f"trace: {len(span)} '{TRACED_RANGE}' ranges")
    lo = float(span[0]["ts"])
    hi = lo + float(span[0]["dur"])

    def corr(e):
        return e.get("args", {}).get("correlation")

    host = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                    "cuda_driver")]
    captured = _capture_spans((e["name"], float(e["ts"]),
                               float(e["ts"]) + float(e["dur"]))
                              for e in host)
    calls = {corr(e) for e in host
             if _is_call(e["name"]) and lo <= float(e["ts"]) <= hi
             and not _in_spans(float(e["ts"]), captured)}
    records = [e for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and corr(e) in calls]
    lost = calls - {corr(e) for e in records}
    lost_names: dict = {}
    for e in host:
        if corr(e) in lost:
            lost_names[e["name"]] = lost_names.get(e["name"], 0) + 1
    on_device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in records)
    busy, end = 0.0, -math.inf
    for t0, t1 in on_device:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)

    def streams(match):
        return sorted({e.get("args", {}).get("stream") for e in records
                       if e.get("cat") in ("kernel", "gpu_memcpy")
                       and match(e["name"])})

    return {"busy_share": busy / (hi - lo), "busy_us": busy,
            "span_us": hi - lo, "device_ops": len(on_device),
            "host_calls": len(calls), "lost": len(lost),
            "lost_names": lost_names, "captures": len(captured),
            "htod_streams": streams(lambda n: "HtoD" in n),
            "kernel_streams": streams(lambda n: "fm_front_kernel" in n
                                      or "fm_resample_kernel" in n),
            "htod_copies": sum("HtoD" in e["name"] for e in records
                               if e.get("cat") == "gpu_memcpy")}


class _StatsRecords(logging.Handler):
    """Collects the ``block_stats`` that ``simple_fm``'s final log record
    carries (its per-read latencies and drops)."""

    def __init__(self):
        super().__init__()
        self.stats = []

    def emit(self, record):
        if hasattr(record, "block_stats"):
            self.stats.append(record.block_stats)


def serve_fake(source_factory=None, testmode=False, max_clients=1,
               queue_limit=TCP_QUEUE):
    """The port's rtl_tcp server on a fresh fake dongle, in a thread:
    (server, close)."""
    import threading

    from tpu_sdr_torch import api as tapi
    from tpu_sdr_torch.control import fake
    from tpu_sdr_torch.stream.rtl_tcp_server import RtlTcpServer

    fake.clear_fake_devices()
    fake.register_fake_device(fake.FakeDeviceSpec(
        serial="ingest01", source_factory=source_factory))
    sdr = tapi.RtlSdr.open_with_index(0)
    sdr.set_sample_rate(REALTIME_SPS)
    sdr.set_testmode(testmode)
    sdr.reset_buffer()
    srv = RtlTcpServer(sdr, "127.0.0.1", 0, queue_limit=queue_limit,
                       max_clients=max_clients)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while srv.bound_port is None and time.monotonic() < deadline:
        time.sleep(0.01)
    require(srv.bound_port is not None, "rtl_tcp server did not bind")

    def close():
        srv.stop()
        t.join(timeout=10)
        sdr.close()
        fake.clear_fake_devices()
        require(not t.is_alive(), "rtl_tcp server did not stop")

    return srv, close


def psd_scan(dev, smi: str) -> dict:
    """``rtl_power`` scanning SCAN_HOPS hops of SCAN_BLOCKS reads (after
    its one settle read a hop) over the network from the port's
    ``RtlTcpServer`` on a fake dongle, at 2.048 Msps and ``n_fft`` 1024,
    eager (``graphs.disabled()``) then graphed.  Gates: one PSD streamer
    a scan, reset at each hop; graphed, one capture for the one block
    length and every other block a replay; a row a hop.  Printed: the
    scan's wall in each form (host clock, the fake dongle unpaced)."""
    import torch

    from tpu_sdr_torch.apps import rtl_power
    from tpu_sdr_torch.control import fake
    from tpu_sdr_torch.ops import spectrum as SP
    from tpu_sdr_torch.utils import graphs

    made = []

    class Recorded(SP.PsdStreamer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    low = 94_000_000
    high = low + SCAN_HOPS * int(PSD_RATE * rtl_power.HOP_CROP)
    require(len(rtl_power.hop_centers(low, high, PSD_RATE)) == SCAN_HOPS,
            "the scan's range does not make its hops")
    res = {"hops": SCAN_HOPS, "blocks_a_hop": SCAN_BLOCKS}
    real = SP.PsdStreamer
    SP.PsdStreamer = Recorded
    try:
        for form in ("eager", "graphed"):
            made.clear()
            srv, close = serve_fake(lambda: fake.SynthFmSource(
                capture_rate=PSD_RATE, seconds=0.5), queue_limit=64)
            argv = ["-f", f"{low}:{high}:2k", "-s", str(PSD_RATE), "-b",
                    str(SCAN_BLOCKS), "--tcp", f"127.0.0.1:{srv.bound_port}"]
            ctx = graphs.disabled() if form == "eager" else \
                contextlib.nullcontext()
            try:
                with ctx:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    text, _ = run_cli("rtl_power", argv)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                close()
            rows = text.decode().strip().splitlines()
            require(len(rows) == SCAN_HOPS, f"rtl_power scan ({form}): "
                    f"{len(rows)} rows for {SCAN_HOPS} hops")
            require(len(made) == 1 and made[0].n_fft == PSD_FFT,
                    f"rtl_power scan ({form}): {len(made)} PSD streamers")
            g = made[0].graphs
            res[form] = {"wall_s": wall, "captures": g.captures,
                         "replays": g.replays, "keys": len(g.keys)}
    finally:
        SP.PsdStreamer = real
    gr = res["graphed"]
    require(gr["captures"] == gr["keys"] == 1 and gr["replays"]
            == SCAN_HOPS * SCAN_BLOCKS - 1,
            f"rtl_power scan: {gr} (one capture a key, not one a hop)")
    print(f"rtl_power scan over rtl_tcp: {SCAN_HOPS} hops x {SCAN_BLOCKS} "
          f"reads of {CLI_READ} B, a row a hop; one streamer a scan: "
          f"{gr['captures']} capture, {gr['replays']} replays; wall eager "
          f"{res['eager']['wall_s']:.3f} s / graphed {gr['wall_s']:.3f} s "
          f"({smi})", flush=True)
    return res


def ingest(dev, u8, spec, smi: str) -> dict:
    """The host-to-device feed (``BlockFeeder`` on the port's C++ ring and
    pump, ``device_blocks``' pinned double buffer) and the network path:
    (a) the native runtime loaded, and the feeder native on a file and on
    an rtl_tcp socket; (b) the feed alone from a file, at the 25 MB block
    and at the 262,144-byte read: a bare pinned copy loop (the ceiling),
    a pageable ``.to`` loop and ``device_blocks`` with a consumer that only
    waits; (c) ``FusedWbfmStreamer`` fed by ``blocks()`` and by
    ``device_blocks()`` on the same file, bit-equal, the copies off the
    kernels' stream in a trace; (d) ``simple_fm --tcp --mode fused`` from
    the port's ``RtlTcpServer`` on a fake dongle paced at 1.02 Msps (no
    drops, K1/K2 once a read, tone, bit-equal to ``--file``, per-read
    latency, busy share), then an unpaced ingest; (e) the server's
    counter test mode and its fan-out.  Returns the numbers."""
    import glob
    import threading

    import numpy as np
    import torch

    from tpu_sdr_torch import native
    from tpu_sdr_torch.control import fake
    from tpu_sdr_torch.ops import fused_fm as FF
    from tpu_sdr_torch.stream import feeder as FD
    from tpu_sdr_torch.utils import profiling
    from tpu_sdr_torch.utils import synth

    out = {}
    rec = _StatsRecords()
    logging.getLogger("simple_fm").addHandler(rec)

    # ---- (a) the native runtime -------------------------------------------
    require(native.available(), "the native runtime did not build or load")
    out["native"] = {"library": os.path.basename(native.library_path()),
                     "build_s": native.build_seconds}

    serve = serve_fake

    with tempfile.TemporaryDirectory() as tmp:
        # ---- (b) the feed alone from a file -------------------------------
        feeds = {}
        for label, nbytes, count in (("block", 2 * BLOCK_COMPLEX, INGEST_BLOCKS),
                                     ("read", CLI_READ, INGEST_READS)):
            path = os.path.join(tmp, f"feed_{label}.u8")
            with open(path, "wb") as f:
                for i in range(count):  # the station capture, read on
                    s = i * nbytes % (len(u8) - nbytes + 1)
                    f.write(u8[s:s + nbytes].tobytes())
            pinned = torch.from_numpy(u8[:nbytes].copy()).pin_memory()
            dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            pageable = [u8[i * nbytes % (len(u8) - nbytes + 1):][:nbytes]
                        for i in range(count)]
            dst.copy_(pinned, non_blocking=True)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(count):
                dst.copy_(pinned, non_blocking=True)
            end.record()
            end.synchronize()
            ceiling = count * nbytes / (start.elapsed_time(end) * 1e-3) / 1e9
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for a in pageable:
                torch.from_numpy(a).to(dev)
            torch.cuda.synchronize()
            paged = count * nbytes / (time.perf_counter() - t0) / 1e9

            def feed(on_device: bool) -> float:
                """GB/s through the native file feeder to the card, with a
                consumer that only waits for each block: device_blocks, or
                blocks() and a pageable .to (the like-for-like reading)."""
                fd = FD.BlockFeeder(FD.FileSource(path), block_bytes=nbytes,
                                    queue_blocks=4)
                fd.start()
                require(fd.is_native, "the file feeder is not native")
                got = 0
                t0 = time.perf_counter()
                for blk in (fd.device_blocks(dev) if on_device
                            else (torch.from_numpy(b).to(dev)
                                  for b in fd.blocks())):
                    torch.cuda.current_stream().synchronize()
                    got += 1
                wall = time.perf_counter() - t0
                fd.stop()
                require(got == count and fd.dropped == 0,
                        f"feed fed {got} of {count} blocks, {fd.dropped} "
                        "dropped")
                require(not on_device or (len(fd.staging) >= 2 and all(
                    s.is_pinned() for s in fd.staging)),
                    "staging slots not pinned")
                return count * nbytes / wall / 1e9

            feed(True)  # warm: the file in the page cache
            rates = {True: [], False: []}
            for on_device in (False, True, True, False, False, True):
                rates[on_device].append(feed(on_device))
            rate = statistics.median(rates[True])
            fed_paged = statistics.median(rates[False])
            feeds[label] = {"bytes": nbytes, "blocks": count,
                            "pinned_copy_gb_s": ceiling,
                            "pageable_to_gb_s": paged,
                            "device_blocks_gb_s": rate,
                            "device_blocks_to_ceiling": rate / ceiling,
                            "blocks_then_to_gb_s": fed_paged}
            print(f"feed {label} ({count} x {nbytes} bytes from a file): "
                  f"pinned copy_ loop {ceiling:.3f} GB/s (the ceiling), "
                  f"pageable .to {paged:.3f} GB/s, device_blocks "
                  f"{rate:.3f} GB/s = {rate / ceiling:.4f} of the ceiling; "
                  f"the same feeder's blocks() then .to {fed_paged:.3f} GB/s "
                  f"({smi})", flush=True)
            del pinned, dst, pageable
        out["feed"] = feeds

        # ---- (c) the main path on the 262,144-byte file --------------------
        path = os.path.join(tmp, "feed_read.u8")
        n_complex = INGEST_READS * CLI_READ // 2

        def run_streamer(on_device: bool, trace_dir: str | None = None):
            fd = FD.BlockFeeder(FD.FileSource(path), block_bytes=CLI_READ)
            fd.start()
            require(fd.is_native, "the file feeder is not native")
            streamer = FF.FusedWbfmStreamer(device=dev)
            blocks = fd.device_blocks(dev) if on_device else fd.blocks()
            with profiling.trace(trace_dir):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                audio = [streamer.demodulate(b) for b in blocks]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            fd.stop()
            require(fd.dropped == 0, "file replay dropped a block")
            return np.concatenate(audio), wall

        run_streamer(False)
        run_streamer(True)
        walls = {"pageable": [], "device": []}
        audio = {}
        for kind in ("pageable", "device", "device", "pageable") * 5:
            FF.reset_launch_counts()
            audio[kind], wall = run_streamer(kind == "device")
            walls[kind].append(wall)
            require(FF.LAUNCHES["fm_front"] == FF.LAUNCHES["fm_resample"]
                    == INGEST_READS, f"{kind} feed: launches {FF.LAUNCHES}")
        require(np.array_equal(audio["pageable"], audio["device"]),
                "device_blocks audio differs from blocks() audio")
        main = {}
        for kind in ("pageable", "device"):
            for attempt in range(1, TRACE_TRIES + 1):  # until one is whole
                tr_dir = os.path.join(tmp, f"main_{kind}_{attempt}")
                run_streamer(kind == "device", tr_dir)
                traces = glob.glob(os.path.join(tr_dir, "*.pt.trace.json"))
                require(len(traces) == 1, f"the trace wrote {traces}")
                main[kind] = trace_device(traces[0])
                if not main[kind]["lost"]:
                    break
            require(not main[kind]["lost"], f"{kind} feed: no whole trace "
                    f"in {TRACE_TRIES}: {main[kind]['lost']} calls lost "
                    f"{main[kind]['lost_names']}, "
                    f"{main[kind]['captures']} captures seen")
            main[kind]["attempts"] = attempt
            main[kind]["wall_s"] = statistics.median(walls[kind])
            main[kind]["walls_s"] = walls[kind]
            main[kind]["realtime_x"] = (n_complex / main[kind]["wall_s"]
                                        / REALTIME_SPS)
        dev_tr = main["device"]
        require(dev_tr["htod_copies"] >= INGEST_READS and dev_tr["kernel_streams"]
                and not set(dev_tr["htod_streams"]) & set(dev_tr["kernel_streams"]),
                f"device_blocks: HtoD copies on streams {dev_tr['htod_streams']}, "
                f"K1/K2 on {dev_tr['kernel_streams']}")
        out["main_path_file"] = main
        print(f"FusedWbfmStreamer on {INGEST_READS} reads of {CLI_READ} bytes "
              f"from a file: blocks() (pageable) {main['pageable']['realtime_x']:.2f}x"
              f" real time, busy {100 * main['pageable']['busy_share']:.2f}%; "
              f"device_blocks() {main['device']['realtime_x']:.2f}x, busy "
              f"{100 * main['device']['busy_share']:.2f}%; audio bit-equal; "
              f"{dev_tr['htod_copies']} HtoD copies on streams "
              f"{dev_tr['htod_streams']}, K1/K2 on {dev_tr['kernel_streams']} "
              f"({smi})", flush=True)

        # ---- (d) simple_fm --tcp --mode fused from the port's server --------
        station = fake.SynthFmSource(capture_rate=REALTIME_SPS,
                                     seconds=TCP_SECONDS)
        head = station._data[:TCP_BLOCKS * CLI_READ]
        require(len(head) == TCP_BLOCKS * CLI_READ, "station too short")
        file_path = os.path.join(tmp, "tcp_head.u8")
        with open(file_path, "wb") as f:
            f.write(head)
        pcm_file = run_app(["--file", file_path, "--mode", "fused"])

        class Paced(fake.SampleSource):
            """The station as a dongle delivers it: a block no sooner than
            its last sample was taken at 1.02 Msps."""

            def __init__(self, inner):
                self.inner, self.sent, self.t0 = inner, 0, None

            def read(self, length):
                if self.t0 is None:
                    self.t0 = time.monotonic()
                self.sent += length
                wait = self.t0 + self.sent / (2 * REALTIME_SPS) - time.monotonic()
                if wait > 0:
                    time.sleep(wait)
                return self.inner.read(length)

        # the feeder's ring on a socket
        srv, close = serve()
        fd = FD.BlockFeeder(FD.RtlTcpClientSource("127.0.0.1", srv.bound_port))
        fd.start()
        require(fd.is_native, "the rtl_tcp feeder is not native")
        fd.stop()
        close()

        pending, reads = 0, 0
        for _ in range(TCP_BLOCKS):  # reads that hold whole chunks
            pending += CLI_READ
            reads += pending >= spec.chunk_bytes
            pending %= spec.chunk_bytes
        tcp = {}
        for traced in (False,) + (True,) * TRACE_TRIES:
            if "traced" in tcp and not tcp["traced"]["lost"]:
                break  # a whole trace is in
            station._pos = 0
            srv, close = serve(lambda: Paced(station))
            argv = ["--tcp", f"127.0.0.1:{srv.bound_port}", "--mode", "fused",
                    "--blocks", str(TCP_BLOCKS)]
            trace_dir = os.path.join(
                tmp, f"tcp_trace_{tcp.get('traced', {}).get('attempts', 0)}")
            if traced:
                argv += ["--trace", trace_dir]
            rec.stats.clear()
            FF.reset_launch_counts()
            t0 = time.monotonic()
            pcm = run_app(argv)
            wall = time.monotonic() - t0
            launches = dict(FF.LAUNCHES)
            close()
            require(len(rec.stats) == 1, "simple_fm logged no block stats")
            st = rec.stats[0]
            require(st.dropped_blocks == 0, f"paced tcp: {st.dropped_blocks} "
                    "blocks dropped")
            require(launches == {"fm_front": reads, "fm_resample": reads},
                    f"paced tcp: launches {launches}, {reads} reads with "
                    "whole chunks")
            require(np.array_equal(pcm, pcm_file),
                    "simple_fm --tcp audio differs from --file audio")
            tone = synth.tone_snr(pcm.astype(np.float64), 1_000.0, 32_000,
                                  skip=1500)
            require(tone >= SNR_TCP_DB, f"paced tcp: tone {tone:.1f} dB")
            if traced:
                traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
                require(len(traces) == 1, f"--trace wrote {traces}")
                tr = trace_device(traces[0])
                require(tr["htod_copies"] >= TCP_BLOCKS and not
                        set(tr["htod_streams"]) & set(tr["kernel_streams"]),
                        f"tcp: HtoD on {tr['htod_streams']}, K1/K2 on "
                        f"{tr['kernel_streams']}")
                attempts = tcp.get("traced", {}).get("attempts", 0) + 1
                tcp["traced"] = {"wall_s": wall, "attempts": attempts, **tr}
                continue
            lat = sorted(st.latencies_ms)
            tcp.update({"blocks": st.blocks, "dropped": st.dropped_blocks,
                        "launches": launches, "tone_db": tone, "wall_s": wall,
                        "latency_ms_p50": statistics.median(lat),
                        "latency_ms_p99": lat[min(len(lat) - 1,
                                                  int(0.99 * len(lat)))],
                        "latency_ms_first": st.latencies_ms[0],
                        "latency_ms_max_after_first": max(st.latencies_ms[1:]),
                        "latency_ms": st.latencies_ms})
        require(not tcp["traced"]["lost"], f"tcp: no whole trace in "
                f"{TRACE_TRIES}: {tcp['traced']['lost']} calls lost "
                f"{tcp['traced']['lost_names']}, "
                f"{tcp['traced']['captures']} captures seen")
        print(f"simple_fm --tcp --mode fused, paced at {REALTIME_SPS} S/s, "
              f"{TCP_BLOCKS} reads: 0 dropped, launches {tcp['launches']}, tone "
              f"{tcp['tone_db']:.1f} dB, audio bit-equal to --file; read "
              f"latency (pop to audio written) median "
              f"{tcp['latency_ms_p50']:.3f} ms, p99 {tcp['latency_ms_p99']:.3f}"
              f" ms (the first read {tcp['latency_ms_first']:.3f} ms, the "
              f"others at most {tcp['latency_ms_max_after_first']:.3f} ms)"
              f"; wall {tcp['wall_s']:.3f} s; device busy "
              f"{100 * tcp['traced']['busy_share']:.3f}% (traced run, "
              f"{tcp['traced']['htod_copies']} HtoD copies on streams "
              f"{tcp['traced']['htod_streams']}, K1/K2 on "
              f"{tcp['traced']['kernel_streams']}) ({smi})", flush=True)

        # unpaced: the fake dongle as fast as it makes bytes (JAX's bench_ingest)
        station._pos = 0
        srv, close = serve(lambda: station, queue_limit=64)
        fd = FD.BlockFeeder(FD.RtlTcpClientSource("127.0.0.1", srv.bound_port),
                            block_bytes=CLI_READ, queue_blocks=16)
        fd.start()
        got = 0
        t0 = time.perf_counter()
        for blk in fd.device_blocks(dev):
            got += 1
            if got >= UNPACED_BLOCKS:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dropped = fd.dropped
        fd.stop()
        close()
        tcp["unpaced"] = {"blocks": got, "msps": got * CLI_READ / 2 / wall / 1e6,
                          "dropped": dropped, "wall_s": wall}
        out["tcp"] = tcp
        print(f"unpaced ingest (fake dongle -> server -> socket -> native "
              f"pump -> device_blocks): {got} blocks, "
              f"{tcp['unpaced']['msps']:.3f} complex Msps, {dropped} dropped "
              f"({smi})", flush=True)

        # ---- (e) the server itself ------------------------------------------
        srv, close = serve(lambda: fake.SynthFmSource(
            capture_rate=REALTIME_SPS, seconds=0.1))
        client = FD.RtlTcpClientSource("127.0.0.1", srv.bound_port)
        client.set_test_mode(True)  # opcode 0x07
        for _ in range(400):  # reads of the station until the counter starts
            if native.count_pattern_breaks(np.frombuffer(
                    client.read_block(COUNTER_READ), np.uint8))[0] == 0:
                break
        else:
            require(False, "counter test mode never started")
        breaks, last = 0, -1
        for _ in range(COUNTER_READS):
            b, last = native.count_pattern_breaks(np.frombuffer(
                client.read_block(COUNTER_READ), np.uint8), last)
            breaks += b
        client.close()
        close()
        require(breaks == 0, f"counter mode: {breaks} breaks over "
                f"{COUNTER_READS} blocks")

        srv, close = serve(testmode=True, max_clients=2, queue_limit=64)
        clients = [FD.RtlTcpClientSource("127.0.0.1", srv.bound_port)
                   for _ in range(2)]
        fan = [None, None]

        def drain(i):
            total, last = 0, -1
            for _ in range(FANOUT_BLOCKS):
                b, last = native.count_pattern_breaks(np.frombuffer(
                    clients[i].read_block(CLI_READ), np.uint8), last)
                total += b
            fan[i] = total

        threads = [threading.Thread(target=drain, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        with srv._sessions_lock:
            drops = [s.drops for s in srv._sessions]
        for c in clients:
            c.close()
        close()
        require(fan == [0, 0] and not any(drops),
                f"fan-out: breaks {fan}, drops {drops}")
        out["server"] = {"counter_blocks": COUNTER_READS,
                         "counter_block_bytes": COUNTER_READ,
                         "counter_breaks": breaks, "fanout_blocks": FANOUT_BLOCKS,
                         "fanout_breaks": fan, "fanout_drops": drops}
        print(f"rtl_tcp server: counter test mode (opcode 0x07) {COUNTER_READS} "
              f"blocks of {COUNTER_READ} bytes, 0 breaks (native "
              f"count_pattern_breaks); fan-out 2 clients x {FANOUT_BLOCKS} "
              f"blocks of {CLI_READ} bytes, each continuous, drops {drops}",
              flush=True)
    logging.getLogger("simple_fm").removeHandler(rec)
    return out


def _capture_spans(events) -> list:
    """The host intervals from each ``cudaStreamBeginCapture`` to the
    next ``cudaStreamEndCapture`` in ``events`` ((name, start, end)
    triples): a call made there is recorded into a graph, and puts no work
    on the device."""
    spans, begin = [], None
    for name, t0, t1 in sorted(events, key=lambda e: e[1]):
        if name.startswith(("cudaStreamBeginCapture", "cuStreamBeginCapture")):
            begin = t0
        elif begin is not None and name.startswith(
                ("cudaStreamEndCapture", "cuStreamEndCapture")):
            spans.append((begin, t1))
            begin = None
    return spans


def _in_spans(t, spans) -> bool:
    return any(a <= t <= b for a, b in spans)


def _is_call(name: str) -> bool:
    """A host runtime call that puts work on the device."""
    return "Launch" in name or name.startswith(
        ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset"))


def trace_reads(fn, reads, start=lambda: None) -> dict:
    """One ``torch.profiler`` trace of ``fn`` over ``reads`` (after the
    rounds that warmed it): device operations by kind, the device's busy
    time (the union of its intervals) over the host wall of the traced
    calls, the host's launch and copy calls by name, and the device's
    runs of each kernel of ``KERNEL_EVENTS`` by counter name.

    Only the host calls made inside the "traced reads" range count (but
    for those recorded into a graph while a stream captured), with the
    device records of their correlation.  A trace opens with
    ``TRACE_PAD_LAUNCHES`` small launches and a pause, outside that range:
    on the H100 a trace's first few device records (the first 0.6-2.2
    ms) came back missing, in a process that had traced before.  Then
    ``start()`` (the caller's marks) and the reads.  The trace must be
    whole, every counted host call with a device record; one that is not
    is taken again, up to ``TRACE_TRIES`` times, with a longer opening."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    pad = torch.zeros(1, device=torch.cuda.current_device())
    for attempt in range(1, TRACE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_PAD_LAUNCHES * attempt):
                pad.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.02 * attempt)
            start()
            with record_function("traced reads"):
                t0 = time.perf_counter()
                for r in reads:
                    fn(r)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        raw = prof.profiler.kineto_results.events()
        # the range on the host (kineto also draws it on the device)
        span = [e for e in raw if e.name() == "traced reads"
                and e.device_type() != DeviceType.CUDA]
        require(len(span) == 1, f"trace: {len(span)} 'traced reads' ranges")
        lo, hi = span[0].start_ns(), span[0].end_ns()
        captured = _capture_spans(
            (e.name(), e.start_ns(), e.end_ns()) for e in raw
            if e.device_type() != DeviceType.CUDA)
        calls = {e.correlation_id(): e.name() for e in raw
                 if e.device_type() != DeviceType.CUDA and _is_call(e.name())
                 and lo <= e.start_ns() <= hi
                 and not _in_spans(e.start_ns(), captured)}
        syncs: dict = {}
        for e in raw:
            if e.device_type() != DeviceType.CUDA and "Synchronize" in \
                    e.name() and lo <= e.start_ns() <= hi:
                syncs[e.name()] = syncs.get(e.name(), 0) + 1
        records = [e for e in raw if e.device_type() == DeviceType.CUDA
                   and e.correlation_id() in calls
                   and e.name() != "traced reads"]
        lost = set(calls) - {e.correlation_id() for e in records}
        if not lost:
            break
        print(f"trace: {len(lost)} of {len(calls)} host calls came back "
              f"without a device record (attempt {attempt}); tracing again",
              flush=True)
    require(not lost, f"trace: {len(lost)} of {len(calls)} host calls without "
            f"a device record in each of {TRACE_TRIES} traces")
    device, host, spans, device_us = {}, {}, [], {}
    kernels = dict.fromkeys(KERNEL_EVENTS, 0)
    dtoh = 0
    for e in records:
        name, low = e.name(), e.name().lower()
        kind = ("memcpy" if "memcpy" in low else "memset" if "memset" in low
                else "kernel")
        device[kind] = device.get(kind, 0) + 1
        dtoh += kind == "memcpy" and "dtoh" in low
        spans.append((e.start_ns() / 1e3, e.end_ns() / 1e3))
        device_us[name[:40]] = (device_us.get(name[:40], 0.0)
                                + (e.end_ns() - e.start_ns()) / 1e3)
        for counter, names in KERNEL_EVENTS.items():
            kernels[counter] += any(k in name for k in names)
    for name in calls.values():
        host[name] = host.get(name, 0) + 1
    busy, end = 0.0, -math.inf
    for t0, t1 in sorted(spans):
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    n = len(reads)
    launches = {k: v for k, v in host.items() if "Launch" in k}
    return {"reads": n, "device_ops_a_read": sum(device.values()) / n,
            "device": device, "busy_us": busy, "wall_us": wall_us,
            "busy_share": busy / wall_us,
            "host_launch_calls_a_read": sum(launches.values()) / n,
            "graph_launches": sum(v for k, v in launches.items()
                                  if "Graph" in k),
            "kernel_launches": sum(v for k, v in launches.items()
                                   if "Graph" not in k),
            "host": host, "kernels": kernels, "attempts": attempt,
            "device_us": device_us, "dtoh_copies": dtoh, "syncs": syncs,
            "span_us": (max(t1 for _, t1 in spans) - min(t0 for t0, _ in spans)
                        if spans else None)}


def same_outputs(a, b) -> bool:
    """Two reads' outputs (arrays, numbers and lists of RDS events) equal
    bit for bit."""
    import numpy as np

    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(same_outputs(x, y) for x, y in zip(a, b)))
    if isinstance(a, str):
        return a == b
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def graphs_phase(dev, u8_two, smi: str) -> dict:
    """Each graphed streamer (``utils.graphs``) at its CLI's read, through
    the CLIs' own per-read work (the streamer, the s16 conversion, the RDS
    decoders): the default (one CUDA graph replay a read after the first
    read of a key) against ``graphs.disabled()`` (eager) on the same
    reads.  Gates: every output of every read bit-equal; after warm-up
    each streamer's read one ``cudaGraphLaunch`` and no kernel launch (a
    profiler trace of each form); K1/K2/K3 counters equal to the eager
    run's and to the reads with a chunk, and over each form's trace to
    the runs of those kernels the trace saw on the device (a whole trace:
    every host launch and copy call in it with its device record).
    Printed: host ms a read and the
    real-time factor of each form (medians of GRAPH_ROUNDS interleaved
    rounds for the CLI paths, one round for the rest), device operations
    and host launch calls a read, the busy share and the peak memory."""
    import numpy as np
    import torch

    from tpu_sdr_torch.apps import rtl_fm
    from tpu_sdr_torch.models import rds as R
    from tpu_sdr_torch.models import wbfm as TW
    from tpu_sdr_torch.models import wbfm_batched as TB
    from tpu_sdr_torch.models import wbfm_exact as TE
    from tpu_sdr_torch.models import wbfm_stereo as TS
    from tpu_sdr_torch.models import wbfm_wideband as WB
    from tpu_sdr_torch.native import f32_to_s16
    from tpu_sdr_torch.ops import fused_channelizer as FC
    from tpu_sdr_torch.ops import fused_fm as FF
    from tpu_sdr_torch.ops import spectrum as SP
    from tpu_sdr_torch.utils import graphs, synth
    from tpu_sdr_torch.utils.design import WbfmConfig

    n = GRAPH_READS + GRAPH_WARM
    mono = u8_two[: n * CLI_READ]
    require(len(mono) == n * CLI_READ, "the mono capture is too short")
    # a stereo station with RDS, and 1.024 s of 8 stations (4 with RDS),
    # read cyclically
    rt = RDS_RT + "\r"
    rt += " " * (-len(rt) % 4)
    one = np.concatenate(
        [R.make_group_0a(RDS_PI, 9, k, RDS_PS[2 * k:2 * k + 2])
         for k in range(4)]
        + [R.make_group_2a(RDS_PI, 9, k, rt[4 * k:4 * k + 4])
           for k in range(len(rt) // 4)])
    t0 = time.monotonic()
    n_st = n * CLI_READ // 2
    n_bits = int(n_st / REALTIME_SPS * R.RDS_RATE) + 2
    stereo, _, _ = synth.synth_wbfm_stereo_u8(
        n_st, REALTIME_SPS, rds_bits=np.tile(one, n_bits // len(one) + 1)
        [:n_bits])
    config = WB.WidebandConfig(channels=WB_CHANNELS)
    K = config.num_channels
    n_wb = GRAPH_WB_READS * WB_READ_BYTES // 2
    n_bits = int(n_wb / config.capture_rate * R.RDS_RATE) + 2
    rds_bits = []
    for ch in WB_CHANNELS:
        if ch in WB_RDS:
            pi, ps = WB_RDS[ch]
            g = np.concatenate([R.make_group_0a(pi, 5, k, ps[2 * k:2 * k + 2])
                                for k in range(4)])
            rds_bits.append(np.tile(g, n_bits // len(g) + 1)[:n_bits])
        else:
            rds_bits.append(None)
    wide, _ = synth.synth_multistation_u8(
        n_wb, config.capture_rate,
        station_freqs=[(k if k <= K // 2 else k - K) * config.channel_rate
                       for k in WB_CHANNELS],
        audio_freqs=list(WB_TONES), deviation=60_000.0, rds_bits=rds_bits)
    print(f"graphs captures: stereo with RDS {n_st} complex, wideband "
          f"{n_wb} complex (RDS on {sorted(WB_RDS)}), made in "
          f"{time.monotonic() - t0:.1f} s", flush=True)

    def cut(data, size):
        return [data[i * size:(i + 1) * size] for i in range(n)]

    def cyclic(data, size, stations=1):
        """Reads of ``size`` bytes, station k offset by k/stations of the
        capture; the capture is read round and round."""
        span = len(data) // size * size
        reads = []
        for i in range(n):
            rows = [data[(i * size + k * span // stations // 2 * 2) % span:][
                :size] for k in range(stations)]
            rows = [r if len(r) == size else np.concatenate(
                [r, data[:size - len(r)]]) for r in rows]
            reads.append(rows[0] if stations == 1 else np.stack(rows))
        return reads

    mono_reads = cut(mono, CLI_READ)
    wide_reads = cyclic(wide, WB_READ_BYTES)

    def mono_path(streamer):
        def read(buf):
            a = streamer.demodulate(buf)
            f32_to_s16(a)
            return [a]
        return read, [streamer]

    def simple(mode, deemph=0.0):
        return mono_path(TW.WbfmStreamer(WbfmConfig(
            filter_mode=mode, deemphasis_tau=deemph * 1e-6), device=dev))

    def stereo_rds():
        s = TS.WbfmStereoStreamer(TS.StereoConfig(emit_mpx=True), device=dev)
        rx = R.RdsStreamDecoder(R.RdsConfig.for_mpx_rate(340_000), device=dev)

        def read(buf):
            a = s.demodulate(buf)
            events = rx.feed_mpx(s.last_mpx)
            f32_to_s16(a.T.reshape(-1))
            return [a, s.last_mpx, rx.rx.pilot_amp, events]
        return read, [s, rx.rx]

    def multi(rds, fused=True):
        s = WB.WidebandStreamer(WB.WidebandConfig(
            channels=WB_CHANNELS, emit_mpx=rds), use_fused=fused, device=dev)
        rxs = [R.RdsStreamDecoder(device=dev) for _ in WB_CHANNELS] if rds \
            else []

        def read(buf):
            a = s.demodulate(buf)
            for row in a:
                f32_to_s16(row)
            return [a] + [rx.feed_mpx(s.last_mpx[k])
                          for k, rx in enumerate(rxs)]
        return read, [s] + [rx.rx for rx in rxs]

    def narrow(mode, rds=False):
        s = rtl_fm.make_streamer(mode, dev, rds=rds)
        rx = R.RdsStreamDecoder(device=dev) if rds else None

        def read(buf):
            a = s.demodulate(buf)
            out = [a, getattr(s, "last_power", None) or 0.0]
            if rx is not None:
                out.append(rx.feed_mpx(s.last_mpx))
            f32_to_s16(a)
            return out
        return read, [s] + ([rx.rx] if rx else [])

    def fused_batch(mixed):
        """The batch at one phase (K1's compile-time body, the phase in the
        key) or at a phase a station (the run-time body, the phases read
        from the streamer's device tensor)."""
        s = FF.FusedWbfmBatchStreamer(GRAPH_BATCH_STATIONS, device=dev)
        if mixed:
            s.phases = [k % 4 for k in range(GRAPH_BATCH_STATIONS)]

        def read(buf):
            return [s.demodulate(buf)]
        return read, [s]

    def float_batch():
        s = TB.WbfmBatchStreamer(2, device=dev)

        def read(buf):
            return [s.demodulate(buf)]
        return read, [s]

    def exact():
        """``simple_fm --mode exact``'s read: its s16 audio goes out as it
        is."""
        s = TE.WbfmExactStreamer(device=dev)

        def read(buf):
            return [s.demodulate(buf)]
        return read, [s]

    def psd():
        """``rtl_power --file``'s read: the PSD's sums stay on the card,
        so a read returns its segment count, and each round ends with the
        one read-back of the bins (``finalize_db``), held bit-equal."""
        s = SP.PsdStreamer(PSD_FFT, device=dev)

        def read(buf):
            s.accumulate(buf)
            return [s.segments]
        return read, [s], s.finalize_db

    def pfb():
        s = FC.FusedPfbStreamer(K, config.taps_per_branch, PFB_FRAMES,
                                device=dev)

        def read(buf):
            return list(s.channelize(buf))
        return read, [s]

    # (name, make, reads, complex samples a read, capture rate, rounds)
    cli = [
        ("simple_fm --mode fused",
         lambda: mono_path(FF.FusedWbfmStreamer(device=dev)), mono_reads),
        ("simple_fm --mode fir", lambda: simple("fir"), mono_reads),
        ("simple_fm --mode boxcar", lambda: simple("boxcar"), mono_reads),
        ("simple_fm --mode fir --deemph 75", lambda: simple("fir", 75.0),
         mono_reads),
        ("simple_fm --mode stereo --rds", stereo_rds,
         cut(np.asarray(stereo, np.uint8), CLI_READ)),
        ("multi_fm --fused", lambda: multi(False), wide_reads),
        ("multi_fm --fused --rds", lambda: multi(True), wide_reads),
        ("rtl_fm -M fm", lambda: narrow("fm"), mono_reads),
        ("rtl_fm -M am", lambda: narrow("am"), mono_reads),
        ("simple_fm --mode exact", exact, mono_reads),
        ("rtl_power --file", psd, mono_reads),
        ("FusedPfbStreamer (K3 alone)", pfb, wide_reads),
    ]
    others = [
        ("rtl_fm -M usb", lambda: narrow("usb"), mono_reads),
        ("rtl_fm -M lsb", lambda: narrow("lsb"), mono_reads),
        ("rtl_fm -M wbfm --rds", lambda: narrow("wbfm", rds=True),
         mono_reads),
        ("multi_fm (plain front)", lambda: multi(False, fused=False),
         wide_reads),
        (f"FusedWbfmBatchStreamer x{GRAPH_BATCH_STATIONS}",
         lambda: fused_batch(False),
         cyclic(u8_two, CLI_READ, GRAPH_BATCH_STATIONS)),
        (f"FusedWbfmBatchStreamer x{GRAPH_BATCH_STATIONS} (a phase a "
         f"station)", lambda: fused_batch(True),
         cyclic(u8_two, CLI_READ, GRAPH_BATCH_STATIONS)),
        ("WbfmBatchStreamer x2", float_batch, cyclic(u8_two, CLI_READ, 2)),
    ]
    reset, counts = reset_launch_counts, launch_counts

    out = {}
    for rounds, table in ((GRAPH_ROUNDS, cli), (1, others)):
        for name, make, reads in table:
            is_wide = name.startswith(("multi_fm", "FusedPfbStreamer"))
            is_psd = name.startswith("rtl_power")
            rate = (config.capture_rate if is_wide else PSD_RATE if is_psd
                    else REALTIME_SPS)
            n_complex = reads[0].shape[-1] // 2
            warm, timed = reads[:GRAPH_WARM], reads[GRAPH_WARM:]
            with graphs.disabled():
                eager_fn, *rest = make()
                eager_final = rest[1] if len(rest) > 1 else None
                for r in warm:
                    eager_fn(r)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            graph_fn, streamers, *rest = make()
            graph_final = rest[0] if rest else None
            for r in warm:
                graph_fn(r)
            walls = {"eager": [], "graphed": []}
            launches = {}
            for k in range(rounds):
                got = {}
                for form in ("eager", "graphed") if k % 2 == 0 else (
                        "graphed", "eager"):
                    reset()
                    ctx = graphs.disabled() if form == "eager" else \
                        contextlib.nullcontext()
                    fn = eager_fn if form == "eager" else graph_fn
                    with ctx:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        got[form] = [fn(r) for r in timed]
                        torch.cuda.synchronize()
                        walls[form].append(time.perf_counter() - t0)
                        final = eager_final if form == "eager" else graph_final
                        if final is not None:  # the round's one read-back
                            got[form].append([final()])
                    launches[form] = counts()
                bad = [i for i, (a, b) in enumerate(zip(got["eager"],
                                                        got["graphed"]))
                       if not same_outputs(a, b)]
                require(not bad, f"graphs: {name} round {k}: reads {bad[:5]} "
                        f"differ from graphs.disabled()")
                require(launches["eager"] == launches["graphed"],
                        f"graphs: {name}: launches {launches}")
            peak = torch.cuda.max_memory_allocated(dev)
            with_chunk = sum(1 for g in got["graphed"][:len(timed)]
                             if np.ndim(g[0]) and np.shape(g[0])[-1])
            lg = launches["graphed"]
            if "fused" in name and not is_wide:
                require(lg["fm_front"] == lg["fm_resample"] == with_chunk,
                        f"graphs: {name}: K1/K2 {lg}, {with_chunk} reads "
                        f"with a chunk")
            if is_wide and "plain" not in name:
                require(lg["pfb_channelize"] == with_chunk,
                        f"graphs: {name}: K3 {lg}, {with_chunk} reads")
            require(not any(lg.get(k) for k in ("halo_pull", "ring_shift")),
                    f"graphs: {name}: halo kernels launched: {lg}")
            # one trace of each form over reads after the rounds
            tr_reads = timed[:GRAPH_TRACE_READS]
            before = []

            def start():
                """Counters to 0 and the streamers' counts, as the traced
                reads begin."""
                reset()
                before[:] = [(s.graphs.captures, s.graphs.replays)
                             for s in streamers]

            trace = {"graphed": trace_reads(graph_fn, tr_reads, start)}
            gained = {"graphed": counts()}
            caps = sum(s.graphs.captures - b[0]
                       for s, b in zip(streamers, before))
            reps = sum(s.graphs.replays - b[1]
                       for s, b in zip(streamers, before))
            with graphs.disabled():
                trace["eager"] = trace_reads(eager_fn, tr_reads, reset)
                gained["eager"] = counts()
            # the counters' launches are the kernels the device ran: inside
            # the replayed graphs as well as eagerly
            for form, seen in ((f, trace[f]["kernels"]) for f in trace):
                require(all(seen[k] == counted(gained[form], k)
                            for k in KERNEL_EVENTS),
                        f"graphs: {name} {form}: the trace saw kernels "
                        f"{seen}, the counters gained {gained[form]}")
            tg = trace["graphed"]
            require(tg["graph_launches"] == reps,
                    f"graphs: {name}: {tg['graph_launches']} graph launches "
                    f"for {reps} replays")
            if caps == 0:
                require(tg["kernel_launches"] == 0 and reps == len(tr_reads)
                        * len(streamers),
                        f"graphs: {name}: {tg['host']} over "
                        f"{len(tr_reads)} reads after warm-up, {reps} replays")
            if is_psd:
                # the form without outputs copies nothing back and waits
                # for no stream: the one device synchronize closes the
                # range, an event wait fences the staging buffer
                waits = {k: v for k, v in tg["syncs"].items()
                         if "Event" not in k}
                require(tg["dtoh_copies"] == 0
                        and waits == {"cudaDeviceSynchronize": 1},
                        f"graphs: {name}: {tg['dtoh_copies']} D2H copies, "
                        f"synchronizes {tg['syncs']} over the traced reads")
            keys = [len(s.graphs.keys) for s in streamers]
            res = {"reads_a_round": len(timed), "rounds": rounds,
                   "read_bytes": int(reads[0].shape[-1]),
                   "peak_mib": peak / 2 ** 20, "keys": keys,
                   "captures": [s.graphs.captures for s in streamers],
                   "trace_captures": caps, "launches": lg,
                   "trace_kernels": trace["graphed"]["kernels"],
                   "trace_attempts": {f: trace[f]["attempts"] for f in trace}}
            for form in ("eager", "graphed"):
                wall = statistics.median(walls[form])
                res[form] = {
                    "host_ms_a_read": wall / len(timed) * 1e3,
                    "walls_s": walls[form],
                    "realtime_x": n_complex * len(timed) / wall / rate,
                    **{k: trace[form][k] for k in (
                        "device_ops_a_read", "host_launch_calls_a_read",
                        "busy_share", "busy_us", "wall_us", "host",
                        "dtoh_copies", "syncs")}}
            out[name] = res
            e, g = res["eager"], res["graphed"]
            print(f"graphs {name}: {len(timed)} reads of "
                  f"{res['read_bytes']} B x {rounds} round(s), bit-equal to "
                  f"graphs.disabled(); host ms a read eager "
                  f"{e['host_ms_a_read']:.4f} / graphed "
                  f"{g['host_ms_a_read']:.4f}; real time {e['realtime_x']:.2f}x"
                  f" / {g['realtime_x']:.2f}x; device ops a read "
                  f"{e['device_ops_a_read']:.1f} / {g['device_ops_a_read']:.1f}"
                  f"; host launch calls a read "
                  f"{e['host_launch_calls_a_read']:.1f} / "
                  f"{g['host_launch_calls_a_read']:.1f} ({g['host']}); busy "
                  f"{100 * e['busy_share']:.2f}% / {100 * g['busy_share']:.2f}"
                  f"%; keys {keys}, launches {lg} (kernels seen in the "
                  f"graphed trace {res['trace_kernels']}; traces taken "
                  f"{res['trace_attempts']}), peak "
                  f"{res['peak_mib']:.1f} "
                  f"MiB ({smi})", flush=True)
            del eager_fn, graph_fn, streamers, eager_final, graph_final
    out["rtl_power scan"] = psd_scan(dev, smi)
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description="Smoke test of the port on one "
                                "NVIDIA GPU.")
    p.add_argument("--baseline-csrc", metavar="DIR",
                   help="an A/B measurement only, never needed for the smoke "
                        "test itself: also build the kernel sources in DIR "
                        "(another commit's tpu_sdr_torch/csrc) and time its "
                        "K1 and K2 beside these, in the same rounds (printed "
                        "as 'time fm_front_parent' / 'fm_resample_parent' "
                        "and in the metrics line)")
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import numpy as np

    from tpu_sdr_torch import kernels
    from tpu_sdr_torch.ops import fused_fm as FF
    from tpu_sdr_torch.utils import synth

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
    from tpu_sdr_torch import native

    t0 = time.monotonic()
    require(native.available(), "the native runtime (g++) did not build")
    print(f"native runtime: {native.library_path()} built by g++ in "
          f"{native.build_seconds:.2f} s (load {time.monotonic() - t0:.2f} s)",
          flush=True)

    # A plain version used as an oracle computes in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    spec = FF.default_spec()
    taps, h_poly = FF.make_kernel_params(device=dev)
    require(BLOCK_COMPLEX % spec.chunk_complex == 0, "block is not whole chunks")

    # two consecutive blocks of one station (the sharded path streams
    # both); the first is the single-station block, byte for byte the
    # capture of BLOCK_COMPLEX samples
    u8_two, _ = synth.synth_wbfm_u8(SHARD_BLOCKS * BLOCK_COMPLEX,
                                    capture_rate=REALTIME_SPS)
    u8_two = np.ascontiguousarray(u8_two, dtype=np.uint8)
    u8 = u8_two[:2 * BLOCK_COMPLEX]
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

    # one ragged size of each: outputs not a whole number of rows, warp
    # tiles or stages; frames not a whole number of tiles
    m_rag, frames_rag = 40_003, 1_237
    block = data[:2 * spec.decim * m_rag]
    z_k, c_k = FF.fm_front(block, 2, carry, taps, spec.decim)
    z_g, c_g = FF.fm_front_reference(block, 2, carry, taps, spec.decim)
    a_k, h_k = FF.resample(z_r[:frames_rag * spec.down], hist, h_poly,
                           spec.down)
    a_g, h_g = FF.resample_reference(z_r[:frames_rag * spec.down], hist,
                                     h_poly, spec.down)
    torch.cuda.synchronize()
    s_front_rag = snr_db(z_g.cpu().numpy(), z_k.cpu().numpy())
    s_rs_rag = snr_db(a_g.cpu().numpy(), a_k.cpu().numpy())
    require(s_front_rag >= SNR_KERNEL_DB and s_rs_rag >= SNR_KERNEL_DB,
            f"ragged: fm_front {s_front_rag:.1f} dB, fm_resample "
            f"{s_rs_rag:.1f} dB")
    require(float((c_k - c_g).abs().max()) <= 1e-3, "ragged fm_front carry")
    require(torch.equal(h_k, h_g), "ragged fm_resample: history differs")
    err_front = max(err_front, float((z_k - z_g).abs().max()))
    err_resample = max(err_resample, float((a_k - a_g).abs().max()))
    print(f"ragged: fm_front at {m_rag} outputs {s_front_rag:.1f} dB, "
          f"fm_resample at {frames_rag} frames {s_rs_rag:.1f} dB vs plain, "
          f"carry and history held", flush=True)

    # K2's library yardstick: one strided convolution of xe = [history |
    # z] with the (up, 1, 127) bank (row s: h[p_s] reversed at o_s); it
    # gives (up, frames), the frame-major transpose is left outside
    up, T = h_poly.shape
    o_s = [s * spec.down // up for s in range(up)]
    w_rs = torch.zeros(up, 1, max(o_s) + T, device=dev)
    for s in range(up):
        w_rs[s, 0, o_s[s]:o_s[s] + T] = h_poly[s * spec.down % up].flip(0)
    xe = torch.cat([hist, z_r])[None, None].contiguous()

    def resample_library():
        return torch.nn.functional.conv1d(xe, w_rs, stride=spec.down)

    s_rs_lib = snr_db(a_r.cpu().numpy(),
                      resample_library()[0].T.reshape(-1).cpu().numpy())
    print(f"fm_resample library yardstick (conv1d, stride {spec.down}): "
          f"{s_rs_lib:.1f} dB vs the plain version", flush=True)

    # the parent commit's kernels, built from its sources, for the A/B
    parent = {}
    if args.baseline_csrc:
        path, _, _ = kernels.build(args.baseline_csrc, os.path.join(
            kernels.BUILD_DIR, "baseline"))
        # the other sources' one-station entry points, declared as ours
        # (their library may lack the rest of ours)
        plib = ctypes.CDLL(path)
        for name in ("tsdr_fm_front", "tsdr_fm_resample"):
            ours = getattr(kernels.load().cdll, name)
            getattr(plib, name).argtypes = ours.argtypes
            getattr(plib, name).restype = ours.restype
        z_p = torch.empty(BLOCK_COMPLEX // spec.decim, device=dev)
        c_p, a_p = torch.empty_like(carry), torch.empty_like(a_r)
        h_p = torch.empty_like(hist)

        def stream():
            return torch.cuda.current_stream().cuda_stream

        def parent_front():
            kernels.check(plib.tsdr_fm_front(
                data.data_ptr(), BLOCK_COMPLEX, 1, carry.data_ptr(),
                taps.data_ptr(), taps.numel(), spec.decim, z_p.data_ptr(),
                c_p.data_ptr(), stream()), "baseline fm_front")

        def parent_resample():
            kernels.check(plib.tsdr_fm_resample(
                z_r.data_ptr(), z_r.numel(), hist.data_ptr(),
                h_poly.data_ptr(), up, spec.down, T, a_p.data_ptr(),
                h_p.data_ptr(), stream()), "baseline fm_resample")

        parent_front()
        parent_resample()
        z_1, _ = FF.fm_front_reference(data, 1, carry, taps, spec.decim)
        s_pf = snr_db(z_1.cpu().numpy(), z_p.cpu().numpy())
        s_pr = snr_db(a_r.cpu().numpy(), a_p.cpu().numpy())
        require(min(s_pf, s_pr) >= SNR_KERNEL_DB, "baseline kernels disagree")
        print(f"baseline kernels from {args.baseline_csrc}: fm_front "
              f"{s_pf:.1f} dB, fm_resample {s_pr:.1f} dB vs plain", flush=True)
        parent = {"fm_front_parent": parent_front,
                  "fm_resample_parent": parent_resample}
        del z_1

    # ---- path phase: the user entry point on a 10.24 s station --------
    n_path = PATH_CHUNKS * spec.chunk_complex
    with tempfile.TemporaryDirectory() as tmp:
        # set-up the CLI pays once a process: one chunk through it first
        path = os.path.join(tmp, "station.u8")
        u8[: spec.chunk_bytes].tofile(path)
        t0 = time.monotonic()
        run_app(["--file", path, "--mode", "fused"])
        print(f"CLI set-up (one chunk): {time.monotonic() - t0:.3f} s",
              flush=True)
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

    # ---- the exact chain and the float chain's modes ----------------------
    md = modes(dev, u8, spec)

    # ---- the receivers: stereo + RDS, rtl_fm, multi_fm --rds, rtl_power,
    # checkpoint, trace ------------------------------------------------------
    rx = receivers(dev, spec, smi)

    # ---- the host-to-device feed and the network path -----------------------
    ig = ingest(dev, u8, spec, smi)

    # ---- the graphed steps: each streamer's read one CUDA graph replay --------
    gr = graphs_phase(dev, u8_two, smi)

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
        "fm_resample_library": resample_library,
        "fused_path_device": lambda: FF.demodulate_fused(
            data, 1, carry, hist, taps, h_poly, spec),
        **parent,
    }, flush=flush_buf.zero_)
    streamer = FF.FusedWbfmStreamer(device=dev)
    ms["streamer_block"] = host_ms(lambda: streamer.demodulate(u8))
    parent_ratio = {}
    for name in ("fm_front", "fm_resample") if parent else ():
        parent_ratio[name] = ms[name] / ms[f"{name}_parent"]
        print(f"one station: {name} {ms[name]:.4f} ms, the parent's sources "
              f"{ms[f'{name}_parent']:.4f} ms, ratio "
              f"{parent_ratio[name]:.4f} ({smi})", flush=True)

    # ---- the station batch: K1 and K2 over 8 stations ---------------------
    bt = batch(dev, flush_buf.zero_, data, taps, h_poly, spec)
    ms.update(bt["ms"])

    # the bounds of K1 and K2 on the block: K1 reads 2 bytes a sample and
    # writes z, and its operations are the FIR's (re and im, an FMA a tap)
    # with the discriminator's complex product and ~16 of the atan; K2
    # reads z and writes the audio, 2 FLOP a tap of an output
    M = BLOCK_COMPLEX // spec.decim
    L, frames = taps.numel(), M // spec.down
    work = {  # (bytes, operations) of one station's block
        "fm_front": (2 * BLOCK_COMPLEX + 4 * M + 2 * 4 * carry.numel()
                     + 4 * L, M * (2 * 2 * L + 6 + 16)),
        "fm_resample": (4 * M + 4 * frames * up + 2 * 4 * (T - 1)
                        + 4 * up * T, 2 * up * T * frames),
    }
    bounds = {name: bound(*w) for name, w in work.items()}

    # the batch's bounds: 8 stations' work, 8 times one station's
    for name, (nbytes, ops) in work.items():
        bounds_batch = bound(BATCH_STATIONS * nbytes, BATCH_STATIONS * ops)
        bt[f"bound_{name}"] = bounds_batch
        t_b, t_s = ms[f"{name}_batch8"], ms[f"{name}_single8"]
        print(f"batch {name}: {BATCH_STATIONS} stations in one launch "
              f"{t_b:.4f} ms, {BATCH_STATIONS} one-station launches "
              f"{t_s:.4f} ms (ratio {t_b / t_s:.4f}), bound "
              f"{bounds_batch['bound_ms']:.6f} ms ({bounds_batch['bound_by']})"
              f" = {100 * bounds_batch['bound_ms'] / t_b:.2f}% of the batch "
              f"({smi})", flush=True)

    # ---- the wideband path: K3 and multi_fm --fused ---------------------
    wb = wideband(dev, flush_buf.zero_, smi)
    ms.update(wb["ms"])
    bounds["pfb_channelize"] = wb["bound"]

    # ---- the sharded paths: K4, K5, ShardedFusedStreamer, channelizer ----
    sh = sharded(dev, flush_buf.zero_, u8_two, smi)
    ms.update(sh["ms"])
    bounds.update(sh["bounds"])
    for name, t in ms.items():
        blocks = BATCH_STATIONS if name.endswith("8") else 1
        rate = ("" if name.startswith(("halo_pull", "ring_shift", "shard_halo"))
                or name.endswith("_read") else
                f" = {blocks * BLOCK_COMPLEX / t / 1e3:.1f} Msps")
        print(f"time {name}: {t:.4f} ms{rate} ({smi})", flush=True)
    print(f"halo cost (the sp={SHARD_SP} step's one K4 exchange): "
          f"{sh['halo_us']:.2f} us (the previous form's two exchanges: "
          f"{sh['halo_us_two_exchanges']:.2f} us); sharded sp={SHARD_SP} / "
          f"unsharded step: eager {sh['sharded_overhead_ratio']:.4f}, graph "
          f"replay {sh['sharded_graph_ratio']:.4f} ({smi})", flush=True)
    # each kernel's row is timed at its main path's shapes: K4 at the
    # sp=4 step's one exchange of records
    timed = {name: name for name in bounds} | {"halo_pull": "halo_pull_step"}
    library = {"fm_front": None, "fm_resample": "fm_resample_library",
               "pfb_channelize": "pfb_channelize_library",
               "halo_pull": "halo_pull_step_library",
               "ring_shift": "ring_shift_library", "shard_halo": None}
    for name, b in bounds.items():
        lib_ms = ms[library[name]] if library[name] else None
        t = ms[timed[name]]
        print(f"bound {name}: {b['bound_ms']:.6f} ms ({b['bound_by']}, "
              f"{b['peak']}), kernel {t:.4f} ms = "
              f"{100 * b['bound_ms'] / t:.2f}% of it, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} ({smi})",
              flush=True)
    print("metrics " + json.dumps({
        "card": smi, "block_complex": BLOCK_COMPLEX, "reps": REPS, "ms": ms,
        "bounds": bounds, "bound_pfb_channelize_read": wb["bound_read"],
        "snr_fm_front_db": snrs, "snr_fm_resample_db": s_rs,
        "snr_ragged_db": {"fm_front": s_front_rag, "fm_resample": s_rs_rag},
        "snr_library_db": {"fm_resample": s_rs_lib,
                           "pfb_channelize": wb["library_snr_db"]},
        "path": {"complex": n_path, "tone_db": tone, "vs_fir_db": s_fir,
                 "wall_s": app_s, "realtime_x": n_path / app_s / REALTIME_SPS},
        "snr_pfb_channelize_db": wb["snr_db"], "wideband_path": wb["path"],
        "sharded_path": sh["path"], "peer_path": sh["peer"],
        "sharded_graphs": {"float_chain": sh["float_graphs"],
                           "bank": wb["bank_graphs"],
                           "channelizer": sh["chan"]["graphs"]},
        "channelizer_path": {k: v for k, v in sh["chan"].items()
                             if k not in ("ms", "graphs")},
        "shard_halo": sh["records"], "sharded_step_host_ms": sh["host_ms"],
        "sharded_step_ops": sh["ops"], "halo_us": sh["halo_us"],
        "halo_us_two_exchanges": sh["halo_us_two_exchanges"],
        "sharded_overhead_ratio": sh["sharded_overhead_ratio"],
        "sharded_graph_ratio": sh["sharded_graph_ratio"],
        "batch": {k: v for k, v in bt.items() if k != "ms"},
        "parent_ratio": parent_ratio,
        "modes": md,
        "receivers": rx,
        "ingest": ig,
        "graphs": gr,
    }), flush=True)

    # the A/B gate, held after every other phase has run
    for name, ratio in parent_ratio.items():
        require(ratio <= PARENT_SLACK, f"{name} at one station is "
                f"{ratio:.4f} of the parent's time")

    def line(name, source, replaces, count, err):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": count, "max_abs_err": err,
                "ms": ms[timed[name]], "plain_ms": ms[f"{timed[name]}_plain"],
                "bound_ms": bounds[name]["bound_ms"],
                "bound_by": bounds[name]["bound_by"],
                "peak": bounds[name]["peak"],
                "library_ms": ms[library[name]] if library[name] else None}

    # the helper is no TPU kernel: a line of its own
    print(json.dumps({"helper": line(
        "shard_halo", "tpu_sdr_torch/csrc/shard_halo.cu",
        "tpu_sdr/parallel/wbfm_sharded_pallas.py:137 (XLA code, no kernel)",
        sh["helper_launches"], sh["records"]["err"])}), flush=True)
    rows = [
        ("fm_front", "tpu_sdr_torch/csrc/fm_front.cu",
         "tpu_sdr/ops/pallas_fm.py:177", launches["fm_front"], err_front),
        ("fm_resample", "tpu_sdr_torch/csrc/fm_resample.cu",
         "tpu_sdr/ops/pallas_fm.py:760", launches["fm_resample"],
         err_resample),
        ("pfb_channelize", "tpu_sdr_torch/csrc/pfb_channelize.cu",
         "tpu_sdr/ops/pallas_channelizer.py:92", wb["launches"], wb["err"]),
        ("halo_pull", "tpu_sdr_torch/csrc/halo.cu",
         "tpu_sdr/parallel/pallas_halo.py:42",
         sh["path"]["launches"]["halo_pull"], sh["err"]),
        ("ring_shift", "tpu_sdr_torch/csrc/halo.cu",
         "tpu_sdr/parallel/pallas_halo.py:145",
         sh["chan"]["launches"]["ring_shift"], sh["err"]),
    ]
    print(json.dumps({"kernels": [line(*r) for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
