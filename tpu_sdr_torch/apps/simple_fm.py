"""simple_fm on PyTorch/CUDA — WBFM receiver emitting raw s16 mono audio on
stdout, the port of ``tpu_sdr.apps.simple_fm``.

Reads a raw u8 I/Q capture (``--file``), a remote rtl_tcp server
(``--tcp``) or a local dongle, through the port's own host layer (the
file loop and demod loop below, ``stream.feeder``, the device control
plane ``api``), and demodulates on a CUDA device:

  exact  the bit-exact integer chain (the conformance path), its s16
         audio written as it is
  boxcar the float twin of the reference's boxcar filters (>= 60 dB
         against exact)
  fir    the float32 chain in plain PyTorch (default, as in the JAX CLI)
  fused  the two hand-written CUDA kernels (fm_front -> fm_resample);
         ``--mode pallas``, the JAX CLI's name for its kernel chain, is
         the same mode
  stereo the pilot-tone stereo decoder on a 340 kHz front end ->
         interleaved L/R s16 (play with -c 2)

``--deemph US`` adds de-emphasis to the fir, boxcar and stereo chains.
``--rds`` (stereo mode) also decodes the Radio Data System from the same
multiplex and prints PI/PS/RadioText lines to stderr.  ``--trace DIR``
writes a ``torch.profiler`` trace of the run into DIR.

The GPU is required: without one the CLI raises, unless ``--torch-device
cpu`` asks for the plain PyTorch versions on the CPU.

Play with:  python -m tpu_sdr_torch.apps.simple_fm | play -r 32k -t raw -e s -b 16 -c 1 -V1 -
"""

from __future__ import annotations

import argparse
import logging
import sys
import threading

import numpy as np

from tpu_sdr_torch import DEFAULT_BUF_LENGTH

log = logging.getLogger("simple_fm")

FREQUENCY = 94_900_000  # Hz (ref simple_fm.rs:25)
SAMPLE_RATE = 170_000  # demod rate (ref simple_fm.rs:26)

MODES = ("exact", "boxcar", "fir", "fused", "stereo")
MODE_ALIASES = {"pallas": "fused"}  # the JAX CLI's spellings
DEEMPH_MODES = ("fir", "boxcar", "stereo")


def make_demodulator(mode: str, device, deemph_us: float = 0.0,
                     rds: bool = False):
    """Return (demod_fn(u8 block) -> np s16 audio, description)."""
    import torch

    from tpu_sdr_torch.native import f32_to_s16

    if mode == "stereo":
        return _stereo_demodulator(device, deemph_us, rds)
    if mode == "exact":
        from tpu_sdr_torch.models.wbfm_exact import WbfmExactStreamer

        streamer = WbfmExactStreamer(device=device)
        desc = "exact integer chain"
    elif mode == "fused":
        from tpu_sdr_torch.ops.fused_fm import FusedWbfmStreamer

        streamer = FusedWbfmStreamer(device=device)
        desc = "fused chain (fm_front + fm_resample kernels)"
    elif mode in DEEMPH_MODES:
        from tpu_sdr_torch.models.wbfm import WbfmStreamer
        from tpu_sdr_torch.utils.design import WbfmConfig

        streamer = WbfmStreamer(WbfmConfig(filter_mode=mode,
                                           deemphasis_tau=deemph_us * 1e-6),
                                device=device)
        desc = f"float chain ({mode})"
        if deemph_us:
            desc += f", {deemph_us:.0f}us de-emphasis"
    else:
        raise ValueError(f"mode {mode!r} is not ported yet")
    if device.type == "cuda":
        desc += f" on {torch.cuda.get_device_name(device)}"
    if mode == "exact":  # its s16 audio goes out as it is
        return streamer.demodulate, f"{desc}, {device}"

    def demod(buf):
        return f32_to_s16(streamer.demodulate(buf))

    return demod, f"{desc}, {device}"


def _stereo_demodulator(device, deemph_us: float, rds: bool):
    import torch

    from tpu_sdr_torch.models import rds as rds_mod
    from tpu_sdr_torch.models.wbfm_stereo import (StereoConfig,
                                                  WbfmStereoStreamer)
    from tpu_sdr_torch.native import f32_to_s16

    config = StereoConfig(emit_mpx=rds, deemphasis_tau=deemph_us * 1e-6)
    streamer = WbfmStereoStreamer(config, device=device)
    # the stereo front is wideband (a 340 kHz multiplex): the RDS
    # decoder's filters are designed for that rate
    rds_rx = (rds_mod.RdsStreamDecoder(
        rds_mod.RdsConfig.for_mpx_rate(config.base.rate_out), device=device)
        if rds else None)

    def demod(buf):
        audio = streamer.demodulate(buf)  # (2, m)
        if rds_rx is not None:
            for event in rds_rx.feed_mpx(streamer.last_mpx):
                print(f"[rds] {event}", file=sys.stderr, flush=True)
        return f32_to_s16(audio.T.reshape(-1))  # interleaved L/R s16

    desc = "stereo multiplex decoder (pilot-tone)" + (" + RDS" if rds else "")
    if deemph_us:
        desc += f", {deemph_us:.0f}us de-emphasis"
    if device.type == "cuda":
        desc += f" on {torch.cuda.get_device_name(device)}"
    return demod, f"{desc}, {device}"


def output(buf: np.ndarray) -> None:
    """Raw s16-LE to stdout (ref simple_fm.rs:430-438)."""
    sys.stdout.buffer.write(np.asarray(buf, dtype="<i2").tobytes())
    sys.stdout.buffer.flush()


def process_loop(demod, feeder, shutdown: threading.Event,
                 max_blocks: int = 0, device=None):
    """Demod loop with running-average timing (ref process,
    simple_fm.rs:135-170).  The receive side is the feeder's reader thread
    or native pump (the reference's receive thread, simple_fm.rs:89-132).
    With a CUDA ``device`` the blocks come through the feeder's pinned
    double buffer (``device_blocks``), else as numpy arrays.  Each block's
    latency, from the feeder's pop to its audio written, goes into the
    stats; the final log record carries them as ``block_stats``."""
    from tpu_sdr_torch.utils.profiling import BlockStats

    stats = BlockStats()
    blocks = (feeder.device_blocks(device) if device is not None
              else feeder.blocks())
    for data in blocks:
        if shutdown.is_set():
            break
        with stats.block(len(data) // 2):
            audio = demod(data)
        output(audio)
        stats.latency(feeder.popped_at)
        if max_blocks and stats.blocks >= max_blocks:
            break
    stats.drop(feeder.dropped)
    if stats.blocks:
        log.info("Average processing time: %.2fms (%d loops); %s",
                 stats.avg_block_ms, stats.blocks, stats.summary(),
                 extra={"block_stats": stats})


def run_file(path: str, demod) -> None:
    """File mode (ref simple_fm.rs:65-84)."""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(DEFAULT_BUF_LENGTH)
            if len(chunk) < 16:
                break
            usable = len(chunk) - (len(chunk) % 16)
            audio = demod(np.frombuffer(chunk[:usable], dtype=np.uint8))
            output(audio)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--freq", type=int, default=FREQUENCY)
    p.add_argument("--file", help="read raw u8 I/Q from file instead of a device")
    p.add_argument("--tcp", metavar="HOST:PORT",
                   help="stream from a remote rtl_tcp server instead of a "
                        "local device (tunes it to --freq)")
    p.add_argument("--device", type=int, default=0, help="dongle index")
    p.add_argument("--mode", choices=(*MODES, *MODE_ALIASES), default="fir",
                   help="exact (integer), boxcar, fir (plain PyTorch), "
                        "fused (the CUDA kernels) or stereo; pallas is the "
                        "JAX CLI's name for fused")
    p.add_argument("--torch-device", default="cuda",
                   help="where to demodulate: cuda (default; raises without "
                        "a GPU), cuda:N, or cpu for the plain PyTorch versions")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace to DIR")
    p.add_argument("--deemph", type=float, default=0.0, metavar="US",
                   help="de-emphasis time constant in microseconds (75 US / "
                        "50 EU; fir, boxcar and stereo modes)")
    p.add_argument("--rds", action="store_true",
                   help="decode RDS alongside the audio (stereo mode); "
                        "PI/PS/RadioText lines go to stderr")
    p.add_argument("--blocks", type=int, default=0,
                   help="stop after N blocks (device/tcp modes; 0 = run "
                        "until interrupted)")
    args = p.parse_args(argv)
    args.mode = MODE_ALIASES.get(args.mode, args.mode)
    if args.rds and args.mode != "stereo":
        p.error("--rds requires --mode stereo here (for mono use "
                "rtl_fm --rds)")
    if args.deemph and args.mode not in DEEMPH_MODES:
        p.error(f"--deemph applies to --mode {', '.join(DEEMPH_MODES)}")

    from tpu_sdr_torch.device import resolve_device
    from tpu_sdr_torch.utils.design import optimal_settings
    from tpu_sdr_torch.utils.profiling import trace

    device = resolve_device(args.torch_device)
    radio, _demod_cfg = optimal_settings(args.freq, SAMPLE_RATE)
    demod, desc = make_demodulator(args.mode, device, args.deemph,
                                   rds=args.rds)
    log.info("Demodulating with %s", desc)

    if args.file:
        with trace(args.trace):
            run_file(args.file, demod)
        return 0

    from tpu_sdr_torch.stream.feeder import BlockFeeder

    if args.tcp:
        from tpu_sdr_torch.stream.feeder import RtlTcpClientSource

        host, _, port = args.tcp.rpartition(":")
        src = RtlTcpClientSource(host or "127.0.0.1", int(port))
        src.set_sample_rate(radio.capture_rate)
        src.set_frequency(radio.capture_freq)
        src.set_gain_mode(False)
        log.info("Streaming from rtl_tcp://%s, tuned to %d Hz at %d S/s",
                 args.tcp, radio.capture_freq, radio.capture_rate)
    else:
        from tpu_sdr_torch.api import DeviceId, RtlSdr, TunerGain
        from tpu_sdr_torch.stream.feeder import DeviceSource

        sdr = RtlSdr.open(DeviceId.index(args.device))
        sdr.set_tuner_gain(TunerGain.AUTO)
        sdr.set_bias_tee(False)
        sdr.reset_buffer()
        sdr.set_center_freq(radio.capture_freq)
        sdr.set_sample_rate(radio.capture_rate)
        log.info("Tuned to %d Hz, sampling at %d S/s",
                 sdr.get_center_freq(), sdr.get_sample_rate())
        src = DeviceSource(sdr)

    shutdown = threading.Event()
    feeder = BlockFeeder(src, block_bytes=DEFAULT_BUF_LENGTH,
                         queue_blocks=16).start()
    # the kernels' chain takes its blocks on the card, through the
    # feeder's pinned double buffer
    feed_device = (device if args.mode == "fused" and device.type == "cuda"
                   else None)
    try:
        with trace(args.trace):
            process_loop(demod, feeder, shutdown, args.blocks, feed_device)
    except KeyboardInterrupt:
        shutdown.set()
    finally:
        feeder.stop()  # also closes the device
    return 0


if __name__ == "__main__":
    sys.exit(main())
