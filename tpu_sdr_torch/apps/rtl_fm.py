"""rtl_fm on PyTorch/CUDA — the multi-mode narrowband receiver CLI, the
port of ``tpu_sdr.apps.rtl_fm`` (the original C ``rtl_fm``'s surface):

    -M wbfm   broadcast FM (the float chain of simple_fm)
    -M fm     narrow FM (12.5 kHz channel)
    -M am     envelope detection
    -M usb/-M lsb  single sideband (3 kHz audio)

s16-LE mono audio on stdout, like the original.  ``--rds`` (wbfm only)
runs the Radio Data System receiver on the multiplex tap alongside the
audio and prints decoded PI/PS/RadioText lines to stderr.  ``-l`` mutes
blocks below a channel-power threshold; more than one frequency with
``-l`` hops between them on the squelch (:func:`scan_loop`).  Sources: a
capture file (``--file``), an rtl_tcp server (``--tcp``) or a local
dongle, through the port's own ``stream.feeder`` and ``api``.

The GPU is required: without one the CLI raises, unless ``--torch-device
cpu`` asks for the plain PyTorch versions on the CPU.

Example: python -m tpu_sdr_torch.apps.rtl_fm -M am --file capture.bin > audio.raw
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from tpu_sdr_torch import DEFAULT_BUF_LENGTH
from tpu_sdr_torch.utils.units import parse_scaled

log = logging.getLogger("rtl_fm")


def expand_freq_spec(spec: str) -> list[int]:
    """One ``-f`` value -> frequencies: either a single scaled number or an
    inclusive ``start:stop:step`` range (the original rtl_fm's scan
    syntax, e.g. ``118M:137M:25k``)."""
    if ":" not in spec:
        return [parse_scaled(spec)]
    parts = spec.split(":")
    if len(parts) != 3:
        raise SystemExit(f"bad -f range '{spec}': want start:stop:step")
    start, stop, step = (parse_scaled(s) for s in parts)
    if step <= 0 or stop < start:
        raise SystemExit(f"bad -f range '{spec}': want start<=stop, step>0")
    return list(range(start, stop + 1, step))


def make_streamer(mode: str, device, rds: bool = False,
                  squelch_db: float | None = None,
                  fine_tune_hz: float = 0.0, deemph_us: float = 0.0):
    if mode == "wbfm":
        from tpu_sdr_torch.models import wbfm
        from tpu_sdr_torch.utils.design import WbfmConfig

        return wbfm.WbfmStreamer(WbfmConfig(filter_mode="fir", emit_mpx=rds),
                                 device=device)
    from tpu_sdr_torch.models import multimode as MM

    mm = {"fm": "nbfm", "am": "am", "usb": "usb", "lsb": "lsb"}[mode]
    return MM.MultimodeStreamer(MM.MultimodeConfig(
        mode=mm, squelch_db=squelch_db, fine_tune_hz=fine_tune_hz,
        deemphasis_tau=deemph_us * 1e-6), device=device)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-M", dest="mode", default="wbfm",
                   choices=["wbfm", "fm", "am", "usb", "lsb"])
    p.add_argument("-f", dest="frequency", action="append", metavar="FREQ",
                   help="center frequency; repeatable, and accepts "
                        "start:stop:step ranges (e.g. -f 88M -f 92.5M or "
                        "-f 118M:137M:25k).  More than one frequency plus "
                        "-l enables squelch-driven scanning: hop while "
                        "squelch is closed, dwell while open (the original "
                        "rtl_fm scan loop; default 94.9M)")
    p.add_argument("--file", help="raw u8 I/Q capture (else open a device)")
    p.add_argument("--tcp", metavar="HOST:PORT",
                   help="stream from a remote rtl_tcp server instead of a "
                        "local device")
    p.add_argument("-d", dest="device", type=int, default=0)
    p.add_argument("--rds", action="store_true",
                   help="decode RDS from the multiplex (wbfm only); "
                        "PI/PS/RadioText lines go to stderr")
    p.add_argument("--blocks", type=int, default=0,
                   help="stop after N blocks (device/tcp modes; 0 = run "
                        "until interrupted)")
    p.add_argument("-l", dest="squelch_db", type=float, default=None,
                   metavar="DBFS",
                   help="squelch: mute blocks whose filtered channel power "
                        "is below this dBFS threshold (narrowband modes; "
                        "the original rtl_fm's -l, in dB instead of raw "
                        "units)")
    p.add_argument("--scan-hold", type=int, default=4, metavar="N",
                   help="scan mode: once a signal was heard at a "
                        "frequency, require N consecutive squelch-closed "
                        "blocks before hopping on (fade tolerance; the "
                        "original's conseq_squelch)")
    p.add_argument("--deemph", dest="deemph_us", type=float, default=0.0,
                   metavar="US",
                   help="narrow-FM de-emphasis time constant in "
                        "microseconds (the original rtl_fm's -E deemp; "
                        "75 in the Americas, 50 elsewhere; 0 = off; "
                        "-M fm only)")
    p.add_argument("--fine-tune", dest="fine_tune", type=float, default=0.0,
                   metavar="HZ",
                   help="SSB software fine tuning in Hz (signed): moves "
                        "the carrier below the R82xx PLL's ~kHz SDM step "
                        "(-M usb|lsb only; every Hz of carrier error "
                        "shifts the voice pitch by a Hz)")
    p.add_argument("--scan-settle", type=int, default=None, metavar="N",
                   help="scan mode: discard N blocks after each retune "
                        "(default 0 for a local device, whose buffer is "
                        "reset on hop; 1 for --tcp, where the server's "
                        "queue still holds pre-retune samples)")
    p.add_argument("--torch-device", default="cuda",
                   help="where to demodulate: cuda (default; raises without "
                        "a GPU), cuda:N, or cpu for the plain PyTorch versions")
    args = p.parse_args(argv)
    freqs = []
    for spec in (args.frequency or ["94.9M"]):
        freqs.extend(expand_freq_spec(spec))
    scanning = len(freqs) > 1
    if args.rds and args.mode != "wbfm":
        p.error("--rds requires -M wbfm (RDS rides the FM multiplex)")
    if args.squelch_db is not None and args.mode == "wbfm":
        p.error("-l squelch applies to the narrowband modes "
                "(-M fm|am|usb|lsb)")
    if scanning:
        if args.file:
            p.error("scanning needs a tunable source, not --file")
        if args.mode == "wbfm" or args.squelch_db is None:
            p.error("scanning (multiple -f) requires a narrowband mode "
                    "(-M fm|am|usb|lsb) and a -l squelch threshold to "
                    "drive the hops")
    if args.fine_tune and args.mode not in ("usb", "lsb"):
        p.error("--fine-tune applies to the SSB modes (-M usb|lsb)")
    if args.deemph_us and args.mode != "fm":
        p.error("--deemph applies to narrow FM (-M fm)")

    from tpu_sdr_torch.device import resolve_device
    from tpu_sdr_torch.native import f32_to_s16

    device = resolve_device(args.torch_device)
    streamer = make_streamer(args.mode, device, rds=args.rds,
                             squelch_db=args.squelch_db,
                             fine_tune_hz=args.fine_tune,
                             deemph_us=args.deemph_us)
    rds_rx = None
    if args.rds:
        from tpu_sdr_torch.models import rds as rds_mod

        rds_rx = rds_mod.RdsStreamDecoder(device=device)
    log.info("Demodulating %s%s on %s", args.mode,
             " + RDS" if args.rds else "", device)

    def emit(buf: np.ndarray) -> None:
        audio = streamer.demodulate(buf)
        sys.stdout.buffer.write(f32_to_s16(audio).tobytes())
        if rds_rx is not None and streamer.last_mpx is not None:
            for event in rds_rx.feed_mpx(streamer.last_mpx):
                print(f"[rds] {event}", file=sys.stderr, flush=True)

    if args.file:
        with open(args.file, "rb") as f:
            while True:
                chunk = f.read(DEFAULT_BUF_LENGTH)
                if len(chunk) < 16:
                    break
                emit(np.frombuffer(chunk, dtype=np.uint8))
        sys.stdout.buffer.flush()
        return 0

    from tpu_sdr_torch.stream.feeder import BlockFeeder, DeviceSource

    cap = getattr(streamer.config, "capture_rate", 1_020_000)
    if args.tcp:
        from tpu_sdr_torch.stream.feeder import RtlTcpClientSource

        host, _, port = args.tcp.rpartition(":")
        source = RtlTcpClientSource(host or "127.0.0.1", int(port))
        source.set_gain_mode(False)
        source.set_sample_rate(cap)
        source.set_frequency(freqs[0] + cap // 4)  # fs/4 offset

        def tune(freq: int) -> None:
            source.set_frequency(freq + cap // 4)

        def read_one() -> bytes | None:
            return source.read_block(DEFAULT_BUF_LENGTH)

        log.info("Streaming from rtl_tcp://%s", args.tcp)
    else:
        from tpu_sdr_torch.api import DeviceId, RtlSdr, TunerGain

        sdr = RtlSdr.open(DeviceId.index(args.device))
        sdr.set_tuner_gain(TunerGain.AUTO)
        sdr.set_sample_rate(cap)
        sdr.set_center_freq(freqs[0] + cap // 4)  # fs/4 offset capture
        sdr.reset_buffer()
        source = DeviceSource(sdr)

        def tune(freq: int) -> None:
            sdr.set_center_freq(freq + cap // 4)
            sdr.reset_buffer()  # drop samples captured at the old tune

        def read_one() -> bytes | None:
            data = sdr.read_sync(DEFAULT_BUF_LENGTH)
            return data if data else None

    if scanning:
        settle = args.scan_settle
        if settle is None:
            settle = 1 if args.tcp else 0
        try:
            return scan_loop(freqs, streamer, tune, read_one, emit,
                             hold=args.scan_hold, max_blocks=args.blocks,
                             settle=settle)
        except KeyboardInterrupt:
            return 0
        finally:
            source.close()

    feeder = BlockFeeder(source).start()
    done = 0
    try:
        for block in feeder.blocks():
            emit(block)
            done += 1
            if args.blocks and done >= args.blocks:
                break
    except KeyboardInterrupt:
        pass
    finally:
        feeder.stop()
    return 0


def scan_loop(freqs: list[int], streamer, tune, read_one, emit,
              hold: int = 4, max_blocks: int = 0, settle: int = 0) -> int:
    """Squelch-driven frequency hopping (the original C rtl_fm's scan
    loop, which the reference port dropped along with multi ``-f``).

    Dwell at each frequency while the squelch is open; hop to the next as
    soon as a block closes it — unless a signal was already heard during
    this visit, in which case ``hold`` consecutive closed blocks are
    required (fade tolerance, rtl_fm's ``conseq_squelch``).  Streaming
    carries are dropped on every hop: samples before and after a retune
    are not continuous.
    """
    import itertools

    done = 0
    order = itertools.cycle(range(len(freqs)))
    for idx in order:
        freq = freqs[idx]
        tune(freq)
        streamer.reset()
        # discard in-flight pre-retune samples (rtl_tcp servers keep a
        # queue the client cannot reset; a local device was reset in
        # tune())
        for _ in range(settle):
            if read_one() is None:
                log.info("scan: source ended")
                return 0
        log.info("scan: %d Hz", freq)
        heard = False
        closed_run = 0
        seen = streamer.n_measurements
        while True:
            block = read_one()
            if block is None:
                log.info("scan: source ended")
                return 0
            emit(np.frombuffer(block, dtype=np.uint8))
            done += 1
            if streamer.n_measurements == seen:
                # sub-quantum block: no new squelch measurement — the
                # observables are stale (init True after reset), so they
                # must not drive a hop decision
                if max_blocks and done >= max_blocks:
                    return 0
                continue
            seen = streamer.n_measurements
            if streamer.last_squelch_open:
                if not heard:
                    log.info("scan: signal at %d Hz (%.1f dBFS)", freq,
                             10 * np.log10(max(streamer.last_power, 1e-12)))
                heard = True
                closed_run = 0
            else:
                closed_run += 1
            if max_blocks and done >= max_blocks:
                return 0
            if closed_run >= (hold if heard else 1):
                break  # hop on
    return 0


if __name__ == "__main__":
    sys.exit(main())
