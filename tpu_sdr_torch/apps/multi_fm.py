"""multi_fm on PyTorch/CUDA — demodulate many WBFM stations from one
wideband capture, the port of ``tpu_sdr.apps.multi_fm``.

A raw u8 I/Q capture at K * 170 kHz (``--file``) is split into K channels
by the polyphase channelizer, and every selected channel's WBFM tail runs
as one batch on the device (``models.wbfm_wideband``).  Fronts:

  plain    the channelizer in plain PyTorch (default, as in the JAX CLI)
  --fused  the hand-written CUDA kernel pfb_channelize (K3); ``--pallas``,
           the JAX CLI's name for its kernel front, is the same flag

Each station's 32 kHz s16 audio is written to ``<out-dir>/station_<ch>.raw``;
with a single channel and no ``--out-dir`` the audio streams to stdout.
Where the stations' files would pass the soft limit of open files
(``RLIMIT_NOFILE``, often 1,024), the CLI raises it as far as the hard
limit allows, and stops with a message where that is not enough.
``--rds`` runs an RDS receiver on every selected station's multiplex,
printing ``[rds ch<N>] PI/PS/RT`` lines to stderr.
The GPU is required: without one the CLI raises, unless ``--torch-device
cpu`` asks for the plain PyTorch versions on the CPU.

Example:  python -m tpu_sdr_torch.apps.multi_fm --file wideband.bin --channels 3,60 --fused
"""

from __future__ import annotations

import argparse
import logging
import os
import resource
import sys

import numpy as np

log = logging.getLogger("multi_fm")


def _room_for_files(n: int) -> None:
    """Raise the soft limit of open files so that ``n`` more fit, with a
    few to spare for the libraries, up to the hard limit; past that, stop
    with a message."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    try:
        in_use = len(os.listdir("/proc/self/fd"))
    except OSError:
        in_use = 64
    need = in_use + n + 32
    if soft == resource.RLIM_INFINITY or soft >= need:
        return
    if hard != resource.RLIM_INFINITY and hard < need:
        raise SystemExit(f"multi_fm: {n} station files need {need} open "
                         f"files, but the hard limit (ulimit -Hn) is {hard}: "
                         "raise it or select fewer channels")
    resource.setrlimit(resource.RLIMIT_NOFILE, (need, hard))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--file", required=True, help="raw u8 I/Q wideband capture")
    p.add_argument("--channels", default="0",
                   help="comma-separated channel indices (k*fs/K offsets)")
    p.add_argument("--num-channels", type=int, default=64)
    p.add_argument("--out-dir", default=None,
                   help="write station_<ch>.raw files here (default: stdout "
                        "when one channel, ./ otherwise)")
    p.add_argument("--fused", "--pallas", dest="fused", action="store_true",
                   help="channelize with the fused CUDA kernel (K3); "
                        "--pallas is the JAX CLI's name for it")
    p.add_argument("--torch-device", default="cuda",
                   help="where to demodulate: cuda (default; raises without "
                        "a GPU), cuda:N, or cpu for the plain PyTorch versions")
    p.add_argument("--rds", action="store_true",
                   help="decode RDS on every station; [rds ch<N>] lines "
                        "go to stderr")
    args = p.parse_args(argv)

    import torch

    from tpu_sdr_torch.device import resolve_device
    from tpu_sdr_torch.models import wbfm_wideband as wb
    from tpu_sdr_torch.native import f32_to_s16
    from tpu_sdr_torch.utils.profiling import BlockStats

    device = resolve_device(args.torch_device)
    channels = tuple(int(c) for c in args.channels.split(","))
    config = wb.WidebandConfig(num_channels=args.num_channels,
                               channels=channels, emit_mpx=args.rds)
    streamer = wb.WidebandStreamer(config, use_fused=args.fused, device=device)
    rds_rxs = None
    if args.rds:
        from tpu_sdr_torch.models import rds as rds_mod

        rds_rxs = [rds_mod.RdsStreamDecoder(device=device) for _ in channels]
    desc = "fused K3 front" if args.fused else "plain front"
    if device.type == "cuda":
        desc += f" on {torch.cuda.get_device_name(device)}"
    log.info("Capture rate %.3f Msps, %d channels of %d kHz, stations %s, "
             "%s, %s", config.capture_rate / 1e6, config.num_channels,
             config.channel_rate // 1000, list(channels), desc, device)

    single_stdout = args.out_dir is None and len(channels) == 1
    sinks = []
    if not single_stdout:
        out_dir = args.out_dir or "."
        os.makedirs(out_dir, exist_ok=True)
        _room_for_files(len(channels))
        for ch in channels:
            sinks.append(open(os.path.join(out_dir, f"station_{ch}.raw"), "wb"))

    stats = BlockStats()
    block_bytes = 64 * config.num_channels * config.resample_down * 2
    try:
        with open(args.file, "rb") as f:
            while True:
                chunk = f.read(block_bytes)
                if len(chunk) < 2 * config.num_channels:
                    break
                data = np.frombuffer(chunk, dtype=np.uint8)
                with stats.block(len(data) // 2):
                    audio = streamer.demodulate(data)
                for s in range(len(channels)):
                    pcm = f32_to_s16(audio[s])
                    if single_stdout:
                        sys.stdout.buffer.write(pcm.tobytes())
                    else:
                        sinks[s].write(pcm.tobytes())
                if rds_rxs is not None:
                    for s, ch in enumerate(channels):
                        for event in rds_rxs[s].feed_mpx(streamer.last_mpx[s]):
                            print(f"[rds ch{ch}] {event}", file=sys.stderr,
                                  flush=True)
    finally:
        for s in sinks:
            s.close()
    if single_stdout:
        sys.stdout.buffer.flush()
    log.info("%s", stats.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
