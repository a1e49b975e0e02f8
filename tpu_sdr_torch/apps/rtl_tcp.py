"""rtl_tcp — I/Q spectrum server CLI.

The port's copy of ``tpu_sdr.apps.rtl_tcp``, on the port's ``api``: the same
options and output, and no ``--torch-device`` (it runs no data plane).

Mirrors the reference's examples/rtl_tcp.rs flags (rtl_tcp.rs:134-289):
``-a`` address, ``-p`` port, ``-f`` frequency, ``-g`` gain, ``-s`` sample
rate (k/M/G suffixes), ``-b`` buffer count (accepted, unused — parity with
rtl_tcp.rs:244), ``-n`` queue limit, ``-d`` device index, ``-P`` ppm,
``-T`` bias tee, ``-D`` direct sampling.  Beyond the reference:
``--max-clients N`` serves N concurrent clients from one acquisition loop
with per-client backpressure isolation.
"""

from __future__ import annotations

import argparse
import logging
import sys

from tpu_sdr_torch.api import DeviceId, DirectSampleMode, RtlSdr, TunerGain
from tpu_sdr_torch.stream.rtl_tcp_server import (
    DEFAULT_PORT,
    DEFAULT_QUEUE_LIMIT,
    DEFAULT_SAMPLE_RATE,
    RtlTcpServer,
)
from tpu_sdr_torch.utils.units import parse_scaled

DEFAULT_FREQUENCY = 100_000_000


def setup_device(args) -> RtlSdr:
    """Open + configure (ref setup_device, rtl_tcp.rs:291-332)."""
    sdr = RtlSdr.open(DeviceId.index(args.device))
    if args.direct_sampling:
        sdr.set_direct_sampling(DirectSampleMode.ON_SWAP)
    if args.ppm:
        sdr.set_freq_correction(args.ppm)
    sdr.set_sample_rate(args.sample_rate)
    sdr.set_center_freq(args.frequency)
    if args.gain is None:
        sdr.set_tuner_gain(TunerGain.AUTO)
    else:
        sdr.set_tuner_gain(TunerGain.manual(args.gain))
    sdr.set_bias_tee(args.bias_tee)
    sdr.reset_buffer()
    print(f"Tuned to {args.frequency} Hz")
    print(f"Sampling at {args.sample_rate} S/s")
    return sdr


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    p = argparse.ArgumentParser(
        description="rtl_tcp, an I/Q spectrum server for RTL-SDR receivers")
    p.add_argument("-a", dest="address", default="127.0.0.1")
    p.add_argument("-p", dest="port", type=int, default=DEFAULT_PORT)
    p.add_argument("-f", dest="frequency", type=parse_scaled, default=DEFAULT_FREQUENCY)
    p.add_argument("-g", dest="gain", type=float, default=None,
                   help="gain in dB (default: auto)")
    p.add_argument("-s", dest="sample_rate", type=parse_scaled, default=DEFAULT_SAMPLE_RATE)
    p.add_argument("-b", dest="buffer_count", type=int, default=None,
                   help="number of buffers (unused, compatibility only)")
    p.add_argument("-n", dest="queue_limit", type=int, default=DEFAULT_QUEUE_LIMIT)
    p.add_argument("-d", dest="device", type=int, default=0)
    p.add_argument("-P", dest="ppm", type=int, default=0)
    p.add_argument("-T", dest="bias_tee", action="store_true")
    p.add_argument("-D", dest="direct_sampling", action="store_true")
    p.add_argument("--max-clients", dest="max_clients", type=int, default=1,
                   help="concurrent clients served by one acquisition loop "
                        "(default 1 = reference behavior)")
    args = p.parse_args(argv)
    if args.gain is not None:
        args.gain = int(round(args.gain * 10))

    try:
        sdr = setup_device(args)
    except Exception as e:
        print(f"rtl_tcp: {e}", file=sys.stderr)
        return 1

    server = RtlTcpServer(sdr, args.address, args.port,
                          queue_limit=args.queue_limit, default_gain=args.gain,
                          max_clients=args.max_clients)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        sdr.close()
    print("bye!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
