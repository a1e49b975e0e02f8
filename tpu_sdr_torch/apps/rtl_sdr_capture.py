"""rtl_sdr — raw I/Q capture to a file (osmocom ``rtl_sdr`` equivalent).

The port's copy of ``tpu_sdr.apps.rtl_sdr_capture``, on the port's ``api``: the same
options and output, and no ``--torch-device`` (it runs no data plane).

The reference port (ccostes/rtl-sdr-rs) ships simple_fm/rtl_tcp/rtl_test
but not the classic raw-capture companion tool every librtlsdr user
reaches for first; this fills that gap (beyond-reference, modeled on
osmocom rtl_sdr's flag surface).  Interleaved unsigned-8-bit I/Q goes to
the output file (``-`` = stdout, logs stay on stderr — same discipline as
the reference apps, examples/simple_fm.rs:38).

    tpu-sdr-torch-rtl-sdr capture.bin -f 94.9M -s 2.4M -n 25.6M
    TPU_SDR_FAKE_DEVICES=1 python -m tpu_sdr_torch.apps.rtl_sdr_capture - -n 512k > iq.bin

The capture file feeds every file-mode receiver in this framework
(simple_fm/rtl_fm/multi_fm --file) and any other rtl_sdr-compatible tool.
"""

from __future__ import annotations

import argparse
import sys

from tpu_sdr_torch import DEFAULT_BUF_LENGTH
from tpu_sdr_torch.api import DeviceId, RtlSdr, TunerGain
from tpu_sdr_torch.utils.units import parse_scaled

DEFAULT_SAMPLE_RATE = 2_048_000


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Capture raw interleaved u8 I/Q samples to a file")
    p.add_argument("output", help="output file ('-' = stdout)")
    p.add_argument("-f", "--frequency", default="100M",
                   help="center frequency (k/M/G suffixes)")
    p.add_argument("-s", "--sample-rate", default=str(DEFAULT_SAMPLE_RATE),
                   help="sample rate in Hz (k/M suffixes)")
    p.add_argument("-d", "--device", type=int, default=0,
                   help="device index")
    p.add_argument("-g", "--gain", type=float, default=None,
                   help="tuner gain in dB (default: auto)")
    p.add_argument("-p", "--ppm", type=int, default=0,
                   help="frequency correction in ppm")
    p.add_argument("-b", "--block-size", default=str(DEFAULT_BUF_LENGTH),
                   help="bytes per sync read")
    p.add_argument("-n", "--num-bytes", default="0",
                   help="stop after this many bytes (0 = until interrupted)")
    p.add_argument("-T", "--bias-tee", action="store_true",
                   help="enable bias tee")
    args = p.parse_args(argv)

    freq = parse_scaled(args.frequency)
    rate = parse_scaled(args.sample_rate)
    block = parse_scaled(args.block_size)
    total = parse_scaled(args.num_bytes)

    sdr = RtlSdr.open(DeviceId.index(args.device))
    try:
        print(f"Found {sdr.get_tuner_id()} tuner", file=sys.stderr)
        sdr.set_sample_rate(rate)
        print(f"Sampling at {sdr.get_sample_rate()} S/s.", file=sys.stderr)
        sdr.set_center_freq(freq)
        print(f"Tuned to {sdr.get_center_freq()} Hz.", file=sys.stderr)
        if args.ppm:
            sdr.set_freq_correction(args.ppm)
        if args.bias_tee:
            sdr.set_bias_tee(True)
        if args.gain is None:
            sdr.set_tuner_gain(TunerGain.AUTO)
            print("Tuner gain set to automatic.", file=sys.stderr)
        else:
            gains = sdr.get_tuner_gains()
            want = int(round(args.gain * 10))
            nearest = min(gains, key=lambda g: abs(g - want))
            sdr.set_tuner_gain(TunerGain.manual(nearest))
            print(f"Tuner gain set to {nearest / 10:.2f} dB.",
                  file=sys.stderr)
        sdr.reset_buffer()

        out = sys.stdout.buffer if args.output == "-" else open(
            args.output, "wb")
        written = 0
        print("Reading samples in sync mode...", file=sys.stderr)
        try:
            while total == 0 or written < total:
                want_now = block
                if total:
                    want_now = min(block, total - written)
                data = sdr.read_sync(want_now)
                if len(data) < want_now:
                    print(f"Short read ({len(data)}), samples lost, "
                          "exiting!", file=sys.stderr)
                    if data:
                        out.write(data)
                        written += len(data)
                    break
                out.write(data)
                written += len(data)
        except KeyboardInterrupt:
            print("\nUser cancel, exiting...", file=sys.stderr)
        finally:
            out.flush()
            if out is not sys.stdout.buffer:
                out.close()
        print(f"Wrote {written} bytes.", file=sys.stderr)
    finally:
        sdr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
