"""rtl_test — device selection + test-pattern sample reader.

The port's copy of ``tpu_sdr.apps.rtl_test``, on the port's ``api``: the same
options and output, and no ``--torch-device`` (it runs no data plane).

Mirrors the reference's examples/rtl_test.rs: select a device by ``--device
<index>`` or ``--find key=value,...`` filters (manufacturer/product/serial),
enable the on-chip counter test pattern, and read sustained sync blocks with
short-read (sample loss) detection.  This version additionally *verifies*
counter continuity — the reference reads but never checks it
(rtl_test.rs:168-181, SURVEY.md §4).
"""

from __future__ import annotations

import argparse
import sys
import threading

from tpu_sdr_torch import DEFAULT_BUF_LENGTH
from tpu_sdr_torch.api import DeviceId, RtlSdr, list_devices

SAMPLE_RATE = 2_048_000  # (ref rtl_test.rs:22)


def parse_filters(text: str) -> dict[str, str]:
    """``manufacturer=X,product=Y,serial=Z`` (ref rtl_test.rs:37-58)."""
    out = {}
    for pair in text.split(","):
        if "=" not in pair:
            continue
        key, value = pair.split("=", 1)
        if key not in ("manufacturer", "product", "serial"):
            raise SystemExit(
                f"Unknown filter key: {key}, must be one of manufacturer, product, serial"
            )
        out[key] = value
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", "-d", type=int, default=None)
    p.add_argument("--find", "-f", default=None)
    p.add_argument("--blocks", type=int, default=0,
                   help="stop after N blocks (0 = run until interrupted)")
    args = p.parse_args(argv)
    if args.device is not None and args.find is not None:
        print("Error: --device/-d and --find/-f are mutually exclusive.", file=sys.stderr)
        return 1

    devices = list_devices()
    if not devices:
        print("No supported devices found.", file=sys.stderr)
        return 1
    print(f"Found {len(devices)} device(s):")
    for d in devices:
        print(f"  {d.index}:  {d.manufacturer}, {d.product}, SN: {d.serial}")
    print()

    if args.device is not None:
        target = next((d for d in devices if d.index == args.device), None)
    elif args.find is not None:
        filters = parse_filters(args.find)
        target = next(
            (d for d in devices
             if all(getattr(d, k) == v for k, v in filters.items())),
            None,
        )
    else:
        print("No device selection mode specified. Use --device/-d or --find/-f.",
              file=sys.stderr)
        return 1
    if target is None:
        print("No matching device found.", file=sys.stderr)
        return 1

    print(f"Using device {target.index}: {target.manufacturer}, {target.product}, "
          f"SN: {target.serial}")
    sdr = RtlSdr.open(DeviceId.index(target.index))
    print(f"Found {sdr.get_tuner_id()} tuner")
    gains = sdr.get_tuner_gains()
    print(f"Supported gain values ({len(gains)}):",
          " ".join(f"{g / 10:.1f}" for g in gains))

    sdr.set_sample_rate(SAMPLE_RATE)
    print(f"Sampling at {sdr.get_sample_rate()} S/s.")
    sdr.set_testmode(True)
    sdr.reset_buffer()
    print("Reading samples in sync mode...")

    import numpy as np

    from tpu_sdr_torch.native import count_pattern_breaks

    shutdown = threading.Event()
    blocks = 0
    breaks_total = 0
    last_counter = -1
    try:
        while not shutdown.is_set():
            data = sdr.read_sync(DEFAULT_BUF_LENGTH)
            if len(data) < DEFAULT_BUF_LENGTH:
                print(f"Short read ({len(data)}), samples lost, exiting!", file=sys.stderr)
                break
            # Full per-byte counter continuity check, carried across blocks
            # (native scan; beyond the reference, which only detects short
            # reads, rtl_test.rs:170-181)
            breaks, last_counter = count_pattern_breaks(
                np.frombuffer(data, dtype=np.uint8), last_counter)
            if breaks:
                breaks_total += breaks
                print(f"{breaks} counter discontinuities in block", file=sys.stderr)
            blocks += 1
            if args.blocks and blocks >= args.blocks:
                break
    except KeyboardInterrupt:
        pass

    print(f"\nRead {blocks} blocks ({blocks * DEFAULT_BUF_LENGTH} bytes), "
          f"{breaks_total} discontinuities. Closing device...")
    sdr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
