"""device_list — enumerate attached RTL-SDR dongles and smoke-test open paths.

The port's copy of ``tpu_sdr.apps.device_list``, on the port's ``api``: the same
options and output, and no ``--torch-device`` (it runs no data plane).

Functional counterpart of the reference's enumeration example
(the reference's examples/device_list.rs) with this framework's own CLI
shape: a compact table of every visible dongle (libusb-backed and
simulated alike — see ``TPU_SDR_FAKE_DEVICES``), then, with ``--probe``,
a walk through each way of opening one.

Exit status is the number of probe failures, so the tool doubles as a
scriptable health check.
"""

from __future__ import annotations

import argparse
import sys

from tpu_sdr_torch import api


def _table(descs) -> str:
    rows = [("idx", "vid:pid", "manufacturer", "product", "serial")]
    for d in descs:
        rows.append((str(d.index), f"{d.vendor_id:04x}:{d.product_id:04x}",
                     d.manufacturer, d.product, d.serial))
    widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
    lines = ["  ".join(cell.ljust(w) for cell, w in zip(r, widths)).rstrip()
             for r in rows]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)


def _probe(descs) -> int:
    """Open index 0 through every addressing path; return failure count."""
    failures = 0

    def attempt(label, fn):
        nonlocal failures
        try:
            with fn() as sdr:
                print(f"  ok   {label}  (freq={sdr.get_center_freq()} Hz, "
                      f"rate={sdr.get_sample_rate()} Hz)")
        except Exception as e:  # noqa: BLE001 — health check reports, not raises
            failures += 1
            print(f"  FAIL {label}: {e}")

    attempt("open_first_available", api.RtlSdr.open_first_available)
    attempt("open_with_index(0)", lambda: api.RtlSdr.open_with_index(0))
    serial = descs[0].serial
    attempt(f"open_with_serial({serial!r})",
            lambda: api.RtlSdr.open_with_serial(serial))

    try:
        info = api.get_device_info(0)
        print(f"  ok   get_device_info(0) -> {info.product!r} "
              f"serial={api.get_device_serial(0)!r}")
    except Exception as e:  # noqa: BLE001
        failures += 1
        print(f"  FAIL get_device_info(0): {e}")
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="device_list",
        description="List RTL-SDR dongles visible to tpu_sdr.")
    p.add_argument("--probe", action="store_true",
                   help="also open device 0 via every addressing path")
    args = p.parse_args(argv)

    descs = api.list_devices()
    if not descs:
        print("no RTL-SDR devices visible")
        print("  - plug in a dongle and set TPU_SDR_USE_LIBUSB=1, or")
        print("  - export TPU_SDR_FAKE_DEVICES=1 for the register-level "
              "simulator")
        return 0

    print(f"{len(descs)} device(s):")
    print(_table(descs))

    if not args.probe:
        return 0
    print("\nprobing open paths on device 0:")
    return _probe(descs)


if __name__ == "__main__":
    sys.exit(main())
