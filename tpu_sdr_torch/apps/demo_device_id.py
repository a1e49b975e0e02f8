"""demo_device_id — tour of the three DeviceId addressing modes.

The port's copy of ``tpu_sdr.apps.demo_device_id``, on the port's ``api``: the same
options and output, and no ``--torch-device`` (it runs no data plane).

A dongle can be addressed three ways (matching the reference's
``DeviceId{Index,Serial,Fd}``, the reference's src/lib.rs:89-94):

* ``DeviceId.index(n)``  — position in the merged enumeration order;
* ``DeviceId.serial(s)`` — USB string-descriptor serial;
* ``DeviceId.fd(n)``     — an already-open kernel device node, wrapped via
  ``libusb_wrap_sys_device`` (the Android path — no enumeration happens).

This demo resolves whatever devices are visible and tries each mode,
printing which resolve and which don't in this environment. Pass
``--fd N`` to hand it a real usbfs descriptor.
"""

from __future__ import annotations

import argparse
import sys

from tpu_sdr_torch import api


def _try_open(device_id: api.DeviceId) -> None:
    try:
        with api.RtlSdr.open(device_id) as sdr:
            print(f"  {device_id.kind}({device_id.value!r}): opened, "
                  f"tuner={sdr.get_tuner_id()}")
    except Exception as e:  # noqa: BLE001 — demo reports every outcome
        print(f"  {device_id.kind}({device_id.value!r}): {e}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="demo_device_id",
        description="Exercise DeviceId.index / .serial / .fd open paths.")
    p.add_argument("--fd", type=int, default=None,
                   help="usbfs file descriptor to wrap (Android-style open)")
    args = p.parse_args(argv)

    descs = api.list_devices()
    print(f"visible devices: {len(descs)}")

    print("by index:")
    _try_open(api.DeviceId.index(0))

    print("by serial:")
    if descs:
        _try_open(api.DeviceId.serial(descs[0].serial))
    else:
        print("  (no devices enumerated — skipped)")

    print("by fd:")
    if args.fd is not None:
        _try_open(api.DeviceId.fd(args.fd))
    else:
        print("  (no --fd given; fd open wraps an existing usbfs node and "
              "cannot be demonstrated without one)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
