"""rtl_eeprom — dump and parse the dongle's configuration EEPROM.

The port's copy of ``tpu_sdr.apps.rtl_eeprom``, on the port's ``api``: the same
options and output, and no ``--torch-device`` (it runs no data plane).

Beyond-reference companion tool (modeled on osmocom ``rtl_eeprom``'s
read side; ccostes/rtl-sdr-rs only reads the byte-7 hack bits during
init, the reference's src/rtlsdr.rs:118-124).  Read-only by design:
writing the EEPROM can soft-brick a dongle and the reference never does.

Prints a hex dump plus the parsed standard layout: magic, VID/PID,
string descriptors (manufacturer/product/serial, UTF-16LE), the
have-serial flag, and the RTL-SDR-Blog hack bits that force bias-tee /
direct-sampling at init.
"""

from __future__ import annotations

import argparse
import sys

from tpu_sdr_torch.api import DeviceId, RtlSdr
from tpu_sdr_torch.control import constants as C


def parse_strings(eeprom: bytes) -> list[str]:
    """Parse the chained string descriptors starting at offset 0x09:
    each is [total_len, 0x03, UTF-16LE chars...]."""
    out = []
    pos = 0x09
    for _ in range(3):
        if pos + 2 > len(eeprom):
            break
        length, tag = eeprom[pos], eeprom[pos + 1]
        if tag != 0x03 or length < 2 or pos + length > len(eeprom):
            break
        raw = bytes(eeprom[pos + 2: pos + length])
        try:
            out.append(raw.decode("utf-16-le").rstrip("\x00"))
        except UnicodeDecodeError:
            break
        pos += length
    return out


def hexdump(data: bytes, stream) -> None:
    for off in range(0, len(data), 16):
        row = data[off: off + 16]
        hexes = " ".join(f"{b:02x}" for b in row)
        chars = "".join(chr(b) if 32 <= b < 127 else "." for b in row)
        print(f"{off:04x}  {hexes:<47}  {chars}", file=stream)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Dump and parse the RTL-SDR configuration EEPROM "
                    "(read-only)")
    p.add_argument("-d", "--device", type=int, default=0,
                   help="device index")
    p.add_argument("-o", "--output", default=None,
                   help="also write the raw EEPROM image to this file")
    args = p.parse_args(argv)

    sdr = RtlSdr.open(DeviceId.index(args.device))
    try:
        eeprom = sdr.read_eeprom(0, C.EEPROM_SIZE)
    finally:
        sdr.close()

    hexdump(eeprom, sys.stdout)
    print()

    magic_ok = eeprom[0] == 0x28 and eeprom[1] == 0x32
    print(f"Magic:            {'0x28 0x32 (valid)' if magic_ok else 'INVALID'}")
    vid = eeprom[2] | (eeprom[3] << 8)
    pid = eeprom[4] | (eeprom[5] << 8)
    print(f"Vendor ID:        0x{vid:04x}")
    print(f"Product ID:       0x{pid:04x}")
    strings = parse_strings(eeprom)
    for label, value in zip(("Manufacturer", "Product", "Serial"), strings):
        print(f"{label + ':':<18}{value}")
    print(f"Have serial:      {'yes' if eeprom[6] == 0xA5 else 'no'}")
    # Byte-7 hack bits, exactly as init interprets them
    # (control/rtlsdr.py: force_bt = bit1==0, force_ds = bit0!=0)
    print(f"Force bias tee:   {'yes' if (eeprom[7] & 0x02) == 0 else 'no'}")
    print(f"Force direct smp: {'yes' if (eeprom[7] & 0x01) != 0 else 'no'}")

    if args.output:
        with open(args.output, "wb") as f:
            f.write(eeprom)
        print(f"\nWrote {len(eeprom)} bytes to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
