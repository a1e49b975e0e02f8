"""RTL2832U register protocol over a UsbBackend.

Implements the reference's device transport layer
(src/device/mod.rs): block-addressed register reads/writes
(LE read / BE write asymmetry, ``index = (block<<8) | 0x10`` write marker),
page-addressed demod registers with the post-write readback, the bulk I/Q
endpoint, the byte-at-a-time EEPROM protocol, and the I2C tunnel used for
the tuner.
"""

from __future__ import annotations

from tpu_sdr_torch.control import constants as C
from tpu_sdr_torch.control.usb import UsbBackend


class Device:
    """One opened dongle's register transport (ref device/mod.rs:31-193)."""

    def __init__(self, backend: UsbBackend):
        self.handle = backend

    def claim_interface(self, iface: int) -> None:
        self.handle.claim_interface(iface)

    def close(self) -> None:
        self.handle.close()

    def test_write(self) -> None:
        """Dummy register write; USB-reset the device if it fails
        (ref device/mod.rs:46-54)."""
        n = self.write_reg(C.BLOCK_USB, C.USB_SYSCTL, 0x09, 1)
        if n == 0:
            self.handle.reset()

    def reset_demod(self) -> None:
        """Demod soft reset via page1 reg 0x01 bit 3 (ref device/mod.rs:56-60)."""
        self.demod_write_reg(1, 0x01, 0x14, 1)
        self.demod_write_reg(1, 0x01, 0x10, 1)

    # -- block registers ---------------------------------------------------

    def read_reg(self, block: int, addr: int, length: int) -> int:
        """Registers read little-endian (ref device/mod.rs:63-71)."""
        assert length in (1, 2)
        data = self.handle.read_control(
            C.CTRL_IN, 0, addr, block << 8, length, C.CTRL_TIMEOUT_MS
        )
        data = bytes(data) + b"\x00\x00"
        return data[0] | (data[1] << 8)

    def write_reg(self, block: int, addr: int, val: int, length: int) -> int:
        """...but written big-endian, with the 0x10 index marker
        (ref device/mod.rs:73-83)."""
        assert length in (1, 2)
        be = bytes([(val >> 8) & 0xFF, val & 0xFF])
        payload = be[1:] if length == 1 else be
        index = (block << 8) | 0x10
        return self.handle.write_control(
            C.CTRL_OUT, 0, addr, index, payload, C.CTRL_TIMEOUT_MS
        )

    # -- demod (page-addressed) registers ---------------------------------

    def demod_read_reg(self, page: int, addr: int) -> int:
        """u8 demod read: value = (addr<<8)|0x20, index = page
        (ref device/mod.rs:86-111)."""
        data = self.handle.read_control(
            C.CTRL_IN, 0, (addr << 8) | 0x20, page, 1, C.CTRL_TIMEOUT_MS
        )
        return data[0] if data else 0

    def demod_write_reg(self, page: int, addr: int, val: int, length: int) -> int:
        """Demod write followed by the status readback the hardware requires
        (ref device/mod.rs:114-139)."""
        assert length in (1, 2)
        index = 0x10 | page
        wire_addr = (addr << 8) | 0x20
        be = bytes([(val >> 8) & 0xFF, val & 0xFF])
        payload = be[1:] if length == 1 else be
        n = self.handle.write_control(
            C.CTRL_OUT, 0, wire_addr, index, payload, C.CTRL_TIMEOUT_MS
        )
        self.demod_read_reg(0x0A, 0x01)
        return n

    # -- bulk I/Q ----------------------------------------------------------

    def bulk_transfer(self, length: int) -> bytes:
        """Synchronous I/Q read from endpoint 0x81 (ref device/mod.rs:141-143)."""
        return self.handle.read_bulk(C.BULK_IQ_ENDPOINT, length, 0)

    # -- EEPROM ------------------------------------------------------------

    def read_eeprom(self, offset: int, length: int) -> bytes:
        """Byte-at-a-time EEPROM read at I2C 0xA0 (ref device/mod.rs:145-152)."""
        assert offset + length <= C.EEPROM_SIZE
        self.write_array(C.BLOCK_IIC, C.EEPROM_ADDR, bytes([offset]))
        out = bytearray()
        for _ in range(length):
            out += self.read_array(C.BLOCK_IIC, C.EEPROM_ADDR, 1)
        return bytes(out)

    def usb_strings(self):
        return self.handle.get_usb_strings()

    # -- I2C tunnel --------------------------------------------------------

    def i2c_read_reg(self, i2c_addr: int, reg: int) -> int:
        """Write register address, read one byte back (ref device/mod.rs:158-170)."""
        self.write_array(C.BLOCK_IIC, i2c_addr, bytes([reg]))
        return self.read_array(C.BLOCK_IIC, i2c_addr, 1)[0]

    def i2c_write(self, i2c_addr: int, data: bytes) -> int:
        return self.write_array(C.BLOCK_IIC, i2c_addr, data)

    def i2c_read(self, i2c_addr: int, length: int) -> bytes:
        return self.read_array(C.BLOCK_IIC, i2c_addr, length)

    # -- raw array transfers ----------------------------------------------

    def read_array(self, block: int, addr: int, length: int) -> bytes:
        return self.handle.read_control(
            C.CTRL_IN, 0, addr, block << 8, length, C.CTRL_TIMEOUT_MS
        )

    def write_array(self, block: int, addr: int, data: bytes) -> int:
        return self.handle.write_control(
            C.CTRL_OUT, 0, addr, (block << 8) | 0x10, data, C.CTRL_TIMEOUT_MS
        )
