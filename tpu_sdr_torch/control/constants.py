"""RTL2832U register map, USB control constants, and known-device table.

Hardware facts mirrored from the reference's src/device/constants.rs — the
42-entry VID/PID signature table (constants.rs:14-225), register block IDs
(constants.rs:239-246), system/USB register addresses (constants.rs:248-271)
and control-transfer request types (constants.rs:273-277).
"""

from __future__ import annotations

# (vid, pid, description) — constants.rs:14-225
KNOWN_DEVICES: tuple[tuple[int, int, str], ...] = (
    (0x0BDA, 0x2832, "Generic RTL2832U"),
    (0x0BDA, 0x2838, "Generic RTL2832U OEM"),
    (0x0413, 0x6680, "DigitalNow Quad DVB-T PCI-E card"),
    (0x0413, 0x6F0F, "Leadtek WinFast DTV Dongle mini D"),
    (0x0458, 0x707F, "Genius TVGo DVB-T03 USB dongle (Ver. B)"),
    (0x0CCD, 0x00A9, "Terratec Cinergy T Stick Black (rev 1)"),
    (0x0CCD, 0x00B3, "Terratec NOXON DAB/DAB+ USB dongle (rev 1)"),
    (0x0CCD, 0x00B4, "Terratec Deutschlandradio DAB Stick"),
    (0x0CCD, 0x00B5, "Terratec NOXON DAB Stick - Radio Energy"),
    (0x0CCD, 0x00B7, "Terratec Media Broadcast DAB Stick"),
    (0x0CCD, 0x00B8, "Terratec BR DAB Stick"),
    (0x0CCD, 0x00B9, "Terratec WDR DAB Stick"),
    (0x0CCD, 0x00C0, "Terratec MuellerVerlag DAB Stick"),
    (0x0CCD, 0x00C6, "Terratec Fraunhofer DAB Stick"),
    (0x0CCD, 0x00D3, "Terratec Cinergy T Stick RC (Rev.3)"),
    (0x0CCD, 0x00D7, "Terratec T Stick PLUS"),
    (0x0CCD, 0x00E0, "Terratec NOXON DAB/DAB+ USB dongle (rev 2)"),
    (0x1554, 0x5020, "PixelView PV-DT235U(RN)"),
    (0x15F4, 0x0131, "Astrometa DVB-T/DVB-T2"),
    (0x15F4, 0x0133, "HanfTek DAB+FM+DVB-T"),
    (0x185B, 0x0620, "Compro Videomate U620F"),
    (0x185B, 0x0650, "Compro Videomate U650F"),
    (0x185B, 0x0680, "Compro Videomate U680F"),
    (0x1B80, 0xD393, "GIGABYTE GT-U7300"),
    (0x1B80, 0xD394, "DIKOM USB-DVBT HD"),
    (0x1B80, 0xD395, "Peak 102569AGPK"),
    (0x1B80, 0xD397, "KWorld KW-UB450-T USB DVB-T Pico TV"),
    (0x1B80, 0xD398, "Zaapa ZT-MINDVBZP"),
    (0x1B80, 0xD39D, "SVEON STV20 DVB-T USB & FM"),
    (0x1B80, 0xD3A4, "Twintech UT-40"),
    (0x1B80, 0xD3A8, "ASUS U3100MINI_PLUS_V2"),
    (0x1B80, 0xD3AF, "SVEON STV27 DVB-T USB & FM"),
    (0x1B80, 0xD3B0, "SVEON STV21 DVB-T USB & FM"),
    (0x1D19, 0x1101, "Dexatek DK DVB-T Dongle (Logilink VG0002A)"),
    (0x1D19, 0x1102, "Dexatek DK DVB-T Dongle (MSI DigiVox mini II V3.0)"),
    (0x1D19, 0x1103, "Dexatek Technology Ltd. DK 5217 DVB-T Dongle"),
    (0x1D19, 0x1104, "MSI DigiVox Micro HD"),
    (0x1F4D, 0xA803, "Sweex DVB-T USB"),
    (0x1F4D, 0xB803, "GTek T803"),
    (0x1F4D, 0xC803, "Lifeview LV5TDeluxe"),
    (0x1F4D, 0xD286, "MyGica TD312"),
    (0x1F4D, 0xD803, "PROlectrix DV107669"),
)

DEVICE_LOOKUP: frozenset[tuple[int, int]] = frozenset((v, p) for v, p, _ in KNOWN_DEVICES)


def is_known_device(vid: int, pid: int) -> bool:
    """VID/PID filter used during enumeration (ref device/mod.rs:26-28)."""
    return (vid, pid) in DEVICE_LOOKUP


EEPROM_ADDR = 0xA0
EEPROM_SIZE = 256

# Register blocks (constants.rs:239-246)
BLOCK_DEMOD = 0
BLOCK_USB = 1
BLOCK_SYS = 2
BLOCK_TUN = 3
BLOCK_ROM = 4
BLOCK_IRB = 5
BLOCK_IIC = 6

# Sys registers (constants.rs:248-261)
DEMOD_CTL = 0x3000
GPO = 0x3001
GPI = 0x3002
GPOE = 0x3003
GPD = 0x3004
SYSINTE = 0x3005
SYSINTS = 0x3006
GP_CFG0 = 0x3007
GP_CFG1 = 0x3008
SYSINTE_1 = 0x3009
SYSINTS_1 = 0x300A
DEMOD_CTL_1 = 0x300B
IR_SUSPEND = 0x300C

# USB registers (constants.rs:263-271)
USB_SYSCTL = 0x2000
USB_CTRL = 0x2010
USB_STAT = 0x2014
USB_EPA_CFG = 0x2144
USB_EPA_CTL = 0x2148
USB_EPA_MAXPKT = 0x2158
USB_EPA_MAXPKT_2 = 0x215A
USB_EPA_FIFO_CFG = 0x2160

# Control transfer request types (constants.rs:273-277)
LIBUSB_ENDPOINT_IN = 0x80
LIBUSB_ENDPOINT_OUT = 0x00
LIBUSB_REQUEST_TYPE_VENDOR = 0x40
CTRL_IN = LIBUSB_ENDPOINT_IN | LIBUSB_REQUEST_TYPE_VENDOR  # 0xC0
CTRL_OUT = LIBUSB_ENDPOINT_OUT | LIBUSB_REQUEST_TYPE_VENDOR  # 0x40
CTRL_TIMEOUT_MS = 300

BULK_IQ_ENDPOINT = 0x81  # I/Q sample stream endpoint (ref device/mod.rs:141-143)
