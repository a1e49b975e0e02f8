"""Core RTL2832U control logic.

Python re-implementation of the reference's src/rtlsdr.rs: the boot
sequence (rtlsdr.rs:66-132), baseband init/deinit (rtlsdr.rs:413-475),
resampler-ratio sample-rate programming (rtlsdr.rs:217-265), IF/DDC
frequency programming (rtlsdr.rs:178-192), FIR coefficient packing
(rtlsdr.rs:525-558), direct sampling (rtlsdr.rs:292-348), GPIO/bias-tee
(rtlsdr.rs:361-363,486-514), I2C repeater bracketing (rtlsdr.rs:516-523)
and tuner probing (rtlsdr.rs:560-582).
"""

from __future__ import annotations

import logging

from tpu_sdr_torch.control import constants as C
from tpu_sdr_torch.control.r82xx import (
    R828D_XTAL_FREQ,
    R82XX_IF_FREQ,
    R820T_TUNER_ID,
    R828D_TUNER_ID,
    R82xx,
)
from tpu_sdr_torch.control.transport import Device
from tpu_sdr_torch.control.tuner import NoTuner, Tuner, known_tuners
from tpu_sdr_torch.errors import InvalidConfigError, RtlSdrError

log = logging.getLogger(__name__)

INTERFACE_ID = 0
DEF_RTL_XTAL_FREQ = 28_800_000
MIN_RTL_XTAL_FREQ = DEF_RTL_XTAL_FREQ - 1000
MAX_RTL_XTAL_FREQ = DEF_RTL_XTAL_FREQ + 1000

FIR_LEN = 16
# Default demod FIR: first 8 coefficients are i8, last 8 are i12
# (rtlsdr.rs:22-26).
DEFAULT_FIR = (-54, -36, -41, -40, -32, -14, 14, 53,
               101, 156, 215, 273, 327, 372, 404, 421)

# Direct-sampling modes (ref src/lib.rs:101-106)
DIRECT_SAMPLING_OFF = "off"
DIRECT_SAMPLING_ON = "on"
DIRECT_SAMPLING_ON_SWAP = "on_swap"


def pack_fir(fir) -> bytes:
    """Pack 8 i8 + 12... the 8 i12 coefficients into the 20-byte demod FIR
    register image (rtlsdr.rs:525-558)."""
    assert len(fir) == FIR_LEN
    tmp = bytearray(20)
    for i in range(8):
        v = fir[i]
        if not -128 <= v <= 127:
            raise InvalidConfigError(f"i8 FIR coefficient out of bounds: {v}")
        tmp[i] = v & 0xFF
    for i in range(0, 8, 2):
        v0, v1 = fir[8 + i], fir[8 + i + 1]
        for v in (v0, v1):
            if not -2048 <= v <= 2047:
                raise InvalidConfigError(f"i12 FIR coefficient out of bounds: {v}")
        tmp[8 + i * 3 // 2] = (v0 >> 4) & 0xFF
        tmp[8 + i * 3 // 2 + 1] = ((v0 << 4) | ((v1 >> 8) & 0x0F)) & 0xFF
        tmp[8 + i * 3 // 2 + 2] = v1 & 0xFF
    return bytes(tmp)


class SdrCore:
    """Chip-level state and orchestration (ref rtlsdr::RtlSdr,
    rtlsdr.rs:28-64)."""

    def __init__(self, handle: Device, blog_mod: bool = False):
        self.handle = handle
        self.tuner: Tuner = NoTuner()
        self.freq = 0
        self.rate = 0
        self.bw = 0
        self.ppm_correction = 0
        self.xtal = DEF_RTL_XTAL_FREQ
        self.tuner_xtal = DEF_RTL_XTAL_FREQ
        self.direct_sampling = DIRECT_SAMPLING_OFF
        self.offset_freq = 0
        self.corr = 0
        self.force_bt = False
        self.force_ds = False
        self.fir = tuple(DEFAULT_FIR)
        self.blog_mod = blog_mod

    # -- bring-up ----------------------------------------------------------

    def init(self) -> None:
        """Full boot sequence (rtlsdr.rs:66-132)."""
        self.handle.claim_interface(INTERFACE_ID)
        self.handle.test_write()
        self.init_baseband()
        self.set_i2c_repeater(True)

        manufact, product, _serial = (None, None, None)
        try:
            manufact, product, _serial = self.handle.usb_strings()
        except RtlSdrError:
            pass
        is_blog_v4 = manufact == "RTLSDRBlog" and product == "Blog V4"

        tuner_id = self.search_tuner()
        if tuner_id is None:
            raise RtlSdrError("Failed to find tuner, aborting")
        log.info("Got tuner ID %s", tuner_id)

        if tuner_id == R820T_TUNER_ID:
            self.tuner = R82xx.new_r820t(blog_mod=self.blog_mod)
        elif tuner_id == R828D_TUNER_ID:
            self.tuner = R82xx.new_r828d(is_blog_v4, blog_mod=self.blog_mod)
        else:
            raise RtlSdrError("Unable to find recognized tuner")

        # Plain R828D uses a 16 MHz tuner crystal; Blog V4 keeps 28.8 MHz
        # (rtlsdr.rs:97-100).
        if tuner_id == R828D_TUNER_ID and not is_blog_v4:
            self.tuner_xtal = R828D_XTAL_FREQ
        else:
            self.tuner_xtal = self.xtal
        self.tuner.set_xtal_freq(self.get_tuner_xtal_freq())

        self.handle.demod_write_reg(1, 0xB1, 0x1A, 1)  # disable Zero-IF
        self.handle.demod_write_reg(0, 0x08, 0x4D, 1)  # I-ADC input only
        self.set_if_freq(R82XX_IF_FREQ)  # R82xx DVB-T 6 MHz IF
        self.handle.demod_write_reg(1, 0x15, 0x01, 1)  # spectrum inversion

        # EEPROM byte 7 hack bits: IR-endpoint=0 forces bias-tee on;
        # remote-enable=1 forces direct sampling (rtlsdr.rs:118-124).
        eeprom = self.handle.read_eeprom(0, C.EEPROM_SIZE)
        self.force_bt = (eeprom[7] & 0x02) == 0
        self.force_ds = (eeprom[7] & 0x01) != 0

        log.info("Init tuner")
        self.tuner.init(self.handle)
        self.set_i2c_repeater(False)
        log.info("Init complete")

    def init_baseband(self) -> None:
        """USB endpoint config, demod power-on, soft reset, FIR, SDR mode,
        AGC/PID disable (rtlsdr.rs:413-464)."""
        h = self.handle
        h.write_reg(C.BLOCK_USB, C.USB_SYSCTL, 0x09, 1)
        h.write_reg(C.BLOCK_USB, C.USB_EPA_MAXPKT, 0x0002, 2)
        h.write_reg(C.BLOCK_USB, C.USB_EPA_CTL, 0x1002, 2)
        h.write_reg(C.BLOCK_SYS, C.DEMOD_CTL_1, 0x22, 1)
        h.write_reg(C.BLOCK_SYS, C.DEMOD_CTL, 0xE8, 1)
        h.reset_demod()
        h.demod_write_reg(1, 0x15, 0x00, 1)  # no spectrum inversion
        h.demod_write_reg(1, 0x16, 0x00, 2)  # channel rejection
        for i in range(5):  # clear DDC shift and IF registers
            h.demod_write_reg(1, 0x16 + i, 0x00, 1)
        self.set_fir(DEFAULT_FIR)
        h.demod_write_reg(0, 0x19, 0x05, 1)  # SDR mode, DAGC off
        h.demod_write_reg(1, 0x93, 0xF0, 1)  # FSM init
        h.demod_write_reg(1, 0x94, 0x0F, 1)
        h.demod_write_reg(1, 0x11, 0x00, 1)  # en_dagc off
        h.demod_write_reg(1, 0x04, 0x00, 1)  # RF/IF AGC loop off
        h.demod_write_reg(0, 0x61, 0x60, 1)  # PID filter off
        h.demod_write_reg(0, 0x06, 0x80, 1)  # default ADC datapath
        h.demod_write_reg(1, 0xB1, 0x1B, 1)  # Zero-IF, DC cancel, IQ comp
        h.demod_write_reg(0, 0x0D, 0x83, 1)  # no 4.096 MHz clock out

    def deinit_baseband(self) -> None:
        """Tuner standby + demod power-off (rtlsdr.rs:466-475)."""
        self.set_i2c_repeater(True)
        self.tuner.exit(self.handle)
        self.set_i2c_repeater(False)
        self.handle.write_reg(C.BLOCK_SYS, C.DEMOD_CTL, 0x20, 1)

    # -- configuration -----------------------------------------------------

    def set_fir(self, fir) -> None:
        packed = pack_fir(fir)
        for i, b in enumerate(packed):
            self.handle.demod_write_reg(1, 0x1C + i, b, 1)

    def reset_buffer(self) -> None:
        """Mandatory endpoint reset before streaming (rtlsdr.rs:155-159)."""
        self.handle.write_reg(C.BLOCK_USB, C.USB_EPA_CTL, 0x1002, 2)
        self.handle.write_reg(C.BLOCK_USB, C.USB_EPA_CTL, 0x0000, 2)

    def get_center_freq(self) -> int:
        return self.freq

    def set_center_freq(self, freq: int) -> None:
        """Retune via tuner PLL, or via the DDC when direct sampling
        (rtlsdr.rs:165-176)."""
        if self.direct_sampling != DIRECT_SAMPLING_OFF:
            self.set_if_freq(freq)
        else:
            self.set_i2c_repeater(True)
            try:
                self.tuner.set_freq(self.handle, freq - self.offset_freq)
            finally:
                self.set_i2c_repeater(False)
        self.freq = freq

    def set_if_freq(self, freq: int) -> None:
        """Program the DDC IF registers (rtlsdr.rs:178-192)."""
        base = 1 << 22
        if_freq = -int(freq * base / DEF_RTL_XTAL_FREQ)
        self.handle.demod_write_reg(1, 0x19, (if_freq >> 16) & 0x3F, 1)
        self.handle.demod_write_reg(1, 0x1A, (if_freq >> 8) & 0xFF, 1)
        self.handle.demod_write_reg(1, 0x1B, if_freq & 0xFF, 1)

    def get_freq_correction(self) -> int:
        return self.corr

    def set_freq_correction(self, ppm: int) -> None:
        """PPM correction: resampler offset + tuner xtal + retune
        (rtlsdr.rs:198-211)."""
        if self.corr == ppm:
            return
        self.corr = ppm
        self.set_sample_freq_correction(ppm)
        self.tuner.set_xtal_freq(self.get_tuner_xtal_freq())
        self.set_center_freq(self.freq)

    def set_sample_freq_correction(self, ppm: int) -> None:
        offs = int(-ppm * (1 << 24) / 1_000_000)
        self.handle.demod_write_reg(1, 0x3F, offs & 0xFF, 1)
        self.handle.demod_write_reg(1, 0x3E, (offs >> 8) & 0x3F, 1)

    def get_sample_rate(self) -> int:
        return self.rate

    def set_sample_rate(self, rate: int) -> None:
        """Resampler-ratio programming with the exact-rate back-computation
        (rtlsdr.rs:217-265)."""
        if rate <= 225_000 or rate > 3_200_000 or (300_000 < rate <= 900_000):
            raise InvalidConfigError(f"Invalid sample rate: {rate} Hz")

        rsamp_ratio = (self.xtal * (1 << 22) // rate) & 0x0FFFFFFC
        real_resamp_ratio = rsamp_ratio | ((rsamp_ratio & 0x08000000) << 1)
        real_rate = (self.xtal * (1 << 22)) / real_resamp_ratio
        if rate != real_rate:
            log.info("Exact sample rate is %s Hz", real_rate)
        self.rate = int(real_rate)

        self.set_i2c_repeater(True)
        try:
            self.tuner.set_bandwidth(
                self.handle, self.bw if self.bw > 0 else self.rate, self.rate
            )
        finally:
            self.set_i2c_repeater(False)
        if self._tuner_is_r82xx():
            self.set_if_freq(self.tuner.get_if_freq())
            self.set_center_freq(self.freq)

        self.handle.demod_write_reg(1, 0x9F, (rsamp_ratio >> 16) & 0xFFFF, 2)
        self.handle.demod_write_reg(1, 0xA1, rsamp_ratio & 0xFFFF, 2)
        self.set_sample_freq_correction(self.corr)
        self.handle.reset_demod()
        if self.offset_freq != 0:
            self.set_offset_tuning(True)

    def set_tuner_bandwidth(self, bw: int) -> None:
        """(rtlsdr.rs:267-278)"""
        bw = bw if bw > 0 else self.rate
        self.set_i2c_repeater(True)
        try:
            self.tuner.set_bandwidth(self.handle, bw, self.rate)
        finally:
            self.set_i2c_repeater(False)
        if self._tuner_is_r82xx():
            self.set_if_freq(self.tuner.get_if_freq())
            self.set_center_freq(self.freq)
        self.bw = bw

    def get_tuner_gains(self) -> list[int]:
        return self.tuner.get_gains()

    def read_tuner_gain(self) -> int:
        self.set_i2c_repeater(True)
        try:
            return self.tuner.read_gain(self.handle)
        finally:
            self.set_i2c_repeater(False)

    def set_tuner_gain(self, gain) -> None:
        """``gain`` is None for auto, else tenth-dB (ref TunerGain,
        rtlsdr.rs:146-151)."""
        self.set_i2c_repeater(True)
        try:
            self.tuner.set_gain(self.handle, gain)
        finally:
            self.set_i2c_repeater(False)

    def set_testmode(self, on: bool) -> None:
        """On-chip counter test pattern (rtlsdr.rs:280-290)."""
        self.handle.demod_write_reg(0, 0x19, 0x03 if on else 0x05, 1)

    def set_direct_sampling(self, mode: str) -> None:
        """Route the ADC directly, bypassing the tuner (rtlsdr.rs:292-348)."""
        if self.force_ds:
            mode = DIRECT_SAMPLING_ON_SWAP
        if mode in (DIRECT_SAMPLING_ON, DIRECT_SAMPLING_ON_SWAP):
            self.set_i2c_repeater(True)
            self.tuner.exit(self.handle)
            self.set_i2c_repeater(False)
            self.handle.demod_write_reg(1, 0xB1, 0x1A, 1)  # Zero-IF off
            self.handle.demod_write_reg(1, 0x15, 0x00, 1)  # inversion off
            self.handle.demod_write_reg(0, 0x08, 0x4D, 1)  # I-ADC only
            if mode == DIRECT_SAMPLING_ON_SWAP:
                self.handle.demod_write_reg(0, 0x06, 0x90, 1)
                log.info("Enabled direct sampling mode: ON (swapped)")
            else:
                self.handle.demod_write_reg(0, 0x06, 0x80, 1)
                log.info("Enabled direct sampling mode: ON")
            self.direct_sampling = mode
        else:
            self.set_i2c_repeater(True)
            self.tuner.init(self.handle)
            self.set_i2c_repeater(False)
            if not self._tuner_is_r82xx():
                self.set_if_freq(0)
                self.handle.demod_write_reg(0, 0x08, 0xCD, 1)  # I+Q ADC
                self.handle.demod_write_reg(1, 0xB1, 0x1B, 1)  # Zero-IF on
            self.handle.demod_write_reg(0, 0x06, 0x80, 1)
            log.info("Disabled direct sampling mode")
            self.direct_sampling = DIRECT_SAMPLING_OFF
        self.set_center_freq(self.freq)

    def set_offset_tuning(self, enable: bool) -> None:
        """Blog hack: "offset tuning" toggles the bias tee GPIO
        (rtlsdr.rs:350-359); a no-op without the blog mod."""
        if self.blog_mod:
            self.set_gpio(0, enable)

    def set_bias_tee(self, on: bool) -> None:
        self.set_gpio(0, on)

    def get_xtal_freq(self) -> int:
        return int(self.xtal * (1.0 + self.ppm_correction / 1e6))

    def get_tuner_xtal_freq(self) -> int:
        return int(self.tuner_xtal * (1.0 + self.ppm_correction / 1e6))

    def set_xtal_freq(self, rtl_freq: int, tuner_freq: int) -> None:
        """(rtlsdr.rs:375-407)"""
        if rtl_freq > 0 and not (MIN_RTL_XTAL_FREQ <= rtl_freq <= MAX_RTL_XTAL_FREQ):
            raise InvalidConfigError(
                f"set_xtal_freq error: rtl_freq {rtl_freq} out of bounds"
            )
        if rtl_freq > 0 and self.xtal != rtl_freq:
            self.xtal = rtl_freq
            if self.rate != 0:
                self.set_sample_rate(self.rate)
        if self.tuner.get_xtal_freq() != tuner_freq:
            self.tuner_xtal = self.xtal if tuner_freq == 0 else tuner_freq
            self.tuner.set_xtal_freq(self.get_tuner_xtal_freq())
            if self.freq != 0:
                self.set_center_freq(self.freq)

    # -- streaming ---------------------------------------------------------

    def read_sync(self, length: int) -> bytes:
        return self.handle.bulk_transfer(length)

    # -- internals ---------------------------------------------------------

    def set_gpio(self, pin: int, on: bool) -> None:
        """(rtlsdr.rs:486-514); EEPROM force_bt pins the bias tee on."""
        if self.force_bt:
            on = True
        mask = 1 << pin
        h = self.handle
        r = h.read_reg(C.BLOCK_SYS, C.GPD, 1)
        h.write_reg(C.BLOCK_SYS, C.GPD, r & ~mask & 0xFFFF, 1)
        r = h.read_reg(C.BLOCK_SYS, C.GPOE, 1)
        h.write_reg(C.BLOCK_SYS, C.GPOE, r | mask, 1)
        r = h.read_reg(C.BLOCK_SYS, C.GPO, 1)
        r = (r | mask) if on else (r & ~mask & 0xFFFF)
        h.write_reg(C.BLOCK_SYS, C.GPO, r, 1)

    def set_i2c_repeater(self, enable: bool) -> None:
        """Bracket around every tuner I2C access (rtlsdr.rs:516-523)."""
        self.handle.demod_write_reg(1, 0x01, 0x18 if enable else 0x10, 1)

    def search_tuner(self) -> str | None:
        """Probe each known tuner's check register (rtlsdr.rs:560-582)."""
        for info in known_tuners():
            try:
                val = self.handle.i2c_read_reg(info.i2c_addr, info.check_addr)
            except RtlSdrError as e:
                log.error("Reading failed, continuing. Err: %s", e)
                continue
            if val == info.check_val:
                return info.id
        return None

    def _tuner_is_r82xx(self) -> bool:
        return self.tuner.get_info().id in (R820T_TUNER_ID, R828D_TUNER_ID)

    def get_tuner_id(self) -> str:
        return self.tuner.get_info().id
