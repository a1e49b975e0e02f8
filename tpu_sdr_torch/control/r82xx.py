"""Rafael Micro R820T / R828D tuner driver.

Python re-implementation of the tuner control logic in
the reference's src/tuners/r82xx.rs: PLL programming with the mix-divider
search and SDM fractional calculator (r82xx.rs:681-807), the 21-band RF
mux/tracking-filter table (r82xx.rs:77-267, 642-679), the LNA/mixer gain
ladder (r82xx.rs:416-463), IF low-pass bandwidth selection (r82xx.rs:543-604),
TV-standard setup with the filter-calibration loop (r82xx.rs:966-1055),
system-frequency AGC setup (r82xx.rs:809-964), the RTL-SDR Blog V4
upconverter/notch/input switching (r82xx.rs:465-541), and the write-only
register cache with masked writes (r82xx.rs:1089-1157).

The reference gates Blog-mod register tweaks behind the ``rtl_sdr_blog``
cargo feature (Cargo.toml:12-15); here that is the runtime flag
``blog_mod``.
"""

from __future__ import annotations

from dataclasses import dataclass

from tpu_sdr_torch.control.tuner import Tuner, TunerInfo
from tpu_sdr_torch.errors import PllError

R820T_I2C_ADDR = 0x34
R828D_I2C_ADDR = 0x74
R828D_XTAL_FREQ = 16_000_000
VER_NUM = 49
R82XX_IF_FREQ = 3_570_000
NUM_REGS = 32
RW_REG_START = 5  # registers 0-4 are read-only status
NUM_CACHE_REGS = NUM_REGS - RW_REG_START
MAX_I2C_MSG_LEN = 8

R828D_INPUT_SWITCH_FREQ = 345_000_000
BLOG_V4_UPCONVERT_FREQ = 28_800_000
# Notch filters are OFF inside these bands, ON outside (r82xx.rs:22-26,484-491)
BLOG_V4_NOTCH_OFF_BANDS = ((0, 2_200_000), (85_000_000, 112_000_000),
                           (172_000_000, 242_000_000))
BLOG_V4_HF_MAX = 28_800_000
BLOG_V4_VHF_MAX = 250_000_000

R820T_TUNER_ID = "r820t"
R828D_TUNER_ID = "r828d"

R820T_TUNER_INFO = TunerInfo(
    id=R820T_TUNER_ID, name="Rafael Micro R820T",
    i2c_addr=0x34, check_addr=0x00, check_val=0x69,
)
R828D_TUNER_INFO = TunerInfo(
    id=R828D_TUNER_ID, name="Rafael Micro R828D",
    i2c_addr=0x74, check_addr=0x00, check_val=0x69,
)

# Power-on defaults for RW registers 0x05..0x1f (r82xx.rs:38-46)
REG_INIT = bytes([
    0x83, 0x32, 0x75,
    0xC0, 0x40, 0xD6, 0x6C,
    0xF5, 0x63, 0x75, 0x68,
    0x6C, 0x83, 0x80, 0x00,
    0x0F, 0x00, 0xC0, 0x30,
    0x48, 0xCC, 0x60, 0x00,
    0x54, 0xAE, 0x4A, 0xC0,
])

# Gain table in tenth-dB (r82xx.rs:53-56)
GAINS = [0, 9, 14, 27, 37, 77, 87, 125, 144, 157, 166, 197, 207, 229, 254,
         280, 297, 328, 338, 364, 372, 386, 402, 421, 434, 439, 445, 480, 496]

LNA_GAIN_STEPS = [0, 9, 13, 40, 38, 13, 31, 22, 26, 31, 26, 14, 19, 5, 35, 13]
MIXER_GAIN_STEPS = [0, 5, 10, 10, 19, 9, 10, 25, 17, 10, 8, 16, 13, 6, 3, -8]


@dataclass(frozen=True)
class FreqRange:
    """One row of the RF mux band table (r82xx.rs:67-75)."""

    mhz: int
    open_d: int
    rf_mux_ploy: int
    tf_c: int
    xtal_cap20p: int
    xtal_cap10p: int
    xtal_cap0p: int


# (start MHz, open_d, rf_mux_ploy, tf_c, cap20p, cap10p, cap0p) — r82xx.rs:77-267
_RANGES = [
    (0,   0x08, 0x02, 0xDF, 0x02, 0x01, 0x00),
    (50,  0x08, 0x02, 0xBE, 0x02, 0x01, 0x00),
    (55,  0x08, 0x02, 0x8B, 0x02, 0x01, 0x00),
    (60,  0x08, 0x02, 0x7B, 0x02, 0x01, 0x00),
    (65,  0x08, 0x02, 0x69, 0x02, 0x01, 0x00),
    (70,  0x08, 0x02, 0x58, 0x02, 0x01, 0x00),
    (75,  0x00, 0x02, 0x44, 0x02, 0x01, 0x00),
    (80,  0x00, 0x02, 0x44, 0x02, 0x01, 0x00),
    (90,  0x00, 0x02, 0x34, 0x01, 0x01, 0x00),
    (100, 0x00, 0x02, 0x34, 0x01, 0x01, 0x00),
    (110, 0x00, 0x02, 0x24, 0x01, 0x01, 0x00),
    (120, 0x00, 0x02, 0x24, 0x01, 0x01, 0x00),
    (140, 0x00, 0x02, 0x14, 0x01, 0x01, 0x00),
    (180, 0x00, 0x02, 0x13, 0x00, 0x00, 0x00),
    (220, 0x00, 0x02, 0x13, 0x00, 0x00, 0x00),
    (250, 0x00, 0x02, 0x11, 0x00, 0x00, 0x00),
    (280, 0x00, 0x02, 0x00, 0x00, 0x00, 0x00),
    (310, 0x00, 0x41, 0x00, 0x00, 0x00, 0x00),
    (450, 0x00, 0x41, 0x00, 0x00, 0x00, 0x00),
    (588, 0x00, 0x40, 0x00, 0x00, 0x00, 0x00),
    (650, 0x00, 0x40, 0x00, 0x00, 0x00, 0x00),
]
FREQ_RANGES = tuple(FreqRange(*row) for row in _RANGES)

# Xtal capacitor selection values (r82xx.rs:287-293)
XTAL_LOW_CAP_30P = "low30"
XTAL_LOW_CAP_20P = "low20"
XTAL_LOW_CAP_10P = "low10"
XTAL_LOW_CAP_0P = "low0"
XTAL_HIGH_CAP_0P = "high0"

IF_LOW_PASS_BW_TABLE = [1_700_000, 1_600_000, 1_550_000, 1_450_000, 1_200_000,
                        900_000, 700_000, 550_000, 450_000, 350_000]
FILT_HP_BW1 = 350_000
FILT_HP_BW2 = 380_000


def bit_reverse(byte: int) -> int:
    """The R82xx serializes register reads MSB-first (r82xx.rs:1160-1165)."""
    lut = [0x0, 0x8, 0x4, 0xC, 0x2, 0xA, 0x6, 0xE,
           0x1, 0x9, 0x5, 0xD, 0x3, 0xB, 0x7, 0xF]
    return (lut[byte & 0xF] << 4) | lut[byte >> 4]


class R82xx(Tuner):
    """Driver state: the write-only register cache plus tuning bookkeeping
    (r82xx.rs:310-325)."""

    def __init__(self, info: TunerInfo, chip: str, is_blog_v4: bool = False,
                 blog_mod: bool = False):
        assert chip in (R820T_TUNER_ID, R828D_TUNER_ID)
        self.info = info
        self.chip = chip
        self.is_blog_v4 = is_blog_v4
        self.blog_mod = blog_mod
        self.regs = bytearray(REG_INIT)
        self.int_freq = 0
        self.xtal_cap_sel = XTAL_LOW_CAP_30P
        self.xtal = 0
        self.use_predetect = False
        self.has_lock = False
        self.fil_cal_code = 0
        self.init_done = False
        self.i2c_addr = R820T_I2C_ADDR if chip == R820T_TUNER_ID else R828D_I2C_ADDR
        self.last_input_sel: str | None = None

    @classmethod
    def new_r820t(cls, blog_mod: bool = False) -> "R82xx":
        return cls(R820T_TUNER_INFO, R820T_TUNER_ID, False, blog_mod)

    @classmethod
    def new_r828d(cls, is_blog_v4: bool, blog_mod: bool = False) -> "R82xx":
        return cls(R828D_TUNER_INFO, R828D_TUNER_ID, is_blog_v4, blog_mod)

    # -- Tuner interface ---------------------------------------------------

    def init(self, handle) -> None:
        """Bring-up: defaults, TV standard (incl. filter calibration), AGC
        clocks (r82xx.rs:379-399)."""
        self.use_predetect = False
        self.last_input_sel = None
        self.xtal_cap_sel = XTAL_HIGH_CAP_0P
        self.write_regs(handle, 0x05, REG_INIT)
        self.set_tv_standard(handle)
        self.sysfreq_sel(handle, 0)
        self.init_done = True

    def get_info(self) -> TunerInfo:
        return self.info

    def get_gains(self) -> list[int]:
        return list(GAINS)

    def read_gain(self, handle) -> int:
        """Gain readout from status reg 3 (r82xx.rs:409-414)."""
        data = self.read_reg(handle, 0x00, 4)
        return ((data[3] & 0x0F) << 1) + ((data[3] & 0xF0) >> 4)

    def set_gain(self, handle, gain) -> None:
        """Auto or manual gain; manual walks the LNA/mixer ladder
        (r82xx.rs:416-463).  ``gain`` is TunerGain-like: ``None`` for auto or
        an int in tenth-dB."""
        if gain is None:
            self.write_reg_mask(handle, 0x05, 0x00, 0x10)  # LNA auto
            self.write_reg_mask(handle, 0x07, 0x10, 0x10)  # mixer auto
            self.write_reg_mask(handle, 0x0C, 0x0B, 0x9F)  # fixed VGA 26.5 dB
            return
        self.write_reg_mask(handle, 0x05, 0x10, 0x10)  # LNA auto off
        self.write_reg_mask(handle, 0x07, 0x00, 0x10)  # mixer auto off
        self.read_reg(handle, 0x00, 4)
        self.write_reg_mask(handle, 0x0C, 0x08, 0x9F)  # fixed VGA 16.3 dB
        total, lna_index, mix_index = 0, 0, 0
        for _ in range(15):
            if total >= gain:
                break
            lna_index += 1
            total += LNA_GAIN_STEPS[lna_index]
            if total >= gain:
                break
            mix_index += 1
            total += MIXER_GAIN_STEPS[mix_index]
        self.write_reg_mask(handle, 0x05, lna_index, 0x0F)
        self.write_reg_mask(handle, 0x07, mix_index, 0x0F)

    def set_freq(self, handle, freq: int) -> None:
        """Retune: optional Blog-V4 upconversion, RF mux band, PLL, and the
        R828D input-switching logic (r82xx.rs:465-541)."""
        upconverted = freq
        if self.is_blog_v4 and self.chip == R828D_TUNER_ID and freq < BLOG_V4_UPCONVERT_FREQ:
            upconverted = freq + BLOG_V4_UPCONVERT_FREQ
        lo_freq = upconverted + self.int_freq
        self.set_mux(handle, lo_freq)
        self.set_pll(handle, lo_freq)

        if self.chip != R828D_TUNER_ID:
            return
        if self.is_blog_v4:
            in_notch_band = any(lo <= freq <= hi for lo, hi in BLOG_V4_NOTCH_OFF_BANDS)
            self.write_reg_mask(handle, 0x17, 0x00 if in_notch_band else 0x08, 0x08)
            if freq <= BLOG_V4_HF_MAX:
                sel = "cable2"
            elif freq <= BLOG_V4_VHF_MAX:
                sel = "cable1"
            else:
                sel = "air"
            if self.last_input_sel != sel:
                cable2_in, cable1_in, air_in = {
                    "cable2": (0x08, 0x00, 0x20),
                    "cable1": (0x00, 0x40, 0x20),
                    "air": (0x00, 0x00, 0x00),
                }[sel]
                self.write_reg_mask(handle, 0x06, cable2_in, 0x08)
                self.write_reg_mask(handle, 0x05, cable1_in, 0x40)
                self.write_reg_mask(handle, 0x05, air_in, 0x20)
                self.last_input_sel = sel
        else:
            sel = "cable1" if freq <= R828D_INPUT_SWITCH_FREQ else "air"
            if self.last_input_sel != sel:
                self.write_reg_mask(handle, 0x05, 0x60 if sel == "cable1" else 0x00, 0x60)
                self.last_input_sel = sel

    def set_bandwidth(self, handle, bw: int, rate: int) -> None:
        """IF filter corner selection; updates ``int_freq`` as the filter
        centers move (r82xx.rs:543-604)."""
        if bw > 7_000_000:  # 8 MHz
            self.int_freq = 4_570_000
            reg_0a, reg_0b = 0x10, 0x0B
        elif bw > 6_000_000:  # 7 MHz
            self.int_freq = 4_570_000
            reg_0a, reg_0b = 0x10, 0x2A
        elif bw > IF_LOW_PASS_BW_TABLE[0] + FILT_HP_BW1 + FILT_HP_BW2:  # 6 MHz
            self.int_freq = 3_570_000
            reg_0a, reg_0b = 0x10, 0x6B
        else:
            self.int_freq = 2_300_000
            reg_0a, reg_0b = 0x00, 0x80
            real_bw = 0
            if bw > IF_LOW_PASS_BW_TABLE[0] + FILT_HP_BW1:
                bw -= FILT_HP_BW2
                self.int_freq += FILT_HP_BW2
                real_bw += FILT_HP_BW2
            else:
                reg_0b |= 0x20
            if bw > IF_LOW_PASS_BW_TABLE[0]:
                bw -= FILT_HP_BW1
                self.int_freq += FILT_HP_BW1
                real_bw += FILT_HP_BW1
            else:
                reg_0b |= 0x40
            # Want the element before the first entry lower than bw
            lp_idx = 0
            for i, corner in enumerate(IF_LOW_PASS_BW_TABLE):
                if bw > corner:
                    break
                lp_idx = i
            reg_0b |= 15 - lp_idx
            real_bw += IF_LOW_PASS_BW_TABLE[lp_idx]
            self.int_freq -= real_bw // 2
        self.write_reg_mask(handle, 0x0A, reg_0a, 0x10)
        self.write_reg_mask(handle, 0x0B, reg_0b, 0xEF)

    def get_if_freq(self) -> int:
        return self.int_freq

    def get_xtal_freq(self) -> int:
        return self.xtal

    def set_xtal_freq(self, freq: int) -> None:
        self.xtal = freq

    def exit(self, handle) -> None:
        """Standby register sequence (r82xx.rs:619-636)."""
        if not self.init_done:
            return
        for reg, val in ((0x06, 0xB1), (0x05, 0xA0), (0x07, 0x3A), (0x08, 0x40),
                         (0x09, 0xC0), (0x0A, 0x36), (0x0C, 0x35), (0x0F, 0x68),
                         (0x11, 0x03), (0x17, 0xF4), (0x19, 0x0C)):
            self.write_regs(handle, reg, bytes([val]))

    # -- tuning internals --------------------------------------------------

    def set_mux(self, handle, freq: int) -> None:
        """Program open-drain, RF mux/polymux, tracking-filter band, and
        xtal cap for the band containing ``freq`` (r82xx.rs:642-679)."""
        freq_mhz = freq // 1_000_000
        rng = FREQ_RANGES[0]
        for candidate in FREQ_RANGES:
            if freq_mhz < candidate.mhz:
                break
            rng = candidate
        self.write_reg_mask(handle, 0x17, rng.open_d, 0x08)
        self.write_reg_mask(handle, 0x1A, rng.rf_mux_ploy, 0xC3)
        self.write_regs(handle, 0x1B, bytes([rng.tf_c]))
        if self.xtal_cap_sel in (XTAL_LOW_CAP_30P, XTAL_LOW_CAP_20P):
            val = rng.xtal_cap20p | 0x08
        elif self.xtal_cap_sel == XTAL_LOW_CAP_10P:
            val = rng.xtal_cap10p | 0x08
        elif self.xtal_cap_sel == XTAL_HIGH_CAP_0P:
            val = rng.xtal_cap0p
        else:
            val = rng.xtal_cap0p | 0x08
        self.write_reg_mask(handle, 0x10, val, 0x0B)
        self.write_reg_mask(handle, 0x08, 0x00, 0x3F)
        self.write_reg_mask(handle, 0x09, 0x00, 0x3F)

    def set_pll(self, handle, freq: int) -> None:
        """PLL programming: mix-divider search over the VCO range, integer
        divider registers, SDM fractional calculator, and the two-attempt
        lock check with a VCO current bump (r82xx.rs:681-807)."""
        freq_khz = (freq + 500) // 1000
        pll_ref = self.xtal
        pll_ref_khz = (self.xtal + 500) // 1000

        self.write_reg_mask(handle, 0x10, 0x00, 0x10)  # refdiv2 off
        self.write_reg_mask(handle, 0x1A, 0x00, 0x0C)  # autotune 128 kHz
        self._set_vco_current(handle)

        vco_min = 1_770_000  # kHz
        vco_max = vco_min * 2
        mix_div, div_num = 2, 0
        while mix_div <= 64:
            if vco_min <= freq_khz * mix_div < vco_max:
                div_buf = mix_div
                while div_buf > 2:
                    div_buf >>= 1
                    div_num += 1
                break
            mix_div <<= 1

        data = self.read_reg(handle, 0x00, 5)
        vco_power_ref = 1 if self.chip == R828D_TUNER_ID else 2
        vco_fine_tune = (data[4] & 0x30) >> 4
        if vco_fine_tune > vco_power_ref:
            div_num -= 1
        elif vco_fine_tune < vco_power_ref:
            div_num += 1
        self.write_reg_mask(handle, 0x10, (div_num << 5) & 0xFF, 0xE0)

        vco_freq = freq * mix_div
        nint = vco_freq // (2 * pll_ref)
        vco_fra = (vco_freq - 2 * pll_ref * nint) // 1000  # kHz

        if nint > (128 // vco_power_ref) - 1:
            raise PllError(f"[R82xx] No valid PLL values for {freq} Hz!")

        # Nint = 4*Ni2c + Si2c + 13, with the same truncating division and
        # u8 wraparound the hardware expects for small nint
        # (r82xx.rs:747-759: e.g. nint 3 -> ni 254, si 254).
        q = nint - 13
        ni = (q // 4 if q >= 0 else -((-q) // 4)) & 0xFF
        si = (nint - 4 * ni - 13) & 0xFF
        self.write_regs(handle, 0x14, bytes([(ni + ((si << 6) & 0xFF)) & 0xFF]))

        if vco_fra == 0:
            self.write_reg_mask(handle, 0x12, 0x08, 0x08)  # sdm power down
        else:
            self.write_reg_mask(handle, 0x12, 0x00, 0x08)

        # SDM fractional calculator (r82xx.rs:768-782)
        sdm, n_sdm = 0, 2
        while vco_fra > 1:
            if vco_fra > 2 * pll_ref_khz // n_sdm:
                sdm += 32768 // (n_sdm // 2)
                vco_fra -= 2 * pll_ref_khz // n_sdm
                if n_sdm >= 0x8000:
                    break
            n_sdm <<= 1
        self.write_regs(handle, 0x16, bytes([(sdm >> 8) & 0xFF]))
        self.write_regs(handle, 0x15, bytes([sdm & 0xFF]))

        for attempt in range(2):
            data = self.read_reg(handle, 0x00, 3)
            if data[2] & 0x40:
                break
            if attempt == 0:
                self._set_vco_current(handle)  # didn't lock: bump current
        if not data[2] & 0x40:
            self.has_lock = False
            return
        self.has_lock = True
        self.write_reg_mask(handle, 0x1A, 0x08, 0x08)  # autotune 8 kHz

    def _set_vco_current(self, handle) -> None:
        """Blog mod uses max VCO current; stock uses the datasheet value
        (r82xx.rs:694-698,791-794)."""
        if self.blog_mod:
            self.write_reg_mask(handle, 0x12, 0x06, 0xFF)
        else:
            self.write_reg_mask(handle, 0x12, 0x80, 0xE0)

    def sysfreq_sel(self, handle, freq: int,
                    tuner_type: str = "digital_tv",
                    delivery_system: str = "dvbt") -> None:
        """AGC/top-point setup for a delivery system (r82xx.rs:809-964).

        The reference only ever calls this as (digital_tv, dvbt) — the
        defaults here — but carries the full per-system parameter tables
        and the analog-TV LNA path; both are kept so other standards stay
        one call away.  ``delivery_system``: dvbt | dvbt2 | isdbt |
        undefined (= DVB-T 8M).
        """
        hot_dvbt = (delivery_system == "dvbt"
                    and freq in (506_000_000, 666_000_000, 818_000_000))
        # Per-system AGC thresholds (r82xx.rs:827-884).  All systems share
        # lna_top 0xE5, mixer_vth_l 0x75, air/cable2 in 0, pre_dect 0x40,
        # lna_discharge 14, filter_cur 0x40; the rows differ only in the
        # mixer top / charge-pump current (hot DVB-T channels) and the LNA
        # detector threshold (ISDB-T).
        mixer_top, cp_cur = (0x14, 0x28) if hot_dvbt else (0x24, 0x38)
        lna_top = 0xE5
        lna_vth_l = 0x75 if delivery_system == "isdbt" else 0x53
        mixer_vth_l = 0x75
        air_cable1_in = 0x00
        cable2_in = 0x00
        pre_dect = 0x40
        lna_discharge = 14
        filter_cur = 0x40
        if self.blog_mod:
            # Blog mod: PLL dropout to 2.0 V for L-band (r82xx.rs:897-916)
            div_buf_cur = 0xA0
        else:
            div_buf_cur = 0x20 if hot_dvbt else 0x30

        if self.use_predetect:
            self.write_reg_mask(handle, 0x06, pre_dect, 0x40)
        self.write_reg_mask(handle, 0x1D, lna_top, 0xC7)
        self.write_reg_mask(handle, 0x1C, mixer_top, 0xF8)
        self.write_regs(handle, 0x0D, bytes([lna_vth_l]))
        self.write_regs(handle, 0x0E, bytes([mixer_vth_l]))
        self.write_reg_mask(handle, 0x05, air_cable1_in, 0x60)
        self.write_reg_mask(handle, 0x06, cable2_in, 0x08)
        self.write_reg_mask(handle, 0x11, cp_cur, 0x38)
        self.write_reg_mask(handle, 0x17, div_buf_cur, 0x30)
        self.write_reg_mask(handle, 0x0A, filter_cur, 0x60)
        if tuner_type != "analog_tv":
            # Digital-TV LNA path (r82xx.rs:922-944)
            self.write_reg_mask(handle, 0x1D, 0x00, 0x38)  # LNA TOP: lowest
            self.write_reg_mask(handle, 0x1C, 0x00, 0x04)  # normal mode
            self.write_reg_mask(handle, 0x06, 0x00, 0x40)  # PRE_DECT off
            self.write_reg_mask(handle, 0x1A, 0x30, 0x30)  # agc clk 250 Hz
            self.write_reg_mask(handle, 0x1D, 0x18, 0x38)  # LNA TOP = 3
            self.write_reg_mask(handle, 0x1C, mixer_top, 0x04)  # discharge
            self.write_reg_mask(handle, 0x1E, lna_discharge, 0x1F)
            self.write_reg_mask(handle, 0x1A, 0x20, 0x30)  # agc clk 60 Hz
        else:
            # Analog-TV LNA path (r82xx.rs:945-960)
            self.write_reg_mask(handle, 0x06, 0x00, 0x40)  # PRE_DECT off
            self.write_reg_mask(handle, 0x1D, lna_top, 0x38)
            self.write_reg_mask(handle, 0x1C, mixer_top, 0x04)  # discharge
            self.write_reg_mask(handle, 0x1E, lna_discharge, 0x1F)
            self.write_reg_mask(handle, 0x1A, 0x00, 0x30)  # agc clk 1 kHz
        self.write_reg_mask(handle, 0x10, lna_discharge, 0x04)

    def set_tv_standard(self, handle) -> None:
        """Fixed DVB-T <6 MHz standard: IF 3.57 MHz, filter calibration at
        56 MHz with retry, and the channel-filter register set
        (r82xx.rs:966-1055)."""
        if_khz = 3570
        filt_cal_lo = 56_000  # kHz
        filt_gain = 0x10
        img_r = 0x00
        filt_q = 0x10
        hp_cor = 0x6B
        ext_enable = 0x60
        loop_through = 0x01
        lt_att = 0x00
        flt_ext_widest = 0x00
        polyfil_cur = 0x60

        self.regs = bytearray(REG_INIT)
        self.write_reg_mask(handle, 0x0C, 0x00, 0x0F)
        self.write_reg_mask(handle, 0x13, VER_NUM, 0x3F)
        self.write_reg_mask(handle, 0x1D, 0x00, 0x38)  # LT gain test
        self.int_freq = if_khz * 1000

        for _ in range(2):  # filter calibration with one retry
            self.write_reg_mask(handle, 0x0B, hp_cor, 0x60)
            self.write_reg_mask(handle, 0x0F, 0x04, 0x04)  # cali clk on
            self.write_reg_mask(handle, 0x10, 0x00, 0x03)  # xtal cap 0 pF
            self.set_pll(handle, filt_cal_lo * 1000)
            self.write_reg_mask(handle, 0x0B, 0x10, 0x10)  # start trigger
            self.write_reg_mask(handle, 0x0B, 0x00, 0x04)  # stop trigger
            data = self.read_reg(handle, 0x00, 5)
            self.fil_cal_code = data[4] & 0x0F
            if self.fil_cal_code != 0x0F:
                break
            self.fil_cal_code = 0  # narrowest on repeated failure

        self.write_reg_mask(handle, 0x0A, filt_q | self.fil_cal_code, 0x1F)
        self.write_reg_mask(handle, 0x0B, hp_cor, 0xEF)
        self.write_reg_mask(handle, 0x07, img_r, 0x80)
        self.write_reg_mask(handle, 0x06, filt_gain, 0x30)
        self.write_reg_mask(handle, 0x1E, ext_enable, 0x60)
        self.write_reg_mask(handle, 0x05, loop_through, 0x80)
        self.write_reg_mask(handle, 0x1F, lt_att, 0x80)
        self.write_reg_mask(handle, 0x0F, flt_ext_widest, 0x80)
        self.write_reg_mask(handle, 0x19, polyfil_cur, 0x60)

    # -- register cache & I2C ---------------------------------------------

    def write_reg_mask(self, handle, reg: int, val: int, mask: int) -> None:
        """Masked write against the local cache (registers are write-only on
        the wire; r82xx.rs:1089-1095)."""
        cached = self.read_cache_reg(reg)
        applied = (cached & ~mask) | (val & mask)
        self.write_regs(handle, reg, bytes([applied & 0xFF]))

    def read_cache_reg(self, reg: int) -> int:
        assert RW_REG_START <= reg < NUM_REGS
        return self.regs[reg - RW_REG_START]

    def write_regs(self, handle, reg: int, val: bytes) -> None:
        """Cache then send over I2C in <=8-byte messages, first byte the
        register address (r82xx.rs:1109-1136)."""
        self._cache_store(reg, val)
        pos = 0
        while pos < len(val):
            size = min(len(val) - pos, MAX_I2C_MSG_LEN - 1)
            msg = bytes([reg + pos]) + val[pos : pos + size]
            handle.i2c_write(self.i2c_addr, msg)
            pos += size

    def read_reg(self, handle, reg: int, length: int) -> bytes:
        """Status read: address, read, bit-reverse each byte
        (r82xx.rs:1139-1148)."""
        handle.i2c_write(self.i2c_addr, bytes([reg]))
        raw = handle.i2c_read(self.i2c_addr, length)
        return bytes(bit_reverse(b) for b in raw)

    def _cache_store(self, reg: int, val: bytes) -> None:
        assert reg >= RW_REG_START
        idx = reg - RW_REG_START
        assert idx + len(val) <= NUM_CACHE_REGS
        self.regs[idx : idx + len(val)] = val
