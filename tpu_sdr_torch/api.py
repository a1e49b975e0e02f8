"""Public API facade — mirrors the reference's ``lib.rs`` surface.

Everything a user of the reference crate (src/lib.rs) could
reach exists here with the same semantics: open by Index/Serial/Fd,
enumeration, all config getters/setters, the sensor API, and sync reads.
Open resolves against both real USB hardware (libusb backend, opt-in) and
registered fake devices (register-level simulator), in one index space.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from enum import Enum
from typing import Union

from tpu_sdr_torch import DEFAULT_BUF_LENGTH  # noqa: F401 (re-exported)
from tpu_sdr_torch.control import fake as fake_mod
from tpu_sdr_torch.control import rtlsdr as core_mod
from tpu_sdr_torch.control.transport import Device
from tpu_sdr_torch.control.usb import DeviceDescriptor, LibusbBackend, real_hardware_enabled
from tpu_sdr_torch.errors import DeviceNotFoundError, RtlSdrError, UsbError


class TunerId:
    """(ref src/lib.rs:19-23)"""

    R820T = "r820t"
    R828D = "r828d"


@dataclass(frozen=True)
class DeviceId:
    """Open-by Index / Serial / Fd selector (ref src/lib.rs:89-94)."""

    kind: str
    value: Union[int, str]

    @staticmethod
    def index(idx: int) -> "DeviceId":
        return DeviceId("index", idx)

    @staticmethod
    def serial(serial: str) -> "DeviceId":
        return DeviceId("serial", serial)

    @staticmethod
    def fd(fd: int) -> "DeviceId":
        return DeviceId("fd", fd)


class TunerGain:
    """Auto or Manual(tenth-dB) (ref src/lib.rs:96-100)."""

    AUTO = None

    @staticmethod
    def manual(tenth_db: int) -> int:
        return tenth_db


class DirectSampleMode(str, Enum):
    """(ref src/lib.rs:101-106)"""

    OFF = core_mod.DIRECT_SAMPLING_OFF
    ON = core_mod.DIRECT_SAMPLING_ON
    ON_SWAP = core_mod.DIRECT_SAMPLING_ON_SWAP


class Sensor(str, Enum):
    """(ref src/lib.rs:108-113)"""

    TUNER_TYPE = "tuner_type"
    TUNER_GAIN_DB = "tuner_gain_db"
    FREQUENCY_CORRECTION_PPM = "frequency_correction_ppm"


@dataclass(frozen=True)
class SensorValue:
    """(ref src/lib.rs:115-120)"""

    sensor: Sensor
    value: Union[str, int]


def _auto_fake_count() -> int:
    try:
        return int(os.environ.get("TPU_SDR_FAKE_DEVICES", "0"))
    except ValueError:
        return 0


def _ensure_auto_fakes() -> None:
    want = _auto_fake_count()
    have = len(fake_mod.fake_devices())
    for _ in range(max(0, want - have)):
        fake_mod.register_fake_device()


def list_devices() -> list[DeviceDescriptor]:
    """Enumerate devices: real hardware first (when enabled), then fakes,
    in one contiguous index space (ref DeviceDescriptors::iter,
    src/lib.rs:49-80)."""
    _ensure_auto_fakes()
    out: list[DeviceDescriptor] = []
    if real_hardware_enabled():
        out.extend(LibusbBackend.list_devices())
    base = len(out)
    for i, spec in enumerate(fake_mod.fake_devices()):
        out.append(DeviceDescriptor(
            index=base + i, vendor_id=spec.vendor_id, product_id=spec.product_id,
            manufacturer=spec.manufacturer, product=spec.product, serial=spec.serial,
        ))
    return out


def get_device_count() -> int:
    """(ref src/lib.rs:217-221)"""
    return len(list_devices())


def get_device_info(index: int) -> DeviceDescriptor:
    """(ref src/lib.rs:239-249)"""
    for d in list_devices():
        if d.index == index:
            return d
    raise DeviceNotFoundError(f"No device found at index {index}")


def get_device_serial(index: int) -> str:
    """(ref src/lib.rs:251-254)"""
    return get_device_info(index).serial


def _open_backend(device_id: DeviceId):
    _ensure_auto_fakes()
    n_real = len(LibusbBackend.list_devices()) if real_hardware_enabled() else 0
    fakes = fake_mod.fake_devices()
    if device_id.kind == "index":
        idx = int(device_id.value)
        if idx < n_real:
            return LibusbBackend.open_index(idx)
        fake_idx = idx - n_real
        if fake_idx < len(fakes):
            return fake_mod.FakeUsbBackend(fakes[fake_idx])
        raise DeviceNotFoundError(f"No device found at index {idx}")
    if device_id.kind == "serial":
        serial = str(device_id.value)
        for spec in fakes:
            if spec.serial == serial:
                return fake_mod.FakeUsbBackend(spec)
        if real_hardware_enabled():
            return LibusbBackend.open_serial(serial)
        raise DeviceNotFoundError(f"No device found with serial {serial}")
    if device_id.kind == "fd":
        # File-descriptor open (Android-style; ref device_handle.rs:96-121):
        # wrap an already-open kernel device node via libusb_wrap_sys_device.
        # Always routed to libusb — the caller already holds an open device,
        # so the TPU_SDR_USE_LIBUSB scan opt-in doesn't apply, and fakes
        # have no system fd.
        try:
            return LibusbBackend.open_fd(int(device_id.value))
        except (OSError, UsbError) as e:
            raise DeviceNotFoundError(
                f"Cannot open fd {device_id.value}: {e}") from e
    raise RtlSdrError(f"Unknown DeviceId kind {device_id.kind}")


class RtlSdr:
    """User-facing device handle (ref pub struct RtlSdr, src/lib.rs:122-255)."""

    def __init__(self, core: core_mod.SdrCore):
        self._core = core

    # -- constructors ------------------------------------------------------

    @classmethod
    def open(cls, device_id: DeviceId,
             blog_mod: bool | None = None) -> "RtlSdr":
        """``blog_mod`` enables the rtl-sdr-blog driver variants (the
        reference's ``rtl_sdr_blog`` cargo feature, Cargo.toml); defaults to
        the ``TPU_SDR_BLOG_MOD=1`` env flag so a whole process/CI leg can
        run with it on, like building the reference with the feature."""
        if blog_mod is None:
            blog_mod = os.environ.get("TPU_SDR_BLOG_MOD") == "1"
        backend = _open_backend(device_id)
        core = core_mod.SdrCore(Device(backend), blog_mod=blog_mod)
        core.init()
        return cls(core)

    @classmethod
    def open_with_index(cls, index: int) -> "RtlSdr":
        return cls.open(DeviceId.index(index))

    @classmethod
    def open_with_serial(cls, serial: str) -> "RtlSdr":
        return cls.open(DeviceId.serial(serial))

    @classmethod
    def open_with_fd(cls, fd: int) -> "RtlSdr":
        return cls.open(DeviceId.fd(fd))

    @classmethod
    def open_first_available(cls) -> "RtlSdr":
        devices = list_devices()
        if not devices:
            raise DeviceNotFoundError("No RTL-SDR devices found")
        return cls.open_with_index(devices[0].index)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self._core.deinit_baseband()
        self._core.handle.close()

    def __enter__(self) -> "RtlSdr":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- streaming ---------------------------------------------------------

    def reset_buffer(self) -> None:
        self._core.reset_buffer()

    def read_sync(self, length: int = DEFAULT_BUF_LENGTH) -> bytes:
        return self._core.read_sync(length)

    def read_eeprom(self, offset: int, length: int) -> bytes:
        """Read the configuration EEPROM (byte-at-a-time I2C at 0xa0,
        ref src/device/mod.rs:145-152)."""
        return self._core.handle.read_eeprom(offset, length)

    # -- configuration -----------------------------------------------------

    def get_center_freq(self) -> int:
        return self._core.get_center_freq()

    def set_center_freq(self, freq: int) -> None:
        self._core.set_center_freq(freq)

    def get_tuner_gains(self) -> list[int]:
        return self._core.get_tuner_gains()

    def read_tuner_gain(self) -> int:
        return self._core.read_tuner_gain()

    def set_tuner_gain(self, gain) -> None:
        self._core.set_tuner_gain(gain)

    def get_freq_correction(self) -> int:
        return self._core.get_freq_correction()

    def set_freq_correction(self, ppm: int) -> None:
        self._core.set_freq_correction(ppm)

    def get_sample_rate(self) -> int:
        return self._core.get_sample_rate()

    def set_sample_rate(self, rate: int) -> None:
        self._core.set_sample_rate(rate)

    def set_tuner_bandwidth(self, bw: int) -> None:
        self._core.set_tuner_bandwidth(bw)

    def set_testmode(self, on: bool) -> None:
        self._core.set_testmode(on)

    def set_direct_sampling(self, mode: DirectSampleMode) -> None:
        self._core.set_direct_sampling(
            mode.value if isinstance(mode, DirectSampleMode) else str(mode)
        )

    def set_bias_tee(self, on: bool) -> None:
        self._core.set_bias_tee(on)

    def get_tuner_id(self) -> str:
        return self._core.get_tuner_id()

    # -- sensors (ref src/lib.rs:198-215) ---------------------------------

    def list_sensors(self) -> list[Sensor]:
        return [Sensor.TUNER_TYPE, Sensor.TUNER_GAIN_DB,
                Sensor.FREQUENCY_CORRECTION_PPM]

    def read_sensor(self, sensor: Sensor) -> SensorValue:
        if sensor == Sensor.TUNER_TYPE:
            return SensorValue(sensor, self.get_tuner_id())
        if sensor == Sensor.TUNER_GAIN_DB:
            return SensorValue(sensor, self.read_tuner_gain())
        if sensor == Sensor.FREQUENCY_CORRECTION_PPM:
            return SensorValue(sensor, self.get_freq_correction())
        raise RtlSdrError(f"Unknown sensor {sensor}")

    # -- static helpers (ref src/lib.rs:217-254) ---------------------------

    get_device_count = staticmethod(get_device_count)
    list_devices = staticmethod(list_devices)
    get_device_info = staticmethod(get_device_info)
    get_device_serial = staticmethod(get_device_serial)
