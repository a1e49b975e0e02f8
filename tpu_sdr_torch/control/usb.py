"""USB HAL: backend abstraction + libusb (ctypes) implementation.

Redesign of the reference's L1 (src/device/device_handle.rs):
where the reference links ``rusb`` at compile time and swaps in a mockall
mock under ``#[cfg(test)]``, here the boundary is a runtime ``UsbBackend``
interface with three implementations:

* :class:`LibusbBackend` — real hardware via ``libusb-1.0`` through ctypes
  (no extra dependencies; the C ABI is stable),
* the register-level simulator in :mod:`tpu_sdr_torch.control.fake`,
* anything test code supplies.

Enumeration merges real USB devices (when libusb is usable) with registered
fake devices, so every app runs unchanged with or without hardware.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading
from dataclasses import dataclass
from typing import Protocol

from tpu_sdr_torch.control import constants as C
from tpu_sdr_torch.errors import DeviceNotFoundError, UsbError


class UsbBackend(Protocol):
    """Operations the register transport needs (ref device_handle.rs:123-185)."""

    def claim_interface(self, iface: int) -> None: ...

    def reset(self) -> None: ...

    def read_control(self, request_type: int, request: int, value: int,
                     index: int, length: int, timeout_ms: int) -> bytes: ...

    def write_control(self, request_type: int, request: int, value: int,
                      index: int, data: bytes, timeout_ms: int) -> int: ...

    def read_bulk(self, endpoint: int, length: int, timeout_ms: int) -> bytes: ...

    def get_usb_strings(self) -> tuple[str | None, str | None, str | None]: ...

    def close(self) -> None: ...


@dataclass(frozen=True)
class DeviceDescriptor:
    """Enumeration record (ref src/lib.rs:31-39)."""

    index: int
    vendor_id: int
    product_id: int
    manufacturer: str
    product: str
    serial: str


# ---------------------------------------------------------------------------
# libusb-1.0 via ctypes
# ---------------------------------------------------------------------------

_LIBUSB_SUCCESS = 0


class _Libusb:
    """Lazily loaded libusb-1.0 with the handful of entry points we use."""

    _instance: "_Libusb | None" = None
    _lock = threading.Lock()

    def __init__(self):
        name = ctypes.util.find_library("usb-1.0") or "libusb-1.0.so.0"
        self.lib = ctypes.CDLL(name)
        lib = self.lib
        lib.libusb_init.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        lib.libusb_get_device_list.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_void_p))]
        lib.libusb_get_device_list.restype = ctypes.c_ssize_t
        lib.libusb_get_device_descriptor.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.libusb_open.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
        lib.libusb_control_transfer.argtypes = [
            ctypes.c_void_p, ctypes.c_uint8, ctypes.c_uint8, ctypes.c_uint16,
            ctypes.c_uint16, ctypes.c_char_p, ctypes.c_uint16, ctypes.c_uint]
        lib.libusb_bulk_transfer.argtypes = [
            ctypes.c_void_p, ctypes.c_uint8, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_uint]
        lib.libusb_get_string_descriptor_ascii.argtypes = [
            ctypes.c_void_p, ctypes.c_uint8, ctypes.c_char_p, ctypes.c_int]
        try:  # libusb >= 1.0.23 (Android/fd support)
            lib.libusb_wrap_sys_device.argtypes = [
                ctypes.c_void_p, ctypes.c_ssize_t,  # intptr_t fd
                ctypes.POINTER(ctypes.c_void_p)]
            lib.libusb_get_device.argtypes = [ctypes.c_void_p]
            lib.libusb_get_device.restype = ctypes.c_void_p
            self.has_wrap = True
        except AttributeError:
            self.has_wrap = False
        self.ctx = ctypes.c_void_p()
        rc = lib.libusb_init(ctypes.byref(self.ctx))
        if rc != _LIBUSB_SUCCESS:
            raise UsbError(f"libusb_init failed: {rc}", rc)

    @classmethod
    def get(cls) -> "_Libusb":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance


class _DeviceDescriptorStruct(ctypes.Structure):
    _fields_ = [
        ("bLength", ctypes.c_uint8), ("bDescriptorType", ctypes.c_uint8),
        ("bcdUSB", ctypes.c_uint16), ("bDeviceClass", ctypes.c_uint8),
        ("bDeviceSubClass", ctypes.c_uint8), ("bDeviceProtocol", ctypes.c_uint8),
        ("bMaxPacketSize0", ctypes.c_uint8), ("idVendor", ctypes.c_uint16),
        ("idProduct", ctypes.c_uint16), ("bcdDevice", ctypes.c_uint16),
        ("iManufacturer", ctypes.c_uint8), ("iProduct", ctypes.c_uint8),
        ("iSerialNumber", ctypes.c_uint8), ("bNumConfigurations", ctypes.c_uint8),
    ]


class LibusbBackend:
    """Real-hardware backend over libusb-1.0 (ref device_handle.rs:18-185)."""

    def __init__(self, handle: ctypes.c_void_p, desc: _DeviceDescriptorStruct):
        self._usb = _Libusb.get()
        self._handle = handle
        self._desc = desc

    # -- enumeration -------------------------------------------------------

    @staticmethod
    def _iter_raw():
        """Yield (device_ptr, descriptor) for known VID/PIDs on the bus."""
        usb = _Libusb.get()
        devs = ctypes.POINTER(ctypes.c_void_p)()
        n = usb.lib.libusb_get_device_list(usb.ctx, ctypes.byref(devs))
        if n < 0:
            raise UsbError(f"libusb_get_device_list failed: {n}", int(n))
        try:
            for i in range(n):
                dev = devs[i]
                desc = _DeviceDescriptorStruct()
                rc = usb.lib.libusb_get_device_descriptor(dev, ctypes.byref(desc))
                if rc != _LIBUSB_SUCCESS:
                    continue
                if C.is_known_device(desc.idVendor, desc.idProduct):
                    yield dev, desc
        finally:
            usb.lib.libusb_free_device_list(devs, 0)

    @staticmethod
    def _read_string(handle, idx: int) -> str:
        if idx == 0:
            return ""
        usb = _Libusb.get()
        buf = ctypes.create_string_buffer(256)
        n = usb.lib.libusb_get_string_descriptor_ascii(handle, idx, buf, 256)
        return buf.raw[:n].decode("ascii", "replace") if n > 0 else ""

    @classmethod
    def list_devices(cls) -> list[DeviceDescriptor]:
        out = []
        try:
            usb = _Libusb.get()
        except (OSError, UsbError):
            return out
        idx = 0
        for dev, desc in cls._iter_raw():
            handle = ctypes.c_void_p()
            if usb.lib.libusb_open(dev, ctypes.byref(handle)) == _LIBUSB_SUCCESS:
                out.append(DeviceDescriptor(
                    index=idx, vendor_id=desc.idVendor, product_id=desc.idProduct,
                    manufacturer=cls._read_string(handle, desc.iManufacturer),
                    product=cls._read_string(handle, desc.iProduct),
                    serial=cls._read_string(handle, desc.iSerialNumber),
                ))
                usb.lib.libusb_close(handle)
            idx += 1
        return out

    @classmethod
    def open_index(cls, target: int) -> "LibusbBackend":
        usb = _Libusb.get()
        idx = 0
        for dev, desc in cls._iter_raw():
            if idx == target:
                handle = ctypes.c_void_p()
                rc = usb.lib.libusb_open(dev, ctypes.byref(handle))
                if rc != _LIBUSB_SUCCESS:
                    raise UsbError(f"libusb_open failed: {rc}", rc)
                return cls(handle, desc)
            idx += 1
        raise DeviceNotFoundError(f"No device found at index {target}")

    @classmethod
    def open_serial(cls, serial: str) -> "LibusbBackend":
        usb = _Libusb.get()
        for dev, desc in cls._iter_raw():
            handle = ctypes.c_void_p()
            if usb.lib.libusb_open(dev, ctypes.byref(handle)) != _LIBUSB_SUCCESS:
                continue
            if cls._read_string(handle, desc.iSerialNumber) == serial:
                return cls(handle, desc)
            usb.lib.libusb_close(handle)
        raise DeviceNotFoundError(f"No device found with serial {serial}")

    @classmethod
    def open_fd(cls, fd: int) -> "LibusbBackend":
        """Wrap an already-open kernel device node (Android-style open;
        ref device_handle.rs:96-121 — ``libusb_wrap_sys_device``).

        The caller owns the fd and already passed the OS permission check,
        so no VID/PID filtering happens here (the fd IS the device) — same
        contract as the reference, which wraps whatever fd it is handed.
        """
        usb = _Libusb.get()
        if not usb.has_wrap:
            raise UsbError(
                "libusb_wrap_sys_device unavailable (libusb < 1.0.23)", -12)
        handle = ctypes.c_void_p()
        rc = usb.lib.libusb_wrap_sys_device(usb.ctx, fd, ctypes.byref(handle))
        if rc != _LIBUSB_SUCCESS:
            raise UsbError(f"libusb_wrap_sys_device failed: {rc}", rc)
        dev = usb.lib.libusb_get_device(handle)
        desc = _DeviceDescriptorStruct()
        usb.lib.libusb_get_device_descriptor(dev, ctypes.byref(desc))
        return cls(handle, desc)

    # -- transfers ---------------------------------------------------------

    def claim_interface(self, iface: int) -> None:
        self._usb.lib.libusb_detach_kernel_driver(self._handle, iface)
        rc = self._usb.lib.libusb_claim_interface(self._handle, iface)
        if rc != _LIBUSB_SUCCESS:
            raise UsbError(f"claim_interface failed: {rc}", rc)

    def reset(self) -> None:
        self._usb.lib.libusb_reset_device(self._handle)

    def read_control(self, request_type, request, value, index, length, timeout_ms):
        buf = ctypes.create_string_buffer(length)
        n = self._usb.lib.libusb_control_transfer(
            self._handle, request_type, request, value, index, buf, length, timeout_ms)
        if n < 0:
            raise UsbError(f"control read failed: {n}", n)
        return buf.raw[:n]

    def write_control(self, request_type, request, value, index, data, timeout_ms):
        n = self._usb.lib.libusb_control_transfer(
            self._handle, request_type, request, value, index, data, len(data), timeout_ms)
        if n < 0:
            raise UsbError(f"control write failed: {n}", n)
        return n

    def read_bulk(self, endpoint, length, timeout_ms):
        buf = ctypes.create_string_buffer(length)
        got = ctypes.c_int(0)
        rc = self._usb.lib.libusb_bulk_transfer(
            self._handle, endpoint, buf, length, ctypes.byref(got), timeout_ms)
        if rc != _LIBUSB_SUCCESS and got.value == 0:
            raise UsbError(f"bulk read failed: {rc}", rc)
        return buf.raw[: got.value]

    def get_usb_strings(self):
        return (
            self._read_string(self._handle, self._desc.iManufacturer) or None,
            self._read_string(self._handle, self._desc.iProduct) or None,
            self._read_string(self._handle, self._desc.iSerialNumber) or None,
        )

    def close(self) -> None:
        if self._handle:
            self._usb.lib.libusb_close(self._handle)
            self._handle = None


def real_hardware_enabled() -> bool:
    """Real USB scanning is opt-in (sandboxed CI has no devices and probing
    the bus can block)."""
    return os.environ.get("TPU_SDR_USE_LIBUSB", "0") not in ("0", "", "false")
