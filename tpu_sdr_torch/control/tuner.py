"""Tuner abstraction: interface, null tuner, and the probe table.

Mirrors the reference's src/tuners/mod.rs — the ``Tuner`` trait surface
(mod.rs:23-35), the ``NoTuner`` null object (mod.rs:36-78), and the
``KNOWN_TUNERS`` I2C probe table (mod.rs:10).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TunerInfo:
    """Identification + probe signature (ref tuners/mod.rs:14-21)."""

    id: str
    name: str
    i2c_addr: int
    check_addr: int
    check_val: int


class Tuner:
    """Operations the core control logic drives (ref tuners/mod.rs:23-35).

    ``handle`` arguments are :class:`tpu_sdr_torch.control.transport.Device`.
    """

    def init(self, handle) -> None: ...

    def get_info(self) -> TunerInfo:
        raise NotImplementedError

    def get_gains(self) -> list[int]:
        return []

    def read_gain(self, handle) -> int:
        return 0

    def set_gain(self, handle, gain) -> None: ...

    def set_freq(self, handle, freq: int) -> None: ...

    def set_bandwidth(self, handle, bw: int, rate: int) -> None: ...

    def get_if_freq(self) -> int:
        return 0

    def get_xtal_freq(self) -> int:
        return 0

    def set_xtal_freq(self, freq: int) -> None: ...

    def exit(self, handle) -> None: ...


class NoTuner(Tuner):
    """Null tuner used before probing succeeds (ref tuners/mod.rs:36-78)."""

    def get_info(self) -> TunerInfo:
        return TunerInfo(id="", name="", i2c_addr=0, check_addr=0, check_val=0)


def known_tuners() -> tuple[TunerInfo, ...]:
    """Probe table (ref tuners/mod.rs:10)."""
    from tpu_sdr_torch.control.r82xx import R820T_TUNER_INFO, R828D_TUNER_INFO

    return (R820T_TUNER_INFO, R828D_TUNER_INFO)
