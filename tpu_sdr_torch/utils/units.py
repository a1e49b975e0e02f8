"""Human-unit parsing for CLI flags (ref rtl_tcp.rs:255-289): the port's
copy of ``tpu_sdr/utils/units.py``."""

from __future__ import annotations


def parse_scaled(value: str) -> int:
    """Parse a number with optional k/M/G suffix into an integer
    (ref parse_scaled, rtl_tcp.rs:255-289)."""
    if not value:
        raise ValueError("Empty numeric value")
    factor = 1.0
    digits = value
    suffix = value[-1]
    if suffix in "kK":
        factor, digits = 1e3, value[:-1]
    elif suffix in "mM":
        factor, digits = 1e6, value[:-1]
    elif suffix in "gG":
        factor, digits = 1e9, value[:-1]
    number = float(digits)
    if number < 0:
        raise ValueError(f"Value must be positive: {value}")
    hz = number * factor
    if hz > 0xFFFFFFFF:
        raise ValueError(f"Value too large: {value}")
    return int(round(hz))
