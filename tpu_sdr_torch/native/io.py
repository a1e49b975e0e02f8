"""Python wrappers over the port's native host runtime (see the package
docstring) — the counterpart of ``tpu_sdr/native/io.py``.

Every entry point has a numpy fallback that gives the same bytes, so the
port works without a C++ compiler; the native paths are the production
ones (the reference's equivalents are native Rust: bounded channels
rtl_tcp.rs:365, rotate_90 simple_fm.rs:300-334, s16 output
simple_fm.rs:430-438).  The ring and the pump have no fallback: the
feeder and the rtl_tcp server take a Python queue instead.
"""

from __future__ import annotations

import ctypes

import numpy as np

import tpu_sdr_torch.native as _native


def _lib():
    lib = _native.load()
    if lib is None:
        raise RuntimeError("native tpusdr_io library unavailable")
    return lib


class NativeRing:
    """Fixed-block bounded ring buffer (the rtl_tcp.rs:24,365 queue)."""

    def __init__(self, block_bytes: int, capacity: int):
        self._lib = _lib()
        self._ptr = self._lib.tsdr_ring_create(block_bytes, capacity)
        if not self._ptr:
            raise RuntimeError("ring allocation failed")
        self.block_bytes = block_bytes
        self.capacity = capacity

    def _handle(self):
        if not self._ptr:
            raise ValueError("the ring is closed")
        return self._ptr

    def push(self, block: bytes | np.ndarray) -> bool:
        """Non-blocking; False means the block was dropped (queue full)."""
        data = bytes(block) if not isinstance(block, bytes) else block
        if len(data) != self.block_bytes:
            raise ValueError(f"block must be exactly {self.block_bytes} bytes")
        return self._lib.tsdr_ring_push(self._handle(), data) == 0

    def pop_into(self, dst_ptr: int, timeout_ms: int = -1) -> bool:
        """Blocking pop of one block into the caller's ``block_bytes`` of
        writable memory at address ``dst_ptr`` (a pinned staging buffer's
        ``data_ptr()``); no intermediate array.  True for a block, False at
        end of stream; raises TimeoutError if ``timeout_ms`` >= 0 elapses
        first.  The copy out of the ring runs under the ring's lock, so
        the pump thread never writes the slot being read."""
        rc = self._lib.tsdr_ring_pop(self._handle(), dst_ptr, timeout_ms)
        if rc == 0:
            raise TimeoutError("ring pop timed out")
        return rc == 1

    def pop(self, timeout_ms: int = -1) -> np.ndarray | None:
        """Blocking pop -> u8 array; None on end-of-stream.

        Raises TimeoutError if ``timeout_ms`` >= 0 elapses first.
        """
        out = np.empty(self.block_bytes, dtype=np.uint8)
        return out if self.pop_into(out.ctypes.data, timeout_ms) else None

    def __len__(self) -> int:
        return int(self._lib.tsdr_ring_count(self._handle()))

    @property
    def dropped(self) -> int:
        return int(self._lib.tsdr_ring_dropped(self._handle()))

    def set_eof(self) -> None:
        self._lib.tsdr_ring_set_eof(self._handle())

    @property
    def eof(self) -> bool:
        return bool(self._lib.tsdr_ring_eof(self._handle()))

    def close(self) -> None:
        if self._ptr:
            self._lib.tsdr_ring_destroy(self._ptr)
            self._ptr = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class NativePump:
    """Native reader thread: fd -> ring (the simple_fm.rs:89-132 receive
    thread, in C++).  ``loop_file`` rewinds at EOF; ``block_on_full``
    stalls on a full ring instead of dropping the newest block."""

    def __init__(self, ring: NativeRing, fd: int, loop_file: bool = False,
                 block_on_full: bool = False):
        self._lib = _lib()
        self.ring = ring
        self._ptr = self._lib.tsdr_pump_start(
            ring._handle(), fd, int(loop_file), int(block_on_full))

    @property
    def blocks_read(self) -> int:
        return int(self._lib.tsdr_pump_blocks(self._ptr)) if self._ptr else 0

    def stop(self) -> None:
        if self._ptr:
            self._lib.tsdr_pump_stop(self._ptr)
            self._ptr = None

    def __del__(self):  # pragma: no cover
        try:
            self.stop()
        except Exception:
            pass


def u8_iq_to_planar_f32(iq: np.ndarray, phase: int = 0,
                        scale: float = 1.0 / 127.5):
    """u8 interleaved I/Q -> (re, im) f32, centered/scaled + fs/4 rotated."""
    iq = np.ascontiguousarray(iq, dtype=np.uint8)
    n = iq.size // 2
    if _native.available():
        re = np.empty(n, dtype=np.float32)
        im = np.empty(n, dtype=np.float32)
        _lib().tsdr_u8_iq_to_planar_f32(
            iq.ctypes.data, n, int(phase) & 3, ctypes.c_float(scale),
            re.ctypes.data, im.ctypes.data)
        return re, im
    x = iq.astype(np.float32) * scale - 127.5 * scale
    i, q = x[0::2], x[1::2]
    k = (np.arange(n) + phase) % 4
    re = np.where(k == 0, i, np.where(k == 1, -q, np.where(k == 2, -i, q)))
    im = np.where(k == 0, q, np.where(k == 1, i, np.where(k == 2, -q, -i)))
    return re.astype(np.float32), im.astype(np.float32)


def rotate_fs4_u8(iq: np.ndarray, phase: int = 0) -> np.ndarray:
    """fs/4 rotation as a pure byte map (stays u8): sample k times
    j**(k + phase).  Negating a centered sample x = 2u - 255 is the byte
    complement 255 - u, so with p = (k + phase) % 4:

        p=0: (I, Q)    p=1: (255-Q, I)    p=2: (255-I, 255-Q)
        p=3: (Q, 255-I)

    One size contract on both paths: whole 4-sample periods
    (``size % 8 == 0``), else ValueError."""
    iq = np.ascontiguousarray(iq, dtype=np.uint8)
    if iq.size % 8:
        raise ValueError(f"buffer of {iq.size} bytes must hold whole "
                         f"4-sample periods (a multiple of 8 bytes)")
    if _native.available():
        out = np.empty_like(iq)
        _lib().tsdr_rotate_fs4_u8(iq.ctypes.data, out.ctypes.data,
                                  iq.size // 2, int(phase) & 3)
        return out
    s = iq.reshape(-1, 4, 2)
    out = np.empty_like(s)
    for k in range(4):
        i_, q_ = s[:, k, 0], s[:, k, 1]
        p = (k + phase) % 4
        if p == 0:
            out[:, k, 0], out[:, k, 1] = i_, q_
        elif p == 1:
            out[:, k, 0], out[:, k, 1] = 255 - q_, i_
        elif p == 2:
            out[:, k, 0], out[:, k, 1] = 255 - i_, 255 - q_
        else:
            out[:, k, 0], out[:, k, 1] = q_, 255 - i_
    return out.reshape(iq.shape)


def f32_to_s16(x: np.ndarray, scale: float = 0.9 * 32767.0) -> np.ndarray:
    """f32 audio -> clamped s16 PCM: scaled in float32, clamped to
    [-32768, 32767] and truncated toward zero on every path.  A C-contiguous
    float32 input is read in place by the native module's entry; any other
    is copied to one first."""
    out = _s16(x, scale)
    if out is None:  # the entry takes C-contiguous float32 buffers only
        out = _s16(np.ascontiguousarray(x, dtype=np.float32), scale)
    return out


def _s16_ctypes(x: np.ndarray, scale: float) -> np.ndarray:
    """The loop through ctypes, for a build without the CPython module."""
    _S16_CALLS["ctypes"] += 1
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.size, dtype=np.int16)
    _lib().tsdr_f32_to_s16(x.ctypes.data, x.size, ctypes.c_float(scale),
                           out.ctypes.data)
    return out


def _s16_numpy(x: np.ndarray, scale: float) -> np.ndarray:
    _S16_CALLS["numpy"] += 1
    x = np.ascontiguousarray(x, dtype=np.float32)
    return np.clip(x * np.float32(scale), -32768, 32767).astype(np.int16)


def _bind_s16(x: np.ndarray, scale: float) -> np.ndarray | None:
    """The first call: binds the conversion to the native module's entry,
    else to the loop through ctypes, else to numpy, and converts ``x``."""
    global _s16
    module = _native.module()
    if module is not None:
        _s16 = module.f32_to_s16
    else:
        _s16 = _s16_ctypes if _native.available() else _s16_numpy
    return _s16(x, scale)


_s16 = _bind_s16
_S16_CALLS = {"ctypes": 0, "numpy": 0}


def s16_calls() -> dict[str, int]:
    """Calls of :func:`f32_to_s16` by the path each took: ``entry``, through
    the native module's entry (each of a library load's calls); ``copied``,
    calls whose input the entry refused and the wrapper copied first (each
    then also one ``entry`` call); ``ctypes``, the loop through ctypes;
    ``numpy``, the fallback."""
    module = _native.module()
    entry, copied = module.s16_counts() if module is not None else (0, 0)
    return {"entry": entry, "copied": copied, **_S16_CALLS}


def count_pattern_breaks(buf: np.ndarray, last: int = -1) -> tuple[int, int]:
    """Count RTL2832U test-pattern counter discontinuities.

    Returns ``(breaks, last_counter)``; feed ``last_counter`` back in for the
    next block (stricter than the reference's rtl_test, which only detects
    short reads, rtl_test.rs:170-181).
    """
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if _native.available():
        c_last = ctypes.c_int(last)
        breaks = _lib().tsdr_count_pattern_breaks(
            buf.ctypes.data, buf.size, ctypes.byref(c_last))
        return int(breaks), int(c_last.value)
    if buf.size == 0:
        return 0, last
    prev = np.concatenate([[last], buf[:-1]]).astype(np.int64)
    bad = buf != (prev + 1) % 256
    bad[0] &= last >= 0  # no counter before the first byte yet
    return int(np.count_nonzero(bad)), int(buf[-1])


def parse_tcp_commands(buf: bytes) -> list[tuple[int, int]]:
    """Parse rtl_tcp 5-byte [cmd u8 | param u32-be] records
    (ref rtl_tcp.rs:633-689); a trailing partial record is ignored."""
    n = len(buf) // 5
    if _native.available():
        cmds = np.empty(n, dtype=np.uint8)
        params = np.empty(n, dtype=np.uint32)
        got = _lib().tsdr_parse_tcp_commands(
            buf, len(buf), cmds.ctypes.data, params.ctypes.data, n)
        return [(int(cmds[i]), int(params[i])) for i in range(got)]
    return [(buf[off], int.from_bytes(buf[off + 1:off + 5], "big"))
            for off in range(0, 5 * n, 5)]
