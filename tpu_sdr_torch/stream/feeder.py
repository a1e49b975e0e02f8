"""Host feeders: pull u8 I/Q blocks from a source and hand them to the
data plane — the port's copy of ``tpu_sdr/stream/feeder.py``.

The reference's ingest is a blocking two-thread pipeline (simple_fm.rs:55-63,
rtl_tcp.rs:378-400): a reader thread fills a bounded queue that the demod
loop drains.  Here, as in the JAX feeder, the queue is the native C++ ring
(:mod:`tpu_sdr_torch.native`) when it is built, and a source with an OS fd
(a file, an rtl_tcp socket) is read by the native pump thread with no
Python in the byte path; otherwise a Python reader thread fills a Python
queue.  A replayable source stalls on a full queue and never drops, a
live one drops.  :meth:`BlockFeeder.device_blocks` is the counterpart of
the JAX feeder's ``jax.device_put`` double buffer: pinned staging slots
that the ring pops straight into, copied to the card on a side CUDA
stream while the consumer computes on the block before.

Sources:

* :class:`FileSource` — raw capture file (simple_fm.rs READ_FROM_FILE mode),
* :class:`DeviceSource` — an opened :class:`tpu_sdr_torch.api.RtlSdr`,
* :class:`RtlTcpClientSource` — client side of the rtl_tcp protocol, so any
  rtl_tcp server (including the reference implementation) can feed the GPU.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from typing import Iterator

import numpy as np

from tpu_sdr_torch import DEFAULT_BUF_LENGTH


class BlockSource:
    """A source of fixed-size u8 I/Q blocks."""

    def read_block(self, length: int) -> bytes | None:
        """Return exactly ``length`` bytes, or None at end of stream."""
        raise NotImplementedError

    def fileno(self) -> int | None:
        """OS fd of the source, or None."""
        return None

    @property
    def wants_backpressure(self) -> bool:
        """True if overrun should stall the producer instead of dropping
        (replayable sources); live radios drop, like the reference feeder."""
        return False

    def close(self) -> None: ...


class FileSource(BlockSource):
    def __init__(self, path: str, loop: bool = False):
        self._f = open(path, "rb")
        self._loop = loop

    def read_block(self, length: int) -> bytes | None:
        data = self._f.read(length)
        while len(data) < length and self._loop:
            self._f.seek(0)
            data += self._f.read(length - len(data))
        if len(data) < length:
            return None
        return data

    def fileno(self) -> int | None:
        return self._f.fileno()

    @property
    def loop(self) -> bool:
        return self._loop

    @property
    def wants_backpressure(self) -> bool:
        return True

    def close(self) -> None:
        self._f.close()


class DeviceSource(BlockSource):
    def __init__(self, sdr):
        self.sdr = sdr

    def read_block(self, length: int) -> bytes | None:
        data = self.sdr.read_sync(length)
        return data if len(data) == length else None

    def close(self) -> None:
        self.sdr.close()


class RtlTcpClientSource(BlockSource):
    """rtl_tcp protocol client (the counterpart of the reference's
    examples/rtl_tcp.rs server side).

    Reads the 12-byte ``RTL0`` handshake, exposes tuner type/gain count, and
    sends 5-byte control commands.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 1234, timeout: float = 5.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        magic = self._read_exact(12)
        if magic is None or magic[:4] != b"RTL0":
            raise ConnectionError("Not an rtl_tcp server (bad handshake)")
        self.tuner_type, self.gain_count = struct.unpack(">II", magic[4:12])
        # Back to a blocking socket once connected, as the JAX feeder does.
        self.sock.settimeout(None)

    def command(self, cmd: int, param: int) -> None:
        self.sock.sendall(struct.pack(">BI", cmd, param & 0xFFFFFFFF))

    def set_frequency(self, hz: int) -> None:
        self.command(0x01, hz)

    def set_sample_rate(self, hz: int) -> None:
        self.command(0x02, hz)

    def set_gain_mode(self, manual: bool) -> None:
        self.command(0x03, int(manual))

    def set_gain(self, tenth_db: int) -> None:
        self.command(0x04, tenth_db)

    def set_test_mode(self, on: bool) -> None:
        self.command(0x07, int(on))

    def read_block(self, length: int) -> bytes | None:
        return self._read_exact(length)

    def fileno(self) -> int | None:
        return self.sock.fileno()

    def _read_exact(self, n: int) -> bytes | None:
        data = b""
        while len(data) < n:
            chunk = self.sock.recv(n - len(data))
            if not chunk:
                return None
            data += chunk
        return data

    def close(self) -> None:
        self.sock.close()




STAGING_SLOTS = 2          # pinned host buffers of device_blocks
POP_TIMEOUT_MS = 30_000    # a stream silent this long has ended


def _native_runtime():
    import tpu_sdr_torch.native as nat

    return nat if nat.available() else None


class BlockFeeder:
    """Producer (native pump or reader thread) + bounded queue + hand-off.

    The bounded queue reproduces the reference's backpressure semantics
    (rtl_tcp.rs:24,365).  ``native`` None (default) takes the C++ ring when
    it is built, True requires it (RuntimeError without it), False takes
    the Python queue.  On the ring, a source exposing an OS fd is pumped by
    the native reader thread with ``block_on_full = wants_backpressure``;
    another source is read by a thin Python thread that pushes into the
    ring.  A source that ``wants_backpressure`` (file replay) stalls on a
    full queue and never drops; a live one drops, at once on the ring and
    after a second's wait on the Python queue, and ``dropped`` counts both.
    ``blocks()`` yields numpy u8 arrays; ``device_blocks(device)`` tensors
    on ``device``.  ``popped_at`` is the ``time.monotonic()`` at which the
    block last yielded left the queue.
    """

    def __init__(self, source: BlockSource, block_bytes: int = DEFAULT_BUF_LENGTH,
                 queue_blocks: int = 16, native: bool | None = None):
        self.source = source
        self.block_bytes = block_bytes
        self._queue_blocks = queue_blocks
        self._nat = _native_runtime() if native in (None, True) else None
        if native is True and self._nat is None:
            raise RuntimeError("native runtime requested but unavailable")
        self._ring = None
        self._pump = None
        self._q: "queue.Queue[bytes | None] | None" = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._py_dropped = 0
        self.popped_at: float | None = None
        self.staging: list = []  # device_blocks' pinned slots, once it runs

    @property
    def is_native(self) -> bool:
        return self._ring is not None

    @property
    def dropped(self) -> int:
        if self._ring is not None:
            return self._ring.dropped + self._py_dropped
        return self._py_dropped

    def start(self) -> "BlockFeeder":
        if self._nat is not None:
            self._ring = self._nat.NativeRing(self.block_bytes, self._queue_blocks)
            fd = self.source.fileno()
            if fd is not None:
                # the C++ thread reads the fd straight into the ring;
                # Python only pops finished blocks
                self._pump = self._nat.NativePump(
                    self._ring, fd, loop_file=bool(getattr(self.source, "loop", False)),
                    block_on_full=self.source.wants_backpressure)
                return self
            target = self._reader_native
        else:
            self._q = queue.Queue(maxsize=self._queue_blocks)
            target = self._reader_py
        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._pump is not None:
            self._pump.stop()
            self._pump = None
        if self._ring is not None:
            self._ring.set_eof()
        if self._q is not None:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.source.close()

    def _reader_native(self) -> None:
        # A replayable source waits for room before it pushes: the ring
        # counts every refused push as a drop (the JAX reader retries the
        # push, so its replay counts drops it never made).  This thread is
        # the ring's only producer, so room seen stays room.
        backpressure = self.source.wants_backpressure
        while not self._stop.is_set():
            data = self.source.read_block(self.block_bytes)
            if data is None:
                break
            while backpressure and len(self._ring) >= self._ring.capacity:
                if self._stop.wait(0.005):
                    break
            self._ring.push(data)  # a live source's block drops when full
        self._ring.set_eof()

    def _put_until_stopped(self, item) -> None:
        """Wait for room for ``item`` until it lands or a stop is requested."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _reader_py(self) -> None:
        backpressure = self.source.wants_backpressure
        while not self._stop.is_set():
            data = self.source.read_block(self.block_bytes)
            if data is None:
                break
            if backpressure:
                self._put_until_stopped(data)
                continue
            try:
                self._q.put(data, timeout=1.0)
            except queue.Full:
                self._py_dropped += 1
        # The end-of-stream sentinel must not be lost to a momentarily-full
        # queue (the consumer would block forever); stop() enqueues its own.
        self._put_until_stopped(None)

    def _pop(self) -> np.ndarray | None:
        if self._ring is not None:
            try:
                return self._ring.pop(timeout_ms=POP_TIMEOUT_MS)
            except TimeoutError:
                return None
        data = self._q.get()
        return None if data is None else np.frombuffer(data, dtype=np.uint8)

    def _pop_into(self, slot, timeout_ms: int) -> bool:
        """The next block into the pinned tensor ``slot``: True, or False
        at end of stream; TimeoutError when none arrives in ``timeout_ms``."""
        if self._ring is not None:
            return self._ring.pop_into(slot.data_ptr(), timeout_ms)
        try:
            data = self._q.get(timeout=timeout_ms / 1e3)
        except queue.Empty:
            raise TimeoutError("no block queued") from None
        if data is None:
            return False
        slot.numpy()[:] = np.frombuffer(data, dtype=np.uint8)
        return True

    def blocks(self) -> Iterator[np.ndarray]:
        while (blk := self._pop()) is not None:
            self.popped_at = time.monotonic()
            yield blk

    def device_blocks(self, device) -> Iterator["torch.Tensor"]:
        """The blocks as u8 tensors on ``device`` (which the caller names;
        none is picked here).

        On a CUDA device: STAGING_SLOTS pinned host slots; the queue pops
        straight into a slot, and the slot's ``copy_(non_blocking=True)``
        into a fresh device block runs on a side stream and records an
        event.  Block N+1's copy is issued before block N is yielded
        whenever N+1 is already queued; a live source's block N is not
        held back waiting for N+1.  The consumer's current stream waits on
        a block's event before it is yielded, and the block is
        ``record_stream``-ed to it, so the caching allocator never hands
        its memory to the next copy while a kernel may still read it.  A
        slot is refilled only after its previous copy's event completed.
        On the CPU: plain tensors of ``blocks()``' bytes, no pinning, no
        stream.
        """
        import torch

        device = torch.device(device)
        if device.type == "cpu":
            for blk in self.blocks():
                yield torch.from_numpy(blk if blk.flags.writeable else blk.copy())
            return
        if device.type != "cuda":
            raise ValueError(f"unsupported device {device}: use cuda or cpu")
        self.staging = slots = [
            torch.empty(self.block_bytes, dtype=torch.uint8, pin_memory=True)
            for _ in range(STAGING_SLOTS)]
        copied = [torch.cuda.Event() for _ in slots]  # each slot's last copy out
        side = torch.cuda.Stream(device)
        consumer = torch.cuda.current_stream(device)
        ready = None  # (device block, its copy's event, pop time), not yet yielded

        def hand_over(item):
            blk, event, t_pop = item
            consumer.wait_event(event)
            blk.record_stream(consumer)
            self.popped_at = t_pop
            return blk

        k = 0
        while True:
            copied[k].synchronize()  # no-op before the slot's first copy
            try:
                got = self._pop_into(slots[k], 0 if ready else POP_TIMEOUT_MS)
            except TimeoutError:
                if ready is None:
                    return  # silent for POP_TIMEOUT_MS: the stream ended
                yield hand_over(ready)  # nothing queued behind it yet
                ready = None
                continue
            if not got:
                break
            t_pop = time.monotonic()
            with torch.cuda.stream(side):
                blk = torch.empty(self.block_bytes, dtype=torch.uint8,
                                  device=device)
                blk.copy_(slots[k], non_blocking=True)
                copied[k].record(side)
            if ready is not None:
                yield hand_over(ready)
            ready = (blk, copied[k], t_pop)
            k = (k + 1) % STAGING_SLOTS
        if ready is not None:
            yield hand_over(ready)
