"""Host feeders: pull u8 I/Q blocks from a source and hand them to the
data plane — the port's copy of ``tpu_sdr/stream/feeder.py``.

The reference's ingest is a blocking two-thread pipeline (simple_fm.rs:55-63,
rtl_tcp.rs:378-400): a reader thread fills a bounded queue that the demod
loop drains.  This copy keeps the JAX feeder's Python reader thread with
the backpressure and drop semantics of its native path (a replayable
source stalls, a live one drops); the C++ ring and pump and the
``jax.device_put`` double buffer are left out.

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


class BlockFeeder:
    """Reader thread + bounded queue + numpy hand-off.

    The bounded queue reproduces the reference's backpressure semantics
    (rtl_tcp.rs:24,365): for a live source the reader waits up to a second
    for room, then drops the block and counts it; a source that
    ``wants_backpressure`` (file replay) stalls instead and never drops.
    ``blocks()`` yields numpy u8 arrays.
    """

    def __init__(self, source: BlockSource, block_bytes: int = DEFAULT_BUF_LENGTH,
                 queue_blocks: int = 16):
        self.source = source
        self.block_bytes = block_bytes
        self._q: "queue.Queue[bytes | None]" = queue.Queue(maxsize=queue_blocks)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._dropped = 0

    @property
    def dropped(self) -> int:
        return self._dropped

    def start(self) -> "BlockFeeder":
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.source.close()

    def _put_until_stopped(self, item) -> None:
        """Wait for room for ``item`` until it lands or a stop is requested."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _reader(self) -> None:
        # A replayable source stalls on a full queue and never drops (the
        # JAX feeder's _reader_native); a live one drops after a second.
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
                self._dropped += 1
        # The end-of-stream sentinel must not be lost to a momentarily-full
        # queue (the consumer would block forever); stop() enqueues its own.
        self._put_until_stopped(None)

    def blocks(self) -> Iterator[np.ndarray]:
        while True:
            data = self._q.get()
            if data is None:
                return
            yield np.frombuffer(data, dtype=np.uint8)
