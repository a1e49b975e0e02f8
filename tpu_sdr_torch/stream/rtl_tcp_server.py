"""rtl_tcp protocol server — the port's copy of
``tpu_sdr/stream/rtl_tcp_server.py``, on the port's ``api`` and
:class:`tpu_sdr_torch.native.NativeRing`.

Wire-compatible re-implementation of the reference's examples/rtl_tcp.rs:
speaks the standard rtl_tcp protocol (``RTL0`` handshake + big-endian tuner
type and gain count, rtl_tcp.rs:691-708; 5-byte ``[cmd u8 | param be32]``
control messages with opcodes 0x01-0x0e, rtl_tcp.rs:659-677), serves one
client at a time from a non-blocking accept loop (rtl_tcp.rs:100-126), and
uses a bounded block queue for backpressure (default 500 blocks,
rtl_tcp.rs:24,365).

Thread layout mirrors the reference's three threads per client
(rtl_tcp.rs:334-502): a reader loop pulling sync blocks from the device, a
sender thread draining the bounded queue into the socket, and a command
thread parsing control messages.

Beyond the reference (which serves one client at a time, rtl_tcp.rs:297):
``max_clients > 1`` switches to fan-out mode — ONE acquisition loop owns
the device and pushes every block into N per-client bounded rings, so a
stalled client only drops its own blocks (backpressure isolated per
client) while the others keep receiving the full stream.
"""

from __future__ import annotations

import logging
import queue
import socket
import struct
import threading
import time

from tpu_sdr_torch import DEFAULT_BUF_LENGTH
from tpu_sdr_torch import native
from tpu_sdr_torch.api import DirectSampleMode, RtlSdr, TunerGain, TunerId

log = logging.getLogger("rtl_tcp")

DEFAULT_PORT = 1234
DEFAULT_SAMPLE_RATE = 2_048_000  # (ref rtl_tcp.rs:22)
DEFAULT_FREQUENCY = 100_000_000
DEFAULT_QUEUE_LIMIT = 500  # blocks (ref rtl_tcp.rs:24)
ACCEPT_POLL_INTERVAL_S = 0.1

# Command opcodes (ref rtl_tcp.rs:659-677)
CMD_SET_FREQUENCY = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03
CMD_SET_GAIN = 0x04
CMD_SET_FREQ_CORRECTION = 0x05
CMD_SET_IF_GAIN = 0x06
CMD_SET_TEST_MODE = 0x07
CMD_SET_AGC_MODE = 0x08
CMD_SET_DIRECT_SAMPLING = 0x09
CMD_SET_OFFSET_TUNING = 0x0A
CMD_SET_RTL_XTAL = 0x0B
CMD_SET_TUNER_XTAL = 0x0C
CMD_SET_GAIN_BY_INDEX = 0x0D
CMD_SET_BIAS_TEE = 0x0E

TUNER_TYPE_CODES = {TunerId.R820T: 5, TunerId.R828D: 6}  # (ref rtl_tcp.rs:699-708)


def send_handshake(sock: socket.socket, tuner_type: int, gain_count: int) -> None:
    """``RTL0`` + be32 tuner type + be32 gain count (ref rtl_tcp.rs:691-697)."""
    sock.sendall(b"RTL0" + struct.pack(">II", tuner_type, gain_count))


class _BlockQueue:
    """Bounded fixed-block queue: the native C++ ring when built, a Python
    queue otherwise (the reference's sync_channel, rtl_tcp.rs:365)."""

    def __init__(self, block_bytes: int, capacity: int):
        self._ring = None
        self._q = None
        if native.available():
            self._ring = native.NativeRing(block_bytes, capacity)
        else:
            self._q = queue.Queue(maxsize=capacity)

    def put(self, data: bytes, timeout: float) -> bool:
        """False when the queue stayed full for ``timeout`` (backpressure)."""
        if self._ring is not None:
            deadline = timeout
            while not self._ring.push(data):
                if deadline <= 0:
                    return False
                time.sleep(0.005)
                deadline -= 0.005
            return True
        try:
            self._q.put(data, timeout=timeout)
            return True
        except queue.Full:
            return False

    def get(self, timeout: float):
        """Block bytes, None at end-of-stream, or raise TimeoutError."""
        if self._ring is not None:
            blk = self._ring.pop(timeout_ms=int(timeout * 1000))
            return None if blk is None else blk.tobytes()
        try:
            data = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError from None
        return data

    def close(self) -> None:
        if self._ring is not None:
            self._ring.set_eof()
        else:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass

    def destroy(self) -> None:
        if self._ring is not None:
            self._ring.close()


class _ClientSession:
    """Per-client state in fan-out mode: its own bounded queue, threads,
    stop flag, and drop counter (backpressure isolation)."""

    def __init__(self, stream: socket.socket, addr, queue_limit: int):
        self.stream = stream
        self.addr = addr
        self.queue = _BlockQueue(DEFAULT_BUF_LENGTH, queue_limit)
        self.stop = threading.Event()
        self.errors: list[str] = []
        self.drops = 0
        self.sender: threading.Thread | None = None
        self.commander: threading.Thread | None = None

    def finish(self) -> None:
        self.stop.set()
        self.queue.close()
        if self.sender is not None:
            self.sender.join(timeout=2.0)
        self.queue.destroy()
        try:
            self.stream.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.stream.close()
        if self.commander is not None:
            self.commander.join(timeout=2.0)


class RtlTcpServer:
    """I/Q server (ref run/serve_client, rtl_tcp.rs:74-502).

    ``max_clients=1`` (default) keeps the reference's one-client-at-a-time
    behavior; larger values enable single-acquisition fan-out.
    """

    def __init__(self, sdr: RtlSdr, address: str = "127.0.0.1", port: int = DEFAULT_PORT,
                 queue_limit: int = DEFAULT_QUEUE_LIMIT, default_gain: int | None = None,
                 max_clients: int = 1):
        self.sdr = sdr
        self.address = address
        self.port = port
        self.queue_limit = max(1, queue_limit)
        self.default_gain = default_gain
        self.max_clients = max(1, max_clients)
        self.shutdown = threading.Event()
        self._listener: socket.socket | None = None
        self.bound_port: int | None = None
        # One lock serializes every device access: commands arrive on
        # per-client threads while the acquisition loop holds the bulk
        # endpoint (the reference instead drains a channel between reads,
        # rtl_tcp.rs:409-470 — same effect, commands apply between blocks).
        self._sdr_lock = threading.Lock()
        self._sessions: list[_ClientSession] = []
        self._sessions_lock = threading.Lock()

    def serve_forever(self) -> None:
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.address, self.port))
        listener.listen(self.max_clients)
        listener.settimeout(ACCEPT_POLL_INTERVAL_S)
        self._listener = listener
        self.bound_port = listener.getsockname()[1]
        log.info("Listening on %s:%s (max %d client%s)", self.address,
                 self.bound_port, self.max_clients,
                 "s" if self.max_clients > 1 else "")
        try:
            if self.max_clients > 1:
                self._serve_forever_multi(listener)
                return
            while not self.shutdown.is_set():
                try:
                    stream, addr = listener.accept()
                except socket.timeout:
                    continue
                log.info("Client accepted from %s", addr)
                err = self.serve_client(stream, addr)
                if err:
                    log.warning("Connection ended: %s", err)
                else:
                    log.info("Connection closed")
        finally:
            listener.close()

    # -- fan-out mode --------------------------------------------------------

    def _serve_forever_multi(self, listener: socket.socket) -> None:
        acq = threading.Thread(target=self._acquisition_loop, daemon=True)
        acq.start()
        try:
            while not self.shutdown.is_set():
                self._reap_sessions()
                try:
                    stream, addr = listener.accept()
                except socket.timeout:
                    continue
                # Reserve the slot BEFORE the handshake: a client may act
                # on its accepted connection (even close it) the moment
                # the handshake bytes arrive, so the session must already
                # be counted by then or a racing connect sees a free slot
                # that is about to be consumed.
                sess = _ClientSession(stream, addr, self.queue_limit)
                with self._sessions_lock:
                    n = len(self._sessions)
                    if n < self.max_clients:
                        self._sessions.append(sess)
                if n >= self.max_clients:
                    log.warning("Refusing client %s: server full (%d)",
                                addr, self.max_clients)
                    stream.close()
                    continue
                if self._start_session(sess):
                    log.info("Client accepted from %s (%d active)", addr,
                             n + 1)
                else:
                    sess.stop.set()  # reaper removes the reserved slot
        finally:
            acq.join(timeout=3.0)
            with self._sessions_lock:
                sessions, self._sessions = self._sessions, []
            for s in sessions:
                s.finish()

    def _start_session(self, sess: _ClientSession) -> bool:
        """Handshake a slot-reserved session and start its threads."""
        try:
            with self._sdr_lock:
                gains = self.sdr.get_tuner_gains()
                tuner_type = TUNER_TYPE_CODES.get(self.sdr.get_tuner_id(), 0)
            send_handshake(sess.stream, tuner_type, len(gains))
        except OSError as e:
            log.warning("Handshake to %s failed: %s", sess.addr, e)
            return False
        last_gain = self.default_gain if self.default_gain is not None else (
            gains[0] if gains else 0)
        ctl = {"manual": self.default_gain is not None,
               "last_gain": last_gain, "gains": gains}
        sess.sender = threading.Thread(
            target=self._sender_loop,
            args=(sess.stream, sess.queue, sess.stop, sess.errors),
            daemon=True)
        sess.commander = threading.Thread(
            target=self._command_loop,
            args=(sess.stream, ctl, sess.stop, sess.errors), daemon=True)
        sess.sender.start()
        sess.commander.start()
        return True

    def _reap_sessions(self) -> None:
        with self._sessions_lock:
            done = [s for s in self._sessions if s.stop.is_set()]
            self._sessions = [s for s in self._sessions
                              if not s.stop.is_set()]
        for s in done:
            s.finish()
            msg = ", ".join(s.errors) if s.errors else "closed"
            log.info("Client %s gone (%s; %d blocks dropped)", s.addr, msg,
                     s.drops)

    def _acquisition_loop(self) -> None:
        """ONE device reader fanning blocks out to every live session.

        A full per-client queue drops that client's block only — a stalled
        reader cannot backpressure the radio or its peers.
        """
        while not self.shutdown.is_set():
            with self._sessions_lock:
                sessions = list(self._sessions)
            if not sessions:
                self.shutdown.wait(ACCEPT_POLL_INTERVAL_S)
                continue
            try:
                with self._sdr_lock:
                    data = self.sdr.read_sync(DEFAULT_BUF_LENGTH)
            except Exception as e:  # noqa: BLE001 — device gone: stop serving
                log.error("Read error, stopping acquisition: %s", e)
                for s in sessions:
                    s.errors.append(f"Read error: {e}")
                    s.stop.set()
                self.shutdown.set()
                return
            if len(data) < DEFAULT_BUF_LENGTH:
                log.warning("Short read (%d), samples lost", len(data))
                continue
            for s in sessions:
                if s.stop.is_set():
                    continue
                if not s.queue.put(data, timeout=0.0):
                    s.drops += 1

    def stop(self) -> None:
        self.shutdown.set()

    # -- per-client --------------------------------------------------------

    def serve_client(self, stream: socket.socket, addr) -> str | None:
        errors: list[str] = []
        connection_stop = threading.Event()
        try:
            gains = self.sdr.get_tuner_gains()
            tuner_type = TUNER_TYPE_CODES.get(self.sdr.get_tuner_id(), 0)
            send_handshake(stream, tuner_type, len(gains))
        except OSError as e:
            stream.close()
            return f"Failed to send handshake: {e}"

        data_q = _BlockQueue(DEFAULT_BUF_LENGTH, self.queue_limit)
        manual_mode = self.default_gain is not None
        last_gain = self.default_gain if self.default_gain is not None else (
            gains[0] if gains else 0
        )
        ctl_state = {"manual": manual_mode, "last_gain": last_gain, "gains": gains}

        sender = threading.Thread(
            target=self._sender_loop, args=(stream, data_q, connection_stop, errors),
            daemon=True,
        )
        commander = threading.Thread(
            target=self._command_loop, args=(stream, ctl_state, connection_stop, errors),
            daemon=True,
        )
        sender.start()
        commander.start()

        # Main loop: sync reads -> bounded queue (ref rtl_tcp.rs:409-470)
        while not (connection_stop.is_set() or self.shutdown.is_set()):
            try:
                with self._sdr_lock:
                    data = self.sdr.read_sync(DEFAULT_BUF_LENGTH)
            except Exception as e:
                errors.append(f"Read error: {e}")
                break
            if len(data) < DEFAULT_BUF_LENGTH:
                errors.append(f"Short read ({len(data)}), samples lost")
                break
            # Bounded-queue backpressure: the reference's sync_channel
            # blocks; a persistent stall means the client is dead.
            queued = False
            while not queued:
                queued = data_q.put(data, timeout=1.0)
                if not queued and (connection_stop.is_set()
                                   or self.shutdown.is_set()):
                    break
            if not queued:
                break
        connection_stop.set()
        data_q.close()
        sender.join(timeout=2.0)
        data_q.destroy()
        try:
            stream.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        stream.close()
        commander.join(timeout=2.0)
        return ", ".join(errors) if errors else None

    def _sender_loop(self, stream, data_q, stop: threading.Event, errors: list):
        """Queue -> socket writer (ref sender_loop, rtl_tcp.rs:609-631)."""
        while not (stop.is_set() or self.shutdown.is_set()):
            try:
                buf = data_q.get(timeout=0.2)
            except TimeoutError:
                continue
            if buf is None:
                break
            try:
                stream.sendall(buf)
            except OSError as e:
                errors.append(f"Failed to send data: {e}")
                stop.set()
                return

    def _command_loop(self, stream, ctl, stop: threading.Event, errors: list):
        """5-byte command reader (ref command_loop, rtl_tcp.rs:633-689)."""
        while not (stop.is_set() or self.shutdown.is_set()):
            try:
                buf = self._read_exact(stream, 5)
            except OSError as e:
                errors.append(f"Command read failed: {e}")
                stop.set()
                return
            if buf is None:  # EOF: client left
                stop.set()
                return
            cmd = buf[0]
            (param_u32,) = struct.unpack(">I", buf[1:5])
            param_i32 = struct.unpack(">i", buf[1:5])[0]
            try:
                with self._sdr_lock:
                    self._handle_command(cmd, param_u32, param_i32, ctl)
            except Exception as e:
                errors.append(str(e))
                stop.set()
                return

    @staticmethod
    def _read_exact(stream: socket.socket, n: int) -> bytes | None:
        data = b""
        while len(data) < n:
            chunk = stream.recv(n - len(data))
            if not chunk:
                return None
            data += chunk
        return data

    def _handle_command(self, cmd: int, u32: int, i32: int, ctl: dict) -> None:
        """Apply one control message (ref handle_control_message,
        rtl_tcp.rs:504-607)."""
        sdr = self.sdr
        if cmd == CMD_SET_FREQUENCY:
            sdr.set_center_freq(u32)
        elif cmd == CMD_SET_SAMPLE_RATE:
            sdr.set_sample_rate(u32)
            sdr.reset_buffer()
        elif cmd == CMD_SET_GAIN_MODE:
            ctl["manual"] = bool(u32)
            sdr.set_tuner_gain(TunerGain.AUTO if not u32 else TunerGain.manual(0))
        elif cmd == CMD_SET_GAIN:
            ctl["manual"] = True
            ctl["last_gain"] = i32
            sdr.set_tuner_gain(TunerGain.manual(i32))
        elif cmd == CMD_SET_FREQ_CORRECTION:
            sdr.set_freq_correction(i32)
        elif cmd == CMD_SET_IF_GAIN:
            stage, gain = u32 >> 16, u32 & 0xFFFF
            log.info("set if gain not supported (stage=%d, gain=%d)", stage, gain)
        elif cmd == CMD_SET_TEST_MODE:
            sdr.set_testmode(bool(u32))
        elif cmd == CMD_SET_AGC_MODE:
            log.info("set agc mode not implemented")
        elif cmd == CMD_SET_DIRECT_SAMPLING:
            mode = {0: DirectSampleMode.OFF, 1: DirectSampleMode.ON,
                    2: DirectSampleMode.ON_SWAP}.get(u32, DirectSampleMode.OFF)
            sdr.set_direct_sampling(mode)
        elif cmd == CMD_SET_OFFSET_TUNING:
            log.info("offset tuning request ignored (not supported): %s", bool(u32))
        elif cmd == CMD_SET_RTL_XTAL:
            log.info("set rtl xtal not supported: %d", u32)
        elif cmd == CMD_SET_TUNER_XTAL:
            log.info("set tuner xtal not supported: %d", u32)
        elif cmd == CMD_SET_GAIN_BY_INDEX:
            gains = ctl["gains"] or self.sdr.get_tuner_gains()
            ctl["gains"] = gains
            if u32 < len(gains):
                ctl["manual"] = True
                ctl["last_gain"] = gains[u32]
                sdr.set_tuner_gain(TunerGain.manual(gains[u32]))
        elif cmd == CMD_SET_BIAS_TEE:
            sdr.set_bias_tee(bool(u32))
        # unknown opcodes are ignored (ref rtl_tcp.rs:677)
