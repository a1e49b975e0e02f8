"""The port's rtl_tcp server (``tpu_sdr_torch.stream.rtl_tcp_server``)
against the JAX package's, over loopback sockets and fake dongles.

The ten cases of ``tests/test_rtl_tcp.py`` run against the port's server
with the port's client: handshake and stream, commands, counter test mode,
reconnect, an unknown opcode, all fourteen opcodes, and the fan-out mode
(full streams, per-client backpressure, the client limit, a freed slot).
Then the wire: the JAX package's client reads the same handshake and bytes
from the port's server as the port's client does from JAX's, and after the
same fourteen-opcode sequence the port's fake dongle holds the register
state that JAX's server leaves in JAX's.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

from tpu_sdr import api as japi
from tpu_sdr.control import fake as jfake
from tpu_sdr.stream import feeder as jfeeder
from tpu_sdr.stream.rtl_tcp_server import RtlTcpServer as JServer
from tpu_sdr_torch import api as tapi
from tpu_sdr_torch import native as tnative
from tpu_sdr_torch.control import fake as tfake
from tpu_sdr_torch.stream import feeder as tfeeder
from tpu_sdr_torch.stream.rtl_tcp_server import RtlTcpServer

Client = tfeeder.RtlTcpClientSource


def _serve(api, fake, server_cls, **kw):
    """A server on a fresh fake dongle, in a thread; returns (server,
    stop)."""
    fake.clear_fake_devices()
    fake.register_fake_device()
    sdr = api.RtlSdr.open_with_index(0)
    sdr.set_sample_rate(2_048_000)
    sdr.set_center_freq(100_000_000)
    sdr.reset_buffer()
    srv = server_cls(sdr, "127.0.0.1", 0, **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    deadline = time.time() + 5
    while srv.bound_port is None and time.time() < deadline:
        time.sleep(0.01)
    assert srv.bound_port is not None

    def stop():
        srv.stop()
        t.join(timeout=5)
        sdr.close()
        fake.clear_fake_devices()
        assert not t.is_alive()

    return srv, stop


@pytest.fixture()
def server():
    srv, stop = _serve(tapi, tfake, RtlTcpServer, queue_limit=16)
    yield srv
    stop()


@pytest.fixture()
def fanout_server():
    srv, stop = _serve(tapi, tfake, RtlTcpServer, queue_limit=8, max_clients=2)
    yield srv
    stop()


def test_handshake_and_stream(server):
    client = Client("127.0.0.1", server.bound_port)
    assert client.tuner_type == 5  # R820T (ref rtl_tcp.rs:699-708)
    assert client.gain_count == 29
    data = client.read_block(4096)
    assert data is not None and len(data) == 4096
    client.close()


def test_commands_applied(server):
    client = Client("127.0.0.1", server.bound_port)
    client.set_frequency(94_900_000)
    client.set_gain_mode(True)
    client.set_gain(297)
    client.set_test_mode(True)
    for _ in range(4):
        assert client.read_block(4096) is not None
    deadline = time.time() + 3
    while server.sdr.get_center_freq() != 94_900_000 and time.time() < deadline:
        time.sleep(0.02)
    assert server.sdr.get_center_freq() == 94_900_000
    client.close()


def test_test_mode_counter_over_tcp(server):
    """Opcode 0x07: after the switch the stream is the counter, checked
    with the port's native count_pattern_breaks across reads."""
    client = Client("127.0.0.1", server.bound_port)
    client.set_test_mode(True)
    time.sleep(0.3)  # let the mode flip between blocks
    data = np.frombuffer(client.read_block(65536), np.uint8)
    best = run = 0
    for i in range(1, len(data)):
        run = run + 1 if data[i] == (int(data[i - 1]) + 1) & 0xFF else 0
        best = max(best, run)
    assert best > 1000, f"no counter pattern seen (best run {best})"
    last, breaks = -1, 0
    client.read_block(262_144 - 65_536)  # to a block boundary
    for _ in range(8):
        b, last = tnative.count_pattern_breaks(
            np.frombuffer(client.read_block(262_144), np.uint8), last)
        breaks += b
    assert breaks == 0
    client.close()


def test_client_reconnect(server):
    c1 = Client("127.0.0.1", server.bound_port)
    assert c1.read_block(1024)
    c1.close()
    for _ in range(50):
        try:
            c2 = Client("127.0.0.1", server.bound_port)
            break
        except (ConnectionError, OSError):
            time.sleep(0.1)
    else:
        pytest.fail("server did not accept a second client")
    assert c2.read_block(1024)
    c2.close()


def test_unknown_command_ignored(server):
    client = Client("127.0.0.1", server.bound_port)
    client.command(0x7F, 123)  # not a real opcode
    assert client.read_block(1024) is not None
    client.close()


FOURTEEN = [
    (0x01, 100_000_000),  # SetFrequency
    (0x02, 2_048_000),    # SetSampleRate
    (0x03, 1),            # SetGainMode manual
    (0x04, 297),          # SetGain
    (0x05, 10),           # SetFreqCorrection
    (0x06, 0x0102),       # SetIfGain (no-op)
    (0x07, 0),            # SetTestMode off
    (0x08, 1),            # SetAgcMode (no-op)
    (0x09, 0),            # SetDirectSampling off
    (0x0A, 1),            # SetOffsetTuning (no-op)
    (0x0B, 28_800_000),   # SetRtlXtal (no-op)
    (0x0C, 28_800_000),   # SetTunerXtal (no-op)
    (0x0D, 3),            # SetGainByIndex
    (0x0E, 0),            # SetBiasTee off
]


def test_all_fourteen_opcodes_survive(server):
    client = Client("127.0.0.1", server.bound_port)
    for op, param in FOURTEEN:
        client.command(op, param)
    for _ in range(4):
        assert client.read_block(4096) is not None
    deadline = time.time() + 3
    while server.sdr.get_freq_correction() != 10 and time.time() < deadline:
        time.sleep(0.02)
    assert server.sdr.get_center_freq() == 100_000_000
    assert server.sdr.get_sample_rate() == 2_048_000
    assert server.sdr.get_freq_correction() == 10
    client.close()


def _counter_continuous(data: bytes) -> bool:
    return all(data[i + 1] == (data[i] + 1) % 256 for i in range(0, 512))


def test_fanout_two_clients_full_stream(fanout_server):
    a = Client("127.0.0.1", fanout_server.bound_port)
    b = Client("127.0.0.1", fanout_server.bound_port)
    assert a.tuner_type == 5 and b.tuner_type == 5
    a.set_test_mode(True)  # either client may command the shared device
    time.sleep(0.3)
    for client in (a, b):
        data = client.read_block(262144)
        assert len(data) == 262144
        assert _counter_continuous(bytes(data)), "gap in fanned-out stream"
    a.close()
    b.close()


def test_fanout_backpressure_isolated(fanout_server):
    slow = Client("127.0.0.1", fanout_server.bound_port)
    fast = Client("127.0.0.1", fanout_server.bound_port)
    fast.set_test_mode(True)
    deadline = time.time() + 10
    drops = []
    while time.time() < deadline:
        with fanout_server._sessions_lock:
            drops = [s.drops for s in fanout_server._sessions]
        if any(d > 3 for d in drops):
            break
        data = fast.read_block(262144)
        assert _counter_continuous(bytes(data)), "fast client saw a gap"
    assert any(d > 3 for d in drops), f"no drops recorded: {drops}"
    slow.close()
    fast.close()


def test_fanout_refuses_extra_client(fanout_server):
    a = Client("127.0.0.1", fanout_server.bound_port)
    b = Client("127.0.0.1", fanout_server.bound_port)
    extra = socket.create_connection(("127.0.0.1", fanout_server.bound_port),
                                     timeout=3)
    extra.settimeout(3)
    got = b""
    try:
        while len(got) < 12:
            chunk = extra.recv(12 - len(got))
            if not chunk:
                break
            got += chunk
    except socket.timeout:
        pass
    assert len(got) < 12, "server handshook a client beyond max_clients"
    extra.close()
    a.close()
    b.close()


def test_fanout_client_leaves_and_slot_reopens(fanout_server):
    a = Client("127.0.0.1", fanout_server.bound_port)
    b = Client("127.0.0.1", fanout_server.bound_port)
    b.close()
    deadline = time.time() + 5
    while time.time() < deadline:
        with fanout_server._sessions_lock:
            if len(fanout_server._sessions) <= 1:
                break
        time.sleep(0.05)
    c = Client("127.0.0.1", fanout_server.bound_port)
    assert c.tuner_type == 5
    assert len(c.read_block(4096)) == 4096
    a.close()
    c.close()


# ---- the wire against the JAX package's server and client -------------------

@pytest.mark.parametrize("pair", ["jax_client_port_server",
                                  "port_client_jax_server"])
def test_wire_is_the_jax_servers(pair):
    """Each package's client on the other's server, and the same client on
    its own package's server: the same handshake bytes and the same first
    4096 bytes of the stream (a counter whose 262,144-byte blocks all start
    at 0)."""
    seen = []
    for side in ("port", "jax"):
        if side == "port":
            srv, stop = _serve(tapi, tfake, RtlTcpServer, queue_limit=16)
        else:
            srv, stop = _serve(japi, jfake, JServer, queue_limit=16)
        cls = (jfeeder.RtlTcpClientSource
               if (pair == "jax_client_port_server") == (side == "port")
               else tfeeder.RtlTcpClientSource)
        try:
            raw = socket.create_connection(("127.0.0.1", srv.bound_port), 3)
            hello = raw.recv(12, socket.MSG_WAITALL)
            raw.close()
            client = cls("127.0.0.1", srv.bound_port)
            seen.append((hello, client.tuner_type, client.gain_count,
                         client.read_block(4096)))
            client.close()
        finally:
            stop()
    assert seen[0] == seen[1]
    assert seen[0][0] == b"RTL0" + struct.pack(">II", 5, 29)
    assert seen[0][3] == bytes(range(256)) * 16


def _registers(sdr) -> tuple:
    backend = sdr._core.handle.handle
    return (dict(backend.sys_regs), dict(backend.demod_regs),
            bytes(backend.tuner_regs), sdr.get_center_freq(),
            sdr.get_sample_rate(), sdr.get_freq_correction(),
            sdr.read_tuner_gain())


def test_fourteen_opcodes_leave_the_jax_servers_register_state():
    """The same fourteen-opcode sequence (then one more frequency, so a
    change marks the end) through each package's client to each package's
    server: the fake dongles end with equal registers and getters."""
    states = []
    for api, fake, server_cls, client_cls in (
            (tapi, tfake, RtlTcpServer, tfeeder.RtlTcpClientSource),
            (japi, jfake, JServer, jfeeder.RtlTcpClientSource)):
        srv, stop = _serve(api, fake, server_cls, queue_limit=16)
        try:
            client = client_cls("127.0.0.1", srv.bound_port)
            for op, param in FOURTEEN + [(0x01, 95_500_000)]:
                client.command(op, param)
            deadline = time.time() + 5
            while (srv.sdr.get_center_freq() != 95_500_000
                   and time.time() < deadline):
                assert client.read_block(4096) is not None
            assert srv.sdr.get_center_freq() == 95_500_000
            client.close()
            with srv._sdr_lock:
                states.append(_registers(srv.sdr))
        finally:
            stop()
    assert states[0] == states[1]
