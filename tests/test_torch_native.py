"""The port's native host runtime (``tpu_sdr_torch.native``) against the JAX
package's (``tpu_sdr.native``, over ``csrc/tpusdr_io.cpp``).

Part 1 holds the port's ring and pump to the behaviours of
``tests/test_native_io.py``: FIFO order, drops, timeout and EOF, a pop
across threads, the fd pump with and without loop replay, a non-blocking
fd, and a concurrent stress.  Part 2 holds each byte map, on the port's
native path and on its numpy fallback, bit-equal to the JAX package's (and
the fs/4 rotation to ``pallas_fm.host_rotate_fs4_u8``, phases 0-3), with
one size contract for the rotation on both paths (the float unpack
bit-equal to JAX's numpy formula, within 2**-23 of its C++).  Part 3: the loader
rebuilds a stale library, and ``pop_into`` fills a torch buffer.  Inputs
are made from a seed with numpy; every comparison is exact (tolerance 0)
but that one.
"""

import os
import shutil
import socket
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

import tpu_sdr.native as jnative
import tpu_sdr_torch.native as tnative
from tpu_sdr.ops.pallas_fm import host_rotate_fs4_u8
from tpu_sdr_torch.native import NativePump, NativeRing


@pytest.fixture(autouse=True)
def _built():
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        pytest.skip("no C++ compiler to build the native runtime")
    assert tnative.available(), "g++ could not build the port's runtime"


# ---- part 1: the ring and the pump --------------------------------------------

def test_ring_fifo_and_count():
    ring = NativeRing(block_bytes=8, capacity=4)
    assert ring.push(bytes(range(8)))
    assert ring.push(np.arange(8, 16, dtype=np.uint8))
    assert len(ring) == 2
    assert list(ring.pop(timeout_ms=1000)) == list(range(8))
    assert list(ring.pop(timeout_ms=1000)) == list(range(8, 16))
    assert len(ring) == 0
    ring.close()
    with pytest.raises(ValueError):
        ring.push(bytes(8))  # a closed ring refuses, it does not crash


def test_ring_backpressure_drops():
    ring = NativeRing(block_bytes=4, capacity=2)
    assert ring.push(b"aaaa") and ring.push(b"bbbb")
    assert not ring.push(b"cccc")  # full -> dropped
    assert ring.dropped == 1
    assert bytes(ring.pop()) == b"aaaa"
    assert ring.push(b"dddd")  # slot freed
    with pytest.raises(ValueError):
        ring.push(b"toolong")
    ring.close()


def test_ring_pop_timeout_and_eof():
    ring = NativeRing(block_bytes=4, capacity=2)
    with pytest.raises(TimeoutError):
        ring.pop(timeout_ms=10)
    ring.push(b"xxxx")
    ring.set_eof()
    assert ring.eof
    assert bytes(ring.pop()) == b"xxxx"  # drains before EOF
    assert ring.pop(timeout_ms=1000) is None
    ring.close()


def test_ring_blocking_pop_cross_thread():
    ring = NativeRing(block_bytes=4, capacity=2)
    got = []
    t = threading.Thread(target=lambda: got.append(bytes(ring.pop(5000))))
    t.start()
    time.sleep(0.05)
    ring.push(b"late")
    t.join(timeout=5)
    assert not t.is_alive() and got == [b"late"]
    ring.close()


def _file(tmp_path, payload: bytes) -> str:
    path = tmp_path / "cap.u8"
    path.write_bytes(payload)
    return str(path)


def test_pump_reads_file_blocks(tmp_path):
    payload = np.random.default_rng(1).integers(0, 256, 1024, np.uint8).tobytes()
    fd = os.open(_file(tmp_path, payload), os.O_RDONLY)
    ring = NativeRing(block_bytes=128, capacity=16)
    pump = NativePump(ring, fd)
    blocks = []
    while (blk := ring.pop(timeout_ms=5000)) is not None:
        blocks.append(bytes(blk))
    assert pump.blocks_read == 8
    pump.stop()
    os.close(fd)
    ring.close()
    assert b"".join(blocks) == payload


def test_pump_loop_mode_replays(tmp_path):
    payload = bytes(range(64))
    fd = os.open(_file(tmp_path, payload), os.O_RDONLY)
    ring = NativeRing(block_bytes=32, capacity=8)
    pump = NativePump(ring, fd, loop_file=True, block_on_full=True)
    blocks = [bytes(ring.pop(timeout_ms=5000)) for _ in range(6)]
    pump.stop()
    os.close(fd)
    ring.close()
    assert b"".join(blocks) == payload * 3


def test_pump_tolerates_nonblocking_fd():
    """Python socket timeouts set O_NONBLOCK; the pump must poll, not EOF."""
    a, b = socket.socketpair()
    a.settimeout(2.0)
    ring = NativeRing(block_bytes=64, capacity=4)
    pump = NativePump(ring, a.fileno())
    time.sleep(0.15)  # the pump meets EAGAIN before the data arrives
    b.sendall(bytes(range(64)))
    assert bytes(ring.pop(timeout_ms=5000)) == bytes(range(64))
    pump.stop()
    a.close()
    b.close()
    ring.close()


def test_ring_concurrent_stress():
    """Every block delivered once, in order, to a consumer that pops into
    its own buffer while a producer spins on a full ring."""
    ring = NativeRing(block_bytes=16, capacity=8)
    n_blocks, got = 2000, []

    def producer():
        for i in range(n_blocks):
            while not ring.push(i.to_bytes(4, "little") * 4):
                pass
        ring.set_eof()

    def consumer():
        buf = np.empty(16, np.uint8)
        while ring.pop_into(buf.ctypes.data, 10_000):
            got.append(int.from_bytes(buf[:4].tobytes(), "little"))

    threads = [threading.Thread(target=producer), threading.Thread(target=consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert got == list(range(n_blocks))
    ring.close()


@pytest.mark.parametrize("block_on_full", [True, False])
def test_pump_stress_order_and_drops(tmp_path, block_on_full):
    """The pump reads straight into the ring's free slot while the consumer
    copies out of the filled one, neither holding the lock: 20,000
    numbered blocks through a 4-block ring.  Replay delivers every block
    in order; a live source delivers an increasing subsequence and counts
    the rest as dropped."""
    n = 20_000
    blocks = np.repeat(np.arange(n, dtype=np.uint32)[:, None], 16, axis=1)
    fd = os.open(_file(tmp_path, blocks.tobytes()), os.O_RDONLY)
    ring = NativeRing(block_bytes=64, capacity=4)
    pump = NativePump(ring, fd, block_on_full=block_on_full)
    buf = np.empty(16, np.uint32)
    got = []
    while ring.pop_into(buf.ctypes.data, 10_000):
        assert (buf == buf[0]).all(), "a torn block"
        got.append(int(buf[0]))
        if not block_on_full and len(got) % 64 == 0:
            time.sleep(0.001)
    pump.stop()
    os.close(fd)
    if block_on_full:
        assert got == list(range(n)) and ring.dropped == 0
    else:
        assert all(a < b for a, b in zip(got, got[1:]))
        assert len(got) + ring.dropped == n
    ring.close()


# ---- part 2: the byte maps, native and numpy, against JAX's -----------------

@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(tnative, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_rotate_fs4_u8_is_jax_bit_for_bit(path, phase):
    buf = np.random.default_rng(11 + phase).integers(0, 256, 4096, np.uint8)
    got = tnative.rotate_fs4_u8(buf, phase=phase)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, host_rotate_fs4_u8(buf, phase=phase))
    np.testing.assert_array_equal(got, jnative.rotate_fs4_u8(buf, phase=phase))


@pytest.mark.parametrize("size", [2, 6, 4094, 4100])
def test_rotate_fs4_u8_takes_whole_periods_only(path, size):
    with pytest.raises(ValueError, match="whole 4-sample periods"):
        tnative.rotate_fs4_u8(np.zeros(size, np.uint8))


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_u8_iq_to_planar_f32_matches_jax(path, phase):
    """Bit-equal to the JAX package's numpy formula on both paths (the
    port's C++ is built without fused multiply-adds); within 2**-23, one
    rounding of the product ``u * scale`` in [0, 2], of JAX's C++, which
    ``-march=native`` may build with them."""
    buf = np.random.default_rng(7 + phase).integers(0, 256, 1030, np.uint8)
    k = (np.arange(515) + phase) % 4
    for scale in (1.0 / 127.5, 2.0):
        x = buf.astype(np.float32) * scale - 127.5 * scale
        i, q = x[0::2], x[1::2]
        formula = (np.select([k == 0, k == 1, k == 2], [i, -q, -i], q),
                   np.select([k == 0, k == 1, k == 2], [q, i, -q], -i))
        got = tnative.u8_iq_to_planar_f32(buf, phase=phase, scale=scale)
        want = jnative.u8_iq_to_planar_f32(buf, phase=phase, scale=scale)
        for g, f, w in zip(got, formula, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, f.astype(np.float32))
            np.testing.assert_allclose(g, w, rtol=0, atol=2.0 ** -23)


def test_f32_to_s16_is_jax_bit_for_bit(path):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-1.3, 1.3, 10_001),
                        [0.0, -0.0, 1.0, -1.0, 2.0, -2.0]]).astype(np.float32)
    for scale in (0.9 * 32767.0, 32767.0):
        np.testing.assert_array_equal(tnative.f32_to_s16(x, scale),
                                      jnative.f32_to_s16(x, scale))
    out = tnative.f32_to_s16(np.array([0.0, 2.0, -2.0], np.float32), 32767.0)
    assert list(out) == [0, 32767, -32768]


def test_count_pattern_breaks_is_jax_bit_for_bit(path):
    rng = np.random.default_rng(5)
    clean = (np.arange(3000) % 256).astype(np.uint8)
    broken = clean.copy()
    broken[rng.integers(0, 3000, 7)] ^= 0x55
    for buf in (clean, broken, np.array([1, 2, 4, 5], np.uint8),
                np.zeros(0, np.uint8)):
        for last in (-1, 0, 255, int(buf[0]) - 1 if buf.size else 3):
            assert (tnative.count_pattern_breaks(buf, last)
                    == jnative.count_pattern_breaks(buf, last))
    assert tnative.count_pattern_breaks(clean) == (0, int(clean[-1]))


def test_parse_tcp_commands_is_jax_bit_for_bit(path):
    rng = np.random.default_rng(9)
    for n in (0, 4, 5, 11, 500):
        buf = rng.integers(0, 256, n, np.uint8).tobytes()
        assert tnative.parse_tcp_commands(buf) == jnative.parse_tcp_commands(buf)
    assert tnative.parse_tcp_commands(bytes([0x01, 0x05, 0xF5, 0xE1, 0x00, 0x07])) \
        == [(0x01, 100_000_000)]


# ---- part 3: the loader, and pop_into ------------------------------------------

def _fresh_loader(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    return tnative.library_path()


def _works(lib) -> bool:
    out = np.empty(8, np.uint8)
    lib.tsdr_rotate_fs4_u8(np.arange(8, dtype=np.uint8).ctypes.data,
                           out.ctypes.data, 4, 0)
    return list(out) == [0, 1, 252, 2, 251, 250, 7, 249]


@pytest.mark.parametrize("stale", ["garbage", "missing_entry_point"])
def test_stale_library_is_rebuilt(monkeypatch, tmp_path, stale):
    """A file under the current name that does not load, or that lacks an
    entry point (a build of a source cut short), is rebuilt and the new
    build loaded; the JAX loader misses the second (its except takes only
    OSError)."""
    path = _fresh_loader(monkeypatch, tmp_path)
    if stale == "garbage":
        with open(path, "wb") as f:
            f.write(b"not a shared library")
    else:
        src = open(tnative.SRC).read()
        cut = tmp_path / "cut.cpp"
        cut.write_text(src[:src.index("size_t tsdr_parse_tcp_commands")] + "}\n")
        subprocess.run(["g++", *tnative.CXX_FLAGS, str(cut), "-o", path,
                        "-lpthread"], check=True, capture_output=True)
    lib = tnative.load()
    assert lib is not None and _works(lib)
    assert tnative.build_seconds > 0
    with open(path, "rb") as f:
        assert f.read(4) == b"\x7fELF"
    assert not [p for p in os.listdir(tmp_path) if ".tmp" in p]


def test_no_native_env_and_a_reused_build(monkeypatch, tmp_path):
    path = _fresh_loader(monkeypatch, tmp_path)
    monkeypatch.setenv("TPU_SDR_NO_NATIVE", "1")
    assert tnative.load() is None and not tnative.available()
    monkeypatch.delenv("TPU_SDR_NO_NATIVE")
    monkeypatch.setattr(tnative, "_tried", False)
    assert tnative.load() is not None and os.path.exists(path)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "build_seconds", 0.0)
    assert _works(tnative.load()) and tnative.build_seconds == 0.0


def test_pop_into_a_torch_buffer():
    ring = NativeRing(block_bytes=64, capacity=4)
    blocks = [np.random.default_rng(i).integers(0, 256, 64, np.uint8)
              for i in range(3)]
    for b in blocks:
        assert ring.push(b)
    ring.set_eof()
    dst = torch.zeros(64, dtype=torch.uint8)
    for b in blocks:
        assert ring.pop_into(dst.data_ptr(), 1000)
        np.testing.assert_array_equal(dst.numpy(), b)
    assert ring.pop_into(dst.data_ptr(), 1000) is False
    ring.close()
    with pytest.raises(ValueError):
        ring.pop_into(dst.data_ptr(), 0)
