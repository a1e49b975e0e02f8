"""The port's native host runtime (``tpu_sdr_torch.native``) against the JAX
package's (``tpu_sdr.native``, over ``csrc/tpusdr_io.cpp``).

Part 1 holds the port's ring and pump to the behaviours of
``tests/test_native_io.py``: FIFO order, drops, timeout and EOF, a pop
across threads, the fd pump with and without loop replay, a non-blocking
fd, and a concurrent stress.  Part 2 holds each byte map, on the port's
native path and on its numpy fallback, bit-equal to the JAX package's (and
the fs/4 rotation to ``pallas_fm.host_rotate_fs4_u8``, phases 0-3), with
one size contract for the rotation on both paths (the float unpack
bit-equal to JAX's numpy formula, within 2**-23 of its C++); f32 -> s16 on
each of its four paths, each call counted on the path it took.  Part 3: the
loader rebuilds a stale library and reuses a good one, a build without the
interpreter's headers or SSE2 converts through ctypes, and ``pop_into``
fills a torch buffer.  Inputs
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
import tpu_sdr_torch.native.io as tio
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


# f32 -> s16 has four paths: the native module's entry reading the input in
# place, the entry after the wrapper copied the input, the loop through
# ctypes (a build without the interpreter's headers) and numpy.

S16_SCALES = (0.9 * 32767.0, 32767.0)
S16_PATHS = ("entry", "copied", "ctypes", "numpy")
# what each path adds to s16_calls() a call
S16_MOVES = {"entry": {"entry": 1}, "copied": {"entry": 1, "copied": 1},
             "ctypes": {"ctypes": 1}, "numpy": {"numpy": 1}}


def _bind_s16(monkeypatch, path):
    if path in ("entry", "copied"):
        if tnative.module() is None:
            pytest.skip("the runtime was built without the interpreter's "
                        "headers: it has no entry")
        monkeypatch.setattr(tio, "_s16", tnative.module().f32_to_s16)
    else:
        monkeypatch.setattr(tio, "_s16", getattr(tio, f"_s16_{path}"))


@pytest.fixture(params=S16_PATHS)
def s16_path(request, monkeypatch):
    _bind_s16(monkeypatch, request.param)
    return request.param


def _s16_edges(scale: float) -> np.ndarray:
    """+-inf, +-0.0, both saturation edges and the values next to them, and
    steps of 0.5 LSB about -40..40 and about the edges, at ``scale``."""
    s = np.float32(scale)
    lsb = np.concatenate([np.float32([32767, -32768, 32768, -32769, 32766,
                                      -32767]), np.arange(-40, 41)])
    steps = (np.concatenate([lsb, lsb + 0.5, lsb - 0.5]) / s).astype(np.float32)
    return np.concatenate([
        np.float32([np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 2.0, -2.0]),
        steps, np.nextafter(steps, np.float32(np.inf)),
        np.nextafter(steps, np.float32(-np.inf))]).astype(np.float32)


def _s16_vector(n: int, scale: float, seed: int = 3) -> np.ndarray:
    """n samples: the edges in order from the first lane (so that short
    vectors hold +-inf and the saturation edges), every third random
    audio past full scale."""
    x = np.resize(_s16_edges(scale), n)
    x[1::3] = np.random.default_rng(seed + n).uniform(-1.3, 1.3, x[1::3].size)
    return x


def _s16_formula(x: np.ndarray, scale: float) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return np.clip(x * np.float32(scale), -32768, 32767).astype(np.int16)


def _s16_counted(path: str, x, scale: float, calls: int = 1) -> np.ndarray:
    """``f32_to_s16(x, scale)``, held to have taken ``path``."""
    before = tio.s16_calls()
    got = tnative.f32_to_s16(x, scale)
    for _ in range(calls - 1):
        tnative.f32_to_s16(x, scale)
    after = tio.s16_calls()
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert moved == {k: v * calls for k, v in S16_MOVES[path].items()}
    assert got.dtype == np.int16
    return got


@pytest.mark.parametrize("n", [*range(18), 1023, 1024, 1025, 4112, 8192])
def test_f32_to_s16_is_jax_bit_for_bit(s16_path, n):
    """Each path at lengths about the 8-wide body and its tail: the numpy
    formula's bits and the JAX package's, at both scales.  The copied path
    is handed float64 (each float32 exact in it)."""
    for scale in S16_SCALES:
        x = _s16_vector(n, scale)
        shown = x.astype(np.float64) if s16_path == "copied" else x
        got = _s16_counted(s16_path, shown, scale)
        assert got.shape == (n,)
        np.testing.assert_array_equal(got, _s16_formula(x, scale))
        np.testing.assert_array_equal(got, jnative.f32_to_s16(x, scale))
    out = tnative.f32_to_s16(np.array([0.0, 2.0, -2.0], np.float32), 32767.0)
    assert list(out) == [0, 32767, -32768]


@pytest.mark.parametrize("path", ["entry", "ctypes", "numpy"])
@pytest.mark.parametrize("layout", ["rows", "unaligned", "strided", "float64",
                                    "read_only"])
def test_f32_to_s16_takes_every_layout(monkeypatch, path, layout):
    """The rows of a C-contiguous (64, 1024) array (64 entry calls, none
    copied), a row one float past an aligned start, and a strided, a float64
    and a read-only input; the entry copies the strided and float64 ones
    first.  Both scales, bit-equal to the numpy formula and to JAX."""
    _bind_s16(monkeypatch, path)
    copies = layout in ("strided", "float64")
    for scale in S16_SCALES:
        x = _s16_vector(64 * 1024 if layout == "rows" else 1025, scale)
        if layout == "rows":
            rows = x.reshape(64, 1024)
            before = tio.s16_calls()
            got = np.stack([tnative.f32_to_s16(r, scale) for r in rows])
            after = tio.s16_calls()
            assert after[path] - before[path] == 64
            assert after["copied"] == before["copied"]
            np.testing.assert_array_equal(got, _s16_formula(rows, scale))
            np.testing.assert_array_equal(
                got, np.stack([jnative.f32_to_s16(r, scale) for r in rows]))
            continue
        if layout == "unaligned":
            shown = np.empty(x.size + 1, np.float32)[1:]
            shown[:] = x
            assert shown.ctypes.data % 16
        elif layout == "strided":
            shown = np.empty((x.size, 3), np.float32)[:, 1]
            shown[:] = x
        elif layout == "float64":
            shown = x.astype(np.float64)
        else:
            shown = x.copy()
            shown.setflags(write=False)
        got = _s16_counted("copied" if copies and path == "entry" else path,
                           shown, scale)
        np.testing.assert_array_equal(got, _s16_formula(x, scale))
        np.testing.assert_array_equal(got, jnative.f32_to_s16(x, scale))


@pytest.mark.parametrize("path", ["entry", "ctypes"])
def test_f32_to_s16_gives_nan_zero_in_every_lane(monkeypatch, path):
    """NaN is masked to 0 in the 8-wide body, as the scalar tail's cast
    gives it, so no sample's value depends on its lane."""
    _bind_s16(monkeypatch, path)
    x = np.full(19, np.nan, np.float32)
    x[::4] = 0.5
    got = tnative.f32_to_s16(x, 32767.0)
    assert list(got[1::4]) == [0] * 5 and list(got[::4]) == [16383] * 5


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
    monkeypatch.setattr(tnative, "_module", None)
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
    """A second load reuses the build, and its entry, without rebuilding."""
    path = _fresh_loader(monkeypatch, tmp_path)
    monkeypatch.setenv("TPU_SDR_NO_NATIVE", "1")
    assert tnative.load() is None and not tnative.available()
    monkeypatch.delenv("TPU_SDR_NO_NATIVE")
    monkeypatch.setattr(tnative, "_tried", False)
    assert tnative.load() is not None and os.path.exists(path)
    built = os.stat(path).st_mtime_ns
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_module", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "build_seconds", 0.0)
    assert _works(tnative.load()) and tnative.build_seconds == 0.0
    assert os.stat(path).st_mtime_ns == built
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    if "-DTSDR_PYTHON" in tnative.CXX_FLAGS:
        monkeypatch.setattr(tio, "_s16", tio._bind_s16)
        x = _s16_vector(1025, 32767.0)
        got = _s16_counted("entry", x, 32767.0)
        np.testing.assert_array_equal(got, _s16_formula(x, 32767.0))


def test_no_native_env_counts_numpy_calls_only(monkeypatch, tmp_path):
    """With ``TPU_SDR_NO_NATIVE`` set, f32_to_s16 binds numpy: only the
    numpy count moves, and nothing is built."""
    module = tnative.module()
    counts = module.s16_counts() if module is not None else None
    _fresh_loader(monkeypatch, tmp_path)
    monkeypatch.setenv("TPU_SDR_NO_NATIVE", "1")
    monkeypatch.setattr(tio, "_s16", tio._bind_s16)
    x = _s16_vector(1024, 0.9 * 32767.0)
    got = _s16_counted("numpy", x, 0.9 * 32767.0, calls=3)
    np.testing.assert_array_equal(got, _s16_formula(x, 0.9 * 32767.0))
    assert tio._s16 is tio._s16_numpy and not os.listdir(tmp_path)
    if module is not None:
        assert module.s16_counts() == counts


def test_without_the_interpreters_headers_or_sse2(monkeypatch, tmp_path):
    """Without the interpreter's headers the build has no CPython module
    and f32_to_s16 binds the loop through ctypes; with ``__SSE2__``
    undefined that loop is the scalar one alone.  The same bits."""
    monkeypatch.setattr(tnative.sysconfig, "get_path",
                        lambda name: str(tmp_path))
    assert tnative._python_flags() == ()
    base = tuple(f for f in tnative.CXX_FLAGS
                 if f != "-DTSDR_PYTHON" and not f.startswith("-I"))
    monkeypatch.setattr(tnative, "CXX_FLAGS", base + ("-U__SSE2__",))
    _fresh_loader(monkeypatch, tmp_path)
    monkeypatch.setattr(tio, "_s16", tio._bind_s16)
    assert tnative.available() and tnative.module() is None
    for n in (0, 7, 8, 17, 1025):
        for scale in S16_SCALES:
            x = _s16_vector(n, scale)
            got = _s16_counted("ctypes", x, scale)
            np.testing.assert_array_equal(got, _s16_formula(x, scale))
            np.testing.assert_array_equal(got, jnative.f32_to_s16(x, scale))
    assert tio._s16 is tio._s16_ctypes


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
