"""The port's feeder on its native runtime, ``device_blocks``, and the fused
streamers fed tensors, against the JAX package and against the numpy feed.

On the CPU ``device_blocks`` yields plain tensors (no pinning, no stream);
its CUDA form (pinned slots, a side stream) runs in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  Inputs are made from a
seed with numpy; every comparison here is exact (bytes and audio bits),
except the tone over the network path, held to ``tests/test_cli.py``'s
20 dB.
"""

import io
import logging
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_sdr.stream import feeder as jfeeder
from tpu_sdr_torch import api as tapi
from tpu_sdr_torch import native as tnative
from tpu_sdr_torch.control import fake as tfake
from tpu_sdr_torch.ops import fused_fm as FF
from tpu_sdr_torch.stream import checkpoint as C
from tpu_sdr_torch.stream import feeder as tfeeder
from tpu_sdr_torch.stream.rtl_tcp_server import RtlTcpServer
from tpu_sdr_torch.utils import synth

torch.set_num_threads(1)

READ = 262_144  # the CLIs' read: 2 chunks and a residual of 1,024 bytes


@pytest.fixture
def capture(tmp_path):
    data = np.random.default_rng(5).integers(0, 256, 4096 * 7 + 100, np.uint8)
    path = tmp_path / "cap.u8"
    data.tofile(path)
    return str(path), data[:4096 * 7]


class _BytesSource(tfeeder.BlockSource):
    """A source with no OS fd (Python produces its bytes)."""

    def __init__(self, data: np.ndarray, backpressure: bool = True):
        self.data, self.pos, self.backpressure = data.tobytes(), 0, backpressure

    def read_block(self, length):
        if self.pos + length > len(self.data):
            return None
        self.pos += length
        return self.data[self.pos - length:self.pos]

    @property
    def wants_backpressure(self):
        return self.backpressure


def _drain(feeder) -> list:
    feeder.start()
    got = [b.copy() for b in feeder.blocks()]
    feeder.stop()
    return got


def test_native_pump_delivers_the_jax_feeders_blocks(capture):
    path, data = capture
    port = tfeeder.BlockFeeder(tfeeder.FileSource(path), block_bytes=4096,
                               queue_blocks=2)
    jax = jfeeder.BlockFeeder(jfeeder.FileSource(path), block_bytes=4096,
                              queue_blocks=2)
    got, want = _drain(port), _drain(jax)
    assert port.is_native and jax.is_native and port._pump is None
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.concatenate(got), data)
    assert port.dropped == jax.dropped == 0


@pytest.mark.parametrize("native", [None, False])
def test_a_source_without_an_fd_goes_through_the_queue(capture, native):
    """No fd: a Python thread pushes into the C++ ring (native) or a
    Python queue (native=False); the same blocks either way, and a replay
    behind a full two-block queue counts no drop."""
    _, data = capture
    feeder = tfeeder.BlockFeeder(_BytesSource(data), block_bytes=4096,
                                 queue_blocks=2, native=native)
    got = _drain(feeder)
    assert feeder.is_native is (native is None)
    np.testing.assert_array_equal(np.concatenate(got), data)
    assert feeder.dropped == 0 and feeder._pump is None


def test_native_true_raises_without_the_runtime(monkeypatch, capture):
    monkeypatch.setattr(tnative, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native runtime"):
        tfeeder.BlockFeeder(tfeeder.FileSource(capture[0]), native=True)
    assert not tfeeder.BlockFeeder(tfeeder.FileSource(capture[0])).is_native


def test_live_source_without_an_fd_drops_on_the_ring(capture):
    """A live source with no fd behind a one-block ring and a consumer
    that sleeps: every block is delivered or counted as dropped."""
    _, data = capture
    feeder = tfeeder.BlockFeeder(_BytesSource(data, backpressure=False),
                                 block_bytes=4096, queue_blocks=1).start()
    got = []
    for b in feeder.blocks():
        got.append(b.copy())
        time.sleep(0.05)
    feeder.stop()
    assert feeder.is_native and feeder.dropped >= 1
    assert len(got) + feeder.dropped == 7


@pytest.mark.parametrize("native", [None, False])
def test_device_blocks_on_the_cpu_yields_the_blocks_in_order(capture, native):
    path, data = capture
    feeder = tfeeder.BlockFeeder(tfeeder.FileSource(path), block_bytes=4096,
                                 queue_blocks=2, native=native).start()
    got = []
    for blk in feeder.device_blocks(torch.device("cpu")):
        assert blk.device.type == "cpu" and blk.dtype == torch.uint8
        assert feeder.popped_at is not None
        got.append(blk.numpy().copy())
    feeder.stop()
    assert feeder.staging == []  # no pinning on the CPU
    np.testing.assert_array_equal(np.concatenate(got), data)
    with pytest.raises(ValueError):
        next(tfeeder.BlockFeeder(tfeeder.FileSource(path)).device_blocks("meta"))


@pytest.fixture(scope="module")
def station():
    u8, _ = synth.synth_wbfm_u8(5 * READ // 2, capture_rate=1_020_000,
                                noise_std=0.01, seed=3)
    return np.asarray(u8, np.uint8)


def _reads(u8):
    return [u8[s:s + READ] for s in range(0, len(u8), READ)]


def test_fused_streamer_fed_tensors_is_bit_equal(station, tmp_path):
    """262,144-byte reads, a residual every read: fed numpy, fed tensors
    and fed by the feeder's device_blocks(cpu), the same audio bits."""
    cpu = torch.device("cpu")
    ref = FF.FusedWbfmStreamer(device=cpu)
    want = np.concatenate([ref.demodulate(r) for r in _reads(station)])
    st = FF.FusedWbfmStreamer(device=cpu)
    got = np.concatenate([st.demodulate(torch.from_numpy(r.copy()))
                          for r in _reads(station)])
    assert torch.is_tensor(st._pending) and st._pending.numel() == 5 * 1024
    np.testing.assert_array_equal(got, want)
    path = tmp_path / "station.u8"
    station.tofile(path)
    feeder = tfeeder.BlockFeeder(tfeeder.FileSource(str(path)),
                                 block_bytes=READ).start()
    st = FF.FusedWbfmStreamer(device=cpu)
    fed = np.concatenate([st.demodulate(b) for b in feeder.device_blocks(cpu)])
    feeder.stop()
    np.testing.assert_array_equal(fed, want)


def test_fused_batch_streamer_fed_tensors_is_bit_equal():
    rng = np.random.default_rng(8)
    bufs = rng.integers(0, 256, (2, 3 * 100_002), np.uint8)
    outs = []
    for as_tensor in (False, True):
        st = FF.FusedWbfmBatchStreamer(2, device="cpu")
        outs.append(np.concatenate([st.demodulate(
            torch.from_numpy(bufs[:, s:s + 100_002].copy()) if as_tensor
            else bufs[:, s:s + 100_002]) for s in range(0, bufs.shape[1],
                                                         100_002)], axis=1))
    assert outs[0].shape == (2, 2 * FF.default_spec().audio_per_chunk)
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize("fed", ["fresh", "fed_tensors"])
def test_checkpoint_with_a_tensor_pending_resumes_bit_equal(station, tmp_path,
                                                            fed):
    """The streamer's ``_pending`` is a tensor after tensor reads; saved,
    it loads into a fresh streamer (as numpy) or into one already fed
    tensors (as a tensor on its device), and the resumed audio is the
    uninterrupted run's, bit for bit."""
    cpu = torch.device("cpu")
    reads = [torch.from_numpy(r.copy()) for r in _reads(station)]
    ref = FF.FusedWbfmStreamer(device=cpu)
    full = np.concatenate([ref.demodulate(r) for r in reads])
    first = FF.FusedWbfmStreamer(device=cpu)
    head = [first.demodulate(r) for r in reads[:2]]
    assert torch.is_tensor(first._pending) and first._pending.numel()
    path = str(tmp_path / "ck.npz")
    C.save_stream_state(path, first)
    resumed = FF.FusedWbfmStreamer(device=cpu)
    if fed == "fed_tensors":
        resumed.demodulate(torch.zeros(1000, dtype=torch.uint8))
    C.load_stream_state(path, resumed)
    assert torch.is_tensor(resumed._pending) is (fed == "fed_tensors")
    np.testing.assert_array_equal(np.asarray(resumed._pending),
                                  np.asarray(first._pending))
    tail = [resumed.demodulate(r) for r in reads[2:]]
    np.testing.assert_array_equal(np.concatenate(head + tail), full)


class _BinStdout:
    def __init__(self):
        self.buffer = io.BytesIO()

    def flush(self):
        pass

    def write(self, s):
        pass


def test_simple_fm_tcp_fused_against_the_ports_server(caplog):
    """simple_fm --tcp --mode fused --torch-device cpu: the port's server
    on a fake dongle synthesizing a station, the port's native pump on the
    socket; the 1 kHz tone survives (tests/test_cli.py's 20 dB) and each
    read's latency is recorded.  The fake dongle is not paced, so the
    pump drops what the CPU chain cannot keep up with, as a live source
    does (the paced run with no drops is chip_smoke.py's)."""
    from tpu_sdr_torch.apps.simple_fm import main

    tfake.clear_fake_devices()
    tfake.register_fake_device(tfake.FakeDeviceSpec(
        serial="tcp00001",
        source_factory=lambda: tfake.SynthFmSource(capture_rate=1_020_000)))
    sdr = tapi.RtlSdr.open_with_index(0)
    srv = RtlTcpServer(sdr, "127.0.0.1", 0, queue_limit=32)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    deadline = time.time() + 5
    while srv.bound_port is None and time.time() < deadline:
        time.sleep(0.01)
    old, sys.stdout = sys.stdout, _BinStdout()
    out = sys.stdout
    try:
        with caplog.at_level(logging.INFO, logger="simple_fm"):
            rc = main(["--tcp", f"127.0.0.1:{srv.bound_port}", "--mode",
                       "fused", "--torch-device", "cpu", "--blocks", "6"])
    finally:
        sys.stdout = old
        srv.stop()
        t.join(timeout=5)
        sdr.close()
        tfake.clear_fake_devices()
    assert rc == 0
    pcm = np.frombuffer(out.buffer.getvalue(), "<i2").astype(np.float64)
    assert len(pcm) > 20_000
    snr = synth.tone_snr(pcm, 1_000.0, 32_000, skip=4000)
    assert snr > 20, f"tone lost over the tcp path: {snr:.1f} dB"
    (stats,) = [r.block_stats for r in caplog.records
                if hasattr(r, "block_stats")]
    assert stats.blocks == 6
    assert len(stats.latencies_ms) == 6 and min(stats.latencies_ms) >= 0
