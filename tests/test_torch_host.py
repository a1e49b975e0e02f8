"""tpu_sdr_torch's own host layer against the JAX package's originals.

The port keeps copies of the jax-free host code it runs on (filter design,
the s16 conversion, the block feeder, the rtl_tcp client and the device
control plane) so that it imports nothing of ``tpu_sdr``.  Here: the import
guard, and each copy held against the module it was copied from.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpu_sdr import api as japi
from tpu_sdr import native as jnative
from tpu_sdr.control import fake as jfake
from tpu_sdr.stream import feeder as jfeeder
from tpu_sdr.stream.rtl_tcp_server import RtlTcpServer
from tpu_sdr.utils import firdes as jfirdes
from tpu_sdr_torch import api as tapi
from tpu_sdr_torch import native as tnative
from tpu_sdr_torch.apps import simple_fm as tsimple
from tpu_sdr_torch.control import fake as tfake
from tpu_sdr_torch.stream import feeder as tfeeder
from tpu_sdr_torch.utils import design
from tpu_sdr_torch.utils import firdes as tfirdes

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_EVERYTHING = """
import importlib, pkgutil, sys
import tpu_sdr_torch
for m in pkgutil.walk_packages(tpu_sdr_torch.__path__, "tpu_sdr_torch."):
    importlib.import_module(m.name)
import chip_smoke
import chip_variants
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("tpu_sdr", "jax"))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_tpu_sdr_nor_jax():
    """Every module of the port, chip_smoke and chip_variants, imported in
    a fresh process, with TPU_SDR_PLATFORM set (it makes tpu_sdr load
    jax)."""
    env = dict(os.environ, TPU_SDR_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", IMPORT_EVERYTHING], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name,args", [
    ("kaiser_beta", (10.0,)), ("kaiser_beta", (30.0,)), ("kaiser_beta", (70.0,)),
    ("lowpass", (72, 0.075)), ("lowpass", (129, 1_000.0, 48_000.0, 80.0)),
    ("decimating_lowpass", (6, 12, 60.0, 0.9)),
    ("decimating_lowpass", (4, 8)),
    ("resampler_taps", (16, 85, 48, 60.0, 0.8)),
    ("resampler_taps", (3, 7)),
    ("bandpass", (65, 19_000.0, 2_000.0, 170_000.0)),
    ("bandpass", (101, 57_000.0, 2_400.0, 228_000.0, 70.0)),
])
def test_firdes_copy_is_equal(name, args):
    got = getattr(tfirdes, name)(*args)
    want = getattr(jfirdes, name)(*args)
    if isinstance(want, float):
        assert got == want
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_f32_to_s16_is_bit_equal():
    """Clip edges, steps of +-0.5 around integers, signed zero, and random
    audio: the same bits as the JAX package's conversion and as its numpy
    formula (C++ and numpy agree there)."""
    scale = np.float32(0.9 * 32767.0)
    k = np.arange(-40, 41, dtype=np.float32)
    steps = np.concatenate([(k + 0.5) / scale, (k - 0.5) / scale, k / scale])
    edges = np.array([1.0, -1.0, 1.1112, -1.1112, 2.0, -2.0, 32767.4 / scale,
                      -32768.6 / scale, 0.0, -0.0], dtype=np.float32)
    rng = np.random.default_rng(3)
    x = np.concatenate([steps, edges, rng.uniform(-1.3, 1.3, 10_001)]
                       ).astype(np.float32)
    got = tnative.f32_to_s16(x)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, jnative.f32_to_s16(x))
    np.testing.assert_array_equal(
        got, np.clip(x * (0.9 * 32767.0), -32768, 32767).astype(np.int16))


def test_block_feeder_over_a_file_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    path = tmp_path / "cap.u8"
    rng.integers(0, 256, 4096 * 5 + 1000, dtype=np.uint8).tofile(path)
    feeders = [tfeeder.BlockFeeder(tfeeder.FileSource(str(path)),
                                   block_bytes=4096, queue_blocks=2),
               jfeeder.BlockFeeder(jfeeder.FileSource(str(path)),
                                   block_bytes=4096, queue_blocks=2,
                                   native=False)]
    blocks = []
    for f in feeders:
        f.start()
        blocks.append([b.copy() for b in f.blocks()])
        f.stop()
    assert len(blocks[0]) == len(blocks[1]) == 5
    for a, b in zip(*blocks):
        np.testing.assert_array_equal(a, b)
    assert feeders[0].dropped == feeders[1].dropped == 0


class _LiveFileSource(tfeeder.FileSource):
    """A file read as if it were a live radio: no backpressure."""

    @property
    def wants_backpressure(self) -> bool:
        return False


@pytest.mark.parametrize("source", [tfeeder.FileSource, _LiveFileSource])
def test_block_feeder_stalls_replay_and_drops_live(tmp_path, source):
    """A consumer that sleeps 1.5 s a block, past the reader's 1 s wait,
    behind a one-block queue: file replay stalls the reader and delivers
    every byte (the JAX feeder's native path), a live source drops."""
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, 3 * 4096, dtype=np.uint8)
    path = tmp_path / "cap.u8"
    data.tofile(path)
    feeder = tfeeder.BlockFeeder(source(str(path)), block_bytes=4096,
                                 queue_blocks=1).start()
    got = []
    for b in feeder.blocks():
        got.append(b.copy())
        time.sleep(1.5)
    feeder.stop()
    if source is tfeeder.FileSource:
        assert feeder.dropped == 0
        np.testing.assert_array_equal(np.concatenate(got), data)
    else:
        assert feeder.dropped >= 1
        assert len(got) + feeder.dropped == 3


@pytest.fixture()
def jax_rtl_tcp_server():
    jfake.clear_fake_devices()
    jfake.register_fake_device()
    sdr = japi.RtlSdr.open_with_index(0)
    sdr.set_sample_rate(2_048_000)
    sdr.set_center_freq(100_000_000)
    sdr.reset_buffer()
    srv = RtlTcpServer(sdr, "127.0.0.1", 0, queue_limit=16)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    deadline = time.time() + 5
    while srv.bound_port is None and time.time() < deadline:
        time.sleep(0.01)
    assert srv.bound_port is not None
    yield srv
    srv.stop()
    t.join(timeout=3)
    sdr.close()
    jfake.clear_fake_devices()


def test_rtl_tcp_client_matches_jax(jax_rtl_tcp_server):
    """Both clients against the JAX package's server on a fake dongle (a
    counter source whose 4096-byte blocks all start at 0): the same
    handshake and the same bytes; the port's commands reach the dongle."""
    port = jax_rtl_tcp_server.bound_port
    seen = []
    for cls in (jfeeder.RtlTcpClientSource, tfeeder.RtlTcpClientSource):
        client = cls("127.0.0.1", port)
        seen.append((client.tuner_type, client.gain_count,
                     client.read_block(4096)))
        if cls is tfeeder.RtlTcpClientSource:
            client.set_frequency(94_900_000)
            for _ in range(4):
                assert client.read_block(4096) is not None
            deadline = time.time() + 3
            while (jax_rtl_tcp_server.sdr.get_center_freq() != 94_900_000
                   and time.time() < deadline):
                time.sleep(0.02)
            assert jax_rtl_tcp_server.sdr.get_center_freq() == 94_900_000
        client.close()
    assert seen[0][:2] == seen[1][:2] == (5, 29)
    assert seen[0][2] == seen[1][2] == bytes(range(256)) * 16


def test_fake_dongle_through_both_apis():
    """simple_fm's set-up sequence on a fake dongle through each package's
    api: equal getters and equal read_sync bytes."""
    radio, _ = design.optimal_settings(tsimple.FREQUENCY, tsimple.SAMPLE_RATE)
    jfake.clear_fake_devices()
    tfake.clear_fake_devices()
    jfake.register_fake_device()
    tfake.register_fake_device()
    try:
        got = []
        for api in (japi, tapi):
            sdr = api.RtlSdr.open(api.DeviceId.index(0))
            sdr.set_tuner_gain(api.TunerGain.AUTO)
            sdr.set_bias_tee(False)
            sdr.reset_buffer()
            sdr.set_center_freq(radio.capture_freq)
            sdr.set_sample_rate(radio.capture_rate)
            got.append((sdr.get_center_freq(), sdr.get_sample_rate(),
                        sdr.get_tuner_gains(), sdr.read_tuner_gain(),
                        sdr.get_freq_correction(), sdr.get_tuner_id(),
                        [d.serial for d in api.list_devices()],
                        sdr.read_sync(65_536), sdr.read_sync(1_000)))
            sdr.close()
        assert got[0] == got[1]
        assert got[1][0] == radio.capture_freq
    finally:
        jfake.clear_fake_devices()
        tfake.clear_fake_devices()
