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
    """Clip edges, steps of +-0.5 around integers and about both saturation
    edges, signed zero, +-inf and random audio, at both scales: the same
    bits as the JAX package's conversion and as its numpy formula (C++ and
    numpy agree there)."""
    rng = np.random.default_rng(3)
    for scale in (np.float32(0.9 * 32767.0), np.float32(32767.0)):
        k = np.concatenate([np.arange(-40, 41), [32766, 32767, 32768, -32767,
                                                 -32768, -32769]])
        steps = np.concatenate([(k + 0.5) / scale, (k - 0.5) / scale,
                                k / scale])
        edges = np.array([1.0, -1.0, 1.1112, -1.1112, 2.0, -2.0,
                          32767.4 / scale, -32768.6 / scale, 0.0, -0.0,
                          np.inf, -np.inf], dtype=np.float32)
        x = np.concatenate([steps, edges, rng.uniform(-1.3, 1.3, 10_001)]
                           ).astype(np.float32)
        got = tnative.f32_to_s16(x, float(scale))
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, jnative.f32_to_s16(x, float(scale)))
        np.testing.assert_array_equal(
            got, np.clip(x * scale, -32768, 32767).astype(np.int16))


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


# ---- the copies this slice added ------------------------------------------

NEW_MODULES = ("tpu_sdr_torch.models.wbfm_stereo", "tpu_sdr_torch.models.rds",
               "tpu_sdr_torch.models.multimode", "tpu_sdr_torch.ops.spectrum",
               "tpu_sdr_torch.apps.rtl_fm", "tpu_sdr_torch.apps.rtl_power",
               "tpu_sdr_torch.utils.units", "tpu_sdr_torch.stream.checkpoint")


@pytest.mark.parametrize("name", NEW_MODULES)
def test_new_module_imports_neither_tpu_sdr_nor_jax(name):
    """Each module of the slice, alone in a fresh process."""
    code = (f"import sys, importlib; importlib.import_module({name!r}); "
            "bad = sorted(k for k in sys.modules "
            "if k.split('.')[0] in ('tpu_sdr', 'jax')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, TPU_SDR_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_parse_scaled_copy_is_equal():
    from tpu_sdr.utils import units as junits
    from tpu_sdr_torch.utils import units as tunits

    for v in ("94.9M", "100k", "2048K", "1.5G", "4G", "0", "170000", "3m",
              "1e3", "0.5k"):
        assert tunits.parse_scaled(v) == junits.parse_scaled(v)
    for bad in ("", "-1", "5G", "x", "12q"):
        with pytest.raises(ValueError) as je:
            junits.parse_scaled(bad)
        with pytest.raises(ValueError) as te:
            tunits.parse_scaled(bad)
        assert str(te.value) == str(je.value)


def test_synth_stereo_and_rds_copies_make_the_same_bytes():
    from tpu_sdr.utils import synth as jsynth
    from tpu_sdr_torch.utils import synth as tsynth

    bits = np.random.default_rng(2).integers(0, 2, 300).astype(np.uint8)
    for kw in ({}, {"rds_bits": bits, "left_freq": 500.0, "right_freq": 0.0}):
        got, exp = (m.synth_wbfm_stereo_u8(51_000, capture_rate=1_020_000,
                                           **kw) for m in (tsynth, jsynth))
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g, e)
    args = (64 * 85 * 8, 16 * 170_000)
    kw = dict(station_freqs=[3 * 170e3, -4 * 170e3], audio_freqs=[1e3, 2.5e3],
              deviation=60_000.0, rds_bits=[bits, None])
    np.testing.assert_array_equal(tsynth.synth_multistation_u8(*args, **kw)[0],
                                  jsynth.synth_multistation_u8(*args, **kw)[0])


def test_rds_group_layer_copy_is_equal():
    from tpu_sdr.models import rds as JR
    from tpu_sdr_torch.models import rds as TR

    rng = np.random.default_rng(12)
    for info in rng.integers(0, 1 << 16, 2_000):
        assert TR.crc10(int(info)) == JR.crc10(int(info))
    assert TR._burst_table() == JR._burst_table()
    assert TR.OFFSET_WORDS == JR.OFFSET_WORDS and TR.PTY_NAMES == JR.PTY_NAMES
    assert [TR.af_code_mhz(c) for c in range(256)] == [
        JR.af_code_mhz(c) for c in range(256)]
    for mjd in (15079, 45000, 51544, 61272, 70000):
        assert TR.mjd_to_date(mjd) == JR.mjd_to_date(mjd)
    makers = [("make_group_0a", (0xBEEF, 4, 2, "AB")),
              ("make_group_0a", (0x1234, 31, 3, "yz", 0xE1CD)),
              ("make_group_2a", (0xF201, 9, 7, "TEXT", 1)),
              ("make_group_4a", (0x1234, 61272, 23, 59, -11, 5)),
              ("make_group_10a", (0x1234, 1, "ball", 2, 1))]
    groups = []
    for name, args in makers:
        g = getattr(TR, name)(*args)
        np.testing.assert_array_equal(g, getattr(JR, name)(*args))
        groups.append(g)
    # random blocks, corrupted by bursts and single flips, against every offset
    for _ in range(200):
        off = rng.choice(list(JR.OFFSET_WORDS))
        blk = JR.make_block(int(rng.integers(0, 1 << 16)), off)
        for i in rng.integers(0, 26, rng.integers(0, 4)):
            blk[i] ^= 1
        for o in JR.OFFSET_WORDS:
            assert TR.correct_block(blk, o) == JR.correct_block(blk, o)
        assert TR._block_offset(blk) == JR._block_offset(blk)
    # a noisy stream of the groups: the parser, the synchronizer, the text
    bits = np.concatenate([rng.integers(0, 2, 41).astype(np.uint8)]
                          + groups * 3)
    bits[300] ^= 1
    assert TR.sync_and_parse(bits) == JR.sync_and_parse(bits)
    tsync, jsync = TR.GroupSynchronizer(), JR.GroupSynchronizer()
    ttext, jtext = TR.RdsText(), JR.RdsText()
    for chunk in np.array_split(bits, 7):
        tg, jg = tsync.feed(chunk), jsync.feed(chunk)
        assert tg == jg
        for g in tg:
            assert ttext.update(g) == jtext.update(g)
    assert (tsync.groups_ok, tsync.groups_bad, tsync.bits_corrected) == (
        jsync.groups_ok, jsync.groups_bad, jsync.bits_corrected)
    b152 = rng.normal(0, 1, 128 * 40).astype(np.float32)
    for ph in (0, 63, 127):
        np.testing.assert_array_equal(TR.soft_bits(b152, ph),
                                      JR.soft_bits(b152, ph))
    assert TR.best_bit_phase(b152) == JR.best_bit_phase(b152)
    np.testing.assert_array_equal(TR.decode_bits(b152), JR.decode_bits(b152))


def test_psd_db_and_hann_copies_are_equal():
    from tpu_sdr.ops import spectrum as JS
    from tpu_sdr_torch.ops import spectrum as TS

    for n in (8, 256, 1024):
        np.testing.assert_array_equal(TS.hann(n), JS.hann(n))
    rng = np.random.default_rng(1)
    acc = rng.uniform(0, 1e4, 512).astype(np.float32)
    acc[:3] = 0.0
    for count in (0.0, 1.0, 37.0):
        state = JS.PsdState(acc, np.float32(count))
        np.testing.assert_array_equal(TS.psd_db(state, TS.hann(512)),
                                      JS.psd_db(state, JS.hann(512)))


def test_rtl_power_helpers_are_equal():
    from tpu_sdr.apps import rtl_power as jrp
    from tpu_sdr_torch.apps import rtl_power as trp

    for text in ("88M:108M:125k", "94M:96M:8k", "100k:200k:1k"):
        assert trp.parse_range(text) == jrp.parse_range(text)
    for bad in ("88M:108M", "108M:88M:1k"):
        with pytest.raises(SystemExit):
            trp.parse_range(bad)
    for rate, step in ((2_048_000, 125_000), (1_020_000, 8_000), (1, 1),
                       (2_048_000, 1)):
        assert trp.fft_size_for(rate, step) == jrp.fft_size_for(rate, step)
    for args in ((88_000_000, 108_000_000, 2_048_000),
                 (94_000_000, 96_040_000, 1_020_000, 1.0)):
        assert trp.hop_centers(*args) == jrp.hop_centers(*args)
    db = np.linspace(-90.0, -10.0, 1024)
    for crop in (0.8, 1.0):
        assert trp.row_for(95_000_000, 94_000_000, 96_000_000, 1_020_000,
                           1024, db, crop) == jrp.row_for(
            95_000_000, 94_000_000, 96_000_000, 1_020_000, 1024, db, crop)


def _options(main, argv=("--help",)):
    """The option strings of the argparse parser ``main`` builds."""
    import argparse

    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["p"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            main(list(argv))
    finally:
        argparse.ArgumentParser.parse_args = real
    return {s for a in seen["p"]._actions for s in a.option_strings} | {
        a.dest for a in seen["p"]._actions if not a.option_strings}


@pytest.mark.parametrize("app", ["simple_fm", "multi_fm", "rtl_fm",
                                 "rtl_power"])
def test_cli_options_are_the_jax_clis_plus_torch_device(app):
    import importlib

    jax_opts = _options(importlib.import_module(f"tpu_sdr.apps.{app}").main)
    port = _options(importlib.import_module(f"tpu_sdr_torch.apps.{app}").main)
    extra = {"--torch-device"} | ({"--fused"} if app == "multi_fm" else set())
    assert port == jax_opts | extra
