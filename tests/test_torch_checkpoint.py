"""Checkpoint/resume of every port streamer (``tpu_sdr_torch.stream.
checkpoint``): stop mid-stream, save the carries, load them into a fresh
streamer of the same configuration, and the rest of the stream must be
bit-identical to an uninterrupted run — the contract of
``tests/test_checkpoint.py``, on the float, exact, fused, batch, stereo,
multimode, wideband (plain and K3, whose carry ``pfb_carry`` the port
adds to the attribute list), sharded and PSD streamers.  The file is the
JAX package's ``.npz`` format: a JAX checkpoint of the float chain loads
into the port's.
"""

import numpy as np
import pytest
import torch

from tpu_sdr.utils import synth
from tpu_sdr_torch.models import multimode as TM
from tpu_sdr_torch.models import wbfm as TW
from tpu_sdr_torch.models import wbfm_batched as TB
from tpu_sdr_torch.models import wbfm_exact as TE
from tpu_sdr_torch.models import wbfm_stereo as TS
from tpu_sdr_torch.models import wbfm_wideband as WB
from tpu_sdr_torch.ops import fused_fm as FF
from tpu_sdr_torch.ops import spectrum as SP
from tpu_sdr_torch.parallel import mesh as M
from tpu_sdr_torch.parallel import wbfm_sharded_fused as WSF
from tpu_sdr_torch.stream import checkpoint as C
from tpu_sdr_torch.utils.design import WbfmConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
CHUNK = FF.default_spec().chunk_bytes


@pytest.fixture(scope="module")
def capture():
    u8, _ = synth.synth_wbfm_u8(CHUNK, capture_rate=1_020_000)  # 2 chunks
    return np.asarray(u8, dtype=np.uint8)


def _wideband_capture():
    config = WB.WidebandConfig(num_channels=16, channels=(3, 12))
    n = 2 * 8 * 16 * 85 * 3
    u8, _ = synth.synth_multistation_u8(
        n, config.capture_rate, station_freqs=[3 * 170e3, -4 * 170e3],
        audio_freqs=[1_000.0, 2_500.0], deviation=45_000.0)
    return config, np.asarray(u8, np.uint8)


def _rows(capture, stations=2):
    rng = np.random.default_rng(4)
    return np.stack([capture] + [rng.integers(0, 256, len(capture),
                                              dtype=np.uint8)
                                 for _ in range(stations - 1)])


def _case(name, capture):
    """(make, data, split, axis): the streamer, its input, the cut and the
    axis the outputs concatenate along."""
    if name == "float_fir":
        return (lambda: TW.WbfmStreamer(device=CPU)), capture, 100_001, 0
    if name == "float_boxcar_deemph_mpx":
        cfg = WbfmConfig(filter_mode="boxcar", deemphasis_tau=75e-6,
                         emit_mpx=True)
        return (lambda: TW.WbfmStreamer(cfg, device=CPU)), capture, 77_777, 0
    if name == "exact":
        return (lambda: TE.WbfmExactStreamer(device=CPU)), capture, 77_776, 0
    if name == "fused":
        return (lambda: FF.FusedWbfmStreamer(device=CPU)), capture, 150_000, 0
    if name == "fused_batch":
        def make():
            s = FF.FusedWbfmBatchStreamer(2, device=CPU)
            s.phases = [0, 3]
            return s
        return make, _rows(capture), 150_000, 1
    if name == "float_batch":
        return ((lambda: TB.WbfmBatchStreamer(2, device=CPU)), _rows(capture),
                100_002, 1)
    if name == "stereo":
        u8, _, _ = synth.synth_wbfm_stereo_u8(510 * 400, capture_rate=1_020_000)
        cfg = TS.StereoConfig(deemphasis_tau=75e-6, emit_mpx=True)
        return ((lambda: TS.WbfmStereoStreamer(cfg, device=CPU)),
                np.asarray(u8, np.uint8), 100_001, 1)
    if name == "multimode_usb":
        rng = np.random.default_rng(2)
        cfg = TM.MultimodeConfig(mode="usb", fine_tune_hz=120.0)
        return ((lambda: TM.MultimodeStreamer(cfg, device=CPU)),
                rng.integers(0, 256, 510 * 300, dtype=np.uint8), 70_003, 0)
    if name in ("wideband", "wideband_fused"):
        config, u8 = _wideband_capture()
        fused = name == "wideband_fused"
        return ((lambda: WB.WidebandStreamer(config, use_fused=fused,
                                             device=CPU)),
                u8, len(u8) // 2 + 1_001, 1)
    raise ValueError(name)


STREAMERS = ["float_fir", "float_boxcar_deemph_mpx", "exact", "fused",
             "fused_batch", "float_batch", "stereo", "multimode_usb",
             "wideband", "wideband_fused"]


def _cut(data, split, axis):
    return (data[..., :split], data[..., split:]) if axis else (
        data[:split], data[split:])


@pytest.mark.parametrize("name", STREAMERS)
def test_roundtrip_is_bit_identical(capture, tmp_path, name):
    make, data, split, axis = _case(name, capture)
    a, b = _cut(data, split, axis)
    ref = make()
    full = np.concatenate([ref.demodulate(a), ref.demodulate(b)], axis=axis)

    first = make()
    out1 = first.demodulate(a)
    path = str(tmp_path / "state.npz")
    C.save_stream_state(path, first)
    resumed = make()
    C.load_stream_state(path, resumed)
    got = np.concatenate([out1, resumed.demodulate(b)], axis=axis)
    assert got.shape == full.shape and got.size > 0
    np.testing.assert_array_equal(got, full)
    saved = str(np.load(path)["__attrs__"]).split(",")
    assert ("pfb_carry" in saved) == (name == "wideband_fused")


def test_sharded_streamer_roundtrip(tmp_path):
    """``ShardedFusedStreamer`` on a (1, 2) CPU mesh: stop after block 1,
    resume in a fresh receiver, block 2 bit-identical."""
    mesh = M.make_mesh(1, 2, devices=[CPU] * 2)
    n = 2 * FF.default_spec().chunk_complex
    rng = np.random.default_rng(31)
    blocks = [rng.integers(0, 256, (2, 2 * n), dtype=np.uint8)
              for _ in range(2)]
    ref = WSF.ShardedFusedStreamer(mesh, 2)
    a1, a2 = ref.demodulate(blocks[0]), ref.demodulate(blocks[1])
    s = WSF.ShardedFusedStreamer(mesh, 2)
    np.testing.assert_array_equal(s.demodulate(blocks[0]), a1)
    path = str(tmp_path / "sharded.npz")
    C.save_stream_state(path, s)
    assert str(np.load(path)["__attrs__"]) == "states,resamp_hists"
    resumed = WSF.ShardedFusedStreamer(mesh, 2)
    C.load_stream_state(path, resumed)
    np.testing.assert_array_equal(resumed.demodulate(blocks[1]), a2)


def test_psd_streamer_roundtrip(tmp_path):
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 256, 2 * 256 * 20 + 77, dtype=np.uint8)
    ref = SP.PsdStreamer(256, device=CPU)
    ref.accumulate(buf)
    first = SP.PsdStreamer(256, device=CPU)
    first.accumulate(buf[:3001])
    path = str(tmp_path / "psd.npz")
    C.save_stream_state(path, first)
    resumed = SP.PsdStreamer(256, device=CPU)
    C.load_stream_state(path, resumed)
    resumed.accumulate(buf[3001:])
    assert resumed.segments == ref.segments and resumed.state.count == 20
    np.testing.assert_allclose(resumed.finalize_db(), ref.finalize_db(),
                               rtol=0, atol=1e-4)


def test_jax_checkpoint_loads_into_the_port(capture, tmp_path):
    """The same ``.npz`` format: a JAX float-chain checkpoint restores the
    port's float streamer (the fs/4 phase and ``t0`` land as ints), which
    continues the JAX stream >= 100 dB (f32 against f32)."""
    from tpu_sdr.models import wbfm as JW
    from tpu_sdr.stream import checkpoint as JC

    jconfig = JW.WbfmConfig(mxu_precision="f32")
    ref = JW.WbfmStreamer(jconfig)
    ref.demodulate(capture[:100_001])
    path = str(tmp_path / "jax.npz")
    JC.save_stream_state(path, ref)
    exp = ref.demodulate(capture[100_001:])
    port = TW.WbfmStreamer(device=CPU)
    C.load_stream_state(path, port)
    assert isinstance(port.state.rot, int) and len(port._pending) == 100_001 % 1020
    got = port.demodulate(capture[100_001:])
    err = got.astype(np.float64) - exp
    assert 10 * np.log10(np.mean(exp ** 2) / np.mean(err ** 2)) >= 100.0


def test_class_mismatch_rejected(capture, tmp_path):
    s = TW.WbfmStreamer(device=CPU)
    s.demodulate(capture[:12_000])
    path = str(tmp_path / "state.npz")
    C.save_stream_state(path, s)
    with pytest.raises(ValueError, match="checkpoint is for"):
        C.load_stream_state(path, TE.WbfmExactStreamer(device=CPU))


def test_structure_drift_detected_and_nothing_assigned(tmp_path):
    s = TW.WbfmStreamer(device=CPU)
    s.demodulate(np.zeros(510 * 8, np.uint8))
    path = str(tmp_path / "st.npz")
    C.save_stream_state(path, s)

    other = TW.WbfmStreamer(WbfmConfig(fir_taps_per_phase=8), device=CPU)
    before = other.state
    with pytest.raises(ValueError, match="shape|leaves"):
        C.load_stream_state(path, other)
    assert other.state is before

    fresh = TW.WbfmStreamer(device=CPU)
    fresh.phases = np.zeros(3)  # a name in the list, absent at save time
    with pytest.raises(ValueError, match="attrs"):
        C.load_stream_state(path, fresh)


def test_unknown_leaf_type_is_refused(tmp_path):
    class Odd:
        state = ({"a": 1},)

    with pytest.raises(TypeError, match="dict"):
        C.save_stream_state(str(tmp_path / "odd.npz"), Odd())
