"""tpu_sdr_torch's float WBFM chain against tpu_sdr's f32 chain.

Same f32 math, other summation order: the streamers must agree to
>=100 dB, on whole kernel chunks and on the reference's 262,144-byte
device blocks (tests/test_fm_fast.py's streaming case).
"""

import numpy as np
import pytest
import torch

from tpu_sdr.models import wbfm as JW
from tpu_sdr.utils import synth
from tpu_sdr_torch import convert
from tpu_sdr_torch.models import wbfm as TW
from tpu_sdr_torch.utils.design import WbfmConfig

torch.set_num_threads(1)

CHUNK = 130_560  # one fused-kernel chunk of bytes
CPU = torch.device("cpu")


def _snr_db(ref, got):
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))


def _jax_f32():
    return JW.WbfmStreamer(JW.WbfmConfig(filter_mode="fir", mxu_precision="f32"))


@pytest.fixture(scope="module")
def capture():
    u8, _ = synth.synth_wbfm_u8(2 * 131_072, capture_rate=1_020_000,
                                noise_std=0.02, seed=7)
    return np.asarray(u8, dtype=np.uint8)


@pytest.mark.parametrize("block", [CHUNK, 262_144])
def test_streamer_matches_jax_f32_chain(capture, block):
    ref, port = _jax_f32(), TW.WbfmStreamer(device=CPU)
    exp, got = [], []
    for s in range(0, len(capture), block):
        exp.append(ref.demodulate(capture[s:s + block]))
        got.append(port.demodulate(capture[s:s + block]))
        assert got[-1].shape == exp[-1].shape
    snr = _snr_db(np.concatenate(exp), np.concatenate(got))
    assert snr >= 100.0, f"port fir chain vs JAX f32 chain: {snr:.1f} dB"


def test_streamer_split_invariance(capture):
    full = TW.WbfmStreamer(device=CPU).demodulate(capture)
    two = TW.WbfmStreamer(device=CPU)
    cut = 100_001  # not a multiple of the quantum: the residual carries
    split = np.concatenate([two.demodulate(capture[:cut]),
                            two.demodulate(capture[cut:])])
    np.testing.assert_allclose(split, full[:len(split)], rtol=1e-5, atol=1e-6)
    assert len(full) - len(split) < 16


def test_state_handoff_from_jax(capture):
    """A JAX float chain's mid-stream state, converted, continues in the
    port as the JAX chain would."""
    ref = _jax_f32()
    first = ref.demodulate(capture[:CHUNK])
    port = TW.WbfmStreamer(device=CPU)
    port.state = convert.wbfm_state_from_jax(ref.state, device=CPU)
    second = port.demodulate(capture[CHUNK:])
    expected = _jax_f32()
    exp = np.concatenate([expected.demodulate(capture[:CHUNK]),
                          expected.demodulate(capture[CHUNK:])])
    got = np.concatenate([first, second])
    assert _snr_db(exp, got) >= 100.0


def test_tone_recovered(capture):
    audio = TW.WbfmStreamer(device=CPU).demodulate(capture)
    assert len(audio) == len(capture) // 2 * 16 // (6 * 85)
    assert synth.tone_snr(audio.astype(np.float64), 1_000.0, 32_000,
                          skip=1500) >= 30.0


@pytest.mark.parametrize("kw", [{"filter_mode": "boxcar"},
                                {"deemphasis_tau": 75e-6},
                                {"emit_mpx": True}])
def test_unported_options_raise(capture, kw):
    """The options this test once saw refused (the boxcar mode, de-emphasis,
    the multiplex tap) are ported: each runs and matches the JAX chain with
    the same config (tests/test_torch_wbfm_modes.py holds them further)."""
    ref = JW.WbfmStreamer(JW.WbfmConfig(mxu_precision="f32", **kw))
    port = TW.WbfmStreamer(WbfmConfig(**kw), device=CPU)
    exp = ref.demodulate(capture[:262_144])
    got = port.demodulate(capture[:262_144])
    assert got.shape == exp.shape and len(got) > 0
    assert _snr_db(exp, got) >= 100.0
    if kw.get("emit_mpx"):
        assert _snr_db(ref.last_mpx, port.last_mpx) >= 100.0


def test_demodulate_block_rejects_unaligned_block():
    """1,024 bytes is not a whole number of 2*decim-byte groups (any such
    multiple now runs: tests/test_torch_wbfm_modes.py)."""
    config = WbfmConfig()
    params = TW.WbfmParams(config, CPU)
    with pytest.raises(ValueError):
        TW.demodulate_block(torch.zeros(1024, dtype=torch.uint8),
                            TW.init_state(config, CPU), params, config)
