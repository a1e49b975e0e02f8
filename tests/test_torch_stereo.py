"""tpu_sdr_torch's stereo decoder against tpu_sdr's ``WbfmStereoStreamer``
on the same capture and the same block cuts.

The oracle is JAX with an f32 front (``mxu_precision="f32"``, the port's
precision): >= 100 dB on L, R and the multiplex tap.  JAX's default front
runs split-bf16 weights; against it the port measured 129.2 dB (L) and
129.4 dB (R) on this capture, held here at >= 110 dB.  The pilot power is
taken once a block, so both run the same cuts.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_sdr.models import wbfm as JW
from tpu_sdr.models import wbfm_stereo as JS
from tpu_sdr.utils import synth
from tpu_sdr_torch import convert
from tpu_sdr_torch.models import wbfm_stereo as TS
from tpu_sdr_torch.ops import fm as TF

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 510 * 200          # 0.1 s at 1.02 Msps
CUT = 100_001          # not a whole quantum: pending bytes carry over
QUANTUM = 2 * 3 * 85
FLOOR_DEFAULT_DB = 110.0


def _snr_db(ref, got):
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))


def _jax_f32(**kw):
    return JS.StereoConfig(base=JW.WbfmConfig(
        filter_mode="fir", decim=3, rate_out=340_000, mxu_precision="f32"),
        **kw)


@pytest.fixture(scope="module")
def capture():
    bits = np.random.default_rng(1).integers(0, 2, 200).astype(np.uint8)
    u8, _, _ = synth.synth_wbfm_stereo_u8(N, capture_rate=1_020_000,
                                          rds_bits=bits)
    return np.asarray(u8, np.uint8)


def _two_calls(streamer, u8):
    out, mpx = [], []
    for part in (u8[:CUT], u8[CUT:]):
        out.append(streamer.demodulate(part))
        mpx.append(streamer.last_mpx)
    return np.concatenate(out, axis=1), (
        np.concatenate(mpx) if mpx[0] is not None else None)


@pytest.mark.parametrize("kw", [{"emit_mpx": True},
                                {"deemphasis_tau": 75e-6},
                                {"deemphasis_tau": 50e-6, "emit_mpx": True}])
def test_streamer_matches_jax_f32_oracle(capture, kw):
    exp, exp_mpx = _two_calls(JS.WbfmStereoStreamer(_jax_f32(**kw)), capture)
    got, got_mpx = _two_calls(
        TS.WbfmStereoStreamer(TS.StereoConfig(**kw), device=CPU), capture)
    assert got.shape == exp.shape == (2, N // (3 * 85) * 8)
    for ch in range(2):
        s = _snr_db(exp[ch], got[ch])
        assert s >= 100.0, f"{kw} channel {ch}: {s:.1f} dB"
    if kw.get("emit_mpx"):
        assert got_mpx.shape == exp_mpx.shape == (N // 3,)
        assert _snr_db(exp_mpx, got_mpx) >= 100.0
    else:
        assert got_mpx is None


def test_default_config_at_its_floor(capture):
    """JAX's default (split-bf16 front) against the port's f32 front."""
    exp, _ = _two_calls(JS.WbfmStereoStreamer(), capture)
    got, _ = _two_calls(TS.WbfmStereoStreamer(device=CPU), capture)
    for ch in range(2):
        assert _snr_db(exp[ch], got[ch]) >= FLOOR_DEFAULT_DB


def test_block_with_converted_params_and_state(capture):
    """``demodulate_block`` from a JAX mid-stream state and the JAX params
    (its split-bf16 decimator as effective f32 weights): the next block
    agrees >= 100 dB, and the port's state continues in JAX."""
    jconfig = JS.StereoConfig(deemphasis_tau=75e-6)
    config = TS.StereoConfig(deemphasis_tau=75e-6)
    a, b = capture[:QUANTUM * 100], capture[QUANTUM * 100:QUANTUM * 200]
    ref = JS.WbfmStereoStreamer(jconfig)
    ref.demodulate(a)
    mid_state = ref.state
    exp = ref.demodulate(b)

    params = convert.stereo_params_from_jax(ref.params, config, device=CPU)
    state = convert.stereo_state_from_jax(mid_state, device=CPU)
    assert isinstance(state.front.rot, int)
    got, end = TS.demodulate_block(torch.from_numpy(b), state, params, config)
    for ch in range(2):
        assert _snr_db(exp[ch], got[ch].numpy()) >= 100.0

    # the port's end state, converted back, continues the JAX stream
    c = capture[QUANTUM * 200:QUANTUM * 250]
    exp_c = ref.demodulate(c)
    back = JS.WbfmStereoStreamer(jconfig)
    back.state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(back.state),
        jax.tree_util.tree_leaves(convert.stereo_state_to_jax(end)))
    got_c = back.demodulate(c)
    for ch in range(2):
        assert _snr_db(exp_c[ch], got_c[ch]) >= 100.0


def test_state_has_the_eleven_carries():
    state = TS.init_state(TS.StereoConfig(), CPU)
    jstate = JS.init_state(JS.StereoConfig())
    assert state._fields == jstate._fields
    assert len(state) == 11
    d = TS.carrier_delay(TS.StereoConfig())
    assert d == JS.carrier_delay(JS.StereoConfig()) == 512
    assert state.dly_y.hist.shape == (d,)


def test_params_equal_jax_designs():
    port = TS.make_params(TS.StereoConfig(), device=CPU)
    ref = JS.make_params(_jax_f32())
    for name in ("W_s", "W_p", "W_c", "W_d"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    np.testing.assert_array_equal(port.front.decim_W.numpy(),
                                  np.asarray(ref.front.decim_W))
    np.testing.assert_array_equal(port.front.resamp_V.numpy(),
                                  np.asarray(ref.front.resamp_V))


def _tone_amp(x, freq, fs, skip=2000):
    x = np.asarray(x, np.float64)[skip:]
    x = x - x.mean()
    t = np.arange(len(x)) / fs
    return np.hypot(2 * np.dot(x, np.cos(2 * np.pi * freq * t)) / len(x),
                    2 * np.dot(x, np.sin(2 * np.pi * freq * t)) / len(x))


@pytest.mark.parametrize("right_freq", [1_300.0, 0.0])
def test_channels_separated(right_freq):
    """The JAX tests' bars on the port: with tones in both channels the
    separation is >= 30 dB both ways; with a left tone alone the right
    channel stays >= 35 dB below it and the left tone reads >= 50 dB."""
    n = 600_000 - 600_000 % 255
    u8, _, _ = synth.synth_wbfm_stereo_u8(n, capture_rate=1_020_000,
                                          right_freq=right_freq)
    audio = TS.WbfmStereoStreamer(device=CPU).demodulate(np.asarray(u8))
    sep_l = 20 * np.log10(_tone_amp(audio[0], 800.0, 32_000)
                          / _tone_amp(audio[1], 800.0, 32_000))
    if right_freq:
        sep_r = 20 * np.log10(_tone_amp(audio[1], right_freq, 32_000)
                              / _tone_amp(audio[0], right_freq, 32_000))
        assert sep_l >= 30.0 and sep_r >= 30.0, (sep_l, sep_r)
        return
    assert sep_l >= 35.0, sep_l
    snr = synth.tone_snr(np.asarray(audio[0], np.float64), 800.0, 32_000,
                         skip=2000)
    assert snr >= 50.0, snr


def test_streaming_split_invariance(capture):
    """The JAX test's tolerance: a whole-quantum split equals one call to
    rtol 2e-3 (the pilot power is taken once a block)."""
    config = TS.StereoConfig(deemphasis_tau=75e-6)
    full = TS.WbfmStereoStreamer(config, device=CPU).demodulate(capture)
    two = TS.WbfmStereoStreamer(config, device=CPU)
    cut = (len(capture) // 2) - ((len(capture) // 2) % QUANTUM)
    split = np.concatenate([two.demodulate(capture[:cut]),
                            two.demodulate(capture[cut:])], axis=1)
    np.testing.assert_allclose(split[:, :full.shape[1]], full, rtol=2e-3,
                               atol=2e-4)


def test_small_calls_carry_pending_bytes():
    s = TS.WbfmStereoStreamer(TS.StereoConfig(emit_mpx=True), device=CPU)
    out = s.demodulate(np.zeros(QUANTUM - 2, np.uint8))
    assert out.shape == (2, 0) and s.last_mpx.shape == (0,)
    assert s.demodulate(np.zeros(2, np.uint8)).shape == (2, 8)


def test_delay_line_across_blocks():
    x = torch.arange(10, dtype=torch.float32)
    st = TF.delay_init(3, CPU)
    a, st = TF.delay(x[:4], st)
    b, st = TF.delay(x[4:], st)
    torch.testing.assert_close(torch.cat([a, b]),
                               torch.cat([torch.zeros(3), x[:7]]))
    torch.testing.assert_close(st.hist, x[7:])
