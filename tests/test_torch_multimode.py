"""tpu_sdr_torch's narrowband receiver (AM / NBFM / USB / LSB, squelch,
SSB fine tune, NBFM de-emphasis) against tpu_sdr's ``MultimodeStreamer``
on the same captures and the same block cuts.

The JAX front always runs its decimator as split-bf16 weights; fed those
weights' effective f32 sum (``convert.multimode_params_from_jax``), the
port must agree to >= 100 dB.  With its own f32 weights it must agree to
>= 100 dB too: measured first at 117.2 dB (AM), 117.7 dB (USB/LSB) and
the same for NBFM, the floor the weights' ~2^-17 relative split error
sets.  The first 32 audio samples (1 ms) are left out of every
comparison: there the channel filter's start-up output is ~0, and the
discriminator's angle of it (NBFM) is set by rounding alone.
"""

import numpy as np
import pytest
import torch

from tpu_sdr.models import multimode as JM
from tpu_sdr.utils import synth
from tpu_sdr_torch import convert
from tpu_sdr_torch.models import multimode as TM

torch.set_num_threads(1)

CPU = torch.device("cpu")
FS = 1_020_000
QUANTUM = 2 * 6 * 85  # bytes
N = 510 * 300          # 0.15 s
CUT = 70_003           # not a whole quantum: pending bytes carry over
SKIP = 32              # start-up samples left out of the comparisons
FLOOR_OWN_DB = 100.0   # the port's own f32 weights (measured 117.2-117.9)


def _snr_db(ref, got):
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))


def _to_u8(baseband: np.ndarray) -> np.ndarray:
    """Complex baseband -> u8 I/Q at the -fs/4 capture offset."""
    n = len(baseband)
    offset = np.choose(np.arange(n) % 4, [1 + 0j, -1j, -1 + 0j, 1j])
    sig = baseband * offset
    iq = np.empty(2 * n, np.float64)
    iq[0::2] = sig.real
    iq[1::2] = sig.imag
    return np.clip(np.round(iq * 127.0 + 127.5), 0, 255).astype(np.uint8)


def _capture(kind: str, n: int = N) -> np.ndarray:
    t = np.arange(n) / FS
    if kind == "am":
        return _to_u8((0.45 * (1.0 + 0.8 * np.sin(2 * np.pi * 1_000.0 * t))
                       ).astype(np.complex128))
    if kind == "nbfm":
        u8, _ = synth.synth_wbfm_u8(n, capture_rate=FS, audio_freq=900.0,
                                    deviation=5_000.0)
        return np.asarray(u8, np.uint8)
    if kind == "usb":  # a tone in the upper sideband, 300 Hz off nominal
        return _to_u8(0.7 * np.exp(2j * np.pi * 1_300.0 * t))
    if kind == "noise":
        rng = np.random.default_rng(9)
        return _to_u8(rng.normal(0, 0.003, n) + 1j * rng.normal(0, 0.003, n))
    raise ValueError(kind)


CASES = [
    ("am", {}), ("am", {"squelch_db": -40.0}),
    ("nbfm", {}), ("nbfm", {"deemphasis_tau": 75e-6}),
    ("usb", {}), ("usb", {"fine_tune_hz": 300.0}),
    ("lsb", {}), ("lsb", {"fine_tune_hz": -150.0}),
]


def _capture_for(mode):
    return _capture({"am": "am", "nbfm": "nbfm"}.get(mode, "usb"))


def _two_calls(streamer, u8):
    out = [streamer.demodulate(u8[:CUT]), streamer.demodulate(u8[CUT:])]
    return np.concatenate(out), streamer.last_power


@pytest.fixture(scope="module")
def jax_runs():
    """Each case's JAX audio and last channel power (one compile each)."""
    runs = {}
    for mode, kw in CASES:
        s = JM.MultimodeStreamer(JM.MultimodeConfig(mode=mode, **kw))
        runs[(mode, tuple(kw.items()))] = (*_two_calls(s, _capture_for(mode)),
                                           s.params)
    return runs


@pytest.mark.parametrize("weights", ["converted", "own"])
@pytest.mark.parametrize("mode,kw", CASES)
def test_streamer_matches_jax(jax_runs, mode, kw, weights):
    exp, exp_power, jparams = jax_runs[(mode, tuple(kw.items()))]
    config = TM.MultimodeConfig(mode=mode, **kw)
    port = TM.MultimodeStreamer(config, device=CPU)
    if weights == "converted":
        port.params = convert.multimode_params_from_jax(jparams, config,
                                                        device=CPU)
    got, power = _two_calls(port, _capture_for(mode))
    assert got.shape == exp.shape and got.dtype == np.float32
    floor = 100.0 if weights == "converted" else FLOOR_OWN_DB
    s = _snr_db(exp[SKIP:], got[SKIP:])
    assert s >= floor, f"{mode} {kw} ({weights} weights): {s:.1f} dB"
    assert power == pytest.approx(exp_power, rel=1e-5)
    assert port.n_measurements == 2


def test_params_equal_jax_designs(jax_runs):
    """The port's own banks are the JAX ones: the f32 decimator (the split
    pair approximates it), the channel filter and the resampler matrix."""
    for (mode, kw), (_, _, jparams) in jax_runs.items():
        port = TM.make_params(TM.MultimodeConfig(mode=mode, **dict(kw)),
                              device=CPU)
        np.testing.assert_array_equal(port.decim_W.numpy(),
                                      np.asarray(jparams.decim_W))
        np.testing.assert_array_equal(port.chan_W.numpy(),
                                      np.asarray(jparams.chan_W))
        np.testing.assert_array_equal(port.resamp_V.numpy(),
                                      np.asarray(jparams.resamp_V))


@pytest.mark.parametrize("mode", ["am", "nbfm", "usb"])
def test_tone_recovered(mode):
    """The JAX tests' bars on the port: AM and NBFM >= 30 dB, USB >= 25."""
    u8 = _capture(mode, n=510 * 800)
    freq = {"am": 1_000.0, "nbfm": 900.0, "usb": 1_300.0}[mode]
    audio = TM.MultimodeStreamer(TM.MultimodeConfig(mode=mode),
                                 device=CPU).demodulate(u8)
    snr = synth.tone_snr(audio.astype(np.float64), freq, 32_000, skip=400)
    assert snr >= (25.0 if mode == "usb" else 30.0), f"{mode}: {snr:.1f} dB"


def test_lsb_rejects_the_upper_sideband():
    u8 = _capture("usb", n=510 * 800)
    usb, lsb = (TM.MultimodeStreamer(TM.MultimodeConfig(mode=m),
                                     device=CPU).demodulate(u8)
                for m in ("usb", "lsb"))
    rej = 10 * np.log10(np.mean(usb[400:] ** 2)
                        / max(np.mean(lsb[400:] ** 2), 1e-30))
    assert rej >= 20.0, f"sideband rejection {rej:.1f} dB"


def test_fine_tune_moves_the_carrier():
    """A USB carrier 300 Hz high: the tone lands at 1.3 kHz untuned and
    back at 1 kHz with ``fine_tune_hz=300``."""
    u8 = _capture("usb", n=510 * 800)
    a0, a1 = (TM.MultimodeStreamer(TM.MultimodeConfig(
        mode="usb", fine_tune_hz=f), device=CPU).demodulate(u8).astype(
            np.float64) for f in (0.0, 300.0))
    assert synth.tone_snr(a0, 1_300.0, 32_000, skip=400) >= 25.0
    assert synth.tone_snr(a1, 1_000.0, 32_000, skip=400) >= 25.0


def test_squelch_mutes_noise_and_a_high_threshold():
    noise = _capture("noise")
    sq = TM.MultimodeStreamer(TM.MultimodeConfig(mode="nbfm", squelch_db=-35.0),
                              device=CPU)
    assert np.all(sq.demodulate(noise) == 0.0) and not sq.last_squelch_open
    off = TM.MultimodeStreamer(TM.MultimodeConfig(mode="nbfm"), device=CPU)
    assert np.any(off.demodulate(noise) != 0.0) and off.last_squelch_open
    closed = TM.MultimodeStreamer(TM.MultimodeConfig(mode="am", squelch_db=0.0),
                                  device=CPU)
    assert np.all(closed.demodulate(_capture("am")) == 0.0)


@pytest.mark.parametrize("kw", [{"mode": "usb", "fine_tune_hz": 150.0},
                                {"mode": "nbfm", "deemphasis_tau": 75e-6},
                                {"mode": "am"}])
def test_streaming_split_invariance(kw):
    """The JAX tests' tolerance: a split at a whole quantum equals one call
    to rtol 1e-4 (AM's block mean and the channel power are taken once a
    block, so cuts move them)."""
    u8 = _capture(kw["mode"] if kw["mode"] != "usb" else "usb")
    full = TM.MultimodeStreamer(TM.MultimodeConfig(**kw),
                                device=CPU).demodulate(u8)
    two = TM.MultimodeStreamer(TM.MultimodeConfig(**kw), device=CPU)
    cut = (len(u8) // 2) - ((len(u8) // 2) % QUANTUM)
    split = np.concatenate([two.demodulate(u8[:cut]), two.demodulate(u8[cut:])])
    if kw["mode"] == "am":
        assert split.shape == full.shape
        return
    np.testing.assert_allclose(split, full, rtol=1e-4, atol=1e-5)


def test_reset_restarts_the_stream():
    u8 = _capture("usb")
    s = TM.MultimodeStreamer(TM.MultimodeConfig(mode="usb"), device=CPU)
    first = s.demodulate(u8[:CUT])
    s.demodulate(u8[CUT:])
    s.reset()
    assert (s.last_power, s.last_squelch_open, s.n_measurements) == (None,
                                                                      True, 0)
    assert len(s._pending) == 0
    np.testing.assert_array_equal(s.demodulate(u8[:CUT]), first)
    assert s.demodulate(u8[:10]).size == 0 and s.n_measurements == 1


@pytest.mark.parametrize("mode", ["usb", "nbfm"])
def test_state_converts_both_ways(mode):
    """A JAX state mid-stream continues in the port, and the port's state
    continues in JAX: all nine carries, the phases as ints."""
    import jax

    u8 = _capture_for(mode)
    kw = {"deemphasis_tau": 75e-6} if mode == "nbfm" else {"fine_tune_hz": 50.0}
    jconfig = JM.MultimodeConfig(mode=mode, **kw)
    config = TM.MultimodeConfig(mode=mode, **kw)
    a, b = u8[:QUANTUM * 40], u8[QUANTUM * 40:QUANTUM * 80]
    ref = JM.MultimodeStreamer(jconfig)
    ref.demodulate(a)
    exp = ref.demodulate(b)

    mid = JM.MultimodeStreamer(jconfig)
    mid.demodulate(a)
    port = TM.MultimodeStreamer(config, device=CPU)
    port.params = convert.multimode_params_from_jax(mid.params, config,
                                                    device=CPU)
    port.state = convert.multimode_state_from_jax(mid.state, device=CPU)
    assert isinstance(port.state.ssb_phase, int)
    assert _snr_db(exp, port.demodulate(b)) >= 100.0

    start = TM.MultimodeStreamer(config, device=CPU)
    start.params = port.params
    start.demodulate(a)
    back = JM.MultimodeStreamer(jconfig)
    back.state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(back.state),
        jax.tree_util.tree_leaves(convert.multimode_state_to_jax(start.state)))
    assert _snr_db(exp, back.demodulate(b)) >= 100.0


def test_requires_a_device():
    with pytest.raises(TypeError):
        TM.MultimodeStreamer(TM.MultimodeConfig())  # device= is required
