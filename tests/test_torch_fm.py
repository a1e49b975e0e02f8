"""tpu_sdr_torch's weight builders and float ops against tpu_sdr's.

Weights must be bit-equal; each float op must agree with its JAX
counterpart within 1e-5 relative (same f32 math, other summation order).
Inputs are made with numpy (``synth.synth_wbfm_u8``) and handed to both.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sdr.models import wbfm as JW
from tpu_sdr.models.wbfm_exact import optimal_settings as jax_optimal_settings
from tpu_sdr.ops import fm as JF
from tpu_sdr.utils import firdes, synth
from tpu_sdr_torch.ops import fm as TF
from tpu_sdr_torch.ops import fused_fm as FF
from tpu_sdr_torch.utils import design

torch.set_num_threads(1)

CONFIG = design.WbfmConfig()


def _close(got, ref, rtol=1e-5):
    """Within ``rtol`` of the reference, relative to its largest value."""
    ref = np.asarray(ref, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def capture():
    u8, _ = synth.synth_wbfm_u8(6 * 85 * 24, capture_rate=1_020_000,
                                noise_std=0.05, seed=3)
    return np.asarray(u8, dtype=np.uint8)


def test_config_matches_jax():
    assert (dataclasses.asdict(CONFIG)
            == dataclasses.asdict(JW.WbfmConfig()))
    assert CONFIG.resample_up == JW.WbfmConfig().resample_up == 16
    assert CONFIG.resample_down == JW.WbfmConfig().resample_down == 85


@pytest.mark.parametrize("freq", [94_900_000, 100_100_000])
def test_optimal_settings_match_jax(freq):
    radio, demod = design.optimal_settings(freq, 170_000)
    jradio, jdemod = jax_optimal_settings(freq, 170_000)
    assert dataclasses.asdict(radio) == dataclasses.asdict(jradio)
    assert dataclasses.asdict(demod) == dataclasses.asdict(jdemod)


def test_banded_matrix_bit_equal():
    taps = design.decimator_taps(CONFIG)
    np.testing.assert_array_equal(
        design.make_banded_decim_matrix(taps, CONFIG.decim),
        np.asarray(JF.make_banded_decim_matrix(taps, CONFIG.decim)))


def test_split_bf16_bit_equal():
    W = design.make_banded_decim_matrix(design.decimator_taps(CONFIG),
                                        CONFIG.decim)
    hi, lo = design.make_split_bf16(W)
    jhi, jlo = JF.make_split_bf16(W)
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(hi.view(torch.int16).numpy(),
                                  np.asarray(jhi).view(np.int16))
    np.testing.assert_array_equal(lo.view(torch.int16).numpy(),
                                  np.asarray(jlo).view(np.int16))
    # the pair sums exactly in f32: one set of taps is the kernel's filter
    eff = FF.effective_taps(hi, lo, CONFIG.num_taps).double()
    exact = hi.double()[:CONFIG.num_taps, 0] + lo.double()[:CONFIG.num_taps, 0]
    assert torch.equal(eff, exact)


def test_polyphase_bit_equal():
    h = firdes.resampler_taps(16, 85, taps_per_phase=48, cutoff_frac=0.8)
    np.testing.assert_array_equal(design.make_polyphase(h, 16),
                                  np.asarray(JF.make_polyphase(h, 16)))
    np.testing.assert_array_equal(design.resampler_poly(CONFIG),
                                  np.asarray(JF.make_polyphase(h, 16)))


@pytest.mark.parametrize("frames_per_row", [1, 4])
def test_aligned_poly_matrix_bit_equal(frames_per_row):
    hp = design.resampler_poly(CONFIG)
    V = design.make_aligned_poly_matrix(hp, 16, 85, frames_per_row)
    np.testing.assert_array_equal(
        V, np.asarray(JF.make_aligned_poly_matrix(hp, 16, 85, frames_per_row)))
    if frames_per_row == 1:  # the plain K2's on-device builder
        got = FF.aligned_poly_matrix(torch.from_numpy(hp), 85)
        np.testing.assert_array_equal(got.numpy(), V)


def test_u8_to_f32(capture):
    re, im = TF.u8_to_f32(torch.from_numpy(capture))
    jre, jim = JF.u8_to_f32(jnp.asarray(capture))
    _close(re, jre)
    _close(im, jim)


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_rotate_fs4(capture, phase):
    re, im = TF.u8_to_f32(torch.from_numpy(capture))
    ore, oim, nxt = TF.rotate_fs4(re, im, phase)
    jre, jim, jst = JF.rotate_fs4(jnp.asarray(re.numpy()),
                                  jnp.asarray(im.numpy()),
                                  JF.RotatorState(jnp.int32(phase)))
    np.testing.assert_array_equal(ore.numpy(), np.asarray(jre, np.float32))
    np.testing.assert_array_equal(oim.numpy(), np.asarray(jim, np.float32))
    assert nxt == int(jst.phase)


def _rotated(capture):
    re, im = TF.u8_to_f32(torch.from_numpy(capture))
    re, im, _ = TF.rotate_fs4(re, im, 0)
    return re, im


def test_fir_decimate_mxu_streaming(capture):
    re, im = _rotated(capture)
    taps = design.decimator_taps(CONFIG)
    W = design.make_banded_decim_matrix(taps, CONFIG.decim)
    L, d = CONFIG.num_taps, CONFIG.decim
    st = TF.fir_init(L, torch.device("cpu"))
    jst = JF.fir_init(L)
    half = (len(re) // 2) // d * d
    for sl in (slice(0, half), slice(half, None)):
        ore, oim, st = TF.fir_decimate_mxu(re[sl], im[sl], torch.from_numpy(W),
                                           L, d, st)
        jre, jim, jst = JF.fir_decimate_mxu(
            jnp.asarray(re[sl].numpy()), jnp.asarray(im[sl].numpy()),
            jnp.asarray(W), L, d, jst)
        _close(ore, jre)
        _close(oim, jim)
    _close(st.hist_re, jst.hist_re)
    _close(st.hist_im, jst.hist_im)


def test_quadrature_demod(capture):
    re, im = _rotated(capture)
    y, st = TF.quadrature_demod(re, im, TF.quad_init(torch.device("cpu")))
    jy, jst = JF.quadrature_demod(jnp.asarray(re.numpy()),
                                  jnp.asarray(im.numpy()), JF.quad_init())
    _close(y, jy)
    assert float(st.pre_re) == float(jst.pre_re)
    assert float(st.pre_im) == float(jst.pre_im)


@pytest.mark.parametrize("frames_per_row", [1, 4])
def test_aligned_resample(frames_per_row):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(85 * 4 * 12).astype(np.float32)
    hist = rng.standard_normal(47).astype(np.float32)
    V = design.make_aligned_poly_matrix(design.resampler_poly(CONFIG), 16, 85,
                                        frames_per_row)
    y, st = TF.aligned_resample(torch.from_numpy(x), torch.from_numpy(V), 16,
                                85, TF.AlignedResampleState(torch.from_numpy(hist)))
    jy, jst = JF.aligned_resample(jnp.asarray(x), jnp.asarray(V), 16, 85,
                                  JF.AlignedResampleState(jnp.asarray(hist)))
    _close(y, jy)
    np.testing.assert_array_equal(st.hist.numpy(), np.asarray(jst.hist))


def test_aligned_resample_rejects_partial_frame():
    V = torch.from_numpy(design.make_aligned_poly_matrix(
        design.resampler_poly(CONFIG), 16, 85))
    with pytest.raises(ValueError):
        TF.aligned_resample(torch.zeros(100), V, 16, 85,
                            TF.aligned_resample_init(48, torch.device("cpu")))
