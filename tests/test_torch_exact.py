"""tpu_sdr_torch's exact integer chain against the rtl_fm golden vectors and
tpu_sdr's ``WbfmExactStreamer``, bit for bit.

Stage by stage as tests/test_golden_exact.py holds the JAX ops; then the
whole chain against JAX's on a synthetic capture in the reference's
262,144-byte blocks and split at odd multiples of 8 bytes; the integer
``fast_atan2`` on its edge values (products past 2^31 included); the
hand-over of a JAX stream's state.  The conftest runs JAX with x64, so the
JAX chain's exact atan2 is float64, as the port's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_vectors import BUF_SIGNED, DEMOD_EXPECTED, LOWPASS, RESULT
from tpu_sdr.models import wbfm_exact as JE
from tpu_sdr.ops import exact as JX
from tpu_sdr.utils import synth
from tpu_sdr_torch import convert
from tpu_sdr_torch.models import wbfm_exact as TE
from tpu_sdr_torch.ops import exact as X

torch.set_num_threads(1)

CPU = torch.device("cpu")
DOWNSAMPLE = 6
BLOCK = 262_144  # the reference's device block


def _pairs(v):
    a = np.asarray(v, dtype=np.int32)
    return torch.from_numpy(a[0::2].copy()), torch.from_numpy(a[1::2].copy())


@pytest.fixture(scope="module")
def capture():
    u8, _ = synth.synth_wbfm_u8(3 * BLOCK // 2, capture_rate=1_020_000,
                                noise_std=0.02, seed=17)
    return np.asarray(u8, dtype=np.uint8)


# ---- stage by stage against the golden vectors ---------------------------

def test_lowpass_golden():
    re, im = _pairs(BUF_SIGNED)
    out_re, out_im, count, _ = X.boxcar_decimate(re, im, X.boxcar_init(CPU),
                                                 DOWNSAMPLE)
    exp_re, exp_im = _pairs(LOWPASS)
    assert int(count) == len(exp_re)
    assert out_re.dtype == torch.int32
    assert torch.equal(out_re[:int(count)], exp_re)
    assert torch.equal(out_im[:int(count)], exp_im)


def test_demod_golden():
    re, im = _pairs(LOWPASS)
    out, count, _ = X.fm_discriminate(re, im, torch.tensor(len(re)),
                                      X.discriminator_init(CPU))
    assert out.dtype == torch.int16
    np.testing.assert_array_equal(out[:int(count)].numpy(), DEMOD_EXPECTED)


def test_lowpass_real_golden():
    x = torch.tensor(DEMOD_EXPECTED, dtype=torch.int16)
    out, count, _ = X.boxcar_resample(x, torch.tensor(len(x)),
                                      X.resampler_init(CPU), 170_000, 32_000)
    np.testing.assert_array_equal(out[:int(count)].numpy(), RESULT)


@pytest.mark.parametrize("split", [1, 5, 6, 7, 13])
def test_lowpass_block_split_invariance(split):
    re, im = _pairs(BUF_SIGNED)
    state, got_re, got_im = X.boxcar_init(CPU), [], []
    for s in range(0, len(re), split):
        o_re, o_im, c, state = X.boxcar_decimate(re[s:s + split],
                                                 im[s:s + split], state,
                                                 DOWNSAMPLE)
        got_re.append(o_re[:int(c)])
        got_im.append(o_im[:int(c)])
    exp_re, exp_im = _pairs(LOWPASS)
    assert torch.equal(torch.cat(got_re), exp_re)
    assert torch.equal(torch.cat(got_im), exp_im)


@pytest.mark.parametrize("split", [7, 11, 42])
def test_resampler_block_split_invariance(split):
    state, got = X.resampler_init(CPU), []
    for s in range(0, len(DEMOD_EXPECTED), split):
        chunk = torch.tensor(DEMOD_EXPECTED[s:s + split], dtype=torch.int16)
        out, c, state = X.boxcar_resample(chunk, torch.tensor(len(chunk)),
                                          state, 170_000, 32_000)
        got.append(out[:int(c)])
    np.testing.assert_array_equal(torch.cat(got).numpy(), RESULT)


def test_rotate_90_matches_jax():
    rng = np.random.default_rng(0)
    buf = rng.integers(0, 256, size=512, dtype=np.uint8)
    got = X.rotate_90_u8(torch.from_numpy(buf)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JX.rotate_90_u8(
        jnp.asarray(buf))))
    with pytest.raises(ValueError):
        X.rotate_90_u8(torch.from_numpy(buf[:12]))


# ---- fast_atan2 on its edges ---------------------------------------------

def test_fast_atan2_edges_match_jax():
    """(0, 0), x = 0, y < 0, |y| > |x|, and products 4096*(x -/+ |y|) past
    2^31 (x up to the 6 x 128 boxcar's ~1.2e6): the wrap before the
    division is live."""
    edge = [(0, 0), (0, 5), (0, -5), (7, 0), (-7, 0), (-3, -4), (3, -4),
            (1, -1), (-1, 1), (-1, -1), (1_179_648, 3), (-1_179_648, -3),
            (600_000, -1), (-600_000, 1), (2 ** 20, 2 ** 20 - 1),
            (-(2 ** 20), 5), (1_000_000, -1_000_000)]
    rng = np.random.default_rng(1)
    big = rng.integers(-1_200_000, 1_200_000, size=(2000, 2))
    yx = np.concatenate([np.asarray(edge), big]).astype(np.int32)
    y, x = yx[:, 1], yx[:, 0]
    got = X.fast_atan2_i32(torch.from_numpy(y), torch.from_numpy(x))
    exp = np.asarray(JX.fast_atan2_i32(jnp.asarray(y), jnp.asarray(x)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)
    assert (np.abs(4096 * (x.astype(np.int64) - np.abs(y))) >= 2 ** 31).any()


# ---- the whole chain against JAX's ---------------------------------------

def _stream(streamer, capture, cuts):
    edges = [0, *cuts, len(capture)]
    return np.concatenate([streamer.demodulate(capture[a:b])
                           for a, b in zip(edges[:-1], edges[1:])])


@pytest.mark.parametrize("cuts", [
    [BLOCK, 2 * BLOCK],                  # the reference's blocks
    [8 * 3, 8 * 4099, 8 * 40_001],       # odd multiples of 8 bytes
])
def test_chain_matches_jax_streamer(capture, cuts):
    exp = _stream(JE.WbfmExactStreamer(), capture, cuts)
    got = _stream(TE.WbfmExactStreamer(device=CPU), capture, cuts)
    assert got.dtype == np.int16 and len(exp) > 10_000
    np.testing.assert_array_equal(got, exp)


def test_state_handoff_from_jax(capture):
    """A JAX exact stream's mid-stream state seeds the port's, and the rest
    of the output is JAX's, bit for bit; the port's state goes back."""
    ref = JE.WbfmExactStreamer()
    first = ref.demodulate(capture[:BLOCK + 8 * 7])
    port = TE.WbfmExactStreamer(device=CPU)
    port.state = convert.exact_state_from_jax(ref.state, device=CPU)
    rest = port.demodulate(capture[BLOCK + 8 * 7:])
    # the same blocks through JAX alone (a block's first sample takes the
    # exact atan2, so the split is part of the stream)
    whole = JE.WbfmExactStreamer()
    exp = _stream(whole, capture, [BLOCK + 8 * 7])
    np.testing.assert_array_equal(np.concatenate([first, rest]), exp)
    for got, exp in zip(convert.exact_state_to_jax(port.state), whole.state):
        assert [int(g) for g in got] == [int(e) for e in exp]


def test_state_is_int32_scalars_and_blocks_are_padded(capture):
    state = TE.init_state(CPU)
    for part in state:
        for x in part:
            assert x.dtype == torch.int32 and x.dim() == 0
    audio, count, _ = TE.demodulate_block(torch.from_numpy(capture[:4096]),
                                          state, TE.WbfmExactConfig())
    assert audio.dtype == torch.int16
    assert count.dtype == torch.int32 and int(count) <= audio.numel()
