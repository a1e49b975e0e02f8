"""tpu_sdr_torch's float chain in every mode against tpu_sdr's ``WbfmStreamer``
with the same config: the boxcar and fir modes, de-emphasis, the
multiplex tap, the unaligned resamplers, the six-field state's hand-over,
the boxcar chain against the exact one, and the sharded boxcar chain
against JAX's 8-device CPU mesh.

Same f32 math in another summation order (XLA's cumsum and scan are
parallel prefixes, the port's a running sum and a doubling scan): the
chains must agree to ``allclose(rtol=1e-4, atol=1e-5)`` and >= 100 dB.
The JAX fir chain runs ``mxu_precision="f32"``, the port's precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sdr.models import wbfm as JW
from tpu_sdr.ops import fm as JF
from tpu_sdr.parallel import mesh as jmesh
from tpu_sdr.parallel.wbfm_sharded import make_sharded_wbfm as j_make_sharded
from tpu_sdr.utils import synth
from tpu_sdr_torch import convert
from tpu_sdr_torch.models import wbfm as TW
from tpu_sdr_torch.models import wbfm_exact as TE
from tpu_sdr_torch.parallel import mesh as M
from tpu_sdr_torch.parallel import wbfm_sharded as WS
from tpu_sdr_torch.utils import synth as tsynth
from tpu_sdr_torch.utils.design import WbfmConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
BLOCK = 262_144  # the reference's device block: not a whole number of frames
MODES = [
    {"filter_mode": "boxcar"},
    {"filter_mode": "boxcar", "deemphasis_tau": 75e-6},
    {"filter_mode": "fir", "deemphasis_tau": 75e-6},
    {"filter_mode": "fir", "emit_mpx": True},
    {"filter_mode": "boxcar", "deemphasis_tau": 50e-6, "emit_mpx": True},
]


def _snr_db(ref, got):
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))


def _close(exp, got, what):
    assert got.shape == exp.shape, what
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-5, err_msg=what)
    assert _snr_db(exp, got) >= 100.0, what


def _configs(**kw):
    jconfig = JW.WbfmConfig(mxu_precision="f32", **kw)
    return jconfig, convert.config_from_jax(jconfig)


@pytest.fixture(scope="module")
def capture():
    u8, _ = synth.synth_wbfm_u8(BLOCK, capture_rate=1_020_000,
                                noise_std=0.02, seed=7)
    return np.asarray(u8, dtype=np.uint8)


@pytest.mark.parametrize("kw", MODES)
def test_streamer_modes_match_jax(capture, kw):
    jconfig, config = _configs(**kw)
    ref, port = JW.WbfmStreamer(jconfig), TW.WbfmStreamer(config, device=CPU)
    exp, got, exp_mpx, got_mpx = [], [], [], []
    for s in range(0, len(capture), BLOCK):
        exp.append(ref.demodulate(capture[s:s + BLOCK]))
        got.append(port.demodulate(capture[s:s + BLOCK]))
        if kw.get("emit_mpx"):
            exp_mpx.append(ref.last_mpx)
            got_mpx.append(port.last_mpx)
    _close(np.concatenate(exp), np.concatenate(got), f"audio {kw}")
    if kw.get("emit_mpx"):
        assert len(got_mpx[0]) == 131_070 // 6
        _close(np.concatenate(exp_mpx), np.concatenate(got_mpx), f"mpx {kw}")
    else:
        assert port.last_mpx is None


@pytest.mark.parametrize("kw", [{"filter_mode": "fir"},
                                {"filter_mode": "boxcar"},
                                {"filter_mode": "boxcar",
                                 "deemphasis_tau": 75e-6}])
def test_unaligned_blocks_match_jax(capture, kw):
    """``demodulate_block`` on multiples of 2*decim bytes that are not
    whole resampler frames (the polyphase resampler's t0, the boxcar
    resampler's accumulator), then one aligned block, as JAX runs them."""
    jconfig, config = _configs(**kw)
    jparams, params = JW.make_params(jconfig), TW.WbfmParams(config, CPU)
    jstate, state = JW.init_state(jconfig), TW.init_state(config, CPU)
    exp, got, off = [], [], 0
    for n in (12 * 1001, 12 * 777, 12 * 85 * 10, 12 * 5003):
        block = capture[off:off + n]
        off += n
        audio, count, jstate = JW.demodulate_block(jnp.asarray(block), jstate,
                                                   jparams, jconfig)
        exp.append(np.asarray(audio)[:int(count)])
        a, state = TW.demodulate_block(torch.from_numpy(block), state, params,
                                       config)
        got.append(a.numpy())
        assert got[-1].shape == exp[-1].shape
        assert state.resamp.t0 == int(jstate.resamp.t0)
        assert state.box_resamp.acc == int(jstate.box_resamp.acc)
    assert state.resamp.t0 != 0 or state.box_resamp.acc != 0
    _close(np.concatenate(exp), np.concatenate(got), f"unaligned {kw}")


def test_demodulate_block_rejects_a_partial_group():
    config = WbfmConfig(filter_mode="boxcar")
    with pytest.raises(ValueError):
        TW.demodulate_block(torch.zeros(1030, dtype=torch.uint8),
                            TW.init_state(config, CPU),
                            TW.WbfmParams(config, CPU), config)


def test_boxcar_chain_matches_exact_chain():
    """The float boxcar chain against the bit-exact integer chain (the
    reference's output) on the same blocks: >= 60 dB at lag 0, the bar of
    tests/test_fm_fast.py."""
    u8, _ = synth.synth_wbfm_u8(245_760, capture_rate=1_020_000)
    u8 = np.asarray(u8, dtype=np.uint8)
    box = TW.WbfmStreamer(WbfmConfig(filter_mode="boxcar"), device=CPU)
    ex = TE.WbfmExactStreamer(device=CPU)
    got, exact = [], []
    for s in range(0, len(u8), 16_320):
        got.append(box.demodulate(u8[s:s + 16_320]))
        exact.append(ex.demodulate(u8[s:s + 16_320]))
    snr, lag = tsynth.align_and_snr(np.concatenate(exact).astype(np.float64),
                                    np.concatenate(got), max_lag=4, skip=50)
    assert lag == 0
    assert snr >= 60.0, f"boxcar vs exact: {snr:.1f} dB"


def _jax_state(parts):
    """numpy parts of ``convert.wbfm_state_to_jax`` -> a JAX WbfmState."""
    rot, fir, quad, rs, box, de = (tuple(jnp.asarray(x) for x in p)
                                   for p in parts)
    return JW.WbfmState(JF.RotatorState(*rot), JF.FirState(*fir),
                        JF.QuadState(*quad), JF.ResampleState(*rs),
                        JF.BoxcarResampleState(*box), JF.DeemphState(*de))


@pytest.mark.parametrize("kw", [{"filter_mode": "fir",
                                 "deemphasis_tau": 75e-6},
                                {"filter_mode": "boxcar",
                                 "deemphasis_tau": 75e-6}])
def test_six_field_state_hands_over_both_ways(capture, kw):
    """A JAX stream's mid-stream state (t0 and the accumulator non-zero,
    de-emphasis running) seeds the port's, and the rest of the output is
    JAX's; the port's state, handed back, continues in JAX."""
    jconfig, config = _configs(**kw)
    jparams, params = JW.make_params(jconfig), TW.WbfmParams(config, CPU)
    first, rest = capture[:12 * 1001], capture[12 * 1001:12 * 3001]
    _, _, jstate = JW.demodulate_block(jnp.asarray(first), JW.init_state(
        jconfig), jparams, jconfig)
    assert int(jstate.resamp.t0) or int(jstate.box_resamp.acc)
    exp, count, jend = JW.demodulate_block(jnp.asarray(rest), jstate, jparams,
                                           jconfig)
    state = convert.wbfm_state_from_jax(jstate, device=CPU)
    got, end = TW.demodulate_block(torch.from_numpy(rest), state, params,
                                   config)
    _close(np.asarray(exp)[:int(count)], got.numpy(), f"hand-over {kw}")
    back = _jax_state(convert.wbfm_state_to_jax(end))
    more = capture[12 * 3001:12 * 4001]
    a1, c1, _ = JW.demodulate_block(jnp.asarray(more), back, jparams, jconfig)
    a2, c2, _ = JW.demodulate_block(jnp.asarray(more), jend, jparams, jconfig)
    _close(np.asarray(a2)[:int(c2)], np.asarray(a1)[:int(c1)],
           f"hand-back {kw}")


# ---- the sharded boxcar chain against JAX's ------------------------------

def _stations(stations, n_complex):
    return np.stack([np.asarray(synth.synth_wbfm_u8(
        n_complex, capture_rate=1_020_000, audio_freq=500.0 * (i + 1),
        seed=i, noise_std=0.01)[0], np.uint8) for i in range(stations)])


@pytest.mark.parametrize("dp,sp,n_loc", [(1, 8, 6 * 4096), (2, 4, 6 * 8192),
                                         (1, 8, 2040 * 12)])
def test_sharded_boxcar_matches_jax(dp, sp, n_loc):
    """Unaligned shards (the global-phase boxcar resampler with its 6-sample
    halo) and aligned ones (the boxcar frame matrix, no halo)."""
    blocks = _stations(dp, sp * n_loc)
    jchain = j_make_sharded(jmesh.make_mesh(dp=dp, sp=sp),
                            JW.WbfmConfig(filter_mode="boxcar"))
    exp = jchain.assemble(*jchain(jax.device_put(blocks, jchain.in_sharding)))
    chain = WS.make_sharded_wbfm(M.make_mesh(dp, sp, devices=[CPU] * (dp * sp)),
                                 WbfmConfig(filter_mode="boxcar"))
    audio, counts = WS.sharded_wbfm_apply(chain, blocks)
    got = chain.assemble(audio, counts)
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-4)
    if (n_loc // 6) % 85:  # the unaligned shards' static maximum
        assert WS.expected_m_max(chain.config,
                                 n_loc // 6) == audio[0][0].shape[1]


def test_sharded_boxcar_refuses_carry_io():
    """As in JAX, block-to-block streaming is the fir chain's."""
    with pytest.raises(ValueError):
        WS.make_sharded_wbfm(M.make_mesh(1, 2, devices=[CPU] * 2),
                             WbfmConfig(filter_mode="boxcar"), carry_io=True)
