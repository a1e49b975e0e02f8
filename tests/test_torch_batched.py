"""The station batch: tpu_sdr_torch's ``WbfmBatchStreamer`` against tpu_sdr's
``wbfm_batched``, and ``FusedWbfmBatchStreamer`` (K1 and K2 over a station
axis; their plain versions here) against the interpreted Pallas
``demodulate_fused_batch``; each batch against its stations run one at a
time (bit-equal on the CPU), across calls, and handed over from JAX; then
the batched wrappers' station axis: argument checks, and a plain-torch
emulation of the batched K1 launch's per-station tiles, strides and
carries held to ``fm_front_reference``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_fm import _fm_front_tiled
from tpu_sdr.models import wbfm as JW
from tpu_sdr.models import wbfm_batched as JB
from tpu_sdr.ops import pallas_fm
from tpu_sdr.utils import synth
from tpu_sdr_torch import convert, kernels
from tpu_sdr_torch.models import wbfm_batched as TB
from tpu_sdr_torch.ops import fused_fm as FF

torch.set_num_threads(1)

CPU = torch.device("cpu")
JSPEC = pallas_fm.default_spec()
SPEC = FF.default_spec()
CHUNK = SPEC.chunk_bytes  # 130,560


def _snr_db(ref, got):
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))


def _f32(x):
    return np.array(x, dtype=np.float32)


def _stations(stations, n_bytes, seed=0):
    """(stations, n_bytes): station i a synthetic capture at its own tone."""
    return np.stack([np.asarray(synth.synth_wbfm_u8(
        n_bytes // 2, capture_rate=1_020_000, audio_freq=500.0 * (i + 1),
        seed=seed + i, noise_std=0.02)[0], np.uint8) for i in range(stations)])


def _two_calls(streamer, data, cut):
    return np.concatenate([streamer.demodulate(data[:, :cut]),
                           streamer.demodulate(data[:, cut:])], axis=1)


# ---- the float chain's batch ---------------------------------------------

@pytest.mark.parametrize("kw", [{"filter_mode": "fir"},
                                {"filter_mode": "boxcar",
                                 "deemphasis_tau": 75e-6}])
def test_batch_streamer_matches_jax(kw):
    """Three stations in calls of 100,001 and 100,002 bytes: the 2*decim
    quantum leaves a ragged residual and runs the unaligned resamplers."""
    jconfig = JW.WbfmConfig(mxu_precision="f32", **kw)
    data = _stations(3, 200_003)
    exp = _two_calls(JB.WbfmBatchStreamer(3, jconfig), data, 100_001)
    got = _two_calls(TB.WbfmBatchStreamer(3, convert.config_from_jax(jconfig),
                                          device=CPU), data, 100_001)
    assert got.shape == exp.shape and got.shape[1] > 3_000
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-5)
    for i in range(3):
        assert _snr_db(exp[i], got[i]) >= 100.0, i


@pytest.mark.parametrize("mode", ["fir", "boxcar"])
def test_batch_streamer_equals_its_stations_one_at_a_time(mode):
    config = convert.config_from_jax(JW.WbfmConfig(filter_mode=mode))
    data = _stations(3, 150_000, seed=4)
    batch = _two_calls(TB.WbfmBatchStreamer(3, config, device=CPU), data,
                       70_001)
    for i in range(3):
        one = _two_calls(TB.WbfmBatchStreamer(1, config, device=CPU),
                         data[i:i + 1], 70_001)
        assert np.array_equal(one[0], batch[i]), i


def test_batch_state_hands_over_from_jax():
    """A JAX batch's stacked mid-stream state seeds the port's batch."""
    jconfig = JW.WbfmConfig(mxu_precision="f32", deemphasis_tau=75e-6)
    data = _stations(2, 120_000, seed=8)
    ref = JB.WbfmBatchStreamer(2, jconfig)
    ref.demodulate(data[:, :60_000])
    port = TB.WbfmBatchStreamer(2, convert.config_from_jax(jconfig),
                                device=CPU)
    port.state = convert.wbfm_state_from_jax(ref.state, device=CPU)
    port._pending = ref._pending.copy()
    assert port.state.fir.hist_re.shape == (2, 71)
    np.testing.assert_allclose(port.demodulate(data[:, 60_000:]),
                               ref.demodulate(data[:, 60_000:]),
                               rtol=1e-4, atol=1e-5)


# ---- the fused chain's batch (K1 and K2 over a station axis) ---------------

@pytest.fixture(scope="module")
def fused_data():
    return _stations(4, 2 * CHUNK, seed=20)


def test_fused_batch_matches_interpreted_pallas_batch(fused_data):
    """Phases 0..3 across the stations: one chunk through JAX's
    ``demodulate_fused_batch`` (in-kernel broadcast rotation, interpreted)
    and the port's batch, >= 100 dB, carries within 1e-3; the JAX batch's
    state then seeds the port's for the second chunk."""
    w_hi, w_lo, v = pallas_fm.make_kernel_params()
    phases = np.arange(4, dtype=np.int32)
    states = jnp.zeros((4, 4, 128), jnp.float32).at[:, 2, 127].set(1.0)
    hists = jnp.zeros((4, SPEC.taps_per_phase - 1), jnp.float32)

    def jax_chunk(k, states, hists, phases):
        d16 = pallas_fm.view_u8_as_i16_batch(
            fused_data[:, k * CHUNK:(k + 1) * CHUNK], JSPEC)
        return pallas_fm.demodulate_fused_batch(
            jnp.asarray(d16), jnp.asarray(phases), states, hists, w_hi, w_lo,
            v, JSPEC, interpret=True, unpack_impl="scale",
            rot_impl="broadcast")

    exp, j_states, j_hists = jax_chunk(0, states, hists, phases)
    port = FF.FusedWbfmBatchStreamer(4, device=CPU)
    port.phases = phases.tolist()
    got = port.demodulate(fused_data[:, :CHUNK])
    assert got.shape == np.asarray(exp).shape == (4, SPEC.audio_per_chunk)
    for i in range(4):
        assert _snr_db(_f32(exp[i]), got[i]) >= 100.0, i
    np.testing.assert_allclose(port.states.numpy(), _f32(j_states), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(port.resamp_hists.numpy(), _f32(j_hists),
                               rtol=1e-5, atol=1e-5)
    assert port.phases == [int(p) for p in (phases + CHUNK // 2) % 4]

    # the JAX batch's carries continue in the port
    handed = FF.FusedWbfmBatchStreamer(4, device=CPU)
    handed.states, handed.resamp_hists, handed.phases = convert.state_from_jax(
        j_states, j_hists, (phases + CHUNK // 2) % 4, device=CPU)
    exp2, _, _ = jax_chunk(1, j_states, j_hists, (phases + CHUNK // 2) % 4)
    got2 = handed.demodulate(fused_data[:, CHUNK:])
    for i in range(4):
        assert _snr_db(_f32(exp2[i]), got2[i]) >= 100.0, i


def test_fused_batch_equals_its_stations_one_at_a_time(fused_data):
    phases = [3, 0, 2, 1]
    batch = FF.FusedWbfmBatchStreamer(4, device=CPU)
    batch.phases = list(phases)
    got = _two_calls(batch, fused_data, CHUNK + 1000)
    for i in range(4):
        one = FF.FusedWbfmStreamer(device=CPU)
        one.phase = phases[i]
        exp = np.concatenate([one.demodulate(fused_data[i, :CHUNK + 1000]),
                              one.demodulate(fused_data[i, CHUNK + 1000:])])
        assert np.array_equal(exp, got[i]), i


def test_fused_batch_split_invariance(fused_data):
    whole = FF.FusedWbfmBatchStreamer(4, device=CPU).demodulate(fused_data)
    split = _two_calls(FF.FusedWbfmBatchStreamer(4, device=CPU), fused_data,
                       CHUNK // 3)
    assert split.shape == whole.shape
    np.testing.assert_allclose(split, whole, rtol=1e-5, atol=1e-6)
    assert FF.FusedWbfmBatchStreamer(2, device=CPU).demodulate(
        fused_data[:2, :100]).shape == (2, 0)
    # a read of other rows than the stations' is refused, not broadcast
    for bad in (fused_data[0, :CHUNK + 10], fused_data[:3, :CHUNK + 10]):
        with pytest.raises(ValueError):
            FF.FusedWbfmBatchStreamer(2, device=CPU).demodulate(bad)


# ---- the station axis of the wrappers --------------------------------------

def test_batch_wrappers_check_phases_and_shapes():
    taps, h_poly = FF.make_kernel_params(device=CPU)
    data = torch.zeros(2, 2 * 6 * 128, dtype=torch.uint8)
    carries = FF.init_carry(CPU).repeat(2, 1, 1)
    for phase in ([0, 1, 2], [0, 4], -1):
        with pytest.raises(ValueError):
            FF.fm_front(data, phase, carries, taps, SPEC.decim)
    with pytest.raises(ValueError):  # 3-D bytes
        FF.fm_front(data[None], 0, carries, taps, SPEC.decim)
    with pytest.raises(ValueError):  # an out of another shape
        FF.fm_front(data, 0, carries, taps, SPEC.decim,
                    out=torch.zeros(2, 127))
    with pytest.raises(ValueError):
        FF.demodulate_fused_batch(data[0], 0, carries[0],
                                  torch.zeros(47), taps, h_poly, SPEC)
    z, c = FF.fm_front(data, [1, 2], carries, taps, SPEC.decim,
                       out=torch.zeros(2, 130)[:, 1:129])
    assert z.shape == (2, 128) and c.shape == (2, 4, 128)
    a, h = FF.resample(torch.zeros(2, 170), torch.zeros(2, 60)[:, 5:52],
                       h_poly, SPEC.down)
    assert a.shape == (2, 32) and h.shape == (2, 47)


def test_check_rows_takes_strided_rows_and_refuses_the_rest():
    recs = torch.zeros(3, 560)
    assert kernels.check_rows(recs[:, :512].reshape(3, 4, 128), "carry",
                              torch.float32, CPU, (3, 4, 128)) == 560
    assert kernels.check_rows(recs[1:2, :47], "hist", torch.float32, CPU,
                              (1, 47)) == 560
    for bad in (recs[:, ::2], recs.as_strided((3, 47), (10, 1))):
        with pytest.raises(ValueError):
            kernels.check_rows(bad, "x", torch.float32, CPU, tuple(bad.shape))
    with pytest.raises(TypeError):
        kernels.check_rows(recs.double(), "x", torch.float32, CPU, (3, 560))
    with pytest.raises(ValueError):
        kernels.check_rows(recs, "x", torch.float32, CPU, (3, 561))


def _k1_grid(stations, M, warps=8, sms=132, per_sm=2):
    """The batched K1 launch's geometry (``csrc/fm_front.cu`` ``launch``):
    one wave of ``sms * per_sm`` blocks split over the stations, capped
    by the tiles; returns grid.x and, per station, the 120-output tiles
    each (block, warp) walks."""
    tiles = -(-M // 120)
    grid = -(-sms * per_sm // stations)
    grid = min(grid, -(-tiles // warps))
    step = grid * warps
    walk = {(bx, w): list(range(step - 1 - (bx * warps + w), tiles, step))
            for bx in range(grid) for w in range(warps)}
    return grid, walk, tiles


@pytest.mark.parametrize("stations,m,per_sm", [(4, 21_760, 2), (3, 40_003, 1),
                                               (8, 127, 4), (1, 21_760, 2)])
def test_emulated_batched_fm_front_launch(stations, m, per_sm):
    """The batched K1 launch in plain torch: station s (blockIdx.y) reads
    its bytes, carry and z row at base + s * stride from flat buffers (the
    carries at a 560-float record's stride, z with a gap between rows),
    runs the tensor-core tiling of ``_fm_front_tiled`` at its own phase,
    and its block 0 writes its carry; every tile of every station is
    walked once.  Held to ``fm_front_reference`` on the batch: >= 100 dB,
    carry rows 0/1 bit-equal."""
    grid, walk, tiles = _k1_grid(stations, m, per_sm=per_sm)
    walked = sorted(t for ts in walk.values() for t in ts)
    assert walked == list(range(tiles))
    if stations == 1:
        assert grid == min(132 * per_sm, -(-tiles // 8))  # the one-station launch

    taps, _ = FF.make_kernel_params(device=CPU)
    n_bytes = 2 * SPEC.decim * m
    iq = torch.from_numpy(_stations(stations, n_bytes, seed=m).reshape(-1))
    rng = np.random.default_rng(m)
    records = torch.from_numpy(rng.uniform(-1, 1, stations * 560).astype(
        np.float32))
    records.view(stations, 560)[:, :256] *= 255.0
    phases = [(5 * s + 1) % 4 for s in range(stations)]
    z_stride, c_stride = m + 3, 560
    z_flat = torch.full((stations * z_stride,), float("nan"))
    c_out = torch.zeros(stations * 512)
    for s in range(stations):  # blockIdx.y = s
        row = iq[s * n_bytes:(s + 1) * n_bytes]
        carry_in = records[s * c_stride:s * c_stride + 512].view(4, 128)
        z, c = _fm_front_tiled(row, phases[s], carry_in, taps, SPEC.decim)
        z_flat[s * z_stride:s * z_stride + m] = z
        c_out[s * 512:(s + 1) * 512] = c.reshape(-1)
    ragged = [(s * n_bytes) % 16 for s in range(stations)]
    assert (m % 8 == 0) == (max(ragged) == 0)  # rows off 16-byte alignment

    data = iq.view(stations, n_bytes)
    carries = records.view(stations, 560)[:, :512].reshape(stations, 4, 128)
    z_ref, c_ref = FF.fm_front_reference(data, phases, carries, taps,
                                         SPEC.decim)
    z_got = z_flat.view(stations, z_stride)[:, :m]
    c_got = c_out.view(stations, 4, 128)
    for s in range(stations):
        assert _snr_db(z_ref[s].numpy(), z_got[s].numpy()) >= 100.0, s
        assert torch.equal(c_got[s, :2], c_ref[s, :2]), s
        np.testing.assert_allclose(c_got[s, 2:].numpy(), c_ref[s, 2:].numpy(),
                                   rtol=1e-5, atol=1e-4)
    assert not torch.isnan(z_got).any()
