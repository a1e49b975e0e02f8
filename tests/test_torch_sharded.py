"""The port's fused sharded chain (K1 and K2 per shard, the end-of-shard
carry shipped by the K4 exchange) against tpu_sdr's Pallas sharded chain
under the interpreter, on port meshes of ``[cpu] * n``, and against the
port's serial fused chain.  One kernel chunk (65,280 complex) per shard;
station 0 a synthetic capture, the others seeded random bytes.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_sdr.models import wbfm as JW
from tpu_sdr.ops import pallas_fm
from tpu_sdr.parallel import mesh as jmesh
from tpu_sdr.parallel.wbfm_sharded_pallas import (
    ShardedPallasStreamer, initial_carry as j_initial_carry,
    make_sharded_wbfm_pallas, sharded_wbfm_pallas_apply, view_blocks_as_i16)
from tpu_sdr.utils import synth
from tpu_sdr_torch import convert
from tpu_sdr_torch.ops import fused_fm as FF
from tpu_sdr_torch.parallel import mesh as M
from tpu_sdr_torch.parallel import wbfm_sharded as WS
from tpu_sdr_torch.parallel import wbfm_sharded_fused as WSF

torch.set_num_threads(1)

CPU = torch.device("cpu")
CHUNK_C = FF.default_spec().chunk_complex  # 65,280 complex per chunk
JCONFIG = JW.WbfmConfig(filter_mode="fir")
GEOMETRIES = [(1, 4), (2, 2)]


def _snr_db(ref, got):
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))


def _cpu_mesh(dp, sp):
    return M.make_mesh(dp, sp, devices=[CPU] * (dp * sp))


def _blocks(stations, n_complex, seed, count=1):
    """``count`` consecutive (stations, bytes) blocks: station 0 a
    synthetic capture, the others random bytes."""
    rng = np.random.default_rng(seed)
    base = np.asarray(synth.synth_wbfm_u8(count * n_complex,
                                          capture_rate=1_020_000)[0],
                      np.uint8)
    rows = [base] + [rng.integers(0, 256, 2 * count * n_complex,
                                  dtype=np.uint8)
                     for _ in range(stations - 1)]
    return [np.stack([r[2 * k * n_complex:2 * (k + 1) * n_complex]
                      for r in rows]) for k in range(count)]


def _serial(blocks):
    """The port's serial fused chain, one streamer per station over all
    ``blocks``."""
    out = []
    for s in range(blocks[0].shape[0]):
        st = FF.FusedWbfmStreamer(device=CPU)
        out.append(np.concatenate([st.demodulate(b[s]) for b in blocks]))
    return np.stack(out)


@pytest.fixture(scope="module")
def one_block():
    """Per geometry: the block and the JAX sharded chain's audio on it."""
    out = {}
    for dp, sp in GEOMETRIES:
        (blocks,) = _blocks(2 * dp, sp * CHUNK_C, seed=9)
        chain = make_sharded_wbfm_pallas(jmesh.make_mesh(dp=dp, sp=sp),
                                         JCONFIG, interpret=True)
        out[dp, sp] = blocks, chain.assemble(
            *sharded_wbfm_pallas_apply(chain, blocks))
    return out


@pytest.fixture(scope="module")
def two_blocks():
    """Per geometry: two consecutive blocks and the JAX carry_io chain's
    audio over both."""
    out = {}
    for dp, sp in GEOMETRIES:
        blocks = _blocks(2 * dp, sp * CHUNK_C, seed=17, count=2)
        chain = make_sharded_wbfm_pallas(jmesh.make_mesh(dp=dp, sp=sp),
                                         JCONFIG, interpret=True,
                                         carry_io=True)
        ke, re = j_initial_carry(2 * dp, JCONFIG)
        parts = []
        for b in blocks:
            x = jax.device_put(view_blocks_as_i16(b), chain.in_sharding)
            audio, counts, ke, re = chain.fn(x, ke, re)
            parts.append(chain.assemble(audio, counts))
        out[dp, sp] = blocks, np.concatenate(parts, axis=1)
    return out


@pytest.mark.parametrize("dp,sp", GEOMETRIES)
def test_fused_sharded_matches_jax_pallas_chain(one_block, dp, sp):
    blocks, exp = one_block[dp, sp]
    chain = WSF.make_sharded_wbfm_fused(_cpu_mesh(dp, sp))
    got = chain.assemble(*WS.sharded_wbfm_apply(chain, blocks))
    assert got.shape == exp.shape
    snr = _snr_db(exp, got)
    assert snr >= 100.0, f"({dp}, {sp}): {snr:.1f} dB"


@pytest.mark.parametrize("dp,sp", GEOMETRIES)
def test_fused_sharded_matches_serial_fused_chain(one_block, dp, sp):
    blocks, _ = one_block[dp, sp]
    chain = WSF.make_sharded_wbfm_fused(_cpu_mesh(dp, sp))
    got = chain.assemble(*WS.sharded_wbfm_apply(chain, blocks))
    exp = _serial([blocks])
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dp,sp", GEOMETRIES)
def test_carry_io_streams_across_blocks(two_blocks, dp, sp):
    """Two carry_io blocks = one serial stream over both, and = JAX's
    carry_io chain."""
    blocks, exp_jax = two_blocks[dp, sp]
    streamer = WSF.ShardedFusedStreamer(_cpu_mesh(dp, sp), 2 * dp)
    got = np.concatenate([streamer.demodulate(b) for b in blocks], axis=1)
    exp = _serial(blocks)
    assert got.shape == exp.shape == exp_jax.shape
    np.testing.assert_allclose(got, exp, rtol=1e-4, atol=1e-5)
    snr = _snr_db(exp_jax, got)
    assert snr >= 100.0, f"({dp}, {sp}) vs JAX carry_io: {snr:.1f} dB"
    assert streamer.states.shape == (2 * dp, FF.STATE_ROWS, FF.LANES)
    assert streamer.resamp_hists.shape == (2 * dp, 47)


def test_streamer_hand_over_with_jax(two_blocks):
    """A JAX ShardedPallasStreamer stopped after block 1 continues in the
    port, and the port's stopped after block 1 continues in JAX: block 2
    agrees with the uninterrupted other side at >= 100 dB."""
    dp, sp = 2, 2
    blocks, _ = two_blocks[dp, sp]
    stations = 2 * dp
    jmesh_ = jmesh.make_mesh(dp=dp, sp=sp)
    pmesh = _cpu_mesh(dp, sp)

    jax_s = ShardedPallasStreamer(jmesh_, stations, JCONFIG,
                                  rot_impl="broadcast", interpret=True)
    jax_s.demodulate(blocks[0])
    port_s = convert.sharded_streamer_from_jax(jax_s, pmesh)
    exp = jax_s.demodulate(blocks[1])
    got = port_s.demodulate(blocks[1])
    assert got.shape == exp.shape
    assert _snr_db(exp, got) >= 100.0

    port_s = WSF.ShardedFusedStreamer(pmesh, stations)
    port_s.demodulate(blocks[0])
    jax_s = ShardedPallasStreamer(jmesh_, stations, JCONFIG,
                                  rot_impl="broadcast", interpret=True)
    jax_s.states, jax_s.resamp_hists = (
        jax.numpy.asarray(a) for a in convert.sharded_streamer_to_jax(port_s))
    exp = port_s.demodulate(blocks[1])
    got = jax_s.demodulate(blocks[1])
    assert got.shape == exp.shape
    assert _snr_db(exp, got) >= 100.0


def test_initial_carry_matches_jax():
    ke, rs = WSF.initial_carry(3, device=CPU)
    jke, jrs = j_initial_carry(3, JCONFIG)
    np.testing.assert_array_equal(ke.numpy(), np.asarray(jke))
    np.testing.assert_array_equal(rs.numpy(), np.asarray(jrs))
    assert pallas_fm.STATE_ROWS == FF.STATE_ROWS
