"""tpu_sdr_torch.parallel against tpu_sdr.parallel on the 8-device virtual
CPU mesh of the JAX tests (tests/conftest.py), with port meshes of
``[cpu] * n``.

The plain halo exchange and ring shift (the plain versions of K4 and K5)
are held to ``lax.ppermute`` exactly, the ring all-to-all to
``lax.all_to_all``; the sharded float chain to JAX's
``make_sharded_wbfm`` at the bar of tests/test_sharded.py; both sharded
channelizers to their JAX twins.  The fused sharded chain (K1, K2 and the
K4 exchange) is in tests/test_torch_sharded.py, the CUDA kernels against
their plain versions in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from tpu_sdr.models import wbfm as JW
from tpu_sdr.ops import pallas_channelizer as jpc
from tpu_sdr.parallel import halo as jhalo
from tpu_sdr.parallel import mesh as jmesh
from tpu_sdr.parallel.channelizer_sharded import (
    make_sharded_channelizer as j_make_channelizer)
from tpu_sdr.parallel.channelizer_sharded_pallas import (
    make_sharded_pfb_pallas, sharded_pfb_pallas_apply)
from tpu_sdr.parallel.wbfm_sharded import (
    initial_xla_carry as j_initial_xla_carry,
    make_sharded_wbfm as j_make_sharded_wbfm)
from tpu_sdr.utils import synth
from tpu_sdr_torch import convert
from tpu_sdr_torch.parallel import channelizer_sharded as CS
from tpu_sdr_torch.parallel import channelizer_sharded_fused as CSF
from tpu_sdr_torch.parallel import cuda_halo as CH
from tpu_sdr_torch.parallel import halo as H
from tpu_sdr_torch.parallel import mesh as M
from tpu_sdr_torch.parallel import wbfm_sharded as WS
from tpu_sdr_torch.parallel import wbfm_sharded_fused as WSF
from tpu_sdr_torch.utils.design import WbfmConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
N_LOC = 32  # entries per shard in the exchange tests
ALIGNED_LOC = 2040 * 12  # complex per shard: % 24 == 0 and /6 % 85 == 0


def _cpu_mesh(dp, sp):
    return M.make_mesh(dp, sp, devices=[CPU] * (dp * sp))


def _jax_row(fn, n_dev, x):
    mesh = jmesh.make_mesh(dp=1, sp=n_dev)
    out = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P("sp"),
                                out_specs=P("sp")))(jnp.asarray(x))
    return np.asarray(out)


def _port_row(n_dev, x):
    return [torch.from_numpy(p.copy()) for p in np.split(x, n_dev)]


# ---- the mesh ------------------------------------------------------------

def test_mesh_places_may_repeat():
    m = _cpu_mesh(2, 4)
    assert m.shape == {"dp": 2, "sp": 4}
    assert m.axis_names == ("dp", "sp")
    assert not m.is_cuda and m.home == CPU and m.local_rows() == [0, 1]
    assert M.make_mesh(2, devices=[CPU] * 8).shape == {"dp": 2, "sp": 4}
    with pytest.raises(ValueError):
        M.make_mesh(2, 8, devices=[CPU] * 8)


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh(1, 4, devices=[torch.device("cuda", 0)] * 4)


def test_shard_time_and_assemble_round_trip():
    m = _cpu_mesh(2, 4)
    blocks = np.arange(4 * 24, dtype=np.int16).reshape(4, 24)
    shards = M.shard_time(m, blocks)
    np.testing.assert_array_equal(shards[1][2].numpy(), blocks[2:, 12:18])
    chain = WS.ShardedWbfm(mesh=m, config=WbfmConfig(), fn=None)
    audio = [[s.float() for s in row] for row in shards]
    np.testing.assert_array_equal(chain.assemble(audio, [6, 5, 6, 4]),
                                  np.concatenate([blocks[:, 0:6],
                                                  blocks[:, 6:11],
                                                  blocks[:, 12:18],
                                                  blocks[:, 18:22]], axis=1))


# ---- the plain exchange against ppermute --------------------------------

@pytest.mark.parametrize("with_edge", [False, True])
@pytest.mark.parametrize("halo", [3, 4, 8])
def test_pull_left_halo_matches_jax(halo, with_edge):
    n_dev = 8
    x = np.arange(n_dev * N_LOC, dtype=np.float32) * 0.5 - 7.0
    edge = np.linspace(-3.0, 3.0, halo).astype(np.float32) if with_edge \
        else None
    exp = _jax_row(lambda xs: jhalo.pull_left_halo(
        xs, halo, "sp", None if edge is None else jnp.asarray(edge)),
        n_dev, x).reshape(n_dev, halo)
    got = H.pull_left_halo(_port_row(n_dev, x), halo,
                           None if edge is None else torch.from_numpy(edge))
    np.testing.assert_array_equal(torch.stack(got).numpy(), exp)


def test_push_right_edge_matches_jax():
    n_dev = 8
    x = np.arange(n_dev * 2, dtype=np.float32) + 1.0
    exp = _jax_row(lambda xs: jhalo.push_right_edge(xs, "sp"), n_dev, x)
    got = H.push_right_edge(_port_row(n_dev, x))
    np.testing.assert_array_equal(torch.cat(got).numpy(), exp)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_ring_shift_matches_ppermute(n_dev):
    x = np.arange(n_dev * N_LOC, dtype=np.float32) - 11.0
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    exp = _jax_row(lambda xs: lax.ppermute(xs, "sp", perm), n_dev, x)
    row = _port_row(n_dev, x)
    got = H.ring_shift(row)
    np.testing.assert_array_equal(torch.cat(got).numpy(), exp)
    assert all(g.data_ptr() != r.data_ptr() for g, r in zip(got, row))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_all_to_all_matches_jax(n_dev):
    """The ring all-to-all (K5's wrapper, the plain ring on the CPU)
    against ``lax.all_to_all`` along axis 0."""
    x = np.arange(n_dev * n_dev * 3, dtype=np.float32) - 5.0
    exp = _jax_row(lambda xs: lax.all_to_all(xs.reshape(n_dev, 3), "sp", 0,
                                             0, tiled=True).reshape(-1),
                   n_dev, x)
    before = dict(CH.LAUNCHES)
    got = CH.all_to_all([r.reshape(n_dev, 3) for r in _port_row(n_dev, x)])
    np.testing.assert_array_equal(
        torch.cat([torch.stack(g).reshape(-1) for g in got]).numpy(), exp)
    assert CH.LAUNCHES == before


@pytest.mark.parametrize("force_kernel", [False, True])
def test_cuda_wrappers_take_the_plain_versions_on_cpu(force_kernel):
    row = [torch.arange(s * 10, s * 10 + 10, dtype=torch.int32)
           for s in range(3)]
    edge = torch.tensor([-1, -2], dtype=torch.int32)
    before = dict(CH.LAUNCHES)
    got = CH.pull_left_halo_cuda(row, 2, edge, force_kernel=force_kernel)
    for g, e in zip(got, H.pull_left_halo(row, 2, edge)):
        assert torch.equal(g, e)
    for g, e in zip(CH.ring_shift_cuda(row), H.ring_shift(row)):
        assert torch.equal(g, e)
    assert CH.LAUNCHES == before


def test_pull_left_halo_rejects_a_short_shard():
    with pytest.raises(ValueError):
        H.pull_left_halo([torch.zeros(4), torch.zeros(2)], 3)


# ---- the sharded float chain against JAX's ------------------------------

def _stations(stations, n_complex):
    return np.stack([np.asarray(synth.synth_wbfm_u8(
        n_complex, capture_rate=1_020_000, audio_freq=500.0 * (i + 1),
        seed=i, noise_std=0.01)[0], np.uint8) for i in range(stations)])


def _jax_float_chain(dp, sp, blocks, **kw):
    chain = j_make_sharded_wbfm(jmesh.make_mesh(dp=dp, sp=sp),
                                JW.WbfmConfig(filter_mode="fir"), **kw)
    return chain, jax.device_put(blocks, chain.in_sharding)


@pytest.mark.parametrize("dp,sp,n_loc", [(1, 8, 6 * 4096), (2, 4, 6 * 8192),
                                         (1, 8, ALIGNED_LOC)])
def test_sharded_float_chain_matches_jax(dp, sp, n_loc):
    """Unaligned shards (the global-phase polyphase resampler) and aligned
    ones (the frame matmul with the pulled halo as history)."""
    blocks = _stations(dp, sp * n_loc)
    jchain, x = _jax_float_chain(dp, sp, blocks)
    exp = jchain.assemble(*jchain(x))
    chain = WS.make_sharded_wbfm(_cpu_mesh(dp, sp), WbfmConfig())
    audio, counts = WS.sharded_wbfm_apply(chain, blocks)
    got = chain.assemble(audio, counts)
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dp,sp", [(1, 8), (2, 4)])
def test_sharded_float_chain_carry_io_matches_jax(dp, sp):
    rng = np.random.default_rng(23)
    blocks = [rng.integers(0, 256, (dp, 2 * ALIGNED_LOC * sp),
                           dtype=np.uint8) for _ in range(2)]
    jchain = j_make_sharded_wbfm(jmesh.make_mesh(dp=dp, sp=sp),
                                 JW.WbfmConfig(filter_mode="fir"),
                                 carry_io=True)
    jcarry = j_initial_xla_carry(dp)
    chain = WS.make_sharded_wbfm(_cpu_mesh(dp, sp), WbfmConfig(),
                                 carry_io=True)
    carry = WS.initial_xla_carry(dp, device=CPU)
    got, exp = [], []
    for b in blocks:
        a, c, jcarry = jchain.fn(jax.device_put(b, jchain.in_sharding),
                                 jcarry)
        exp.append(jchain.assemble(a, c))
        a, c, carry = WS.sharded_wbfm_apply(chain, b, carry)
        got.append(chain.assemble(a, c))
    got, exp = np.concatenate(got, axis=1), np.concatenate(exp, axis=1)
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-4)
    for g, e in zip(convert.xla_carry_to_jax(carry), jcarry):
        np.testing.assert_allclose(g, np.asarray(e), rtol=2e-4, atol=2e-4)


def test_float_chain_carry_hand_over_from_jax():
    """JAX's sharded float chain streams block 1; its XlaStreamCarry,
    converted, continues the stream in the port on block 2."""
    dp, sp = 2, 4
    rng = np.random.default_rng(5)
    blocks = [rng.integers(0, 256, (dp, 2 * ALIGNED_LOC * sp),
                           dtype=np.uint8) for _ in range(2)]
    jchain = j_make_sharded_wbfm(jmesh.make_mesh(dp=dp, sp=sp),
                                 JW.WbfmConfig(filter_mode="fir"),
                                 carry_io=True)
    _, _, jcarry = jchain.fn(jax.device_put(blocks[0], jchain.in_sharding),
                             j_initial_xla_carry(dp))
    audio, counts, _ = jchain.fn(
        jax.device_put(blocks[1], jchain.in_sharding), jcarry)
    exp = jchain.assemble(audio, counts)
    chain = WS.make_sharded_wbfm(_cpu_mesh(dp, sp), WbfmConfig(),
                                 carry_io=True)
    audio, counts, _ = WS.sharded_wbfm_apply(
        chain, blocks[1], convert.xla_carry_from_jax(jcarry, device=CPU))
    got = chain.assemble(audio, counts)
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=2e-4, atol=2e-4)


def test_counts_partition_total():
    """Per-shard emission counts are JAX's and sum to the serial total:
    the closed-form ownership rule leaves no gaps or overlaps."""
    config = JW.WbfmConfig(filter_mode="fir")
    blocks = _stations(1, 8 * 6 * 4096)
    jchain, x = _jax_float_chain(1, 8, blocks)
    _, jcounts = jchain(x)
    chain = WS.make_sharded_wbfm(_cpu_mesh(1, 8), WbfmConfig())
    _, counts = WS.sharded_wbfm_apply(chain, blocks)
    np.testing.assert_array_equal(counts, np.asarray(jcounts))
    serial = JW.demodulate_block(jnp.asarray(blocks[0]),
                                 JW.init_state(config),
                                 JW.make_params(config), config)
    assert sum(counts) == int(serial[1])
    assert WS.expected_m_max(WbfmConfig(), 4096) == 4096 * 16 // 85 + 1


# ---- refusals ------------------------------------------------------------

def test_boxcar_and_bad_halo_modes_are_refused():
    """The float chain's sharded boxcar mode is ported and runs (against
    JAX in tests/test_torch_wbfm_modes.py), but not with carry_io, as in
    JAX; the fused chain, FIR-only like JAX's Pallas chain, refuses it."""
    boxcar = WbfmConfig(filter_mode="boxcar")
    chain = WS.make_sharded_wbfm(_cpu_mesh(1, 2), boxcar)
    audio, counts = WS.sharded_wbfm_apply(chain, _stations(1, 2 * 6 * 4096))
    assert chain.assemble(audio, counts).shape == (1, 2 * 6 * 4096 // 6 * 16
                                                   // 85)
    with pytest.raises(ValueError):
        WS.make_sharded_wbfm(_cpu_mesh(1, 2), boxcar, carry_io=True)
    with pytest.raises(NotImplementedError):
        WSF.make_sharded_wbfm_fused(_cpu_mesh(1, 2), boxcar)
    with pytest.raises(ValueError):  # a shard of a part of a kernel chunk
        WSF.make_sharded_wbfm_fused(_cpu_mesh(1, 2)).fn(
            M.shard_time(_cpu_mesh(1, 2), np.zeros((1, 130_560), np.uint8)))
    with pytest.raises(ValueError):  # an all-to-all needs a slice a shard
        CH.all_to_all([torch.zeros(3, 2)] * 2)
    chain = WSF.make_sharded_wbfm_fused(_cpu_mesh(1, 1), carry_io=True)
    with pytest.raises(ValueError):  # carry_io chain without its carry
        chain.fn(chain.shard(np.zeros((1, 130_560), np.uint8)))


# ---- the sharded channelizers against their JAX twins -------------------

def test_time_sharded_channelizer_matches_jax():
    K, T, sp = 32, 6, 8
    rng = np.random.default_rng(0)
    n = K * 64 * sp
    t = np.arange(n)
    x = sum(np.exp(2j * np.pi * ((k + 0.05) / K) * t) for k in (2, 9, 20))
    x = x + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    re, im = x.real.astype(np.float32), x.imag.astype(np.float32)
    exp = np.asarray(j_make_channelizer(jmesh.make_mesh(dp=1, sp=sp), K,
                                        taps_per_branch=T)(re, im))
    got = CS.make_sharded_channelizer(_cpu_mesh(1, sp), K,
                                      taps_per_branch=T)(re, im)
    assert got.shape == exp.shape == (K, n // K)
    np.testing.assert_allclose(got.numpy(), exp, rtol=2e-3, atol=2e-3)


PFB_K, PFB_T, PFB_C = 64, 8, 64


@pytest.fixture(scope="module")
def pfb_capture():
    rng = np.random.default_rng(3)
    spec = jpc.default_spec(PFB_K, PFB_T, PFB_C)
    return rng.integers(0, 256, size=2 * spec.chunk_bytes, dtype=np.uint8)


@pytest.mark.parametrize("n_dev", [4, 8])
def test_channel_parallel_channelizer_matches_jax(pfb_capture, n_dev):
    bank = make_sharded_pfb_pallas(jmesh.make_mesh(dp=1, sp=n_dev), PFB_K,
                                   PFB_T, PFB_C, interpret=True)
    e_re, e_im, e_carry = sharded_pfb_pallas_apply(bank, pfb_capture)
    pbank = CSF.make_sharded_pfb_fused(_cpu_mesh(1, n_dev), PFB_K, PFB_T,
                                       PFB_C)
    assert pbank.spec.out_channels == PFB_K // n_dev
    g_re, g_im, g_carry = CSF.sharded_pfb_fused_apply(pbank, pfb_capture)
    np.testing.assert_allclose(g_re.numpy(), np.asarray(e_re), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(g_im.numpy(), np.asarray(e_im), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(g_carry.numpy(), np.asarray(e_carry))


def test_channel_parallel_channelizer_carries_state(pfb_capture):
    bank = CSF.make_sharded_pfb_fused(_cpu_mesh(1, 4), PFB_K, PFB_T, PFB_C)
    half = bank.spec.chunk_bytes
    r1, _, carry = CSF.sharded_pfb_fused_apply(bank, pfb_capture[:half])
    r2, _, _ = CSF.sharded_pfb_fused_apply(bank, pfb_capture[half:], carry)
    full, _, _ = CSF.sharded_pfb_fused_apply(bank, pfb_capture)
    np.testing.assert_allclose(torch.cat([r1, r2]).numpy(), full.numpy(),
                               rtol=1e-5, atol=1e-5)
