"""The three sharded functions of the port run through ``utils.graphs`` on
the CPU, on meshes of logical shards ``[cpu] * n``.

A mesh whose shards all sit on one place runs the sharded float chain's
``fn``, the time-sharded channelizer and the channel-parallel K3 bank as
one step of ``utils.graphs`` in its device-output form: on a card one CUDA
graph replay a call, on the CPU the same step eagerly on the same static
buffers.  Here each function over two calls (another input the second
time, so the second call replays the first one's key) must give the bits
of ``graphs.disabled()``, match its JAX twin at the bar
``tests/test_torch_parallel.py`` holds it to (shapes from that file), and
hand out tensors of its own: an output kept from the first call is
unchanged by the second.  The twins on the card are in
``tests/test_torch_cuda.py``.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_sdr.models import wbfm as JW
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
from tpu_sdr_torch.parallel import mesh as M
from tpu_sdr_torch.parallel import wbfm_sharded as WS
from tpu_sdr_torch.utils import graphs
from tpu_sdr_torch.utils.design import WbfmConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
ALIGNED_LOC = 2040 * 12  # complex per shard: % 24 == 0 and /6 % 85 == 0
PFB_K, PFB_T, PFB_C = 64, 8, 64
TOL = 2e-4   # the float chain's bar against JAX
CH_TOL = 2e-3  # the time-sharded channelizer's
PFB_TOL = 1e-5  # the K3 bank's


def _cpu_mesh(dp, sp):
    return M.make_mesh(dp, sp, devices=[CPU] * (dp * sp))


def _stations(stations, n_complex, seed=0):
    return np.stack([np.asarray(synth.synth_wbfm_u8(
        n_complex, capture_rate=1_020_000, audio_freq=500.0 * (i + 1),
        seed=seed + i, noise_std=0.01)[0], np.uint8)
        for i in range(stations)])


def _flat(tensors):
    """The tensors of a nested result (lists, tuples), in order."""
    if torch.is_tensor(tensors):
        return [tensors]
    if isinstance(tensors, (list, tuple)):
        return [t for x in tensors for t in _flat(x)]
    return []


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert len(fa) == len(fb) > 0
    for x, y in zip(fa, fb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def _two_calls(call, inputs):
    """``call`` over the inputs, graphed and under ``graphs.disabled()``:
    bit-equal, and the first result (copied before the second call)
    unchanged after it."""
    got, kept = [], None
    for x in inputs:
        got.append(call(*x))
        if kept is None:
            kept = [t.clone() for t in _flat(got[0])]
    for t, k in zip(_flat(got[0]), kept):
        assert torch.equal(t, k), "an output changed under a later call"
    with graphs.disabled():
        off = [call(*x) for x in inputs]
    for g, o in zip(got, off):
        _same(g, o)
    return got


@pytest.mark.parametrize("mode,dp,sp,n_loc", [
    ("fir", 2, 4, 6 * 8192), ("fir", 1, 8, ALIGNED_LOC),
    ("boxcar", 2, 4, 6 * 8192), ("boxcar", 1, 8, ALIGNED_LOC)])
def test_float_chain_graphed_equals_disabled_and_jax(mode, dp, sp, n_loc):
    blocks = [_stations(dp, sp * n_loc, seed=s) for s in (0, 5)]
    chain = WS.make_sharded_wbfm(_cpu_mesh(dp, sp),
                                 WbfmConfig(filter_mode=mode))
    got = _two_calls(lambda b: chain.fn(chain.shard(b)),
                     [(b,) for b in blocks])
    assert (chain.graphs.captures, chain.graphs.replays) == (1, 1)
    jchain = j_make_sharded_wbfm(jmesh.make_mesh(dp=dp, sp=sp),
                                 JW.WbfmConfig(filter_mode=mode))
    for b, (audio, counts) in zip(blocks, got):
        exp = jchain.assemble(*jchain(jax.device_put(b, jchain.in_sharding)))
        g = chain.assemble(audio, counts)
        assert g.shape == exp.shape
        np.testing.assert_allclose(g, exp, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dp,sp", [(1, 8), (2, 4)])
def test_float_chain_carry_io_graphed_equals_disabled_and_jax(dp, sp):
    """Three streamed blocks: the new carry comes back as a tensor of its
    own, goes in again, and the stream stays JAX's."""
    rng = np.random.default_rng(23)
    blocks = [rng.integers(0, 256, (dp, 2 * ALIGNED_LOC * sp),
                           dtype=np.uint8) for _ in range(3)]
    chain = WS.make_sharded_wbfm(_cpu_mesh(dp, sp), WbfmConfig(),
                                 carry_io=True)

    def stream():
        carry, out = WS.initial_xla_carry(dp, device=CPU), []
        for b in blocks:
            audio, counts, carry = chain.fn(chain.shard(b), carry)
            out.append((audio, counts, carry))
        return out

    got = stream()
    kept = [t.clone() for t in _flat(got[0])]
    assert all(torch.equal(t, k) for t, k in zip(_flat(got[0]), kept))
    with graphs.disabled():
        off = stream()
    for g, o in zip(got, off):
        _same(g, o)
    assert (chain.graphs.captures, chain.graphs.replays) == (1, 2)
    jchain = j_make_sharded_wbfm(jmesh.make_mesh(dp=dp, sp=sp),
                                 JW.WbfmConfig(filter_mode="fir"),
                                 carry_io=True)
    jcarry = j_initial_xla_carry(dp)
    for b, (audio, counts, carry) in zip(blocks, got):
        a, c, jcarry = jchain.fn(jax.device_put(b, jchain.in_sharding),
                                 jcarry)
        np.testing.assert_allclose(chain.assemble(audio, counts),
                                   jchain.assemble(a, c), rtol=TOL, atol=TOL)
        for g, e in zip(convert.xla_carry_to_jax(carry), jcarry):
            np.testing.assert_allclose(g, np.asarray(e), rtol=TOL, atol=TOL)


def test_time_sharded_channelizer_graphed_equals_disabled_and_jax():
    K, T, sp = 32, 6, 8
    n = K * 64 * sp
    t = np.arange(n)
    inputs = []
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        x = sum(np.exp(2j * np.pi * ((k + 0.05 * (seed + 1)) / K) * t)
                for k in (2, 9, 20))
        x = x + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        inputs.append((x.real.astype(np.float32), x.imag.astype(np.float32)))
    chan = CS.make_sharded_channelizer(_cpu_mesh(1, sp), K, taps_per_branch=T)
    got = _two_calls(chan, inputs)
    assert (chan.graphs.captures, chan.graphs.replays) == (1, 1)
    jchan = j_make_channelizer(jmesh.make_mesh(dp=1, sp=sp), K,
                               taps_per_branch=T)
    for (re, im), g in zip(inputs, got):
        exp = np.asarray(jchan(re, im))
        assert g.shape == exp.shape == (K, n // K)
        np.testing.assert_allclose(g.numpy(), exp, rtol=CH_TOL, atol=CH_TOL)


@pytest.mark.parametrize("n_dev", [4, 8])
def test_channel_parallel_bank_graphed_equals_disabled_and_jax(n_dev):
    """Two chunks streamed through the bank, the second from the first's
    carry (a tensor of its own, passed back in)."""
    rng = np.random.default_rng(3)
    pbank = CSF.make_sharded_pfb_fused(_cpu_mesh(1, n_dev), PFB_K, PFB_T,
                                       PFB_C)
    half = pbank.spec.chunk_bytes
    capture = rng.integers(0, 256, size=2 * half, dtype=np.uint8)

    def stream():
        first = CSF.sharded_pfb_fused_apply(pbank, capture[:half])
        kept = [t.clone() for t in first]
        second = CSF.sharded_pfb_fused_apply(pbank, capture[half:], first[2])
        assert all(torch.equal(t, k) for t, k in zip(first, kept))
        return [first, second]

    got = stream()
    with graphs.disabled():
        off = stream()
    for g, o in zip(got, off):
        _same(g, o)
    assert (pbank.graphs.captures, pbank.graphs.replays) == (1, 1)
    bank = make_sharded_pfb_pallas(jmesh.make_mesh(dp=1, sp=n_dev), PFB_K,
                                   PFB_T, PFB_C, interpret=True)
    e_re, e_im, e_carry = sharded_pfb_pallas_apply(bank, capture[:half])
    e2_re, e2_im, e2_carry = sharded_pfb_pallas_apply(bank, capture[half:],
                                                      e_carry)
    for (g_re, g_im, g_carry), (x_re, x_im, x_carry) in zip(
            got, [(e_re, e_im, e_carry), (e2_re, e2_im, e2_carry)]):
        np.testing.assert_allclose(g_re.numpy(), np.asarray(x_re),
                                   rtol=PFB_TOL, atol=PFB_TOL)
        np.testing.assert_allclose(g_im.numpy(), np.asarray(x_im),
                                   rtol=PFB_TOL, atol=PFB_TOL)
        np.testing.assert_array_equal(g_carry.numpy(), np.asarray(x_carry))


def test_a_mesh_over_several_places_runs_eagerly():
    """Only a mesh on one place is graphed: a multi-process mesh (a row
    a process) keeps the eager functions."""
    mesh = M.Mesh(np.array([[CPU, CPU]], dtype=object), process_row=0)
    assert not mesh.single_place and _cpu_mesh(2, 4).single_place
    assert WS.make_sharded_wbfm(mesh, WbfmConfig()).graphs is None
    assert CS.make_sharded_channelizer(mesh, 32, 6).graphs is None
