"""The halo record of a time shard (``parallel.shard_halo``) on the CPU:
its plain version against the end-of-shard carry of the previous form of
the chain (the JAX chain's formula on the last 128 samples) and against
K1's plain version's last T-1 discriminator outputs; the fused sharded
row making one record build and one halo exchange a row; the streamer
staying eager off the card; ``time_cuts`` and ``shard_time``.
The record kernel itself is held to this plain version on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from tpu_sdr.utils import synth
from tpu_sdr_torch.ops import fused_fm as FF
from tpu_sdr_torch.parallel import cuda_halo as CH
from tpu_sdr_torch.parallel import mesh as M
from tpu_sdr_torch.parallel import shard_halo as SH
from tpu_sdr_torch.parallel import wbfm_sharded as WS
from tpu_sdr_torch.parallel import wbfm_sharded_fused as WSF
from tpu_sdr_torch.utils import design
from tpu_sdr_torch.utils.design import WbfmConfig

torch.set_num_threads(1)

CPU = torch.device("cpu")
SPEC = FF.default_spec()
CHUNK_C = SPEC.chunk_complex
T = SPEC.taps_per_phase


@pytest.fixture(scope="module")
def params():
    return SH.make_params(device=CPU)


def _shard(stations, n_complex, seed):
    """(stations, 2 n) u8: station 0 a synthetic capture, the others
    random bytes."""
    rng = np.random.default_rng(seed)
    rows = [np.asarray(synth.synth_wbfm_u8(n_complex, capture_rate=1_020_000,
                                           seed=seed)[0], np.uint8)]
    rows += [rng.integers(0, 256, 2 * n_complex, dtype=np.uint8)
             for _ in range(stations - 1)]
    return torch.from_numpy(np.stack(rows))


def test_record_geometry(params):
    assert (params.tail, params.record) == (360, 560)
    assert params.matrix.shape == (720, SH.END + 2 * T)
    # the tail reaches the first sample of the T-th last decimated window
    assert params.tail >= SPEC.decim * T + SPEC.num_taps - 1
    assert params.tail % 4 == 0 and (params.record * 4) % 16 == 0


@pytest.mark.parametrize("stations", [1, 3])
def test_record_carry_equals_the_end_state(params, stations):
    """Floats 0-511 are the end-of-shard carry of the 128-sample form:
    rows 0/1 bit-equal, rows 2/3 (lane 127 the design-tap dot / 255)
    within f32 rounding."""
    x = _shard(stations, CHUNK_C, seed=stations)
    (rec,) = SH.shard_halo([x], {CPU: params})
    assert rec.shape == (stations, params.record)
    A, div = SH.end_state_matrix(design.decimator_taps(WbfmConfig()),
                                 SPEC.decim, 128)
    tail = x[:, -256:].to(torch.float32) * 2.0 - 255.0
    old = tail @ torch.from_numpy(A) / torch.from_numpy(div)
    assert torch.equal(rec[:, :256], old[:, :256])
    torch.testing.assert_close(rec[:, 256:SH.END], old[:, 256:], rtol=1e-6,
                               atol=0.0)
    carry = rec[:, :SH.END].reshape(stations, FF.STATE_ROWS, FF.LANES)
    assert torch.count_nonzero(carry[:, 2:, :-1]) == 0


@pytest.mark.parametrize("stations", [1, 3])
def test_record_tail_equals_fm_front_outputs(params, stations):
    """Floats 512-558 are K1's plain version's last T-1 outputs on the
    same shard (within 1e-5), whatever carry K1 started from; the padding
    is zero."""
    x = _shard(stations, 2 * CHUNK_C, seed=10 + stations)
    (rec,) = SH.shard_halo([x], {CPU: params})
    taps, _ = FF.make_kernel_params(device=CPU)
    for j in range(stations):
        z, _ = FF.fm_front_reference(x[j], 0, FF.init_carry(CPU), taps,
                                     SPEC.decim)
        tail = rec[j, SH.END:SH.END + T - 1]
        assert float((tail - z[-(T - 1):]).abs().max()) <= 1e-5
    assert torch.count_nonzero(rec[:, SH.END + T - 1:]) == 0


def test_records_of_a_row_are_per_shard(params):
    row = [_shard(2, CHUNK_C, seed=s) for s in range(3)]
    got = SH.shard_halo(row, {CPU: params})
    assert len(got) == 3
    for x, rec in zip(row, got):
        assert torch.equal(rec, SH.records_reference(x, params))


def test_shard_halo_rejects_bad_shards(params):
    x = _shard(1, CHUNK_C, seed=1)
    with pytest.raises(ValueError):
        SH.shard_halo([], {CPU: params})
    with pytest.raises(ValueError):  # shorter than the tail
        SH.shard_halo([x[:, :2 * 300]], {CPU: params})
    with pytest.raises(ValueError):  # not a whole number of 4-sample groups
        SH.shard_halo([x[:, :-2]], {CPU: params})
    with pytest.raises(ValueError):  # shards of different shapes
        SH.shard_halo([x, x[:, :-8]], {CPU: params})
    with pytest.raises(ValueError):  # not bytes
        SH.shard_halo([x.to(torch.int16)], {CPU: params})


def test_plain_records_launch_nothing(params):
    SH.reset_launch_counts()
    SH.shard_halo([_shard(1, CHUNK_C, seed=2)], {CPU: params})
    assert SH.LAUNCHES == {"shard_halo": 0}


@pytest.mark.parametrize("dp,sp", [(1, 4), (2, 2)])
def test_row_makes_one_record_build_and_one_exchange(monkeypatch, dp, sp):
    """Each row builds its records once and exchanges them once: the carry
    and the resampler halo travel together."""
    calls = {"halo": 0, "records": 0}
    pull, build = CH.pull_left_halo_cuda, SH.shard_halo

    def counted_pull(*a, **k):
        calls["halo"] += 1
        return pull(*a, **k)

    def counted_build(*a, **k):
        calls["records"] += 1
        return build(*a, **k)

    monkeypatch.setattr(CH, "pull_left_halo_cuda", counted_pull)
    monkeypatch.setattr(SH, "shard_halo", counted_build)
    mesh = M.make_mesh(dp, sp, devices=[CPU] * (dp * sp))
    chain = WSF.make_sharded_wbfm_fused(mesh, carry_io=True)
    blocks = np.concatenate([_shard(dp, CHUNK_C, seed=s).numpy()
                             for s in range(sp)], axis=1)
    ke, rs = WSF.initial_carry(dp, device=CPU)
    audio, counts, ke, rs = WS.sharded_wbfm_apply(chain, blocks, ke, rs)
    assert calls == {"halo": dp, "records": dp}
    assert ke.shape == (dp, FF.STATE_ROWS, FF.LANES)
    assert rs.shape == (dp, T - 1)


def test_cpu_streamer_stays_eager():
    mesh = M.make_mesh(1, 2, devices=[CPU] * 2)
    streamer = WSF.ShardedFusedStreamer(mesh, 1)
    assert not streamer.graphed
    streamer.demodulate(np.concatenate(
        [_shard(1, CHUNK_C, seed=s).numpy() for s in range(2)], axis=1))
    assert streamer.step_graph is None


def test_time_cuts_are_views_that_shard_time_places():
    mesh = M.make_mesh(2, 2, devices=[CPU] * 4)
    block = np.random.default_rng(3).integers(0, 256, (4, 64),
                                              dtype=np.uint8)
    cuts = M.time_cuts(mesh, block)
    shards = M.shard_time(mesh, block)
    for d in range(2):
        for s in range(2):
            part = block[2 * d:2 * d + 2, 32 * s:32 * s + 32]
            assert np.shares_memory(cuts[d][s], block)
            np.testing.assert_array_equal(cuts[d][s], part)
            np.testing.assert_array_equal(shards[d][s].numpy(), part)
    with pytest.raises(ValueError):
        M.time_cuts(mesh, block[:3])
