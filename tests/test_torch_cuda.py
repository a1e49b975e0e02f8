"""tpu_sdr_torch's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a GPU.

This module imports no jax (the machine with the card has none), so on that
machine it runs without the repository's conftest, which sets JAX up:

    python3 -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import io
import sys

import numpy as np
import pytest
import torch

from tpu_sdr_torch.models import wbfm_wideband as WB
from tpu_sdr_torch.ops import fused_channelizer as FC
from tpu_sdr_torch.ops import fused_fm as FF
from tpu_sdr_torch.utils import design, synth

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

SPEC = FF.default_spec()
CHUNK = SPEC.chunk_bytes


def _snr_db(ref, got):
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    # the plain versions are the oracles: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def capture():
    u8, _ = synth.synth_wbfm_u8(CHUNK, capture_rate=1_020_000,
                                noise_std=0.02, seed=11)
    return np.asarray(u8, dtype=np.uint8)


def _mid_stream_carry(data, taps, dev):
    return FF.fm_front_reference(data[:CHUNK], 0, FF.init_carry(dev), taps,
                                 SPEC.decim)[1]


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_fm_front_kernel_matches_plain(capture, dev, phase):
    taps, _ = FF.make_kernel_params(device=dev)
    data = torch.from_numpy(capture).to(dev)
    carry = _mid_stream_carry(data, taps, dev)
    before = FF.LAUNCHES["fm_front"]
    z, c = FF.fm_front(data, phase, carry, taps, SPEC.decim)
    zr, cr = FF.fm_front_reference(data, phase, carry, taps, SPEC.decim)
    assert FF.LAUNCHES["fm_front"] == before + 1
    assert _snr_db(zr.cpu(), z.cpu()) >= 100.0
    torch.testing.assert_close(c, cr, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("m", [50, 1000])
def test_fm_front_kernel_ragged_calls(capture, dev, m):
    """Calls of m outputs: fewer than the carry's 128 lanes (rows 2/3 shift)
    and not a whole number of thread blocks (masked tail)."""
    taps, _ = FF.make_kernel_params(device=dev)
    data = torch.from_numpy(capture).to(dev)
    carry = _mid_stream_carry(data, taps, dev)
    block = data[CHUNK:CHUNK + 2 * SPEC.decim * m]
    z, c = FF.fm_front(block, 2, carry, taps, SPEC.decim)
    zr, cr = FF.fm_front_reference(block, 2, carry, taps, SPEC.decim)
    assert z.shape == (m,)
    assert _snr_db(zr.cpu(), z.cpu()) >= 100.0
    torch.testing.assert_close(c, cr, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("chunks", [1, 2, 192])
def test_fm_front_kernel_whole_chunks(dev, chunks):
    """1, 2 and 192 chunks (the 25 MB block: 2,040 stages of 1,024
    outputs on a persistent grid) of random bytes from a mid-stream carry."""
    rng = np.random.default_rng(chunks)
    taps, _ = FF.make_kernel_params(device=dev)
    data = torch.from_numpy(rng.integers(0, 256, chunks * CHUNK,
                                         dtype=np.uint8)).to(dev)
    carry = _mid_stream_carry(data, taps, dev)
    before = FF.LAUNCHES["fm_front"]
    z, c = FF.fm_front(data, 1, carry, taps, SPEC.decim)
    zr, cr = FF.fm_front_reference(data, 1, carry, taps, SPEC.decim)
    assert FF.LAUNCHES["fm_front"] == before + 1
    assert z.shape == (chunks * SPEC.chunk_complex // SPEC.decim,)
    assert _snr_db(zr.cpu(), z.cpu()) >= 100.0
    torch.testing.assert_close(c, cr, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("m,offset", [(4099, 0), (40_003, 2), (127, 6)])
def test_fm_front_kernel_unaligned_and_ragged(capture, dev, m, offset):
    """Outputs not a whole number of rows or stages, input 2 or 6 bytes off
    16-byte alignment (the scalar staging path), a history that is not
    x255 integers (the residual path)."""
    taps, _ = FF.make_kernel_params(device=dev)
    buf = torch.from_numpy(np.tile(capture, 2)).to(dev)
    block = buf[offset:offset + 2 * SPEC.decim * m]
    rng = np.random.default_rng(m)
    carry = FF.init_carry(dev)
    carry[:2] = torch.from_numpy(rng.uniform(-255, 255, (2, 128)).astype(
        np.float32)).to(dev)
    z, c = FF.fm_front(block, 3, carry, taps, SPEC.decim)
    zr, cr = FF.fm_front_reference(block, 3, carry, taps, SPEC.decim)
    assert _snr_db(zr.cpu(), z.cpu()) >= 100.0
    torch.testing.assert_close(c, cr, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("L,decim", [(40, 3), (129, 1), (33, 11), (72, 20)])
def test_fm_front_kernel_other_shapes(capture, dev, L, decim):
    """The generic form: band depths over 8 k-steps, other halos and row
    strides; taps that are sums of two bf16."""
    rng = np.random.default_rng(L)
    w = torch.from_numpy(rng.standard_normal(L).astype(np.float32)) / (L * 255)
    hi = w.to(torch.bfloat16).float()
    taps = (hi + (w - hi).to(torch.bfloat16).float()).to(dev)
    n = decim * 30_001
    data = torch.from_numpy(np.tile(capture, 5)[:2 * n]).to(dev)
    _, carry = FF.fm_front_reference(data[-2 * decim * 300:], 0,
                                     FF.init_carry(dev), taps, decim)
    z, c = FF.fm_front(data, 2, carry, taps, decim)
    zr, cr = FF.fm_front_reference(data, 2, carry, taps, decim)
    assert _snr_db(zr.cpu(), z.cpu()) >= 100.0
    torch.testing.assert_close(c, cr, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("frames", [1, 3, 256, 24_576])
def test_fm_resample_kernel_matches_plain(capture, dev, frames):
    taps, h_poly = FF.make_kernel_params(device=dev)
    z, _ = FF.fm_front_reference(torch.from_numpy(
        np.tile(capture, 96)).to(dev), 0, FF.init_carry(dev), taps,
        SPEC.decim)
    z = z[:frames * SPEC.down].contiguous()
    hist = torch.linspace(-0.5, 0.5, SPEC.taps_per_phase - 1, device=dev)
    before = FF.LAUNCHES["fm_resample"]
    a, h = FF.resample(z, hist, h_poly, SPEC.down)
    ar, hr = FF.resample_reference(z, hist, h_poly, SPEC.down)
    assert FF.LAUNCHES["fm_resample"] == before + 1
    assert a.shape == (frames * SPEC.up,)
    assert _snr_db(ar.cpu(), a.cpu()) >= 100.0
    assert torch.equal(h, hr)


@pytest.mark.parametrize("up,down,T,frames", [(16, 85, 48, 1), (3, 7, 5, 999),
                                              (2, 1, 48, 40)])
def test_fm_resample_kernel_offsets_and_shapes(dev, up, down, T, frames):
    """z and the audio 4 bytes off 16-byte alignment (the shifted staging
    and scalar stores), and other ratios (the generic form), including
    calls shorter than the history."""
    rng = np.random.default_rng(up)
    buf = torch.from_numpy(rng.standard_normal(frames * down + 1).astype(
        np.float32)).to(dev)
    z = buf[1:]
    hist = torch.from_numpy(rng.standard_normal(T - 1).astype(np.float32)
                            ).to(dev)
    h_poly = torch.from_numpy(rng.standard_normal((up, T)).astype(
        np.float32)).to(dev)
    out = torch.empty(frames * up + 1, device=dev)[1:]
    a, h = FF.resample(z, hist, h_poly, down, out=out)
    ar, hr = FF.resample_reference(z, hist, h_poly, down)
    assert a.data_ptr() == out.data_ptr()
    assert _snr_db(ar.cpu(), a.cpu()) >= 100.0
    assert torch.equal(h, hr)


def test_cuda_streamer_matches_cpu_streamer(capture, dev):
    def two(s):
        return np.concatenate([s.demodulate(capture[:CHUNK]),
                               s.demodulate(capture[CHUNK:])])

    gpu = two(FF.FusedWbfmStreamer(device=dev))
    cpu = two(FF.FusedWbfmStreamer(device="cpu"))
    assert _snr_db(cpu, gpu) >= 100.0


def test_wrappers_reject_bad_tensors(capture, dev):
    taps, h_poly = FF.make_kernel_params(device=dev)
    data = torch.from_numpy(capture).to(dev)
    carry = FF.init_carry(dev)
    with pytest.raises(TypeError):
        FF.fm_front(data, 0, carry.double(), taps, SPEC.decim)
    with pytest.raises(ValueError):  # carry on the CPU
        FF.fm_front(data, 0, carry.cpu(), taps, SPEC.decim)
    with pytest.raises(ValueError):  # not 2-byte aligned
        FF.fm_front(data[1:1 + 2 * 6 * 64], 0, carry, taps, SPEC.decim)
    with pytest.raises(ValueError):  # non-contiguous z
        FF.resample(torch.zeros(2 * 170, device=dev)[::2], torch.zeros(
            47, device=dev), h_poly, SPEC.down)


def test_cli_fused_mode_on_the_card(capture, dev, tmp_path):
    from tpu_sdr_torch.apps import simple_fm

    path = tmp_path / "cap.u8"
    np.tile(capture, 4).tofile(path)
    raw, saved = io.BytesIO(), sys.stdout
    sys.stdout = io.TextIOWrapper(raw, write_through=True)
    FF.reset_launch_counts()
    try:
        assert simple_fm.main(["--file", str(path), "--mode", "fused"]) == 0
    finally:
        sys.stdout.detach()
        sys.stdout = saved
    assert FF.LAUNCHES["fm_front"] > 0 and FF.LAUNCHES["fm_resample"] > 0
    pcm = np.frombuffer(raw.getvalue(), dtype="<i2")
    assert len(pcm) == 4 * 2 * SPEC.audio_per_chunk
    assert synth.tone_snr(pcm.astype(np.float64), 1_000.0, 32_000,
                          skip=1500) >= 30.0


# ---- K3: the PFB channelizer ------------------------------------------------

WB_SPEC = WB.fused_spec(WB.WidebandConfig())  # K=64, R=9, C=680


@pytest.mark.parametrize("channel_slice,local", [(None, None),
                                                 (slice(16, 32), 16)])
@pytest.mark.parametrize("chunks", [1, 3, 288])
def test_pfb_channelize_kernel_matches_plain(dev, chunks, channel_slice,
                                             local):
    rng = np.random.default_rng(chunks)
    spec = WB_SPEC._replace(local_channels=local)
    data = torch.from_numpy(rng.integers(
        0, 256, chunks * spec.chunk_bytes, dtype=np.uint8)).to(dev)
    # a mid-stream carry: 2H frames of x255 integers
    carry = torch.from_numpy((rng.integers(0, 256, (16, 64)) * 2 - 255)
                             .astype(np.float32)).to(dev)
    h = design.design_pfb(64, 8, cutoff_frac=0.95)
    m2 = FC.kernel_matrix(h, channel_slice).to(dev)
    c0 = channel_slice.start if channel_slice else 0
    before = FC.LAUNCHES["pfb_channelize"]
    y_re, y_im, c = FC.channelize(data, carry, FC.kernel_taps(h).to(dev),
                                  spec, channel_offset=c0)
    y, cr = FC.channelize_reference(data, carry, m2, spec)
    assert FC.LAUNCHES["pfb_channelize"] == before + 1
    assert y_re.shape == (chunks * spec.frames_per_chunk, spec.out_channels)
    got = torch.cat([y_re, y_im], dim=1)
    assert _snr_db(y.cpu(), got.cpu()) >= 100.0
    assert torch.equal(c, cr)


@pytest.mark.parametrize("frames", [3, 100])
def test_pfb_channelize_kernel_short_calls(dev, frames):
    """Calls of fewer frames than the carry's 8 rows (the carry shifts) and
    not a whole number of thread blocks (masked tail)."""
    rng = np.random.default_rng(frames)
    data = torch.from_numpy(rng.integers(0, 256, 2 * 64 * frames,
                                         dtype=np.uint8)).to(dev)
    carry = torch.from_numpy((rng.integers(0, 256, (16, 64)) * 2 - 255)
                             .astype(np.float32)).to(dev)
    h = design.design_pfb(64, 8, cutoff_frac=0.95)
    m2 = FC.kernel_matrix(h).to(dev)
    y_re, y_im, c = FC.channelize(data, carry, FC.kernel_taps(h).to(dev),
                                  WB_SPEC)
    y, cr = FC.channelize_reference(data, carry, m2, WB_SPEC)
    assert y_re.shape == (frames, 64)
    assert _snr_db(y.cpu(), torch.cat([y_re, y_im], dim=1).cpu()) >= 100.0
    assert torch.equal(c, cr)


@pytest.mark.parametrize("K,local,c0,frames,offset", [
    (64, 16, 48, 680, 0),       # the last 16-channel window
    (64, None, 0, 5_440, 0),    # the multi_fm CLI's 696,320-byte read
    (64, None, 0, 1, 0),        # one frame: the carry shifts by one
    (64, 16, 16, 8_459, 0),     # no whole number of 16-frame tiles
    (64, 14, 50, 4_000, 2),     # 2-byte aligned input, an unaligned window
    (32, None, 0, 1_000, 0),    # the direct-DFT path
    (32, 8, 8, 3, 0),
    (1024, None, 0, 5_440, 0),  # the 1024-channel bank's multi_fm read
    (1024, 256, 768, 680, 0)])  # its last 256 columns, one chunk
def test_pfb_channelize_kernel_windows_and_shapes(dev, K, local, c0, frames,
                                                  offset):
    """K3 at other column windows, frame counts, alignments and K, against
    its plain version (>=100 dB, carry equal) and the float64 PFB
    (>=130 dB)."""
    rng = np.random.default_rng(frames + K)
    spec = FC.PfbSpec(K, 9, 680, local)
    ko = spec.out_channels
    buf = rng.integers(0, 256, 2 * K * frames, dtype=np.uint8)
    carry_np = (rng.integers(0, 256, (16, K)) * 2 - 255).astype(np.float32)
    raw = torch.zeros(offset + buf.size, dtype=torch.uint8, device=dev)
    data = raw[offset:]
    data.copy_(torch.from_numpy(buf))
    carry = torch.from_numpy(carry_np).to(dev)
    h = design.design_pfb(K, 8, cutoff_frac=0.95)
    before = FC.LAUNCHES["pfb_channelize"]
    y_re, y_im, c = FC.channelize(data, carry, FC.kernel_taps(h).to(dev), spec,
                                  channel_offset=c0)
    y, cr = FC.channelize_reference(
        data, carry, FC.kernel_matrix(h, slice(c0, c0 + ko)).to(dev), spec)
    assert FC.LAUNCHES["pfb_channelize"] == before + 1
    assert y_re.shape == y_im.shape == (frames, ko)
    got = torch.cat([y_re, y_im], dim=1).cpu().numpy().astype(np.float64)
    assert _snr_db(y.cpu(), got) >= 100.0
    assert torch.equal(c, cr)
    # the exact PFB: FIR down the frames, DFT across the branches, / 255
    x = buf.astype(np.float64).reshape(-1, K, 2) * 2 - 255
    ext = np.concatenate([carry_np[:8] + 1j * carry_np[8:],
                          x[..., 0] + 1j * x[..., 1]])
    fir = sum(h[t].astype(np.float64) * ext[8 - t:8 - t + frames]
              for t in range(9))
    exact = np.fft.fft(fir, axis=1)[:, c0:c0 + ko] / 255.0
    assert _snr_db(np.concatenate([exact.real, exact.imag], axis=1),
                   got) >= 130.0


def test_pfb_channelize_rejects_bad_tensors(dev):
    taps = torch.zeros(9, 64, device=dev)
    carry = torch.zeros(16, 64, device=dev)
    data = torch.zeros(WB_SPEC.chunk_bytes + 2, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):  # carry on the CPU
        FC.channelize(data[:-2], carry.cpu(), taps, WB_SPEC)
    with pytest.raises(ValueError):  # not 2-byte aligned
        FC.channelize(data[1:-1], carry, taps, WB_SPEC)
    with pytest.raises(ValueError):  # a tap table of the wrong width
        FC.channelize(data[:-2], carry, taps[:, :32].contiguous(), WB_SPEC)
    with pytest.raises(ValueError):  # channels beyond K
        FC.channelize(data[:-2], carry, taps, WB_SPEC._replace(
            local_channels=16), channel_offset=56)


@pytest.fixture(scope="module")
def wideband_capture():
    u8, _ = synth.synth_multistation_u8(
        348_160, 10_880_000, station_freqs=[3 * 170e3, -4 * 170e3],
        audio_freqs=[1_000.0, 2_500.0], deviation=45_000.0)
    return np.asarray(u8, dtype=np.uint8)


def test_cuda_wideband_streamer_matches_plain(wideband_capture, dev):
    config = WB.WidebandConfig(channels=(3, 60))
    FC.reset_launch_counts()
    gpu = WB.WidebandStreamer(config, use_fused=True, device=dev)
    fused = np.concatenate([gpu.demodulate(wideband_capture[:87_040 * 3]),
                            gpu.demodulate(wideband_capture[87_040 * 3:])],
                           axis=1)
    assert FC.LAUNCHES["pfb_channelize"] == 2
    cpu = WB.WidebandStreamer(config, use_fused=True, device="cpu")
    assert _snr_db(cpu.demodulate(wideband_capture), fused) >= 100.0
    plain = WB.WidebandStreamer(config, device=dev).demodulate(wideband_capture)
    assert _snr_db(plain, fused) >= 70.0
    assert synth.tone_snr(fused[0], 1_000.0, 32_000, skip=400) >= 25.0


def test_cuda_wideband_streamer_at_1024_channels(dev):
    """The 1024-channel bank on the card with every channel demodulated,
    fed multi_fm's 11,141,120-byte reads of a capture with a station in
    each channel (``sdrbench``'s ``wbfm_bank1024``): K3's direct path, the
    tail at 1,024 stations, one graph replay a read; every station's s16
    within the configuration's limits of the float64 reference
    (``sdrbench/reference/dsp.py``)."""
    import json
    import os

    from sdrbench import capture
    from sdrbench.reference import dsp
    from tpu_sdr_torch.native import f32_to_s16

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "sdrbench", "configs",
                           "wbfm_bank1024.json")) as f:
        cfg = json.load(f)
    read = 64 * 1024 * 85 * 2
    plan = capture.plan(cfg, {"read_bytes": read, "ring_reads": 2,
                              "rds": False, "tones": 3,
                              "audio_hz": [50, 15000], "deviation_hz": 75000,
                              "noise_std": 0.004}, 2**31 + 23)
    ring = capture.synthesize(plan, dev).cpu().numpy()
    config = WB.WidebandConfig(num_channels=1024, channels=tuple(range(1024)))
    assert cfg["channels"] == list(config.channels)
    FC.reset_launch_counts()
    streamer = WB.WidebandStreamer(config, use_fused=True, device=dev)
    reads = [streamer.demodulate(ring[i * read:(i + 1) * read])
             for i in range(2)]
    assert FC.LAUNCHES["pfb_channelize"] == 2
    assert streamer.graphs.captures == 1 and streamer.graphs.replays == 1
    assert reads[0].shape == (1024, 1024)
    pcm = np.stack([np.concatenate([f32_to_s16(r[s]) for r in reads])
                    for s in range(1024)]).astype(np.int64)
    ref = dsp.audio_s16(cfg, ring, 0, device=dev).astype(np.int64)
    assert pcm.shape == ref.shape
    d = pcm - ref
    assert np.abs(d).max() <= cfg["limits"]["audio_gap_lsb"]
    assert np.sqrt((d * d).mean(axis=1)).max() <= cfg["limits"]["audio_rms_lsb"]


# ---- K4 and K5: the halo exchange and the ring shift ----------------------

def _row(dev, n, dtype, numel=1000, seed=0):
    """n shards of ``numel`` entries: f32 (400, ...) rows or raw bytes."""
    rng = np.random.default_rng(seed + n)
    if dtype == torch.uint8:
        data = rng.integers(0, 256, (n, numel), dtype=np.uint8)
    else:
        data = rng.standard_normal((n, numel // 4, 4)).astype(np.float32)
    return [torch.from_numpy(d).to(dev) for d in data]


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("with_edge", [False, True])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_halo_pull_kernel_matches_plain(dev, n, with_edge, dtype):
    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.parallel import halo as H

    row = _row(dev, n, dtype)
    halo = 3 if dtype == torch.uint8 else 7
    edge = (_row(dev, 1, dtype, seed=5)[0][:halo].contiguous() if with_edge
            else None)
    before = CH.LAUNCHES["halo_pull"]
    got = CH.pull_left_halo_cuda(row, halo, edge, force_kernel=True)
    exp = H.pull_left_halo(row, halo, edge)
    torch.cuda.synchronize()
    assert CH.LAUNCHES["halo_pull"] == before + 1
    for g, e in zip(got, exp):
        assert g.dtype == dtype and torch.equal(g, e)
    if n == 1:  # without force_kernel the one-shard exchange is vacuous
        (vac,) = CH.pull_left_halo_cuda(row, halo, edge)
        assert CH.LAUNCHES["halo_pull"] == before + 1
        assert torch.equal(vac, exp[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_ring_shift_kernel_matches_plain(dev, n, dtype):
    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.parallel import halo as H

    row = _row(dev, n, dtype, numel=(1 << 20) + 12)  # a ragged 1 MB tail
    before = CH.LAUNCHES["ring_shift"]
    got = CH.ring_shift_cuda(row)
    exp = H.ring_shift(row)
    torch.cuda.synchronize()
    assert CH.LAUNCHES["ring_shift"] == before + 1
    for g, e, x in zip(got, exp, row):
        assert torch.equal(g, e) and g.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_all_to_all_on_the_card_matches_plain(dev, n):
    """The ring all-to-all: n - 1 launches of K5, equal to the plain ring's
    result on the CPU."""
    from tpu_sdr_torch.parallel import cuda_halo as CH

    row = [torch.from_numpy(r).reshape(n, 2, 5, 3) for r in
           np.random.default_rng(n).standard_normal(
               (n, n * 30)).astype(np.float32)]
    before = CH.LAUNCHES["ring_shift"]
    got = CH.all_to_all([r.to(dev) for r in row])
    assert CH.LAUNCHES["ring_shift"] == before + n - 1
    for g, e in zip(got, CH.all_to_all(row)):
        assert all(a.device == dev and torch.equal(a.cpu(), b)
                   for a, b in zip(g, e))


def test_sharded_channelizers_on_the_card(dev):
    """The time-sharded channelizer (K4 frame halo, K5 all-to-all) and the
    channel-parallel one (K3 a channel block) on logical shards of one
    card, each against the same chain on CPU shards."""
    from tpu_sdr_torch.parallel import channelizer_sharded as CS
    from tpu_sdr_torch.parallel import channelizer_sharded_fused as CSF
    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.parallel import mesh as PM

    K, T, sp = 32, 6, 4
    rng = np.random.default_rng(6)
    t = np.arange(K * 64 * sp)
    z = sum(np.exp(2j * np.pi * (k + 0.05) / K * t) for k in range(K))
    z = z + 0.05 * (rng.standard_normal(t.size) + 1j * rng.standard_normal(
        t.size))
    x = z.real.astype(np.float32), z.imag.astype(np.float32)
    u8 = rng.integers(0, 256, 2 * 64 * 64 * 2, dtype=np.uint8)
    outs = {}
    for d in (dev, torch.device("cpu")):
        mesh = PM.make_mesh(1, sp, devices=[d] * sp)
        CH.reset_launch_counts()
        FC.reset_launch_counts()
        demod = CS.make_sharded_channelizer(mesh, K, taps_per_branch=T)(*x)
        bank = CSF.make_sharded_pfb_fused(mesh, 64, 8, 64)
        y_re, y_im, carry = CSF.sharded_pfb_fused_apply(bank, u8)
        launched = (CH.LAUNCHES["halo_pull"], CH.LAUNCHES["ring_shift"],
                    FC.LAUNCHES["pfb_channelize"])
        assert launched == ((2, sp - 1, sp) if d.type == "cuda"
                            else (0, 0, 0))
        outs[d.type] = [t.cpu() for t in (demod, y_re, y_im, carry)]
    gpu, cpu = outs["cuda"], outs["cpu"]
    # a phase (in units of pi) compared modulo 2
    assert float(torch.remainder(gpu[0] - cpu[0] + 1, 2).sub(1).abs().max()
                 ) <= 2e-3
    assert _snr_db(cpu[1], gpu[1]) >= 100.0
    assert _snr_db(cpu[2], gpu[2]) >= 100.0
    assert torch.equal(gpu[3], cpu[3])


def test_halo_pull_kernel_unaligned_bytes(dev):
    """Sources 1 byte off 16-byte alignment take the byte path."""
    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.parallel import halo as H

    buf = torch.arange(4 * 4097, device=dev).to(torch.uint8)
    row = [buf[1 + s * 4097:(s + 1) * 4097] for s in range(4)]
    got = CH.pull_left_halo_cuda(row, 33)
    for g, e in zip(got, H.pull_left_halo(row, 33)):
        assert torch.equal(g, e)


def test_enable_peer_raises_for_a_missing_peer(dev):
    from tpu_sdr_torch.parallel import cuda_halo as CH

    with pytest.raises(RuntimeError, match="cannot read"):
        CH.enable_peer(0, torch.cuda.device_count() + 7)
    CH.enable_peer(0, 0)  # one device needs nothing


def test_sharded_fused_chain_on_the_card(dev):
    """The fused sharded chain on a (2, 2) mesh of logical shards on one
    card against the same chain on CPU shards; 'auto' runs K4."""
    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.parallel import mesh as PM
    from tpu_sdr_torch.parallel import wbfm_sharded_fused as WSF

    rng = np.random.default_rng(4)
    blocks = rng.integers(0, 256, (4, 2 * 2 * SPEC.chunk_complex),
                          dtype=np.uint8)
    outs = {}
    for d in (dev, torch.device("cpu")):
        CH.reset_launch_counts()
        FF.reset_launch_counts()
        streamer = WSF.ShardedFusedStreamer(
            PM.make_mesh(2, 2, devices=[d] * 4), 4)
        outs[d.type] = np.concatenate([streamer.demodulate(blocks),
                                       streamer.demodulate(blocks[::-1])],
                                      axis=1)
        launched = (CH.LAUNCHES["halo_pull"], FF.LAUNCHES["fm_front"],
                    FF.LAUNCHES["fm_resample"])
        assert all(c > 0 for c in launched) == (d.type == "cuda")
    assert outs["cuda"].shape == outs["cpu"].shape
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], rtol=1e-4,
                               atol=1e-5)


# ---- the halo record and the graph-replayed sharded step -------------------

def _record_row(dev, shards, stations, seed, n_bytes=4 * 1024):
    """``shards`` (stations, n_bytes) u8 shards of random bytes on ``dev``,
    station 0 of shard 0 a synthetic capture."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (shards, stations, n_bytes), dtype=np.uint8)
    u8, _ = synth.synth_wbfm_u8(n_bytes // 2, capture_rate=1_020_000,
                                seed=seed)
    rows[0, 0] = np.asarray(u8, dtype=np.uint8)
    return [torch.from_numpy(r).to(dev) for r in rows]


@pytest.mark.parametrize("shards,stations", [(4, 1), (4, 2), (4, 4), (32, 1),
                                             (32, 3)])
def test_shard_halo_kernel_matches_plain(dev, shards, stations):
    """The record kernel against its plain version: the carry within 1e-6
    relative (rows 0/1 bit-equal), the T-1 outputs within 1e-5, the padding
    zero; one launch for the row, a full 32-shard table included."""
    from tpu_sdr_torch.parallel import shard_halo as SH

    params = {dev: SH.make_params(device=dev)}
    row = _record_row(dev, shards, stations, seed=shards + stations)
    before = SH.LAUNCHES["shard_halo"]
    got = SH.shard_halo(row, params)
    assert SH.LAUNCHES["shard_halo"] == before + 1
    T = SPEC.taps_per_phase
    for x, g in zip(row, got):
        exp = SH.records_reference(x, params[dev])
        assert g.shape == exp.shape == (stations, 560)
        assert torch.equal(g[:, :256], exp[:, :256])
        torch.testing.assert_close(g[:, :SH.END], exp[:, :SH.END],
                                   rtol=1e-6, atol=1e-6)
        assert float((g[:, SH.END:SH.END + T - 1]
                      - exp[:, SH.END:SH.END + T - 1]).abs().max()) <= 1e-5
        assert torch.count_nonzero(g[:, SH.END + T - 1:]) == 0


def test_shard_halo_tail_matches_fm_front(dev):
    """The record's T-1 outputs against K1's own last T-1 on the shard."""
    from tpu_sdr_torch.parallel import shard_halo as SH

    (x,) = _record_row(dev, 1, 2, seed=3, n_bytes=CHUNK)
    (rec,) = SH.shard_halo([x], {dev: SH.make_params(device=dev)})
    taps, _ = FF.make_kernel_params(device=dev)
    T = SPEC.taps_per_phase
    for j in range(2):
        z, _ = FF.fm_front(x[j], 0, FF.init_carry(dev), taps, SPEC.decim)
        assert _snr_db(z[-(T - 1):].cpu(),
                       rec[j, SH.END:SH.END + T - 1].cpu()) >= 100.0


def test_shard_halo_rejects_33_shards(dev):
    from tpu_sdr_torch.parallel import shard_halo as SH

    row = _record_row(dev, 33, 1, seed=33, n_bytes=1024)
    with pytest.raises(ValueError, match="at most 32"):
        SH.shard_halo(row, {dev: SH.make_params(device=dev)})


def _launches():
    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.parallel import shard_halo as SH

    return {**FF.LAUNCHES, **CH.LAUNCHES, **SH.LAUNCHES}


def _reset_launches():
    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.parallel import shard_halo as SH

    FF.reset_launch_counts()
    CH.reset_launch_counts()
    SH.reset_launch_counts()


@pytest.mark.parametrize("dp,sp", [(1, 4), (2, 2)])
def test_graph_replay_equals_the_eager_chain(dev, dp, sp):
    """``ShardedFusedStreamer`` on logical shards of one card (a CUDA
    graph from its second block) over three blocks: bit-equal to the eager
    ``chain.fn``, with the same launch counts."""
    from tpu_sdr_torch.parallel import mesh as PM
    from tpu_sdr_torch.parallel import wbfm_sharded_fused as WSF

    stations = 2 * dp
    rng = np.random.default_rng(dp * 10 + sp)
    blocks = [rng.integers(0, 256, (stations, sp * CHUNK), dtype=np.uint8)
              for _ in range(3)]
    mesh = PM.make_mesh(dp, sp, devices=[dev] * (dp * sp))
    _reset_launches()
    chain = WSF.make_sharded_wbfm_fused(mesh, carry_io=True)
    ke, rs = WSF.initial_carry(stations, device=dev)
    eager = []
    for b in blocks:
        audio, counts, ke, rs = chain.fn(chain.shard(b), ke, rs)
        eager.append(chain.assemble(audio, counts))
    eager_launches = _launches()
    _reset_launches()
    streamer = WSF.ShardedFusedStreamer(mesh, stations)
    assert streamer.graphed
    graphed = [streamer.demodulate(b) for b in blocks]
    assert streamer.step_graph is not None
    assert _launches() == eager_launches
    assert eager_launches["halo_pull"] == 3 * dp
    assert eager_launches["shard_halo"] == 3 * dp
    # one K1 and one K2 launch a shard, whatever its stations
    assert eager_launches["fm_front"] == 3 * dp * sp
    assert eager_launches["fm_resample"] == 3 * dp * sp
    for e, g in zip(eager, graphed):
        assert np.array_equal(e, g)
    assert torch.equal(streamer.states, ke)
    assert torch.equal(streamer.resamp_hists, rs)
    # a new carry from outside (reset) reaches the graph's buffers
    streamer.reset()
    again = streamer.demodulate(blocks[0])
    assert np.array_equal(again, eager[0])


# ---- K1 and K2 over a station axis -----------------------------------------

def _station_rows(dev, stations, n_bytes, seed):
    """(stations, n_bytes) u8 on ``dev``: station 0 a synthetic capture,
    the others random bytes."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (stations, n_bytes), dtype=np.uint8)
    u8, _ = synth.synth_wbfm_u8(n_bytes // 2, capture_rate=1_020_000,
                                seed=seed)
    rows[0] = np.asarray(u8, dtype=np.uint8)[:n_bytes]
    return torch.from_numpy(rows).to(dev)


def _strided_carries(dev, stations, taps, data, record=560):
    """Mid-stream (stations, 4, 128) carries as slices of (stations,
    record) records, as the sharded chain hands them to K1."""
    recs = torch.zeros(stations, record, device=dev)
    for j in range(stations):
        _, c = FF.fm_front_reference(data[j, -2 * SPEC.decim * 500:], j % 4,
                                     FF.init_carry(dev), taps, SPEC.decim)
        recs[j, :512] = c.reshape(-1)
    return recs[:, :512].reshape(stations, FF.STATE_ROWS, FF.LANES)


@pytest.mark.parametrize("stations,m", [(4, 21_760), (3, 40_003), (8, 127)])
def test_fm_front_batch_matches_plain_and_single_launches(dev, stations, m):
    """One launch over the stations, phases 0..3 across them, carries at a
    record's stride: each station >= 100 dB against the plain version, its
    carry within 1e-3, and bit-equal to a one-station launch on the same
    row (40,003 outputs a station: rows and z off 16- and 8-byte
    alignment)."""
    taps, _ = FF.make_kernel_params(device=dev)
    data = _station_rows(dev, stations, 2 * SPEC.decim * m, seed=m)
    carries = _strided_carries(dev, stations, taps, data)
    phases = [j % 4 for j in range(stations)]
    before = FF.LAUNCHES["fm_front"]
    z, c = FF.fm_front(data, phases, carries, taps, SPEC.decim)
    assert FF.LAUNCHES["fm_front"] == before + 1
    assert z.shape == (stations, m) and c.shape == (stations, 4, 128)
    zr, cr = FF.fm_front_reference(data, phases, carries, taps, SPEC.decim)
    for j in range(stations):
        # z is an angle / pi: an output at the +-1 edge of random bytes
        # may round to either side in the two FIR summation orders
        err = torch.remainder(z[j] - zr[j] + 1, 2) - 1
        assert _snr_db(zr[j].cpu(), (zr[j] + err).cpu()) >= 100.0, j
        torch.testing.assert_close(c[j], cr[j], rtol=1e-5, atol=1e-3)
        z1, c1 = FF.fm_front(data[j], phases[j], carries[j].contiguous(),
                             taps, SPEC.decim)
        assert torch.equal(z1, z[j]) and torch.equal(c1, c[j]), j


def test_fm_front_batch_writes_strided_out(dev):
    """``out`` rows at a stride, as the wideband tail or a caller's buffer
    gives them; one phase for every station."""
    taps, _ = FF.make_kernel_params(device=dev)
    data = _station_rows(dev, 2, CHUNK, seed=5)
    carries = FF.init_carry(dev).repeat(2, 1, 1)
    m = CHUNK // 2 // SPEC.decim
    out = torch.zeros(2, m + 3, device=dev)[:, 1:m + 1]
    z, _ = FF.fm_front(data, 2, carries, taps, SPEC.decim, out=out)
    assert z.data_ptr() == out.data_ptr()
    zr, _ = FF.fm_front_reference(data, 2, carries, taps, SPEC.decim)
    assert _snr_db(zr.cpu(), out.cpu()) >= 100.0


@pytest.mark.parametrize("stations,frames", [(4, 256), (3, 1_237), (8, 1)])
def test_fm_resample_batch_matches_plain_and_single_launches(dev, stations,
                                                              frames):
    """One launch over the stations, histories at a record's stride, z
    rows off 16-byte alignment (1,237 frames of 85): >= 100 dB against the
    plain version, the history equal, bit-equal to one-station launches."""
    _, h_poly = FF.make_kernel_params(device=dev)
    rng = np.random.default_rng(frames)
    z = torch.from_numpy(rng.uniform(-1, 1, (stations, frames * SPEC.down))
                         .astype(np.float32)).to(dev)
    recs = torch.from_numpy(rng.uniform(-1, 1, (stations, 560)).astype(
        np.float32)).to(dev)
    hists = recs[:, 512:512 + SPEC.taps_per_phase - 1]
    before = FF.LAUNCHES["fm_resample"]
    a, h = FF.resample(z, hists, h_poly, SPEC.down)
    assert FF.LAUNCHES["fm_resample"] == before + 1
    assert a.shape == (stations, frames * SPEC.up)
    ar, hr = FF.resample_reference(z, hists, h_poly, SPEC.down)
    assert torch.equal(h, hr)
    for j in range(stations):
        assert _snr_db(ar[j].cpu(), a[j].cpu()) >= 100.0, j
        a1, h1 = FF.resample(z[j], hists[j].contiguous(), h_poly, SPEC.down)
        assert torch.equal(a1, a[j]) and torch.equal(h1, h[j]), j


def test_fused_batch_streamer_on_the_card_matches_cpu(dev):
    """``FusedWbfmBatchStreamer`` on the card (one K1 and one K2 launch a
    call) against the same streamer on the CPU, stations at phases 0..3."""
    data = _station_rows(torch.device("cpu"), 4, 2 * CHUNK, seed=9).numpy()
    outs = {}
    for d in (dev, torch.device("cpu")):
        st = FF.FusedWbfmBatchStreamer(4, device=d)
        st.phases = [0, 1, 2, 3]
        FF.reset_launch_counts()
        outs[d.type] = np.concatenate([st.demodulate(data[:, :CHUNK + 100]),
                                       st.demodulate(data[:, CHUNK + 100:])],
                                      axis=1)
        launched = FF.LAUNCHES["fm_front"], FF.LAUNCHES["fm_resample"]
        assert launched == ((2, 2) if d.type == "cuda" else (0, 0))
    assert outs["cuda"].shape == outs["cpu"].shape == (4, 2 * SPEC.audio_per_chunk)
    for j in range(4):
        assert _snr_db(outs["cpu"][j], outs["cuda"][j]) >= 100.0, j


def test_batch_wrappers_reject_bad_rows(dev):
    taps, h_poly = FF.make_kernel_params(device=dev)
    data = torch.zeros(2, 2 * 6 * 128, dtype=torch.uint8, device=dev)
    carries = FF.init_carry(dev).repeat(2, 1, 1)
    with pytest.raises(ValueError):  # a phase for 3 stations
        FF.fm_front(data, [0, 1, 2], carries, taps, SPEC.decim)
    with pytest.raises(ValueError):  # phase 4
        FF.fm_front(data, [0, 4], carries, taps, SPEC.decim)
    with pytest.raises(ValueError):  # rows not contiguous
        FF.fm_front(torch.zeros(2, 2 * 2 * 6 * 128, dtype=torch.uint8,
                                device=dev)[:, ::2], 0, carries, taps,
                    SPEC.decim)
    with pytest.raises(ValueError):  # carries for 1 station
        FF.fm_front(data, 0, carries[:1], taps, SPEC.decim)
    with pytest.raises(ValueError):  # overlapping histories
        FF.resample(torch.zeros(2, 170, device=dev),
                    torch.zeros(60, device=dev).as_strided((2, 47), (5, 1)),
                    h_poly, SPEC.down)


# ---- the exact chain and the float chain's modes on the card ---------------

def test_exact_chain_on_the_card_is_bit_equal_to_cpu(dev):
    """The integer chain on the card (float64 atan2 there too) against the
    CPU, bit for bit, in the reference's blocks and at odd multiples of 8."""
    from tpu_sdr_torch.models import wbfm_exact as TE

    u8, _ = synth.synth_wbfm_u8(400_000, capture_rate=1_020_000, seed=12)
    u8 = np.asarray(u8, dtype=np.uint8)
    outs = {}
    for d in (dev, torch.device("cpu")):
        st = TE.WbfmExactStreamer(device=d)
        cuts = [0, 262_144, 262_144 + 8 * 4001, len(u8)]
        outs[d.type] = np.concatenate([st.demodulate(u8[a:b]) for a, b in
                                       zip(cuts[:-1], cuts[1:])])
    assert len(outs["cpu"]) > 10_000
    np.testing.assert_array_equal(outs["cuda"], outs["cpu"])


@pytest.mark.parametrize("kw", [{"filter_mode": "boxcar"},
                                {"filter_mode": "fir", "deemphasis_tau": 75e-6},
                                {"filter_mode": "boxcar", "emit_mpx": True,
                                 "deemphasis_tau": 50e-6}])
def test_float_modes_on_the_card_match_cpu(capture, dev, kw):
    from tpu_sdr_torch.models import wbfm as TW

    config = design.WbfmConfig(**kw)
    outs, mpx = {}, {}
    for d in (dev, torch.device("cpu")):
        st = TW.WbfmStreamer(config, device=d)
        outs[d.type] = np.concatenate([st.demodulate(capture[:100_001]),
                                       st.demodulate(capture[100_001:])])
        mpx[d.type] = st.last_mpx
    assert outs["cuda"].shape == outs["cpu"].shape
    assert _snr_db(outs["cpu"], outs["cuda"]) >= 100.0
    if kw.get("emit_mpx"):
        assert _snr_db(mpx["cpu"], mpx["cuda"]) >= 100.0


def test_float_batch_on_the_card_matches_cpu(capture, dev):
    """The float chain's station batch (unaligned calls: the polyphase
    resampler with its t0) on the card against the CPU."""
    from tpu_sdr_torch.models import wbfm_batched as TB

    data = np.stack([capture, capture[::-1].copy(), np.roll(capture, 999)])
    outs = {}
    for d in (dev, torch.device("cpu")):
        st = TB.WbfmBatchStreamer(3, device=d)
        outs[d.type] = np.concatenate([st.demodulate(data[:, :70_001]),
                                       st.demodulate(data[:, 70_001:])],
                                      axis=1)
    assert outs["cuda"].shape == outs["cpu"].shape
    for j in range(3):
        assert _snr_db(outs["cpu"][j], outs["cuda"][j]) >= 100.0, j


@pytest.mark.parametrize("mode", ["exact", "boxcar"])
def test_cli_exact_and_boxcar_modes_on_the_card(capture, dev, tmp_path, mode):
    from tpu_sdr_torch.apps import simple_fm

    path = tmp_path / "cap.u8"
    np.tile(capture, 4).tofile(path)
    pcm = {}
    for device in ("cuda", "cpu"):
        raw, saved = io.BytesIO(), sys.stdout
        sys.stdout = io.TextIOWrapper(raw, write_through=True)
        try:
            assert simple_fm.main(["--file", str(path), "--mode", mode,
                                   "--torch-device", device]) == 0
        finally:
            sys.stdout.detach()
            sys.stdout = saved
        pcm[device] = np.frombuffer(raw.getvalue(), dtype="<i2")
    assert len(pcm["cuda"]) == len(pcm["cpu"]) > 10_000
    if mode == "exact":
        assert pcm["cuda"].tobytes() == pcm["cpu"].tobytes()
    else:
        assert np.abs(pcm["cuda"].astype(int) - pcm["cpu"]).max() <= 1


# ---- stereo, RDS, the narrowband modes, the PSD, checkpoint, traces --------

def _stereo_capture(n=510 * 400, seed=3):
    bits = np.random.default_rng(seed).integers(0, 2, 600).astype(np.uint8)
    u8, _, _ = synth.synth_wbfm_stereo_u8(n, capture_rate=1_020_000,
                                          rds_bits=bits)
    return np.asarray(u8, np.uint8)


@pytest.mark.parametrize("kw", [{"emit_mpx": True},
                                {"deemphasis_tau": 75e-6}])
def test_stereo_on_the_card_matches_cpu(dev, kw):
    from tpu_sdr_torch.models import wbfm_stereo as TS

    u8 = _stereo_capture()
    outs, mpx = {}, {}
    for d in (dev, torch.device("cpu")):
        st = TS.WbfmStereoStreamer(TS.StereoConfig(**kw), device=d)
        outs[d.type] = np.concatenate([st.demodulate(u8[:100_001]),
                                       st.demodulate(u8[100_001:])], axis=1)
        mpx[d.type] = st.last_mpx
    assert outs["cuda"].shape == outs["cpu"].shape == (2, 6400)
    for ch in range(2):
        assert _snr_db(outs["cpu"][ch], outs["cuda"][ch]) >= 100.0
    if kw.get("emit_mpx"):
        assert _snr_db(mpx["cpu"], mpx["cuda"]) >= 100.0


def test_rds_on_the_card_matches_cpu(dev):
    """The 340 kHz baseband (the stereo front's multiplex) on the card
    against the CPU, and the same bits."""
    from tpu_sdr_torch.models import rds as R
    from tpu_sdr_torch.models import wbfm_stereo as TS

    st = TS.WbfmStereoStreamer(TS.StereoConfig(emit_mpx=True),
                               device=torch.device("cpu"))
    st.demodulate(_stereo_capture(n=510 * 1200))
    cfg = R.RdsConfig.for_mpx_rate(340_000)
    bb, amp = {}, {}
    for d in (dev, torch.device("cpu")):
        rx = R.RdsReceiver(cfg, device=d)
        bb[d.type] = np.concatenate([rx.process(st.last_mpx[:70_001]),
                                     rx.process(st.last_mpx[70_001:])])
        amp[d.type] = rx.pilot_amp
    assert bb["cuda"].shape == bb["cpu"].shape
    assert _snr_db(bb["cpu"], bb["cuda"]) >= 100.0
    assert amp["cuda"] == pytest.approx(amp["cpu"], rel=1e-5)
    np.testing.assert_array_equal(R.decode_bits(bb["cuda"]),
                                  R.decode_bits(bb["cpu"]))


@pytest.mark.parametrize("kw", [{"mode": "am"}, {"mode": "nbfm",
                                                 "deemphasis_tau": 75e-6},
                                {"mode": "usb", "fine_tune_hz": 300.0},
                                {"mode": "lsb", "squelch_db": -40.0}])
def test_multimode_on_the_card_matches_cpu(dev, kw):
    from tpu_sdr_torch.models import multimode as TM

    u8, _ = synth.synth_wbfm_u8(510 * 300, capture_rate=1_020_000,
                                deviation=5_000.0, noise_std=0.05, seed=4)
    u8 = np.asarray(u8, np.uint8)
    outs, power = {}, {}
    for d in (dev, torch.device("cpu")):
        st = TM.MultimodeStreamer(TM.MultimodeConfig(**kw), device=d)
        outs[d.type] = np.concatenate([st.demodulate(u8[:70_003]),
                                       st.demodulate(u8[70_003:])])
        power[d.type] = st.last_power
    assert outs["cuda"].shape == outs["cpu"].shape
    # the first 32 samples: the channel filter's start-up, where the
    # discriminator's angle of ~0 is set by rounding alone
    assert _snr_db(outs["cpu"][32:], outs["cuda"][32:]) >= 100.0
    assert power["cuda"] == pytest.approx(power["cpu"], rel=1e-5)


def test_psd_on_the_card_matches_cpu(dev):
    from tpu_sdr_torch.ops import spectrum as SP

    rng = np.random.default_rng(6)
    buf = rng.integers(0, 256, 2 * 1024 * 50 + 333, dtype=np.uint8)
    db = {}
    for d in (dev, torch.device("cpu")):
        ps = SP.PsdStreamer(1024, device=d)
        ps.accumulate(buf[:9_999])
        ps.accumulate(buf[9_999:])
        assert ps.state.acc.device.type == d.type
        db[d.type] = ps.finalize_db()
    np.testing.assert_allclose(db["cuda"], db["cpu"], rtol=0, atol=0.01)


@pytest.mark.parametrize("name", ["stereo", "multimode", "wideband_fused"])
def test_checkpoint_on_the_card(dev, tmp_path, name):
    """A card streamer's checkpoint resumes bit-identically on the card,
    its tensors landing on the card."""
    from tpu_sdr_torch.models import multimode as TM
    from tpu_sdr_torch.models import wbfm_stereo as TS
    from tpu_sdr_torch.stream import checkpoint as C

    if name == "stereo":
        def make():
            return TS.WbfmStereoStreamer(TS.StereoConfig(emit_mpx=True),
                                         device=dev)
        data, split, axis = _stereo_capture(), 100_001, 1
    elif name == "multimode":
        def make():
            return TM.MultimodeStreamer(TM.MultimodeConfig(mode="usb"),
                                        device=dev)
        data = np.random.default_rng(2).integers(0, 256, 510 * 300,
                                                 dtype=np.uint8)
        split, axis = 70_003, 0
    else:
        config = WB.WidebandConfig(num_channels=16, channels=(3, 12))

        def make():
            return WB.WidebandStreamer(config, use_fused=True, device=dev)
        data = np.random.default_rng(3).integers(0, 256, 2 * 8 * 16 * 85 * 6,
                                                 dtype=np.uint8)
        split, axis = len(data) // 2 + 1_001, 1
    ref = make()
    full = np.concatenate([ref.demodulate(data[:split]),
                           ref.demodulate(data[split:])], axis=axis)
    first = make()
    out1 = first.demodulate(data[:split])
    path = str(tmp_path / "ck.npz")
    C.save_stream_state(path, first)
    resumed = make()
    C.load_stream_state(path, resumed)
    leaves = C._flatten(resumed.state)
    assert all(x.device.type == "cuda" for x in leaves if torch.is_tensor(x))
    got = np.concatenate([out1, resumed.demodulate(data[split:])], axis=axis)
    np.testing.assert_array_equal(got, full)


@pytest.mark.parametrize("when", ["before_graph", "after_graph"])
def test_checkpoint_into_a_graphed_sharded_streamer(dev, tmp_path, when):
    """``ShardedFusedStreamer`` on logical shards of one card: a checkpoint
    taken after block 1 resumes block 2 bit-identically, loaded into a
    fresh streamer (no graph yet) or into one whose captured graph already
    replayed (its static carries must take the loaded ones)."""
    from tpu_sdr_torch.parallel import mesh as PM
    from tpu_sdr_torch.parallel import wbfm_sharded_fused as WSF
    from tpu_sdr_torch.stream import checkpoint as C

    mesh = PM.make_mesh(1, 2, devices=[dev] * 2)
    rng = np.random.default_rng(17)
    blocks = [rng.integers(0, 256, (2, 2 * CHUNK), dtype=np.uint8)
              for _ in range(3)]
    ref = WSF.ShardedFusedStreamer(mesh, 2)
    exp = [ref.demodulate(b) for b in blocks]
    first = WSF.ShardedFusedStreamer(mesh, 2)
    first.demodulate(blocks[0])
    path = str(tmp_path / "sharded.npz")
    C.save_stream_state(path, first)
    target = WSF.ShardedFusedStreamer(mesh, 2)
    if when == "after_graph":
        for b in blocks[::-1]:  # eager, then the graph, then a replay
            target.demodulate(b)
        assert target.step_graph is not None
    C.load_stream_state(path, target)
    np.testing.assert_array_equal(target.demodulate(blocks[1]), exp[1])
    np.testing.assert_array_equal(target.demodulate(blocks[2]), exp[2])


def test_trace_on_the_card_names_the_kernels(capture, dev, tmp_path):
    import json

    from tpu_sdr_torch.apps import simple_fm

    path = tmp_path / "cap.u8"
    np.tile(capture, 2).tofile(path)
    raw, saved = io.BytesIO(), sys.stdout
    sys.stdout = io.TextIOWrapper(raw, write_through=True)
    try:
        assert simple_fm.main(["--file", str(path), "--mode", "fused",
                               "--trace", str(tmp_path / "tr")]) == 0
    finally:
        sys.stdout.detach()
        sys.stdout = saved
    (trace,) = (tmp_path / "tr").glob("*.pt.trace.json")
    names = " ".join(e.get("name", "") for e in json.loads(
        trace.read_text())["traceEvents"])
    assert "fm_front" in names and "fm_resample" in names
    # the program's spans on their own track, on the same time axis: each
    # replay span holds its graph launch, each sync span its wait
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    calls = [e for e in events if e.get("cat") == "cuda_runtime"]
    for part, call in (("replay", "cudaGraphLaunch"),
                       ("sync", "cudaStreamSynchronize")):
        mine = [e for e in spans if e["name"] == f"FusedWbfmStreamer.{part}"]
        assert mine
        for s in mine:
            assert any(c["name"] == call and s["ts"] <= c["ts"]
                       <= s["ts"] + s["dur"] for c in calls), (part, s)


def test_card_timeline_holds_each_steps_host_calls(wideband_capture, dev):
    """Under the card's profiler the spans go to the timeline, on its host
    clock: every graph launch of the reads lies in a replay span, one
    each, and every synchronize in a sync span; the totals stay empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_sdr_torch.models import rds as R
    from tpu_sdr_torch.utils import profiling

    config = WB.WidebandConfig(channels=(3, 60), emit_mpx=True)
    streamer = WB.WidebandStreamer(config, use_fused=True, device=dev)
    decoders = [R.RdsStreamDecoder(device=dev) for _ in config.channels]
    read = 87_040

    def reads():
        for at in range(0, len(wideband_capture), read):
            streamer.demodulate(wideband_capture[at:at + read])
            for s, dec in enumerate(decoders):
                dec.feed_mpx(streamer.last_mpx[s])

    reads()  # capture every key
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        reads()
    assert profiling.totals() == {"spans": {}, "counters": {}}
    tl = profiling.timeline()
    host = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() != DeviceType.CUDA]
    for part, call in (("replay", "cudaGraphLaunch"),
                       ("sync", "cudaStreamSynchronize")):
        mine = [s for s in tl if s.name.endswith(f".{part}")]
        stamps = [e.start_ns() for e in host if e.name() == call]
        assert len(mine) == 3 * len(wideband_capture) // read
        assert len(stamps) == len(mine), part
        for t in stamps:
            assert sum(s.start_ns <= t <= s.end_ns for s in mine) == 1, part
    for s in tl:
        if s.name == R.FEED_SPAN:
            assert s.read is not None and s.station in (0, 1)


# ---- the feeder's pinned double buffer and the port's rtl_tcp server -------

def test_device_blocks_are_pinned_and_land_on_the_card(dev, tmp_path):
    """The native file feed through ``device_blocks``: at least two pinned
    staging slots, every block a u8 tensor on cuda:0, the bytes in
    order, none dropped."""
    from tpu_sdr_torch.stream import feeder as FD

    data = np.random.default_rng(4).integers(0, 256, 6 * 4096, dtype=np.uint8)
    path = tmp_path / "cap.u8"
    data.tofile(path)
    fd = FD.BlockFeeder(FD.FileSource(str(path)), block_bytes=4096,
                        queue_blocks=2, native=True).start()
    got = []
    for blk in fd.device_blocks(dev):
        assert blk.device == dev and blk.dtype == torch.uint8
        got.append(blk.cpu().numpy())
    fd.stop()
    assert len(fd.staging) >= 2 and all(s.is_pinned() for s in fd.staging)
    assert fd.is_native and fd.dropped == 0
    np.testing.assert_array_equal(np.concatenate(got), data)


def test_fused_streamer_fed_device_blocks_is_bit_equal(dev, tmp_path):
    """262,144-byte reads (a residual every read) through the feeder's
    pinned double buffer: the same audio bits as the numpy feed, one K1
    and one K2 launch a read, the residual kept on the card."""
    from tpu_sdr_torch.stream import feeder as FD

    read = 262_144
    u8, _ = synth.synth_wbfm_u8(6 * read // 2, capture_rate=1_020_000)
    u8 = np.asarray(u8, dtype=np.uint8)
    path = tmp_path / "cap.u8"
    u8.tofile(path)
    ref = FF.FusedWbfmStreamer(device=dev)
    want = np.concatenate([ref.demodulate(u8[s:s + read])
                           for s in range(0, len(u8), read)])
    fd = FD.BlockFeeder(FD.FileSource(str(path)), block_bytes=read).start()
    st = FF.FusedWbfmStreamer(device=dev)
    before = dict(FF.LAUNCHES)
    got = np.concatenate([st.demodulate(b) for b in fd.device_blocks(dev)])
    fd.stop()
    assert {k: FF.LAUNCHES[k] - before[k] for k in before} == {
        "fm_front": 6, "fm_resample": 6}
    assert torch.is_tensor(st._pending) and st._pending.device == dev
    np.testing.assert_array_equal(got, want)


def test_fused_batch_streamer_fed_tensors_is_bit_equal(dev):
    rng = np.random.default_rng(6)
    bufs = rng.integers(0, 256, (3, 3 * 100_002), dtype=np.uint8)
    outs = []
    for on_card in (False, True):
        st = FF.FusedWbfmBatchStreamer(3, device=dev)
        pieces = [bufs[:, s:s + 100_002] for s in range(0, bufs.shape[1],
                                                        100_002)]
        outs.append(np.concatenate([st.demodulate(
            torch.from_numpy(p.copy()).to(dev) if on_card else p)
            for p in pieces], axis=1))
    assert outs[0].shape[1] > 0
    np.testing.assert_array_equal(outs[1], outs[0])


def test_rtl_tcp_counter_round_trip(dev):
    """The port's server and client on the chip machine (which has no JAX
    server): the handshake, opcode 0x07, and the counter test pattern
    continuous over 64 reads (the native count_pattern_breaks)."""
    import threading
    import time

    from tpu_sdr_torch import api, native
    from tpu_sdr_torch.control import fake
    from tpu_sdr_torch.stream.feeder import RtlTcpClientSource
    from tpu_sdr_torch.stream.rtl_tcp_server import RtlTcpServer

    fake.clear_fake_devices()
    fake.register_fake_device()
    sdr = api.RtlSdr.open_with_index(0)
    sdr.set_testmode(True)
    sdr.reset_buffer()
    srv = RtlTcpServer(sdr, "127.0.0.1", 0, queue_limit=16)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    deadline = time.time() + 5
    while srv.bound_port is None and time.time() < deadline:
        time.sleep(0.01)
    try:
        client = RtlTcpClientSource("127.0.0.1", srv.bound_port)
        assert (client.tuner_type, client.gain_count) == (5, 29)
        client.set_test_mode(True)
        breaks, last = 0, -1
        for _ in range(64):
            b, last = native.count_pattern_breaks(np.frombuffer(
                client.read_block(65_536), np.uint8), last)
            breaks += b
        client.close()
        assert native.available() and breaks == 0
    finally:
        srv.stop()
        t.join(timeout=5)
        sdr.close()
        fake.clear_fake_devices()
    assert not t.is_alive()


# ---- the graphed steps (utils.graphs): each streamer's read one replay ----

def _graph_cases():
    """name -> (make(device) streamer, data, read lengths, feed): small
    captures, uneven seeded reads with two-chunk reads among them."""
    from tpu_sdr_torch.models import multimode as TM
    from tpu_sdr_torch.models import rds as TR
    from tpu_sdr_torch.models import wbfm as TW
    from tpu_sdr_torch.models import wbfm_batched as TB
    from tpu_sdr_torch.models import wbfm_exact as TE
    from tpu_sdr_torch.models import wbfm_stereo as TS
    from tpu_sdr_torch.ops import spectrum as SP

    def lengths(mean, jitter, seed, long=0, n=24):
        rng = np.random.default_rng(seed)
        out = (mean + rng.integers(-jitter, jitter + 1, n)) // 2 * 2
        if long:
            out[3::6] = long
        return out

    def fm(n, seed):
        return np.asarray(synth.synth_wbfm_u8(n, noise_std=0.02,
                                              seed=seed)[0], np.uint8)

    def float_stream(**kw):
        config = design.WbfmConfig(**kw)
        return (lambda d: TW.WbfmStreamer(config, device=d), fm(60_000, 1),
                lengths(3_300, 700, 2),
                lambda s, b: (s.demodulate(b),) + (
                    (s.last_mpx,) if config.emit_mpx else ()))

    def batch(d):
        s = FF.FusedWbfmBatchStreamer(2, device=d)
        s.phases = [1, 2]
        return s

    mpx = np.sin(np.arange(60_000) * 0.7).astype(np.float32)
    rows = np.stack([fm(1_200_000, 3), fm(1_200_000, 4)])
    wide = np.asarray(synth.synth_multistation_u8(
        700_000, 64 * 170_000, station_freqs=[3 * 170_000, -4 * 170_000],
        audio_freqs=[1_000.0, 2_500.0], deviation=45_000.0)[0], np.uint8)
    stereo = np.asarray(synth.synth_wbfm_stereo_u8(60_000)[0], np.uint8)

    def wideband(fused):
        config = WB.WidebandConfig(channels=(3, 60), emit_mpx=True)
        return (lambda d: WB.WidebandStreamer(config, use_fused=fused,
                                              device=d),
                wide, lengths(30_000, 28_000, 5, long=180_000),
                lambda s, b: (s.demodulate(b), s.last_mpx))

    def multimode(mode, **kw):
        config = TM.MultimodeConfig(mode=mode, **kw)
        return (lambda d: TM.MultimodeStreamer(config, device=d),
                fm(60_000, 8), lengths(3_300, 700, 8),
                lambda s, b: (s.demodulate(b), np.float32(s.last_power)))

    return {
        "fused": (lambda d: FF.FusedWbfmStreamer(device=d), fm(1_200_000, 2),
                  lengths(50_000, 48_000, 3, long=2 * CHUNK + 9_000),
                  lambda s, b: (s.demodulate(b),)),
        "fused_batch": (batch, rows,
                        lengths(50_000, 48_000, 4, long=2 * CHUNK + 9_000),
                        lambda s, b: (s.demodulate(b),)),
        "fused_batch_one_phase": (
            lambda d: FF.FusedWbfmBatchStreamer(2, device=d), rows,
            lengths(50_000, 48_000, 4, long=2 * CHUNK + 9_000),
            lambda s, b: (s.demodulate(b),)),
        "fir": float_stream(),
        "boxcar": float_stream(filter_mode="boxcar"),
        "fir_deemph_mpx": float_stream(deemphasis_tau=75e-6, emit_mpx=True),
        "float_batch": (lambda d: TB.WbfmBatchStreamer(2, device=d),
                        rows[:, :120_000], lengths(3_000, 6, 6),
                        lambda s, b: (s.demodulate(b),)),
        "wideband_plain": wideband(False),
        "wideband_fused": wideband(True),
        "stereo": (lambda d: TS.WbfmStereoStreamer(TS.StereoConfig(
            emit_mpx=True, deemphasis_tau=75e-6), device=d), stereo,
            lengths(2_100, 500, 7),
            lambda s, b: (s.demodulate(b), s.last_mpx)),
        "rds": (lambda d: TR.RdsReceiver(device=d), mpx,
                lengths(2_200, 500, 9),
                lambda s, b: (s.process(b), np.float32(s.pilot_amp))),
        "fm": multimode("nbfm", deemphasis_tau=75e-6),
        "am": multimode("am", squelch_db=-40.0),
        "usb": multimode("usb", fine_tune_hz=120.0),
        "lsb": multimode("lsb"),
        "exact": (lambda d: TE.WbfmExactStreamer(device=d), fm(60_000, 10),
                  lengths(3_296, 8, 10) // 8 * 8,
                  lambda s, b: (s.demodulate(b),)),
        "psd": (lambda d: SP.PsdStreamer(1024, device=d), fm(60_000, 11),
                lengths(5_000, 4_000, 11), _psd_feed),
        "pfb": (lambda d: FC.FusedPfbStreamer(device=d), wide,
                lengths(40_000, 38_000, 12, long=3 * 32_768 + 100),
                lambda s, b: tuple(y.T for y in s.channelize(b))),
    }


def _psd_feed(s, b):
    """The PSD's bins after a read that added segments, else nothing."""
    before = s.segments
    s.accumulate(b)
    return (s.finalize_db(),) if s.segments > before else (np.zeros(0),)


GRAPH_CASES = ["fused", "fused_batch", "fused_batch_one_phase", "fir", "boxcar", "fir_deemph_mpx",
               "float_batch", "wideband_plain", "wideband_fused", "stereo",
               "rds", "fm", "am", "usb", "lsb", "exact", "psd", "pfb"]


def _launch_counts():
    return {**FF.LAUNCHES, **FC.LAUNCHES}


@pytest.mark.parametrize("name", GRAPH_CASES)
def test_graphed_streamer_equals_disabled(dev, name):
    """Each graphed streamer on the card over uneven reads: the same bits
    as ``graphs.disabled()`` (the eager step), every read after the first
    of its key one replay, the kernels' counters exact (one K1 and one K2,
    or one K3, a read with a chunk), the peak memory bounded."""
    from tpu_sdr_torch.utils import graphs

    make, data, lens, feed = _graph_cases()[name]
    reads, at = [], 0
    for n in lens:
        reads.append(data[..., at:at + n])
        at += n
    eager_streamer = make(dev)
    with graphs.disabled():
        FF.reset_launch_counts()
        FC.reset_launch_counts()
        exp = [feed(eager_streamer, r) for r in reads]
        eager_launches = _launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    s = make(dev)
    FF.reset_launch_counts()
    FC.reset_launch_counts()
    got = []
    for r in reads:
        before = (s.graphs.captures, s.graphs.replays)
        got.append(feed(s, r))
        after = (s.graphs.captures, s.graphs.replays)
        if got[-1][0].shape[-1]:
            assert sum(after) == sum(before) + 1
    peak = torch.cuda.max_memory_allocated(dev)
    assert s.graphs.graph is not None and s.graphs.replays > s.graphs.captures
    for i, (e, g) in enumerate(zip(exp, got)):
        for x, y in zip(e, g):
            assert x.shape == y.shape and np.array_equal(x, y), (name, i)
    assert _launch_counts() == eager_launches
    with_chunk = sum(1 for g in got if g[0].shape[-1])
    if name.startswith("fused"):
        assert eager_launches["fm_front"] == with_chunk
        assert eager_launches["fm_resample"] == with_chunk
    if name in ("wideband_fused", "pfb"):
        assert eager_launches["pfb_channelize"] == with_chunk
    assert peak < 2 << 30, f"{name}: peak {peak / 2**20:.1f} MiB"


@pytest.mark.parametrize("residual", [0, 1000])
def test_graphed_wideband_reads_in_pieces_equal_disabled(wideband_capture,
                                                         dev, residual):
    """``WidebandStreamer(use_fused=True)`` under graphs, its residual and
    each read's whole chunks written as two pieces into the staging
    buffer, reads handed in one reused read-only buffer as ``multi_fm``'s
    ``np.frombuffer`` hands them: the same bits as the same reads under
    ``graphs.disabled()``, one graph a usable length, one K3 launch a
    read."""
    from tpu_sdr_torch.utils import graphs

    config = WB.WidebandConfig(channels=(3, 60), emit_mpx=True)
    quantum = WB.fused_spec(config).chunk_bytes
    reads = [(1 + k % 2) * quantum + residual for k in range(5)]
    scratch = bytearray(max(reads))

    def run(streamer):
        out, at = [], 0
        for n in reads:
            scratch[:n] = wideband_capture[at:at + n].tobytes()
            at += n
            buf = np.frombuffer(memoryview(scratch)[:n].toreadonly(),
                                np.uint8)
            out.append((streamer.demodulate(buf), streamer.last_mpx))
            del buf
        return out

    assert sum(reads) <= len(wideband_capture)
    with graphs.disabled():
        exp = run(WB.WidebandStreamer(config, use_fused=True, device=dev))
    s = WB.WidebandStreamer(config, use_fused=True, device=dev)
    FC.reset_launch_counts()
    got = run(s)
    assert FC.LAUNCHES["pfb_channelize"] == len(reads)
    for i, (e, g) in enumerate(zip(exp, got)):
        for x, y in zip(e, g):
            assert x.shape == y.shape and np.array_equal(x, y), (residual, i)
    # the usable parts are one and two chunks, whatever the residual
    assert len(s.graphs.keys) == s.graphs.captures == 2
    assert s.graphs.replays == len(reads) - s.graphs.captures > 0
    assert s.graphs.graph is not None


def test_graphed_batch_reads_in_pieces_equal_joined_blocks(dev):
    """``FusedWbfmBatchStreamer(16)`` under graphs, fed 262,144-byte rows
    from one reused read-only (16, 262,144) buffer as the fleet's caller
    hands them: each row's residual and whole chunks written as pieces into
    the staging buffer's rows.  Over 260 reads both keys (2 and 3 chunks a
    row) are captured and replayed, and the audio is bit-equal to a twin
    fed the usable blocks joined, contiguous."""
    stations, rb, n_reads = 16, 262_144, 260
    base = np.random.default_rng(21).integers(
        0, 256, (stations, 8 * rb), dtype=np.uint8)
    scratch = bytearray(stations * rb)
    s = FF.FusedWbfmBatchStreamer(stations, device=dev)
    twin = FF.FusedWbfmBatchStreamer(stations, device=dev)
    pending = base[:, :0]
    widths = []
    for i in range(n_reads):
        rows = base[:, i % 8 * rb:(i % 8 + 1) * rb]
        np.frombuffer(scratch, np.uint8).reshape(stations, rb)[:] = rows
        view = memoryview(scratch).toreadonly()
        got = s.demodulate(np.frombuffer(view, np.uint8).reshape(stations,
                                                                  rb))
        del view
        joined = np.concatenate([pending, rows], axis=1)
        usable = joined.shape[1] - joined.shape[1] % CHUNK
        pending = joined[:, usable:]
        exp = twin.demodulate(np.ascontiguousarray(joined[:, :usable]))
        assert got.shape == exp.shape and np.array_equal(got, exp), i
        assert np.array_equal(s._pending, pending), i
        widths.append(usable // CHUNK)
    assert sorted(set(widths)) == [2, 3] and widths.count(3) >= 2
    assert s.graphs.keys == twin.graphs.keys and len(s.graphs.keys) == 2
    assert (s.graphs.captures, s.graphs.replays) == (2, n_reads - 2)
    assert s.graphs.graph is not None


def test_graph_capture_failure_names_the_streamer(dev):
    """A step that syncs with the host cannot be captured: the error names
    the streamer and the key, and nothing runs eagerly in its place."""
    from tpu_sdr_torch.utils import graphs

    def step(static, inputs, carries):
        x = inputs[0] * 2
        if float(x.sum()) > 1e30:  # a host sync inside the step
            x = x * 0
        return [x], [carries[0] + 1], None

    g = graphs.StepGraphs("syncing", step, dev)
    with pytest.raises(graphs.GraphCaptureError, match="syncing"):
        g((), [np.ones(8, np.float32)], [torch.zeros(1, device=dev)])
    assert g.keys == [] and g.graph is None


def test_exact_chain_step_has_no_hidden_sync(dev):
    """The exact chain's block step (the graphed step's body) on the card
    under ``set_sync_debug_mode("error")``: no op reads a device value on
    the host (a 0-d index tensor turned into an int would)."""
    from tpu_sdr_torch.models import wbfm_exact as TE

    data = np.asarray(synth.synth_wbfm_u8(20_000, seed=13)[0], np.uint8)
    block = torch.from_numpy(data[:32_768]).to(dev)
    config = TE.WbfmExactConfig()
    state = TE.init_state(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            audio, count, state = TE.demodulate_block(block, state, config)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(count) > 0


def test_psd_graphed_reads_do_not_wait_for_the_card(dev):
    """The PSD's form without outputs: after the first read, distinct
    blocks back to back under ``set_sync_debug_mode("error")`` (no D2H
    copy, no synchronize; the staging buffer's fence is an event), then
    the sums bit-equal to ``graphs.disabled()`` on the same blocks: a
    block written into the staging buffer while the previous one's copy
    was in flight would show here."""
    from tpu_sdr_torch.ops import spectrum as SP
    from tpu_sdr_torch.utils import graphs

    rng = np.random.default_rng(14)
    blocks = [rng.integers(0, 256, 262_144, dtype=np.uint8)
              for _ in range(48)]
    with graphs.disabled():
        ref = SP.PsdStreamer(1024, device=dev)
        for b in blocks:
            ref.accumulate(b)
    ps = SP.PsdStreamer(1024, device=dev)
    ps.accumulate(blocks[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in blocks[1:]:
            ps.accumulate(b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (ps.graphs.captures, ps.graphs.replays) == (1, len(blocks) - 1)
    assert ps.segments == ref.segments == 48 * 128
    assert torch.equal(ps.state.acc, ref.state.acc)
    # a hop reset keeps the graph
    ps.reset()
    ps.accumulate(blocks[0])
    assert ps.graphs.captures == 1


def _sharded_function(name, dev):
    """name -> (call(x) -> tensors, three inputs, launches a call)."""
    from tpu_sdr_torch.parallel import channelizer_sharded as CS
    from tpu_sdr_torch.parallel import channelizer_sharded_fused as CSF
    from tpu_sdr_torch.parallel import mesh as PM
    from tpu_sdr_torch.parallel import wbfm_sharded as WS

    rng = np.random.default_rng(len(name))
    if name.startswith("float"):
        dp, sp = 2, 4
        mesh = PM.make_mesh(dp, sp, devices=[dev] * 8)
        carry_io = name == "float_fir"
        chain = WS.make_sharded_wbfm(mesh, design.WbfmConfig(
            filter_mode="fir" if carry_io else "boxcar"), carry_io=carry_io)
        blocks = [rng.integers(0, 256, (dp, 2 * sp * 24_480), dtype=np.uint8)
                  for _ in range(3)]
        state = {"carry": WS.initial_xla_carry(dp, device=dev)}

        def call(b):
            if not carry_io:
                return chain.fn(chain.shard(b))
            audio, counts, state["carry"] = chain.fn(chain.shard(b),
                                                     state["carry"])
            return audio, counts, state["carry"]
        return chain.graphs, call, blocks, {}
    if name == "time_channelizer":
        chan = CS.make_sharded_channelizer(
            PM.make_mesh(1, 4, devices=[dev] * 4), 64)
        xs = [(rng.standard_normal(64 * 4 * 256).astype(np.float32),
               rng.standard_normal(64 * 4 * 256).astype(np.float32))
              for _ in range(3)]
        return chan.graphs, lambda x: chan(*x), xs, {"halo_pull": 2,
                                                     "ring_shift": 3}
    bank = CSF.make_sharded_pfb_fused(PM.make_mesh(1, 4, devices=[dev] * 4))
    chunks = [rng.integers(0, 256, 2 * bank.spec.chunk_bytes, dtype=np.uint8)
              for _ in range(3)]
    state = {"carry": FC.init_carry(bank.spec, dev)}

    def feed(b):
        out = bank(b, state["carry"])
        state["carry"] = out[2]
        return out
    return bank.graphs, feed, chunks, {"pfb_channelize": 4}


def _tensors(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    return []


@pytest.mark.parametrize("name", ["float_fir", "float_boxcar",
                                  "time_channelizer", "pfb_bank"])
def test_graphed_sharded_function_equals_disabled(dev, name):
    """The three sharded functions on logical shards of one card: three
    calls (the second and third replays), bit-equal to
    ``graphs.disabled()``, the kernels' counters the same (two K4 and
    three K5 launches, or four K3, a call), and a result kept from the
    first call unchanged by the later ones."""
    from tpu_sdr_torch.parallel import cuda_halo as CH
    from tpu_sdr_torch.utils import graphs

    def counts():
        return {**FC.LAUNCHES, **CH.LAUNCHES}

    def reset():
        FC.reset_launch_counts()
        CH.reset_launch_counts()

    _, call, inputs, per_call = _sharded_function(name, dev)
    reset()
    with graphs.disabled():
        exp = [_tensors(call(x)) for x in inputs]
    eager = counts()
    steps, call, inputs, _ = _sharded_function(name, dev)
    reset()
    got = [_tensors(call(x)) for x in inputs]
    kept = [t.clone() for t in got[0]]
    got.append(_tensors(call(inputs[0])))
    assert counts() == {k: v * 4 // 3 for k, v in eager.items()}
    assert all(eager[k] == 3 * n for k, n in per_call.items())
    assert (steps.captures, steps.replays) == (1, 3)
    assert steps.graph is not None
    for e, g in zip(exp, got):
        assert len(e) == len(g) > 0
        for x, y in zip(e, g):
            assert x.device == y.device and torch.equal(x, y), name
    for t, k in zip(got[0], kept):
        assert torch.equal(t, k)
