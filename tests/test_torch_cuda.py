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

from tpu_sdr.utils import synth
from tpu_sdr_torch.models import wbfm_wideband as WB
from tpu_sdr_torch.ops import fused_channelizer as FC
from tpu_sdr_torch.ops import fused_fm as FF
from tpu_sdr_torch.utils import design

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


@pytest.mark.parametrize("frames", [3, 256])
def test_fm_resample_kernel_matches_plain(capture, dev, frames):
    taps, h_poly = FF.make_kernel_params(device=dev)
    z, _ = FF.fm_front_reference(torch.from_numpy(capture).to(dev), 0,
                                 FF.init_carry(dev), taps, SPEC.decim)
    z = z[:frames * SPEC.down].contiguous()
    hist = torch.linspace(-0.5, 0.5, SPEC.taps_per_phase - 1, device=dev)
    before = FF.LAUNCHES["fm_resample"]
    a, h = FF.resample(z, hist, h_poly, SPEC.down)
    ar, hr = FF.resample_reference(z, hist, h_poly, SPEC.down)
    assert FF.LAUNCHES["fm_resample"] == before + 1
    assert a.shape == (frames * SPEC.up,)
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
    before = FC.LAUNCHES["pfb_channelize"]
    y_re, y_im, c = FC.channelize(data, carry, m2, spec)
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
    m2 = FC.kernel_matrix(design.design_pfb(64, 8, cutoff_frac=0.95)).to(dev)
    y_re, y_im, c = FC.channelize(data, carry, m2, WB_SPEC)
    y, cr = FC.channelize_reference(data, carry, m2, WB_SPEC)
    assert y_re.shape == (frames, 64)
    assert _snr_db(y.cpu(), torch.cat([y_re, y_im], dim=1).cpu()) >= 100.0
    assert torch.equal(c, cr)


def test_pfb_channelize_rejects_bad_tensors(dev):
    m2 = torch.zeros(9 * 64, 128, device=dev)
    carry = torch.zeros(16, 64, device=dev)
    data = torch.zeros(WB_SPEC.chunk_bytes + 2, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):  # carry on the CPU
        FC.channelize(data[:-2], carry.cpu(), m2, WB_SPEC)
    with pytest.raises(ValueError):  # not 2-byte aligned
        FC.channelize(data[1:-1], carry, m2, WB_SPEC)
    with pytest.raises(ValueError):  # M2 of the wrong width
        FC.channelize(data[:-2], carry, m2[:, :64].contiguous(), WB_SPEC)


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
