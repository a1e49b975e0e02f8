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
from tpu_sdr_torch.ops import fused_fm as FF

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
