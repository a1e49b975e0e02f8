"""tpu_sdr_torch's PFB channelizer against tpu_sdr's.

Weight designers must be bit-equal; the plain front (``pfb_analyze``)
must match the XLA one, and K3's plain version (``channelize_reference``)
the interpreted Pallas kernel, at >=100 dB (same f32 math, other summation
order) with the new carry exactly equal (it is raw input frames).  The CUDA
kernel against this plain version is in tests/test_torch_cuda.py.  Sizes
are those of tests/test_pallas_channelizer.py (K=64, T=8, C=64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sdr.ops import channelizer as JC
from tpu_sdr.ops import pallas_channelizer as pc
from tpu_sdr.ops.fm import u8_to_f32
from tpu_sdr_torch import convert
from tpu_sdr_torch.ops import channelizer as TC
from tpu_sdr_torch.ops import fused_channelizer as FC
from tpu_sdr_torch.utils import design

torch.set_num_threads(1)

K, T, C = 64, 8, 64
CPU = torch.device("cpu")


def _snr_db(ref, got):
    ref = np.asarray(ref, dtype=np.complex128)
    err = np.asarray(got, dtype=np.complex128) - ref
    return 10 * np.log10(np.mean(np.abs(ref) ** 2)
                         / max(np.mean(np.abs(err) ** 2), 1e-30))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    spec = FC.default_spec(K, T, C)
    buf = rng.integers(0, 256, size=3 * spec.chunk_bytes, dtype=np.uint8)
    # a mid-stream carry: 2T frames of x255 integers
    carry = (rng.integers(0, 256, size=(2 * T, K)) * 2 - 255).astype(np.float32)
    return spec, buf, carry


# ---- weight designers ----------------------------------------------------

@pytest.mark.parametrize("k,t,cutoff", [(64, 8, 0.45), (64, 8, 0.95),
                                        (32, 6, 0.45)])
def test_design_copies_bit_equal(k, t, cutoff):
    h = design.design_pfb(k, t, cutoff_frac=cutoff)
    np.testing.assert_array_equal(h, JC.design_pfb(k, t, cutoff_frac=cutoff))
    for got, ref in zip(design.pfb_mxu_matrices(h), JC.pfb_mxu_matrices(h)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(design.channel_frequencies(k, 10.88e6),
                                  JC.channel_frequencies(k, 10.88e6))


@pytest.mark.parametrize("channel_slice", [None, slice(16, 32)])
def test_packed_matrices_bit_equal(channel_slice):
    h = design.design_pfb(K, T)
    hi, lo = FC.make_packed_matrices(h, channel_slice=channel_slice)
    jhi, jlo = pc.make_packed_matrices(h, channel_slice=channel_slice)
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(hi.view(torch.int16).numpy(),
                                  np.asarray(jhi).view(np.int16))
    np.testing.assert_array_equal(lo.view(torch.int16).numpy(),
                                  np.asarray(jlo).view(np.int16))


def test_conv_weights_read_back_to_packed_matrix():
    h = design.design_pfb(K, T)
    np.testing.assert_array_equal(
        convert.pfb_matrix_from_conv_weights(JC.pfb_conv_weights(h)).numpy(),
        TC.packed_matrix(h, device=CPU).numpy())


# ---- plain front against the XLA front -----------------------------------

def test_pfb_analyze_matches_xla(setup):
    _, buf, carry = setup
    h = design.design_pfb(K, T)
    re, im = u8_to_f32(jnp.asarray(buf))
    jstate = JC.PfbState(jnp.asarray(carry[:T] / 255), jnp.asarray(carry[T:] / 255))
    jr, ji, jst = JC.pfb_analyze(re, im, jnp.asarray(h), jstate)

    state = TC.PfbState(torch.from_numpy(carry[:T] / 255),
                        torch.from_numpy(carry[T:] / 255))
    tr, ti, st = TC.pfb_analyze(torch.from_numpy(np.array(re)),
                                torch.from_numpy(np.array(im)),
                                TC.packed_matrix(h, device=CPU), state)
    assert tr.shape == (len(buf) // 2 // K, K)
    snr = _snr_db(np.asarray(jr) + 1j * np.asarray(ji), tr.numpy() + 1j * ti.numpy())
    assert snr >= 100.0, f"pfb_analyze vs XLA: {snr:.1f} dB"
    np.testing.assert_array_equal(st.hist_re.numpy(), np.asarray(jst.hist_re))
    np.testing.assert_array_equal(st.hist_im.numpy(), np.asarray(jst.hist_im))


def test_pfb_analyze_streaming_invariance():
    k, t = 32, 6
    h = design.design_pfb(k, t)
    m2 = TC.packed_matrix(h, device=CPU)
    rng = np.random.default_rng(0)
    re = torch.from_numpy(rng.standard_normal(k * 300).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal(k * 300).astype(np.float32))
    yr, yi, _ = TC.pfb_analyze(re, im, m2, TC.pfb_init(h, CPU))
    st, parts = TC.pfb_init(h, CPU), []
    for s in range(0, re.numel(), k * 100):
        r, i, st = TC.pfb_analyze(re[s:s + k * 100], im[s:s + k * 100], m2, st)
        parts.append((r, i))
    np.testing.assert_allclose(torch.cat([p[0] for p in parts]).numpy(),
                               yr.numpy(), atol=1e-5)
    np.testing.assert_allclose(torch.cat([p[1] for p in parts]).numpy(),
                               yi.numpy(), atol=1e-5)


# ---- K3's plain version against the interpreted Pallas kernel -------------

@pytest.mark.parametrize("channel_slice,local", [(None, None),
                                                 (slice(16, 32), 16)])
def test_channelize_reference_matches_pallas(setup, channel_slice, local):
    _, buf, carry = setup
    h = design.design_pfb(K, T)
    jspec = pc.PallasPfbSpec(K, T + 1, C, local)
    jhi, jlo = pc.make_packed_matrices(h, channel_slice=channel_slice)
    jr, ji, jcarry = pc.channelize_fused(
        jnp.asarray(pc.view_u8_as_i16(buf, jspec)), jnp.asarray(carry), jhi,
        jlo, jspec, interpret=True)

    spec = FC.PfbSpec(K, T + 1, C, local)
    FC.reset_launch_counts()
    y_re, y_im, new = FC.channelize(
        torch.from_numpy(buf), torch.from_numpy(carry), FC.kernel_taps(h),
        spec, channel_offset=channel_slice.start if channel_slice else 0)
    assert FC.LAUNCHES["pfb_channelize"] == 0  # CPU: the plain version
    assert y_re.shape == y_im.shape == (3 * C, spec.out_channels)
    snr = _snr_db(np.asarray(jr) + 1j * np.asarray(ji),
                  y_re.numpy() + 1j * y_im.numpy())
    assert snr >= 100.0, f"channelize_reference vs Pallas: {snr:.1f} dB"
    np.testing.assert_array_equal(new.numpy(), np.asarray(jcarry))


def test_fused_streamer_matches_pallas_streamer(setup):
    spec, buf, _ = setup
    ref = pc.PallasPfbStreamer(K, T, C, interpret=True)
    jr, ji = ref.channelize(buf)
    port = FC.FusedPfbStreamer(K, T, C, device=CPU)
    tr, ti = port.channelize(buf)
    assert _snr_db(jr + 1j * ji, tr + 1j * ti) >= 100.0
    np.testing.assert_array_equal(port.state.numpy(), np.asarray(ref.state))


def test_fused_streamer_split_invariance(setup):
    spec, buf, _ = setup
    full = np.stack(FC.FusedPfbStreamer(K, T, C, device=CPU).channelize(buf))
    two = FC.FusedPfbStreamer(K, T, C, device=CPU)
    cut = spec.chunk_bytes + 2 * K * 5 + 3  # mid-chunk, mid-frame, odd byte
    a = np.stack(two.channelize(buf[:cut]))
    b = np.stack(two.channelize(buf[cut:]))
    assert a.shape[1] == C and two._pending.size == 0
    np.testing.assert_allclose(np.concatenate([a, b], axis=1), full,
                               rtol=1e-5, atol=1e-5)


def test_short_calls_match_one_call(setup):
    """Calls of fewer frames than the carry's H rows keep the stream exact:
    the new carry is the last H frames of [carry | call]."""
    spec, buf, carry = setup
    m2 = FC.kernel_matrix(design.design_pfb(K, T))
    data = torch.from_numpy(buf[:2 * K * 30])
    y_all, c_all = FC.channelize_reference(data, torch.from_numpy(carry), m2,
                                           spec)
    c, parts = torch.from_numpy(carry), []
    for s in range(0, data.numel(), 2 * K * 3):
        y, c = FC.channelize_reference(data[s:s + 2 * K * 3], c, m2, spec)
        parts.append(y)
    np.testing.assert_allclose(torch.cat(parts).numpy(), y_all.numpy(),
                               rtol=1e-5, atol=1e-4)
    assert torch.equal(c, c_all)


def test_tone_lands_in_channel_5():
    n = 2 * C * K
    ph = 2 * np.pi * 5 / K * np.arange(n)
    u8 = np.empty(2 * n, np.uint8)
    u8[0::2] = np.clip(np.round(127.5 + 120 * np.cos(ph)), 0, 255)
    u8[1::2] = np.clip(np.round(127.5 + 120 * np.sin(ph)), 0, 255)
    y_re, y_im = FC.FusedPfbStreamer(K, T, C, device=CPU).channelize(u8)
    power = np.mean(y_re ** 2 + y_im ** 2, axis=0)
    assert int(np.argmax(power)) == 5
    assert power[5] > 20 * np.partition(power, -2)[-2]


def test_carry_and_pfb_state_convert_by_255(setup):
    """The fused front's x255 carry and the plain front's normalised
    state hold the same frames: a plain-front state seeds K3 exactly."""
    _, buf, carry = setup
    h = design.design_pfb(K, T)
    state = FC.pfb_state_from_carry(torch.from_numpy(carry))
    torch.testing.assert_close(FC.carry_from_pfb_state(state),
                               torch.from_numpy(carry), rtol=1e-6, atol=1e-4)
    re, im = u8_to_f32(jnp.asarray(buf))
    pr, pi, _ = TC.pfb_analyze(torch.from_numpy(np.array(re)),
                               torch.from_numpy(np.array(im)),
                               TC.packed_matrix(h, device=CPU), state)
    fr, fi, _ = FC.channelize(torch.from_numpy(buf), torch.from_numpy(carry),
                              FC.kernel_taps(h), FC.default_spec(K, T, C))
    # the two fronts differ only by the split-bf16 weights (~2^-17)
    assert _snr_db(pr + 1j * pi, fr + 1j * fi) >= 90.0


# ---- spec and wrapper checks ------------------------------------------------

def test_spec_rejects_what_the_jax_spec_rejects():
    with pytest.raises(ValueError, match="taps_per_branch"):
        FC.default_spec(64, 4, 256)
    with pytest.raises(AssertionError, match="taps_per_branch"):
        pc.default_spec(64, 4, 256)
    spec = FC.default_spec(64, 8, 680)
    assert spec == pc.default_spec(64, 8, 680)
    assert FC.PfbSpec(64, 9, 680, 16).out_channels == 16


def test_spec_admits_the_1024_channel_bank_and_keeps_k3s_limits():
    """The port's spec admits what K3 computes, all 1,024 output columns
    of the 1024-channel bank, which the JAX spec refuses (2*Ko packed
    lanes of one TPU matmul); odd K and more columns than K stay refused,
    and so do the streamer's chunk conditions."""
    from tpu_sdr_torch.models import wbfm_wideband as WB

    config = WB.WidebandConfig(num_channels=1024, channels=tuple(range(1024)))
    spec = WB.fused_spec(config)
    assert spec == FC.PfbSpec(1024, 9, 680)
    assert spec.out_channels == 1024 and spec.chunk_bytes == 1_392_640
    with pytest.raises(AssertionError, match="packed lanes"):
        pc.PallasPfbSpec(1024, 9, 680).validate()
    FC.PfbSpec(1024, 9, 680, 256).validate()
    with pytest.raises(ValueError, match="must be even"):
        FC.PfbSpec(1023, 9, 680).validate()
    with pytest.raises(ValueError, match="output channels"):
        FC.PfbSpec(64, 9, 680, 128).validate()
    with pytest.raises(ValueError, match="multiple of 8"):
        FC.PfbSpec(1024, 9, 684).validate()
    with pytest.raises(ValueError, match="history longer"):
        FC.PfbSpec(1024, 18, 8).validate()


@pytest.mark.parametrize("nbytes", [0, 2 * K + 2, 2 * K * 3 - 1])
def test_channelize_rejects_partial_frames(nbytes):
    spec = FC.default_spec(K, T, C)
    taps = torch.zeros(T + 1, K)
    with pytest.raises(ValueError):
        FC.channelize(torch.zeros(nbytes, dtype=torch.uint8),
                      FC.init_carry(spec, CPU), taps, spec)


def test_channelize_refuses_other_devices():
    spec = FC.default_spec(K, T, C)
    with pytest.raises(ValueError):
        FC.channelize(torch.zeros(2 * K * 8, dtype=torch.uint8, device="meta"),
                      torch.zeros(2 * T, K, device="meta"),
                      torch.zeros(T + 1, K, device="meta"), spec)
