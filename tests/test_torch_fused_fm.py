"""tpu_sdr_torch's fused chain against tpu_sdr's Pallas kernels.

Part 1 holds the plain versions of K1 (``fm_front_reference``) and K2
(``resample_reference``) against the interpreted Pallas kernels; part 2
the streamer, its carries and the JAX <-> port hand-over.  The CUDA
kernels against these plain versions are in tests/test_torch_cuda.py.
Captures are 2 chunks of 130,560 bytes, as in tests/test_pallas_fm.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sdr.models import wbfm as JW
from tpu_sdr.ops import pallas_fm
from tpu_sdr.utils import synth
from tpu_sdr_torch import convert, kernels
from tpu_sdr_torch.models import wbfm as TW
from tpu_sdr_torch.ops import fm as F
from tpu_sdr_torch.ops import fused_fm as FF

import chip_variants

torch.set_num_threads(1)

JSPEC = pallas_fm.default_spec()
SPEC = FF.default_spec()
CHUNK = SPEC.chunk_bytes  # 130560
CPU = torch.device("cpu")


def _snr_db(ref, got):
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))


def _f32(x):
    return np.array(x, dtype=np.float32)  # a writable copy


@pytest.fixture(scope="module")
def capture():
    u8, _ = synth.synth_wbfm_u8(CHUNK, capture_rate=1_020_000,
                                noise_std=0.02, seed=11)
    u8 = np.asarray(u8, dtype=np.uint8)
    assert len(u8) == 2 * CHUNK
    return u8


@pytest.fixture(scope="module")
def jax_params():
    return pallas_fm.make_kernel_params()


@pytest.fixture(scope="module")
def mid_stream(capture, jax_params):
    """JAX kernel state after the capture's first chunk: a carry with real
    history, previous sample and resampler history."""
    w_hi, w_lo, v = jax_params
    init = jnp.zeros((4, 128), jnp.float32).at[2, 127].set(1.0)
    _, state, hist = pallas_fm.demodulate_fused(
        jnp.asarray(pallas_fm.view_u8_as_i16(capture[:CHUNK], JSPEC)),
        jnp.asarray([0], jnp.int32), init, jnp.zeros(47, jnp.float32),
        w_hi, w_lo, v, JSPEC, interpret=True, rot_impl="broadcast",
        unpack_impl="scale")
    return state, hist


# ---- part 1: plain versions against the interpreted Pallas kernels ------

@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_fm_front_reference_matches_pallas(capture, jax_params, mid_stream,
                                           phase):
    w_hi, w_lo, v = jax_params
    state, hist = mid_stream
    audio, new_state, _ = pallas_fm.demodulate_fused(
        jnp.asarray(pallas_fm.view_u8_as_i16(capture[CHUNK:], JSPEC)),
        jnp.asarray([phase], jnp.int32), state, hist, w_hi, w_lo, v, JSPEC,
        interpret=True, rot_impl="broadcast", unpack_impl="scale")

    taps, h_poly = FF.make_kernel_params(device=CPU)
    z, carry = FF.fm_front_reference(
        torch.from_numpy(capture[CHUNK:]), phase,
        torch.from_numpy(_f32(state)), taps, SPEC.decim)
    assert z.shape == (CHUNK // 2 // SPEC.decim,)
    got, _ = FF.resample_reference(z, torch.from_numpy(_f32(hist)), h_poly,
                                   SPEC.down)
    snr = _snr_db(_f32(audio), got.numpy())
    assert snr >= 100.0, f"fm_front_reference @ phase {phase}: {snr:.1f} dB"
    np.testing.assert_allclose(carry.numpy(), _f32(new_state), rtol=1e-5,
                               atol=1e-4)


def test_resample_reference_matches_pallas(capture, jax_params, mid_stream):
    _, _, v = jax_params
    _, hist = mid_stream
    taps, h_poly = FF.make_kernel_params(device=CPU)
    z, _ = FF.fm_front_reference(torch.from_numpy(capture), 0,
                                 FF.init_carry(CPU), taps, SPEC.decim)
    audio, new_hist = pallas_fm.pallas_resample(
        jnp.asarray(z.numpy()), v, SPEC.up, SPEC.down, hist, interpret=True)
    got, got_hist = FF.resample_reference(z, torch.from_numpy(_f32(hist)),
                                          h_poly, SPEC.down)
    snr = _snr_db(_f32(audio), got.numpy())
    assert snr >= 100.0, f"resample_reference: {snr:.1f} dB"
    np.testing.assert_array_equal(got_hist.numpy(), _f32(new_hist))


# ---- part 2: the streamer, its carries, the hand-over -------------------

def _two_chunks(streamer, capture):
    return np.concatenate([streamer.demodulate(capture[:CHUNK]),
                           streamer.demodulate(capture[CHUNK:])])


def test_streamer_matches_pallas_streamer(capture):
    ref = pallas_fm.PallasWbfmStreamer(interpret=True, rot_impl="broadcast")
    expected = _two_chunks(ref, capture)
    got = _two_chunks(FF.FusedWbfmStreamer(device="cpu"), capture)
    assert got.shape == expected.shape
    snr = _snr_db(expected, got)
    assert snr >= 100.0, f"fused streamer vs Pallas streamer: {snr:.1f} dB"


def test_streamer_matches_f32_chain(capture):
    ref = JW.WbfmStreamer(JW.WbfmConfig(filter_mode="fir", mxu_precision="f32"))
    expected = _two_chunks(ref, capture)
    got = _two_chunks(FF.FusedWbfmStreamer(device="cpu"), capture)
    snr = _snr_db(expected, got)
    assert snr >= 80.0, f"fused streamer vs f32 chain: {snr:.1f} dB"


def test_streamer_one_call_equals_two(capture):
    full = FF.FusedWbfmStreamer(device="cpu").demodulate(capture)
    split = _two_chunks(FF.FusedWbfmStreamer(device="cpu"), capture)
    np.testing.assert_allclose(split, full, rtol=1e-5, atol=1e-6)


def test_streamer_residual_and_phase(capture):
    fs = FF.FusedWbfmStreamer(device="cpu")
    assert fs.demodulate(capture[:CHUNK - 2]).size == 0  # held back
    out = fs.demodulate(capture[CHUNK - 2:CHUNK + 6])     # completes chunk 1
    assert out.size == SPEC.audio_per_chunk
    assert fs.phase == (CHUNK // 2) % 4
    assert fs._pending.size == 6


def test_carry_matches_jax(capture):
    ref = pallas_fm.PallasWbfmStreamer(interpret=True, rot_impl="broadcast")
    port = FF.FusedWbfmStreamer(device="cpu")
    for part in (capture[:CHUNK], capture[CHUNK:]):
        ref.demodulate(part)
        port.demodulate(part)
        carry, hist, phase = convert.state_to_jax(port.state, port.resamp_hist,
                                                  port.phase)
        np.testing.assert_allclose(carry, _f32(ref.state), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(hist, _f32(ref.resamp_hist), rtol=1e-5,
                                   atol=1e-6)
        assert phase == ref.phase


def test_params_from_jax_equal_port_params(jax_params):
    taps, h_poly = convert.params_from_jax(*jax_params, SPEC, device=CPU)
    ptaps, ph_poly = FF.make_kernel_params(device=CPU)
    assert torch.equal(taps, ptaps)
    assert torch.equal(h_poly, ph_poly)


def test_handover_jax_to_port_and_back(capture, jax_params):
    """JAX weights and mid-stream state, converted, continue in the port as
    in the JAX streamer; the port's state converts back the same way."""
    ref = pallas_fm.PallasWbfmStreamer(interpret=True, rot_impl="broadcast")
    expected = _two_chunks(ref, capture)

    jx = pallas_fm.PallasWbfmStreamer(interpret=True, rot_impl="broadcast")
    first = jx.demodulate(capture[:CHUNK])
    port = FF.FusedWbfmStreamer(device="cpu")
    port.model.taps, port.model.h_poly = convert.params_from_jax(
        *jax_params, SPEC, device=CPU)
    port.state, port.resamp_hist, port.phase = convert.state_from_jax(
        jx.state, jx.resamp_hist, jx.phase, device=CPU)
    second = port.demodulate(capture[CHUNK:])
    assert _snr_db(expected, np.concatenate([first, second])) >= 100.0

    back = pallas_fm.PallasWbfmStreamer(interpret=True, rot_impl="broadcast")
    carry, hist, phase = convert.state_to_jax(port.state, port.resamp_hist,
                                              port.phase)
    back.state, back.resamp_hist, back.phase = (jnp.asarray(carry),
                                                jnp.asarray(hist), phase)
    more = synth.synth_wbfm_u8(CHUNK // 2, capture_rate=1_020_000, seed=2)[0]
    np.testing.assert_allclose(port.demodulate(more), back.demodulate(more),
                               rtol=1e-4, atol=1e-5)


def test_float_chain_state_packs_into_fused_chain(capture):
    """pack_state: the float chain's mid-stream state seeds the fused chain
    (the port's twin of test_pallas_fm.test_state_handoff_xla_to_pallas)."""
    fir = TW.WbfmStreamer(device=CPU)
    first = fir.demodulate(capture[:CHUNK])
    fused = FF.FusedWbfmStreamer(device="cpu")
    fused.state = FF.pack_state(fir.state, SPEC)
    fused.resamp_hist = fir.state.resamp.hist
    fused.phase = fir.state.rot
    second = fused.demodulate(capture[CHUNK:])
    ref = TW.WbfmStreamer(device=CPU)
    assert _snr_db(ref.demodulate(capture),
                   np.concatenate([first, second])) >= 80.0

    st = FF.unpack_state(fused.state, fused.phase, fused.resamp_hist, SPEC)
    packed = FF.pack_state(st, SPEC)
    Lm1 = SPEC.num_taps - 1
    torch.testing.assert_close(packed[:2, :Lm1], fused.state[:2, :Lm1])
    assert torch.equal(packed[2:, -1], fused.state[2:, -1])
    assert st.rot == fused.phase


def test_cpu_tensors_take_the_plain_versions(capture):
    FF.reset_launch_counts()
    FF.FusedWbfmStreamer(device="cpu").demodulate(capture)
    assert FF.LAUNCHES == {"fm_front": 0, "fm_resample": 0}


# ---- part 3: K1's tensor-core tiling, emulated in plain torch -------------

def _f16(x):
    return x.to(torch.float16).to(torch.float32)


def _fm_front_tiled(data_u8, phase, carry, taps, decim):
    """Plain-torch emulation of csrc/fm_front.cu's arithmetic: rows of 8
    outputs over the rotated x255 samples in f16 (exact; row g starts at
    8dg - (L-1) - delta), one (16 ks x 8) band scaled by 2^e and split into
    f16 hi + lo; zero bytes (x = -255, rotated) before the block, their
    windows swapped for the carry's f32 history; every predecessor the
    band's own previous output (the kernel's tiles recompute the group
    before them), output 0's the carry's."""
    n, L, d = data_u8.numel() // 2, taps.numel(), decim
    M = n // d
    delta = (1 - L) % 8
    ks = max(8, -(-(delta + 7 * d + L) // 16))
    x = data_u8.reshape(n, 2).to(torch.float32) * 2.0 - 255.0
    re, im, _ = F.rotate_fs4(x[:, 0], x[:, 1], phase)
    zero_re, zero_im, _ = F.rotate_fs4(torch.full((4,), -255.0),
                                       torch.full((4,), -255.0), 0)

    def stream(k):  # the staged samples; zero bytes outside the block
        inside = (k >= 0) & (k < n)
        rot = (k + phase) % 4
        out = torch.stack([zero_re[rot], zero_im[rot]])
        out[0, inside], out[1, inside] = re[k[inside]], im[k[inside]]
        return _f16(out)

    e = 15 - int(np.frexp(float(taps.abs().max()))[1])
    s = torch.arange(16 * ks)
    j = s[:, None] - delta - d * torch.arange(8)[None, :]
    band = torch.where((j >= 0) & (j < L), taps[j.clamp(0, L - 1)], 0.0) * 2.0 ** e
    hi = _f16(band)
    lo = _f16(band - hi)
    groups = -(-M // 8)
    rows = 8 * d * torch.arange(groups)[:, None] - (L - 1) - delta + s[None]
    A = stream(rows.reshape(-1)).reshape(2, groups, 16 * ks)
    y = (A @ hi + A @ lo).reshape(2, -1)[:, :M] * 2.0 ** -e  # (re/im, M)

    for m in range(min(M, -(-(L - 1) // d))):  # windows into the history
        k = d * m - (L - 1) + torch.arange(L)
        h = k < 0
        garbage = stream(k[h])
        y[:, m] += (carry[:2, (L - 1) + k[h]] - garbage) @ taps[h]

    pred = torch.cat([carry[2:4, LANES - 1:], y[:, :-1]], dim=1)
    c_re = y[0] * pred[0] + y[1] * pred[1]
    c_im = y[1] * pred[0] - y[0] * pred[1]
    z = FF.atan2_poly6(c_im, c_re) * (1.0 / np.pi)
    new = carry.clone()
    xr = torch.cat([carry[0, :L - 1], re])
    xi = torch.cat([carry[1, :L - 1], im])
    new[0, :L - 1], new[1, :L - 1] = xr[n:], xi[n:]
    new[2:4] = torch.cat([carry[2:4], y], dim=1)[:, -LANES:]
    return z, new


LANES = FF.LANES


def _assert_front_equal(z, c, z_ref, c_ref):
    assert z.shape == z_ref.shape
    snr = _snr_db(z_ref.numpy(), z.numpy())
    assert snr >= 100.0, f"tiled K1 vs plain: {snr:.1f} dB"
    assert torch.equal(c[:2], c_ref[:2])
    np.testing.assert_allclose(c[2:].numpy(), c_ref[2:].numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_tiled_fm_front_matches_plain_and_pallas(capture, jax_params,
                                                 mid_stream, phase):
    """Two chunks (21,760 outputs: 181.3 warp tiles of 120)
    from a mid-stream carry, at every phase: against the plain version and,
    through the plain resampler, the interpreted Pallas kernel."""
    w_hi, w_lo, v = jax_params
    state, hist = mid_stream
    taps, h_poly = FF.make_kernel_params(device=CPU)
    data = torch.from_numpy(capture)
    carry = torch.from_numpy(_f32(state))
    z, c = _fm_front_tiled(data, phase, carry, taps, SPEC.decim)
    _assert_front_equal(z, c, *FF.fm_front_reference(data, phase, carry, taps,
                                                     SPEC.decim))

    audio, new_state, _ = pallas_fm.demodulate_fused(
        jnp.asarray(pallas_fm.view_u8_as_i16(capture, JSPEC)),
        jnp.asarray([phase], jnp.int32), state, hist, w_hi, w_lo, v, JSPEC,
        interpret=True, rot_impl="broadcast", unpack_impl="scale")
    got, _ = FF.resample_reference(z, torch.from_numpy(_f32(hist)), h_poly,
                                   SPEC.down)
    assert _snr_db(_f32(audio), got.numpy()) >= 100.0
    np.testing.assert_allclose(c.numpy(), _f32(new_state), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("outputs", [50, 127, 1000, 4099])
def test_tiled_fm_front_ragged_calls(capture, outputs):
    """Fewer outputs than the carry's 128 lanes, partial rows of 8 and
    partial tiles, from a carry whose history is not x255 integers (the
    residual path)."""
    taps, _ = FF.make_kernel_params(device=CPU)
    data = torch.from_numpy(capture[:2 * SPEC.decim * outputs])
    rng = np.random.default_rng(outputs)
    carry = FF.init_carry(CPU)
    carry[:2] = torch.from_numpy(rng.uniform(-255, 255, (2, LANES))
                                 .astype(np.float32))
    carry[2:] = torch.from_numpy(rng.uniform(-1, 1, (2, LANES))
                                 .astype(np.float32))
    z, c = _fm_front_tiled(data, 3, carry, taps, SPEC.decim)
    _assert_front_equal(z, c, *FF.fm_front_reference(data, 3, carry, taps,
                                                     SPEC.decim))


@pytest.mark.parametrize("L,decim", [(40, 3), (129, 1), (33, 11)])
def test_tiled_fm_front_other_shapes(capture, L, decim):
    """Other tap counts and decimations (the kernel's generic form: other
    row shifts, halos and band depths) with taps that are sums of two
    bf16, as make_kernel_params gives them."""
    rng = np.random.default_rng(L)
    w = torch.from_numpy(rng.standard_normal(L).astype(np.float32)) / (L * 255)
    hi = w.to(torch.bfloat16).to(torch.float32)
    taps = hi + (w - hi).to(torch.bfloat16).to(torch.float32)
    n = decim * 3001
    data = torch.from_numpy(capture[:2 * n])
    _, carry = FF.fm_front_reference(torch.from_numpy(capture[-2 * n:]), 1,
                                     FF.init_carry(CPU), taps, decim)
    z, c = _fm_front_tiled(data, 2, carry, taps, decim)
    _assert_front_equal(z, c, *FF.fm_front_reference(data, 2, carry, taps,
                                                     decim))


@pytest.mark.parametrize("nbytes,phase", [(2 * 6 * 10 + 2, 0), (3, 0),
                                          (2 * 6 * 10, 4)])
def test_fm_front_rejects_bad_arguments(nbytes, phase):
    taps, _ = FF.make_kernel_params(device=CPU)
    with pytest.raises(ValueError):
        FF.fm_front(torch.zeros(nbytes, dtype=torch.uint8), phase,
                    FF.init_carry(CPU), taps, SPEC.decim)


def test_wrappers_refuse_other_devices():
    taps = torch.zeros(72, device="meta")
    with pytest.raises(ValueError):
        FF.fm_front(torch.zeros(1200, dtype=torch.uint8, device="meta"), 0,
                    torch.zeros(4, 128, device="meta"), taps, SPEC.decim)
    with pytest.raises(ValueError):
        FF.resample(torch.zeros(170, device="meta"),
                    torch.zeros(47, device="meta"),
                    torch.zeros(16, 48, device="meta"), SPEC.down)


def test_small_calls_match_one_big_call(capture):
    """Calls shorter than the carry's 128 lanes (any n % decim == 0) keep
    the stream exact: the carry rows shift instead of being replaced."""
    taps, _ = FF.make_kernel_params(device=CPU)
    data = torch.from_numpy(capture[:2 * 6 * 300])
    z_all, c_all = FF.fm_front_reference(data, 1, FF.init_carry(CPU), taps, 6)
    carry, parts, phase = FF.init_carry(CPU), [], 1
    for s in range(0, data.numel(), 2 * 6 * 50):
        z, carry = FF.fm_front_reference(data[s:s + 600], phase, carry, taps, 6)
        parts.append(z)
        phase = (phase + 300) % 4
    np.testing.assert_allclose(torch.cat(parts).numpy(), z_all.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(carry.numpy(), c_all.numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("name", sorted(chip_variants.VARIANTS))
def test_chip_variants_patches_match_the_kernel_sources(name):
    """chip_variants.py's text patches of K1, K2 and K3 each match the source
    they patch exactly once, so an edit of a kernel shows here, not first
    on the card."""
    _, fname, patches = chip_variants.VARIANTS[name]
    with open(os.path.join(kernels.SRC_DIR, fname)) as f:
        src = f.read()
    for old, _ in patches:
        assert src.count(old) == 1, (name, old)
