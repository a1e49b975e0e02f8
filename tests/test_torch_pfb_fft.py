"""K3's own arithmetic on the CPU: a plain-torch emulation of
``csrc/pfb_channelize.cu`` held to three oracles.

The CUDA kernel runs only on the card, so this file repeats what it
computes, step for step, in float32: the tiles of TM frames with their own
history (the carry before the call's first frame, zeros past its end), the
R-tap branch FIR, and at K = 64 the radix-8 x 8 FFT (the same 4 + 4 + 2
butterflies, the twiddle table ``fused_channelizer.twiddles`` with its
folded 1/255, the lanes' butterfly transpose as ``__shfl_xor_sync`` does
it, the output digit order k = j + 8*k2), at other K the direct DFT in the
kernel's summation order (16 partial sums, added pairwise); then the
column window [c0, c0 + Ko).  The oracles: K3's plain version
``channelize_reference`` (the TPU kernel's split-bf16 M2) and the
interpreted Pallas kernel at >=100 dB, and a float64 numpy PFB at
>=130 dB.  The kernel itself against the plain
version is in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sdr.ops import pallas_channelizer as pc
from tpu_sdr_torch.ops import fused_channelizer as FC
from tpu_sdr_torch.utils import design

torch.set_num_threads(1)

T, C = 8, 64
SMS = 132            # the H100's SMs, for the tile choice
RSQRT2 = np.float32(0.70710678118654752)
SUMS = 16            # the direct DFT's partial sums a column


def _snr_db(ref, got):
    ref = np.asarray(ref, dtype=np.complex128)
    err = np.asarray(got, dtype=np.complex128) - ref
    return 10 * np.log10(np.mean(np.abs(ref) ** 2)
                         / max(np.mean(np.abs(err) ** 2), 1e-30))


def _tile_frames(m, K, R):
    """The host's tile choice in ``tsdr_pfb_channelize``."""
    if K == 64 and R == 9:
        return 16 if -(-m // 16) >= 2 * SMS else 8
    return min(32, (96 * 1024 - 8 * K) // (8 * K))


# ---- the emulation --------------------------------------------------------

def _dft4(a0, a1, a2, a3):
    t0, t1 = (a0[0] + a2[0], a0[1] + a2[1]), (a0[0] - a2[0], a0[1] - a2[1])
    t2, t3 = (a1[0] + a3[0], a1[1] + a3[1]), (a1[0] - a3[0], a1[1] - a3[1])
    return ((t0[0] + t2[0], t0[1] + t2[1]), (t1[0] + t3[1], t1[1] - t3[0]),
            (t0[0] - t2[0], t0[1] - t2[1]), (t1[0] - t3[1], t1[1] + t3[0]))


def _dft8(a):
    """``dft8``: a list of 8 (re, im) f32 tensors, natural order."""
    e = _dft4(a[0], a[2], a[4], a[6])
    o = list(_dft4(a[1], a[3], a[5], a[7]))
    o[1] = ((o[1][0] + o[1][1]) * RSQRT2, (o[1][1] - o[1][0]) * RSQRT2)
    o[2] = (o[2][1], -o[2][0])
    o[3] = ((o[3][1] - o[3][0]) * RSQRT2, -(o[3][0] + o[3][1]) * RSQRT2)
    out = [None] * 8
    for k in range(4):
        out[k] = (e[k][0] + o[k][0], e[k][1] + o[k][1])
        out[k + 4] = (e[k][0] - o[k][0], e[k][1] - o[k][1])
    return out


def _transpose8(a):
    """``transpose8``: the lane axis is the last one (8 lanes a frame);
    ``__shfl_xor_sync(v, s)`` reads lane ``j ^ s``."""
    lanes = torch.arange(8)
    for s in (1, 2, 4):
        upper = (lanes & s) != 0
        for i in range(8):
            if i & s:
                continue
            send = tuple(torch.where(upper, a[i][c], a[i | s][c])
                         for c in range(2))
            recv = tuple(x[..., lanes ^ s] for x in send)
            a[i] = tuple(torch.where(upper, recv[c], a[i][c]) for c in range(2))
            a[i | s] = tuple(torch.where(upper, a[i | s][c], recv[c])
                             for c in range(2))
    return a


def _fft64(fr, fi, tw):
    """(.., 64) FIR -> (.., 64) Y/255: lane j takes p = j + 8q."""
    xr = fr.reshape(*fr.shape[:-1], 8, 8)   # [q, j] = p = j + 8q
    xi = fi.reshape(*fi.shape[:-1], 8, 8)
    a = _dft8([(xr[..., q, :], xi[..., q, :]) for q in range(8)])  # k1, lane j
    j = torch.arange(8)
    for k1 in range(8):
        w = tw[j * k1]                         # W64^(j k1) / 255 per lane
        re, im = a[k1]
        a[k1] = (re * w[:, 0] - im * w[:, 1], re * w[:, 1] + im * w[:, 0])
    a = _dft8(_transpose8(a))                  # k2, lane j = k1
    yr = torch.stack([a[k2][0] for k2 in range(8)], dim=-2)  # [k2, k1]
    yi = torch.stack([a[k2][1] for k2 in range(8)], dim=-2)
    return (yr.reshape(*fr.shape[:-1], 64), yi.reshape(*fi.shape[:-1], 64))


def _direct_dft(fr, fi, tw, cols):
    """Each column's K-term sum in ``SUMS`` partial sums, branch p into
    sum p mod SUMS, added pairwise at the end.  Branches past K are zeros,
    which leave a sum as it is, where the kernel skips them.  A block of
    frames at a time, so that the sums stay in the cache."""
    K = fr.shape[-1]
    lead = fr.shape[:-1]
    pad = -K % SUMS
    fr = torch.nn.functional.pad(fr.reshape(-1, K), (0, pad))[:, None]
    fi = torch.nn.functional.pad(fi.reshape(-1, K), (0, pad))[:, None]
    k = torch.as_tensor(cols)[:, None]
    tws = [tw[((p0 + torch.arange(SUMS)) * k) % K].unbind(-1)
           for p0 in range(0, K, SUMS)]          # (cols, SUMS) re, im
    out_r = torch.empty(fr.shape[0], len(cols))
    out_i = torch.empty_like(out_r)
    for b in range(0, fr.shape[0], 32):
        re = torch.zeros(min(32, fr.shape[0] - b), len(cols), SUMS)
        im = torch.zeros_like(re)
        for p0, (w_r, w_i) in zip(range(0, K, SUMS), tws):
            x_r = fr[b:b + 32, :, p0:p0 + SUMS]
            x_i = fi[b:b + 32, :, p0:p0 + SUMS]
            re.add_(-x_i * w_i).add_(x_r * w_r)
            im.add_(x_i * w_r).add_(x_r * w_i)
        s = SUMS // 2
        while s:
            re = re[..., :s] + re[..., s:2 * s]
            im = im[..., :s] + im[..., s:2 * s]
            s //= 2
        out_r[b:b + 32], out_i[b:b + 32] = re[..., 0], im[..., 0]
    return out_r.reshape(*lead, -1), out_i.reshape(*lead, -1)


def emulate(data_u8, carry, taps, spec, c0=0):
    """K3 as the kernel computes it -> ((m, 2Ko) [Y_re | Y_im], carry)."""
    K, R, Ko = spec.num_channels, spec.branch_rows, spec.out_channels
    H = R - 1
    x = data_u8.reshape(-1, K, 2).to(torch.float32) * 2.0 - 255.0
    m = x.shape[0]
    tm = _tile_frames(m, K, R)
    n_tiles = -(-m // tm)
    # the frames a tile loads: the carry before frame 0, zeros past m
    ext_r = torch.cat([carry[:H], x[..., 0], torch.zeros(tm, K)])
    ext_i = torch.cat([carry[H:], x[..., 1], torch.zeros(tm, K)])
    g = torch.arange(n_tiles)[:, None] * tm + torch.arange(tm + H)[None]
    win_r, win_i = ext_r[g], ext_i[g]        # (tiles, TM + H, K)
    fr = torch.zeros(n_tiles, tm, K)
    fi = torch.zeros_like(fr)
    for t in range(R):                       # fmaf(G[t], x[f - t], acc)
        fr = taps[t] * win_r[:, H - t:H - t + tm] + fr
        fi = taps[t] * win_i[:, H - t:H - t + tm] + fi
    tw = FC.twiddles(K)
    if K == 64 and R == 9:
        yr, yi = _fft64(fr, fi, tw)
        yr, yi = yr[..., c0:c0 + Ko], yi[..., c0:c0 + Ko]
    else:
        yr, yi = _direct_dft(fr, fi, tw, list(range(c0, c0 + Ko)))
    y = torch.cat([yr, yi], dim=-1).reshape(n_tiles * tm, 2 * Ko)[:m]
    new = torch.cat([torch.cat([carry[:H], x[..., 0]])[-H:],
                     torch.cat([carry[H:], x[..., 1]])[-H:]])
    return y, new


def pfb64(data_u8, carry, h_poly, spec, c0=0):
    """The exact PFB in float64 numpy: (m, Ko) complex."""
    K, R, Ko = spec.num_channels, spec.branch_rows, spec.out_channels
    H = R - 1
    x = np.asarray(data_u8, np.float64).reshape(-1, K, 2) * 2 - 255
    c = np.asarray(carry, np.float64)
    ext = np.concatenate([c[:H] + 1j * c[H:], x[..., 0] + 1j * x[..., 1]])
    m = x.shape[0]
    G = np.asarray(h_poly, np.float64)
    fir = sum(G[t] * ext[H - t:H - t + m] for t in range(R))
    return np.fft.fft(fir, axis=1)[:, c0:c0 + Ko] / 255.0


# ---- fixtures -------------------------------------------------------------

# (K, Ko, c0): the factored path at full width and three 16-channel
# windows, the direct path at K = 32 full and windowed
CASES = [(64, None, 0), (64, 16, 0), (64, 16, 16), (64, 16, 48),
         (32, None, 0), (32, 8, 8)]


def _inputs(K, frames, seed):
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, size=2 * K * frames, dtype=np.uint8)
    carry = (rng.integers(0, 256, size=(2 * T, K)) * 2 - 255).astype(np.float32)
    return buf, carry


def _spec(K, Ko):
    return FC.PfbSpec(K, T + 1, C, Ko)


def _complex(y, Ko):
    y = np.asarray(y)
    return y[:, :Ko] + 1j * y[:, Ko:]


# ---- the oracles ----------------------------------------------------------

@pytest.mark.parametrize("K,Ko,c0", CASES)
def test_emulation_matches_plain_version(K, Ko, c0):
    spec = _spec(K, Ko)
    ko = spec.out_channels
    buf, carry = _inputs(K, 3 * C, seed=K + c0)
    h = design.design_pfb(K, T, cutoff_frac=0.95)
    data, c = torch.from_numpy(buf), torch.from_numpy(carry)
    y, new = emulate(data, c, FC.kernel_taps(h), spec, c0)
    y_ref, c_ref = FC.channelize_reference(
        data, c, FC.kernel_matrix(h, slice(c0, c0 + ko)), spec)
    assert y.shape == (3 * C, 2 * ko)
    snr = _snr_db(_complex(y_ref, ko), _complex(y, ko))
    assert snr >= 100.0, f"emulation vs plain version: {snr:.1f} dB"
    assert torch.equal(new, c_ref)


@pytest.mark.parametrize("K,Ko,c0", CASES)
def test_emulation_matches_pallas(K, Ko, c0):
    spec = _spec(K, Ko)
    ko = spec.out_channels
    buf, carry = _inputs(K, 3 * C, seed=2 * K + c0)
    h = design.design_pfb(K, T)
    jspec = pc.PallasPfbSpec(K, T + 1, C, Ko)
    jhi, jlo = pc.make_packed_matrices(h, channel_slice=slice(c0, c0 + ko))
    jr, ji, jcarry = pc.channelize_fused(
        jnp.asarray(pc.view_u8_as_i16(buf, jspec)), jnp.asarray(carry), jhi,
        jlo, jspec, interpret=True)
    y, new = emulate(torch.from_numpy(buf), torch.from_numpy(carry),
                     FC.kernel_taps(h), spec, c0)
    snr = _snr_db(np.asarray(jr) + 1j * np.asarray(ji), _complex(y, ko))
    assert snr >= 100.0, f"emulation vs Pallas: {snr:.1f} dB"
    np.testing.assert_array_equal(new.numpy(), np.asarray(jcarry))


@pytest.mark.parametrize("K,Ko,c0", CASES)
def test_emulation_matches_float64_pfb(K, Ko, c0):
    """The factored f32 form against the exact PFB: closer than the plain
    version, whose split-bf16 M2 rounds at ~2^-17."""
    spec = _spec(K, Ko)
    ko = spec.out_channels
    buf, carry = _inputs(K, 1000, seed=3 * K + c0)
    h = design.design_pfb(K, T, cutoff_frac=0.95)
    y, _ = emulate(torch.from_numpy(buf), torch.from_numpy(carry),
                   FC.kernel_taps(h), spec, c0)
    snr = _snr_db(pfb64(buf, carry, h, spec, c0), _complex(y, ko))
    assert snr >= 130.0, f"emulation vs float64 PFB: {snr:.1f} dB"


# ---- tiles, short calls, streaming ----------------------------------------

@pytest.mark.parametrize("frames", [1, 3, 1003, 5440, 8459])
def test_ragged_and_short_calls(frames):
    """Frame counts that are no whole number of tiles (1,003 and 8,459 at
    TM = 8 and 16), shorter than the 8-frame history (1, 3: the carry
    shifts), and the CLI's 5,440-frame read."""
    K = 64
    spec = _spec(K, None)
    buf, carry = _inputs(K, frames, seed=frames)
    h = design.design_pfb(K, T, cutoff_frac=0.95)
    data, c = torch.from_numpy(buf), torch.from_numpy(carry)
    y, new = emulate(data, c, FC.kernel_taps(h), spec)
    y_ref, c_ref = FC.channelize_reference(data, c, FC.kernel_matrix(h), spec)
    assert y.shape == (frames, 2 * K)
    assert _snr_db(_complex(y_ref, K), _complex(y, K)) >= 100.0
    assert _snr_db(pfb64(buf, carry, h, spec), _complex(y, K)) >= 130.0
    assert torch.equal(new, c_ref)


@pytest.mark.parametrize("K", [64, 32])
def test_streaming_split_invariance(K):
    """Calls of 5, 2 and 293 frames chained through the carry give the one
    call's output bit for bit: a frame's arithmetic does not depend on
    where the call or the tile starts."""
    spec = _spec(K, None)
    buf, carry = _inputs(K, 300, seed=7)
    taps = FC.kernel_taps(design.design_pfb(K, T))
    data = torch.from_numpy(buf)
    y_all, c_all = emulate(data, torch.from_numpy(carry), taps, spec)
    c, parts, s = torch.from_numpy(carry), [], 0
    for n in (5, 2, 293):
        y, c = emulate(data[2 * K * s:2 * K * (s + n)], c, taps, spec)
        parts.append(y)
        s += n
    assert torch.equal(torch.cat(parts), y_all)
    assert torch.equal(c, c_all)


def test_twiddle_table():
    """exp(-2 pi i n / K) / 255 rounded once from float64."""
    tw = FC.twiddles(64).numpy()
    exact = np.exp(-2j * np.pi * np.arange(64) / 64) / 255.0
    assert tw.shape == (64, 2) and tw.dtype == np.float32
    np.testing.assert_array_equal(tw[:, 0], exact.real.astype(np.float32))
    np.testing.assert_array_equal(tw[:, 1], exact.imag.astype(np.float32))


def test_transpose8_is_a_transpose():
    v = torch.arange(64, dtype=torch.float32).reshape(8, 8)  # [lane, i]
    out = _transpose8([(v[:, i], -v[:, i]) for i in range(8)])
    got = torch.stack([out[i][0] for i in range(8)], dim=1)
    assert torch.equal(got, v.T)


# ---- K = 1024: the direct DFT of the 1024-channel bank ------------------

BANK_K, BANK_C = 1024, 680   # the bank's width, one chunk of its streamer


@pytest.mark.parametrize("Ko,c0", [(None, 0), (256, 768)])
def test_direct_path_at_1024_channels(Ko, c0):
    """The direct DFT at K = 1024 over one 680-frame chunk, all 1,024
    columns and the last 256-column window: against the float64 PFB
    (>=130 dB) and the plain version (>=100 dB, carry equal)."""
    spec = FC.PfbSpec(BANK_K, T + 1, BANK_C, Ko)
    spec.validate()
    ko = spec.out_channels
    buf, carry = _inputs(BANK_K, BANK_C, seed=BANK_K + c0)
    h = design.design_pfb(BANK_K, T, cutoff_frac=0.95)
    data, c = torch.from_numpy(buf), torch.from_numpy(carry)
    y, new = emulate(data, c, FC.kernel_taps(h), spec, c0)
    assert y.shape == (BANK_C, 2 * ko)
    snr = _snr_db(pfb64(buf, carry, h, spec, c0), _complex(y, ko))
    assert snr >= 130.0, f"emulation vs float64 PFB: {snr:.1f} dB"
    y_ref, c_ref = FC.channelize_reference(
        data, c, FC.kernel_matrix(h, slice(c0, c0 + ko)), spec)
    snr = _snr_db(_complex(y_ref, ko), _complex(y, ko))
    assert snr >= 100.0, f"emulation vs plain version: {snr:.1f} dB"
    assert torch.equal(new, c_ref)


def test_direct_path_at_1024_channels_matches_pallas():
    """The 256-column window from column 768, the widest the JAX spec
    admits at K = 1024, against the interpreted Pallas kernel."""
    Ko, c0 = 256, 768
    spec = FC.PfbSpec(BANK_K, T + 1, BANK_C, Ko)
    buf, carry = _inputs(BANK_K, BANK_C, seed=7 * BANK_K)
    h = design.design_pfb(BANK_K, T)
    jspec = pc.PallasPfbSpec(BANK_K, T + 1, BANK_C, Ko)
    jspec.validate()
    jhi, jlo = pc.make_packed_matrices(h, channel_slice=slice(c0, c0 + Ko))
    jr, ji, jcarry = pc.channelize_fused(
        jnp.asarray(pc.view_u8_as_i16(buf, jspec)), jnp.asarray(carry), jhi,
        jlo, jspec, interpret=True)
    y, new = emulate(torch.from_numpy(buf), torch.from_numpy(carry),
                     FC.kernel_taps(h), spec, c0)
    snr = _snr_db(np.asarray(jr) + 1j * np.asarray(ji), _complex(y, Ko))
    assert snr >= 100.0, f"emulation vs Pallas: {snr:.1f} dB"
    np.testing.assert_array_equal(new.numpy(), np.asarray(jcarry))


def test_only_the_jax_spec_keeps_the_lane_limit():
    """The one deliberate difference between the two specs: the JAX spec
    refuses more than 256 output columns (2*Ko packed lanes of one TPU
    matmul), the port's admits all 1,024 of the bank, which K3 computes."""
    with pytest.raises(AssertionError, match="packed lanes"):
        pc.PallasPfbSpec(BANK_K, T + 1, BANK_C).validate()
    FC.PfbSpec(BANK_K, T + 1, BANK_C).validate()
    for Ko in (16, 256):
        pc.PallasPfbSpec(BANK_K, T + 1, BANK_C, Ko).validate()
        FC.PfbSpec(BANK_K, T + 1, BANK_C, Ko).validate()
