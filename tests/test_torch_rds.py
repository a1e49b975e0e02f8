"""tpu_sdr_torch's RDS receiver against tpu_sdr's.

The DSP half (``baseband_block``, in PyTorch) must agree with JAX's to
>= 100 dB on the baseband, and the bits and text events that the host
half makes of both must be equal: a bit is the sign of a soft sum, so this
is checked, not implied.  The host half is the JAX group layer copied;
the JAX tests of that layer run here on the port's copy.
"""

import numpy as np
import pytest
import torch

from tpu_sdr.models import rds as JR
from tpu_sdr_torch import convert
from tpu_sdr_torch.models import rds as R

torch.set_num_threads(1)

CPU = torch.device("cpu")
FS = 170_000


def _snr_db(ref, got):
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))


def _synth_mpx(n_bits: int, seed: int = 4, bits: np.ndarray | None = None,
               fs: int = FS):
    """Standard multiplex: mono tone + pilot + RDS BPSK at 3x pilot."""
    if bits is None:
        rng = np.random.default_rng(seed)
        bits = rng.integers(0, 2, n_bits).astype(np.uint8)
    d = np.bitwise_xor.accumulate(bits)  # differential encode
    n = int(np.ceil((n_bits + 2) / R.RDS_RATE * fs))
    n -= n % 85  # resampler alignment
    t = np.arange(n) / fs
    theta = 2 * np.pi * 19_000.0 * t
    tb = t * R.RDS_RATE
    k = np.minimum(tb.astype(int), n_bits - 1)
    frac = tb - tb.astype(int)
    sign = np.where(d[k] == 0, 1.0, -1.0) * np.where(frac < 0.5, 1.0, -1.0)
    mpx = (0.4 * np.sin(2 * np.pi * 1_000.0 * t)
           + 0.1 * np.cos(theta)
           + 0.06 * sign * np.cos(3 * theta))
    return mpx.astype(np.float32), bits


def _groups_bits(groups, repeats: int = 3) -> np.ndarray:
    return np.concatenate([np.concatenate(groups)] * repeats)


def _text_bits(pi=0xF201, ps="TPU SDR!", rt="HELLO FROM TPU_SDR\r",
               repeats=3) -> np.ndarray:
    """PS (0A, with a method-A AF list), RT (2A) and CT (4A) groups."""
    rt = rt + " " * (-len(rt) % 4)
    af = [(227 << 8) | 110, (1 << 8) | 204]
    groups = [R.make_group_0a(pi, 9, seg, ps[2 * seg: 2 * seg + 2],
                              af=af[seg % 2]) for seg in range(4)]
    groups += [R.make_group_2a(pi, 9, seg, rt[4 * seg: 4 * seg + 4])
               for seg in range(len(rt) // 4)]
    groups += [R.make_group_4a(pi, 61272, 10, 30, offset_half_hours=4, pty=9)]
    return _groups_bits(groups, repeats)


@pytest.fixture(scope="module")
def text_mpx():
    bits = _text_bits()
    mpx, _ = _synth_mpx(len(bits), bits=bits)
    return mpx


@pytest.mark.parametrize("mpx_rate", [170_000, 340_000])
def test_baseband_matches_jax(mpx_rate):
    """At the mono chain's rate and at the stereo front's 340 kHz
    (``RdsConfig.for_mpx_rate``), in two calls cut mid-frame."""
    mpx, _ = _synth_mpx(1_200, fs=mpx_rate)
    jcfg = JR.RdsConfig.for_mpx_rate(mpx_rate)
    cfg = R.RdsConfig.for_mpx_rate(mpx_rate)
    assert cfg.pilot_taps == jcfg.pilot_taps and cfg.post_taps == jcfg.post_taps
    ref, port = JR.RdsReceiver(jcfg), R.RdsReceiver(cfg, device=CPU)
    cut = len(mpx) // 3 + 7
    exp = np.concatenate([ref.process(mpx[:cut]), ref.process(mpx[cut:])])
    got = np.concatenate([port.process(mpx[:cut]), port.process(mpx[cut:])])
    assert got.shape == exp.shape and got.dtype == np.float32
    assert _snr_db(exp, got) >= 100.0
    assert port.pilot_amp == pytest.approx(ref.pilot_amp, rel=1e-5)
    np.testing.assert_array_equal(R.decode_bits(got), JR.decode_bits(exp))


def test_stream_decoder_events_equal_jax(text_mpx):
    """PS, RT, AF and CT groups through both streaming receivers, fed in the
    same irregular chunks: the same lock phase, bits and events."""
    ref, port = JR.RdsStreamDecoder(), R.RdsStreamDecoder(device=CPU)
    events = [[], []]
    pos, sizes, i = 0, [7000, 12345, 30000], 0
    while pos < len(text_mpx):
        n = sizes[i % len(sizes)]
        events[0] += ref.feed_mpx(text_mpx[pos:pos + n])
        events[1] += port.feed_mpx(text_mpx[pos:pos + n])
        pos += n
        i += 1
    assert events[1] == events[0]
    assert port.phase == ref.phase
    for e in ("PI: F201", "PS: 'TPU SDR!'", "RT: 'HELLO FROM TPU_SDR'",
              "AF: 87.6, 98.5, 107.9 MHz", "CT: 2026-08-20 10:30 UTC+2:00"):
        assert e in events[1], (e, events[1])
    assert port.sync.groups_ok == ref.sync.groups_ok >= 10


def test_stream_decoder_requires_pilot():
    t = np.arange(85 * 3000) / FS
    mpx = (0.4 * np.sin(2 * np.pi * 1_000.0 * t)).astype(np.float32)
    rx = R.RdsStreamDecoder(device=CPU)
    assert rx.feed_mpx(mpx) == [] and not rx.locked


def test_params_and_state_convert():
    """JAX params and a mid-stream JAX state continue in the port: equal
    bits; the port's state, converted back, continues in JAX."""
    import jax

    mpx, _ = _synth_mpx(800)
    a, b = mpx[:85 * 600], mpx[85 * 600:]
    ref = JR.RdsReceiver()
    ref.process(a)
    mid = ref.state
    exp = ref.process(b)
    port = R.RdsReceiver(device=CPU)
    port.params = convert.rds_params_from_jax(ref.params, port.config,
                                              device=CPU)
    port.state = convert.rds_state_from_jax(mid, device=CPU)
    got = port.process(b)
    assert _snr_db(exp, got) >= 100.0

    first = R.RdsReceiver(device=CPU)
    first.process(a)
    back = JR.RdsReceiver()
    back.state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(back.state),
        jax.tree_util.tree_leaves(convert.rds_state_to_jax(first.state)))
    assert _snr_db(exp, back.process(b)) >= 100.0


# ---- the JAX tests of the bit and group layer, on the port's copy ---------

def _best_alignment(got: np.ndarray, want: np.ndarray, max_off: int = 8):
    best = (0.0, 0)
    for off in range(-max_off, max_off + 1):
        if off >= 0:
            m = min(len(got) - off, len(want))
            agree = np.mean(got[off:off + m] == want[:m])
        else:
            m = min(len(got), len(want) + off)
            agree = np.mean(got[:m] == want[-off:-off + m])
        best = max(best, (float(agree), off))
    return best


def test_bits_recovered():
    mpx, bits = _synth_mpx(3000)
    got = R.decode_bits(R.RdsReceiver(device=CPU).process(mpx))
    assert len(got) >= 2500
    agree, off = _best_alignment(got[2:], bits[2:])
    assert agree >= 0.995, f"bit agreement {agree:.3f} (offset {off})"


def test_group_sync_end_to_end():
    words = [(0x3001 + 7 * g, 0x0520 + g, 0xABC0 ^ g, 0x2020 + g)
             for g in range(20)]
    payload = np.concatenate([R.make_group(w) for w in words])
    rng = np.random.default_rng(8)
    bits = np.concatenate([rng.integers(0, 2, 37).astype(np.uint8), payload,
                           rng.integers(0, 2, 40).astype(np.uint8)])
    mpx, _ = _synth_mpx(len(bits), bits=bits)
    groups = R.sync_and_parse(R.decode_bits(
        R.RdsReceiver(device=CPU).process(mpx)))
    assert len(groups) >= 18
    start = [tuple(w) for w in words].index(groups[0])
    for i, g in enumerate(groups[: len(words) - start]):
        assert g == tuple(words[start + i])


def test_group_synchronizer_flywheel():
    words = [(0x1111 + g, 0x2000 + g, 0x3000 + g, 0x4000 + g)
             for g in range(12)]
    bits = np.concatenate([R.make_group(w) for w in words])
    bits = np.concatenate([np.ones(15, np.uint8), bits])  # offset the start
    bits[15 + 104 * 3 + 40] ^= 1          # corrupt group 3
    slip_at = 15 + 104 * 6                # delete a bit before group 6
    bits = np.concatenate([bits[:slip_at], bits[slip_at + 1:]])
    sync = R.GroupSynchronizer(max_bad_groups=2, correct=False)
    got = []
    for chunk in np.array_split(bits, 9):
        got += sync.feed(chunk)
    assert tuple(words[0]) in got and tuple(words[2]) in got
    assert tuple(words[3]) not in got
    assert len([w for w in words[9:] if tuple(w) in got]) == 3


def test_burst_error_correction():
    table = R._burst_table()
    assert len(table) == 367 and 0 not in table
    words = [(0xAAA0 + g, 0x2000 + g, 0x3000 + g, 0x4000 + g)
             for g in range(8)]
    bits = np.concatenate([R.make_group(w) for w in words])
    for off in range(5):
        bits[104 * 2 + 3 + off] ^= 1
    bits[104 * 3 + 26 * 3 + 7] ^= 1
    bits[104 * 3 + 26 * 3 + 10] ^= 1
    for off in range(6):
        bits[104 * 5 + 26 + 2 + off] ^= 1
    sync = R.GroupSynchronizer()
    got = sync.feed(bits)
    assert tuple(words[2]) in got and tuple(words[3]) in got
    assert tuple(words[5]) not in got
    assert sync.blocks_corrected >= 2 and sync.bits_corrected >= 7


def test_correct_block_direct():
    blk = R.make_block(0x1234, "B")
    assert R.correct_block(blk, "B") == (0x1234, 0)
    blk2 = blk.copy()
    blk2[5] ^= 1
    blk2[8] ^= 1  # burst span 4
    assert R.correct_block(blk2, "B") == (0x1234, 2)
    assert R.correct_block(blk2, "A") != (0x1234, 2)  # wrong offset


def test_text_groups():
    """PTY names, method-A AF lists (fillers and 0B skipped), CT with a
    negative offset and MJD 0, and PTYN with its A/B toggle."""
    txt = R.RdsText()
    assert "PTY: 4 (Sport)" in txt.update(
        (0x1234, (0 << 12) | (4 << 5) | 0, 0xE0E0, 0x4142))
    txt = R.RdsText()
    txt.update((0x1234, 0 << 12, (227 << 8) | 110, 0x4142))
    assert "AF: 87.6, 98.5, 107.9 MHz" in txt.update(
        (0x1234, (0 << 12) | 1, (1 << 8) | 204, 0x4344))
    txt = R.RdsText()
    txt.update((0x1234, (0 << 12) | (1 << 11), (227 << 8) | 110, 0x4142))
    assert txt._af_expect == 0
    g = R.make_group_4a(0x1234, 61272, 23, 59, offset_half_hours=-11)
    words = R.sync_and_parse(np.concatenate([g] * 4))
    assert "CT: 2026-08-20 23:59 UTC-5:30" in R.RdsText().update(words[0])
    assert R.RdsText().update((0x1234, 4 << 12, 0, (5 << 12) | (1 << 6))) == [
        "PI: 1234"]
    txt = R.RdsText()
    for seg, quad in ((0, "Foot"), (1, "ball")):
        ev = txt.update(R.sync_and_parse(np.concatenate(
            [R.make_group_10a(0x1234, seg, quad)] * 4))[0])
    assert "PTYN: 'Football'" in ev
    txt.update(R.sync_and_parse(np.concatenate(
        [R.make_group_10a(0x1234, 0, "News", flag=1)] * 4))[0])
    assert txt.ptyn == "Football"
