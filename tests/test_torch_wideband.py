"""tpu_sdr_torch's wideband multi-station receiver against tpu_sdr's.

One synthetic capture of 348,160 complex samples at 10.88 Msps (one
696,320-byte ``multi_fm`` read: 64 quanta of the plain front, 8 chunks of
K3's) holds stations at channels 3 and 60, as tests/test_wideband.py.  The
port's ``WidebandStreamer`` must match the JAX one at >=100 dB with each
front (plain against the XLA front, fused against the interpreted Pallas
front), recover both tones at >=25 dB with >=20 dB crosstalk rejection,
take over a JAX mid-stream state through ``convert``, and its ``multi_fm``
CLI must write the same audio on the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sdr.models import wbfm_wideband as JWB
from tpu_sdr.ops import channelizer as JC
from tpu_sdr.ops import fm as JF
from tpu_sdr.ops import pallas_channelizer as pc
from tpu_sdr.utils import synth
from tpu_sdr_torch import convert
from tpu_sdr_torch.apps import multi_fm
from tpu_sdr_torch.models import wbfm_wideband as WB
from tpu_sdr_torch.ops import fm as TF
from tpu_sdr_torch.ops import fused_channelizer as FC
from tpu_sdr_torch.utils import synth as tsynth

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CHANNELS = (3, 60)
TONES = (1_000.0, 2_500.0)
N_COMPLEX = 348_160
HALF = N_COMPLEX  # bytes: half the capture, 4 chunks / 32 quanta
FRONTS = ["plain", "fused"]


def _snr_db(ref, got):
    ref = np.asarray(ref, dtype=np.float64)
    err = np.asarray(got, dtype=np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / max(np.mean(err ** 2), 1e-30))


def _jax_config(**kw):
    return JWB.WidebandConfig(num_channels=64, channels=CHANNELS, **kw)


def _port_config(**kw):
    return WB.WidebandConfig(num_channels=64, channels=CHANNELS, **kw)


def _jax_streamer(front, **kw):
    if front == "fused":
        return JWB.WidebandStreamer(_jax_config(**kw), use_pallas=True,
                                    interpret=True)
    return JWB.WidebandStreamer(_jax_config(**kw))


def _port_streamer(front, **kw):
    return WB.WidebandStreamer(_port_config(**kw), use_fused=front == "fused",
                               device=CPU)


@pytest.fixture(scope="module")
def capture():
    ch_rate = 170_000
    u8, _ = synth.synth_multistation_u8(
        N_COMPLEX, 64 * ch_rate, station_freqs=[3 * ch_rate, -4 * ch_rate],
        audio_freqs=list(TONES), deviation=45_000.0)
    return np.asarray(u8, dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_audio(capture):
    return {front: _jax_streamer(front).demodulate(capture) for front in FRONTS}


@pytest.fixture(scope="module")
def port_audio(capture):
    return {front: _port_streamer(front).demodulate(capture)
            for front in FRONTS}


def test_config_matches_jax():
    assert (dataclasses.asdict(WB.WidebandConfig())
            == dataclasses.asdict(JWB.WidebandConfig()))
    config = WB.WidebandConfig()
    assert config.capture_rate == JWB.WidebandConfig().capture_rate == 10_880_000
    assert (config.resample_up, config.resample_down) == (16, 85)
    assert WB.fused_spec(config).chunk_bytes == 87_040


@pytest.mark.parametrize("front", FRONTS)
def test_streamer_matches_jax(jax_audio, port_audio, front):
    ref, got = jax_audio[front], port_audio[front]
    assert got.shape == ref.shape == (2, N_COMPLEX // 64 // 85 * 16)
    snr = _snr_db(ref, got)
    assert snr >= 100.0, f"{front} front vs JAX: {snr:.1f} dB"


@pytest.mark.parametrize("front", FRONTS)
def test_stations_recovered_and_isolated(port_audio, front):
    audio = port_audio[front]
    for s, tone in enumerate(TONES):
        snr = synth.tone_snr(audio[s], tone, 32_000, skip=400)
        assert snr >= 25.0, f"station {CHANNELS[s]}: tone SNR {snr:.1f} dB"
    want = synth.tone_snr(audio[0], TONES[0], 32_000, skip=400)
    leak = synth.tone_snr(audio[0], TONES[1], 32_000, skip=400)
    assert want - leak >= 20.0, f"crosstalk: {want:.1f} vs {leak:.1f} dB"


def test_fused_front_matches_plain_front(port_audio):
    snr = _snr_db(port_audio["plain"], port_audio["fused"])
    assert snr >= 70.0, f"fused vs plain front: {snr:.1f} dB"


@pytest.mark.parametrize("front", FRONTS)
def test_streaming_split_invariance(capture, port_audio, front):
    s = _port_streamer(front)
    cut = 87_040 * 3 + 1_001  # mid-chunk and mid-quantum, odd byte
    split = np.concatenate([s.demodulate(capture[:cut]),
                            s.demodulate(capture[cut:])], axis=1)
    np.testing.assert_allclose(split, port_audio[front], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("front", FRONTS)
def test_emit_mpx_matches_jax(capture, front):
    ref = _jax_streamer(front, emit_mpx=True)
    port = _port_streamer(front, emit_mpx=True)
    ref.demodulate(capture[:HALF])
    port.demodulate(capture[:HALF])
    assert port.last_mpx.shape == ref.last_mpx.shape == (2, N_COMPLEX // 128)
    assert _snr_db(ref.last_mpx, port.last_mpx) >= 100.0


@pytest.mark.parametrize("front", FRONTS)
def test_jax_state_continues_in_port_and_back(capture, jax_audio, front):
    """JAX weights and mid-stream state, converted, continue in the port as
    in the JAX streamer; the port's state converts back the same way."""
    jx = _jax_streamer(front)
    first = jx.demodulate(capture[:HALF])
    port = _port_streamer(front)
    h = JC.design_pfb(64, 8, cutoff_frac=0.95)
    m2_hi, m2_lo = pc.make_packed_matrices(h)
    port.params = convert.wideband_params_from_jax(
        jx.params, m2_hi, m2_lo, port.config, device=CPU)
    port.state = convert.wideband_state_from_jax(jx.state, device=CPU)
    if front == "fused":
        port.pfb_carry = convert.pfb_carry_from_jax(jx.pfb_carry, device=CPU)
    second = port.demodulate(capture[HALF:])
    got = np.concatenate([first, second], axis=1)
    assert _snr_db(jax_audio[front], got) >= 100.0

    back = _jax_streamer(front)
    pfb, quad, resamp = convert.wideband_state_to_jax(port.state)
    back.state = JWB.WidebandState(
        JC.PfbState(*map(jnp.asarray, pfb)), JF.QuadState(*map(jnp.asarray, quad)),
        JF.AlignedResampleState(jnp.asarray(resamp[0])))
    if front == "fused":
        back.pfb_carry = jnp.asarray(convert.pfb_carry_to_jax(port.pfb_carry))
    more = capture[:HALF][::-1].copy()
    assert _snr_db(back.demodulate(more), port.demodulate(more)) >= 100.0


def test_batched_tail_equals_per_station_calls():
    rng = np.random.default_rng(7)
    S, n = 3, 85 * 12
    re = torch.from_numpy(rng.standard_normal((S, n)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((S, n)).astype(np.float32))
    pre = torch.from_numpy(rng.standard_normal((2, S)).astype(np.float32))
    hist = torch.from_numpy(rng.standard_normal((S, 47)).astype(np.float32))
    V = WB.make_params(WB.WidebandConfig(), device=CPU).resamp_V
    y, q = TF.quadrature_demod(re, im, TF.QuadState(pre[0], pre[1]))
    a, rs = TF.aligned_resample(y, V, 16, 85, TF.AlignedResampleState(hist))
    assert y.shape == (S, n) and a.shape == (S, n // 85 * 16)
    for s in range(S):
        y1, q1 = TF.quadrature_demod(re[s], im[s],
                                     TF.QuadState(pre[0, s], pre[1, s]))
        a1, rs1 = TF.aligned_resample(y[s], V, 16, 85,
                                      TF.AlignedResampleState(hist[s]))
        # the same f32 math; atan2's vector and scalar loops differ by an ulp
        torch.testing.assert_close(y[s], y1, rtol=1e-6, atol=1e-7)
        assert torch.equal(q.pre_re[s], q1.pre_re)
        assert torch.equal(q.pre_im[s], q1.pre_im)
        torch.testing.assert_close(a[s], a1, rtol=1e-6, atol=1e-6)
        assert torch.equal(rs.hist[s], rs1.hist)


# ---- the multi_fm CLI ------------------------------------------------------

@pytest.fixture(scope="module")
def capture_file(capture, tmp_path_factory):
    path = tmp_path_factory.mktemp("wb") / "wideband.u8"
    capture.tofile(path)
    return str(path)


@pytest.mark.parametrize("front", FRONTS)
def test_cli_writes_station_files(capture_file, port_audio, tmp_path, front):
    argv = ["--file", capture_file, "--channels", "3,60", "--out-dir",
            str(tmp_path), "--torch-device", "cpu"]
    assert multi_fm.main(argv + (["--fused"] if front == "fused" else [])) == 0
    for s, ch in enumerate(CHANNELS):
        pcm = np.fromfile(tmp_path / f"station_{ch}.raw", dtype="<i2")
        assert len(pcm) == port_audio[front].shape[1]
        assert synth.tone_snr(pcm.astype(np.float64), TONES[s], 32_000,
                              skip=400) >= 25.0


def test_cli_pallas_flag_is_fused(capture_file, tmp_path):
    """``--pallas``, the JAX CLI's spelling, writes the ``--fused`` files."""
    argv = ["--file", capture_file, "--channels", "3,60", "--torch-device",
            "cpu"]
    for flag in ("--pallas", "--fused"):
        assert multi_fm.main(argv + [flag, "--out-dir",
                                     str(tmp_path / flag[2:])]) == 0
    for ch in CHANNELS:
        pallas = (tmp_path / "pallas" / f"station_{ch}.raw").read_bytes()
        assert len(pallas) > 0
        assert pallas == (tmp_path / "fused" / f"station_{ch}.raw").read_bytes()


def test_cli_single_channel_streams_to_stdout(capture_file, capsysbinary):
    assert multi_fm.main(["--file", capture_file, "--channels", "60",
                          "--fused", "--torch-device", "cpu"]) == 0
    pcm = np.frombuffer(capsysbinary.readouterr().out, dtype="<i2")
    assert len(pcm) == N_COMPLEX // 64 // 85 * 16
    assert synth.tone_snr(pcm.astype(np.float64), TONES[1], 32_000,
                          skip=400) >= 25.0


def test_cli_refuses_rds(tmp_path, capsys):
    """``--rds``, once refused, decodes every station's multiplex: the
    station carrying RDS prints its PI and PS on ``[rds ch<N>]`` lines,
    through either front, and the other stays silent."""
    from tpu_sdr_torch.models import rds as R

    pi, ps = 0xC0DE, "WIDEBAND"
    groups = [R.make_group_0a(pi, 7, seg, ps[2 * seg: 2 * seg + 2])
              for seg in range(4)]
    bits = np.concatenate([np.concatenate(groups)] * 4)
    K, ch_rate = 16, 170_000
    n = int(np.ceil((len(bits) + 120) / 1187.5 * K * ch_rate))
    n -= n % (16 * K * 85)
    u8, _ = tsynth.synth_multistation_u8(
        n, K * ch_rate, station_freqs=[3 * ch_rate, -4 * ch_rate],
        audio_freqs=[1000.0, 2500.0], deviation=60_000.0,
        rds_bits=[bits, None])
    path = tmp_path / "wb_rds.bin"
    path.write_bytes(bytes(u8))
    for front in ([], ["--fused"]):
        assert multi_fm.main(["--file", str(path), "--channels", f"3,{K - 4}",
                              "--num-channels", str(K), "--rds",
                              "--torch-device", "cpu", "--out-dir",
                              str(tmp_path / "out")] + front) == 0
        err = capsys.readouterr().err
        assert f"[rds ch3] PI: {pi:04X}" in err
        assert f"[rds ch3] PS: '{ps}'" in err
        assert f"ch{K - 4}]" not in err


def test_cli_requires_cuda_by_default(capture_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multi_fm.main(["--file", capture_file, "--fused"])


def test_cli_never_imports_jax(capture_file, tmp_path):
    code = f"""
import sys
from tpu_sdr_torch.apps import multi_fm
assert multi_fm.main(["--file", {capture_file!r}, "--channels", "3,60",
                      "--fused", "--torch-device", "cpu",
                      "--out-dir", {str(tmp_path)!r}]) == 0
print("JAX_LOADED", "jax" in sys.modules)
"""
    env = {k: v for k, v in os.environ.items() if k != "TPU_SDR_PLATFORM"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_LOADED False" in proc.stdout, proc.stdout + proc.stderr


# ---- the 1024-channel bank ---------------------------------------------------

def _bank_config() -> dict:
    import json

    with open(os.path.join(ROOT, "sdrbench", "configs",
                           "wbfm_bank1024.json")) as f:
        return json.load(f)


def test_fused_streamer_at_1024_channels_against_the_plain_reference():
    """The 1024-channel bank (the benchmark's ``wbfm_bank1024``), designed
    from its configuration, on a capture drawn from a seed with stations in
    six of its channels (the edges, the middle; all 1,024 are the card's
    work): two reads of one 680-frame chunk each through K3's plain
    version and the tail, every station's s16 within the configuration's
    limits of ``sdrbench/reference/dsp.py``'s float64 receiver."""
    from sdrbench import capture
    from sdrbench.reference import dsp
    from tpu_sdr_torch.native import f32_to_s16

    cfg = dict(_bank_config(), channels=[0, 1, 511, 512, 767, 1023])
    chunk = 2 * 1024 * 680
    traffic = {"read_bytes": chunk, "ring_reads": 2, "rds": False, "tones": 3,
               "audio_hz": [50, 15000], "deviation_hz": 75000,
               "noise_std": 0.004}
    plan = capture.plan(cfg, traffic, 2**31 + 17)
    ring = capture.synthesize(plan, CPU).numpy()
    config = WB.WidebandConfig(
        num_channels=cfg["num_channels"],
        taps_per_branch=cfg["taps_per_branch"],
        pfb_cutoff_frac=cfg["pfb_cutoff_frac"],
        channels=tuple(cfg["channels"]), channel_rate=cfg["channel_rate"],
        rate_resample=cfg["rate_resample"],
        resample_taps_per_phase=cfg["resample_taps_per_phase"],
        resample_cutoff_frac=cfg["resample_cutoff_frac"])
    streamer = WB.WidebandStreamer(config, use_fused=True, device=CPU)
    reads = [streamer.demodulate(ring[i * chunk:(i + 1) * chunk])
             for i in range(2)]
    pcm = np.stack([np.concatenate([f32_to_s16(r[s]) for r in reads])
                    for s in range(len(cfg["channels"]))]).astype(np.int64)
    ref = dsp.audio_s16(cfg, ring, 0).astype(np.int64)
    assert pcm.shape == ref.shape == (6, 2 * 680 // 85 * 16)
    d = pcm - ref
    assert np.abs(d).max() <= cfg["limits"]["audio_gap_lsb"]
    assert np.sqrt((d * d).mean(axis=1)).max() <= cfg["limits"]["audio_rms_lsb"]
    assert np.abs(ref).max() > 10_000      # the stations are there


def _multi_fm_with_open_files(tmp_path, soft, hard, stations):
    """multi_fm in a process of its own whose limit of open files is
    (soft, hard), writing ``stations`` files of a 128-channel bank."""
    K = 128
    path = tmp_path / "bank.u8"
    np.random.default_rng(5).integers(
        0, 256, 2 * K * 680, dtype=np.uint8).tofile(path)
    code = f"""
import resource, sys
resource.setrlimit(resource.RLIMIT_NOFILE, ({soft}, {hard}))
from tpu_sdr_torch.apps import multi_fm
sys.exit(multi_fm.main(["--file", {str(path)!r}, "--num-channels", "{K}",
                        "--channels", {",".join(map(str, range(stations)))!r},
                        "--fused", "--torch-device", "cpu",
                        "--out-dir", {str(tmp_path / "out")!r}]))
"""
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_cli_raises_the_soft_limit_of_open_files(tmp_path):
    """More stations than the soft limit of open files allows: the CLI
    raises the limit up to the hard one and writes every station's file."""
    import resource

    hard = resource.getrlimit(resource.RLIMIT_NOFILE)[1]
    if hard != resource.RLIM_INFINITY and hard < 512:
        pytest.skip(f"the hard limit of open files is {hard}")
    proc = _multi_fm_with_open_files(tmp_path, 64, hard, 128)
    assert proc.returncode == 0, proc.stderr
    sizes = {(tmp_path / "out" / f"station_{ch}.raw").stat().st_size
             for ch in range(128)}
    assert sizes == {2 * 680 // 85 * 16}


def test_cli_stops_with_a_message_past_the_hard_limit(tmp_path):
    proc = _multi_fm_with_open_files(tmp_path, 64, 64, 128)
    assert proc.returncode == 1
    assert "128 station files need" in proc.stderr
    assert "hard limit (ulimit -Hn) is 64" in proc.stderr
    assert "Traceback" not in proc.stderr
