"""tpu_sdr_torch.apps.simple_fm on the CPU, and the port's freedom from jax.

The CLI runs with ``--torch-device cpu`` (the plain PyTorch versions of
the kernels) from a capture file, a fake dongle opened through the port's
own api, and an rtl_tcp server, and must recover the 1 kHz tone; a
subprocess with ``TPU_SDR_PLATFORM`` unset runs the whole slice and must
never import jax — the machine with the GPU has none.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_sdr.utils import synth
from tpu_sdr_torch.apps import simple_fm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 130_560


@pytest.fixture(scope="module")
def capture_file(tmp_path_factory):
    u8, _ = synth.synth_wbfm_u8(8 * CHUNK // 2, capture_rate=1_020_000,
                                noise_std=0.01, seed=5)
    path = tmp_path_factory.mktemp("cap") / "cap.u8"
    np.asarray(u8, dtype=np.uint8).tofile(path)
    return str(path)


def _run(argv, capsysbinary):
    assert simple_fm.main(argv) == 0
    return np.frombuffer(capsysbinary.readouterr().out, dtype="<i2")


@pytest.mark.parametrize("mode", ["fused", "fir"])
def test_cli_file_mode_recovers_tone(capture_file, capsysbinary, mode):
    pcm = _run(["--file", capture_file, "--mode", mode, "--torch-device",
                "cpu"], capsysbinary)
    n_complex = os.path.getsize(capture_file) // 2
    assert abs(len(pcm) - n_complex * 16 // (6 * 85)) <= 2048
    snr = synth.tone_snr(pcm.astype(np.float64), 1_000.0, 32_000, skip=1500)
    assert snr >= 40.0, f"--mode {mode}: tone SNR {snr:.1f} dB"


def test_cli_pallas_mode_is_fused(capture_file, capsysbinary):
    """``--mode pallas``, the JAX CLI's spelling, writes the fused bytes."""
    args = ["--file", capture_file, "--torch-device", "cpu", "--mode"]
    pallas = _run(args + ["pallas"], capsysbinary)
    fused = _run(args + ["fused"], capsysbinary)
    assert len(fused) > 0
    assert pallas.tobytes() == fused.tobytes()


def test_cli_fused_agrees_with_fir(capture_file, capsysbinary):
    args = ["--file", capture_file, "--torch-device", "cpu", "--mode"]
    fused = _run(args + ["fused"], capsysbinary).astype(np.float64)
    fir = _run(args + ["fir"], capsysbinary).astype(np.float64)
    n = min(len(fused), len(fir))
    err = fused[:n] - fir[:n]
    snr = 10 * np.log10(np.mean(fir[:n] ** 2) / max(np.mean(err ** 2), 1e-30))
    assert snr >= 80.0, f"fused vs fir s16 output: {snr:.1f} dB"


@pytest.mark.parametrize("extra", [["--mode", "exact"], ["--mode", "stereo"],
                                   ["--rds"], ["--deemph", "75"]])
def test_cli_unported_options_exit_with_usage_error(capture_file,
                                                    capsysbinary, extra):
    """Every option once refused is ported: ``--mode exact`` and
    ``--deemph`` write mono audio, ``--mode stereo`` interleaved L/R (two
    s16 a sample); ``--rds`` without ``--mode stereo`` is the JAX CLI's
    usage error (exit 2, its message)."""
    argv = ["--file", capture_file, "--torch-device", "cpu", *extra]
    if extra == ["--rds"]:
        with pytest.raises(SystemExit) as exc:
            simple_fm.main(argv)
        assert exc.value.code == 2
        assert ("--rds requires --mode stereo here (for mono use rtl_fm "
                "--rds)") in capsysbinary.readouterr().err.decode()
        return
    pcm = _run(argv, capsysbinary)
    n_complex = os.path.getsize(capture_file) // 2
    channels = 2 if "stereo" in extra else 1
    assert abs(len(pcm) - channels * n_complex * 16 // (6 * 85)) <= 2048
    if channels == 2:  # a mono capture: the tone in L (no pilot, no L-R)
        assert synth.tone_snr(pcm[0::2].astype(float), 1_000.0, 32_000,
                              skip=1500) >= 40.0


def test_cli_deemph_needs_a_float_chain(capture_file):
    for mode in ("exact", "fused"):
        with pytest.raises(SystemExit) as exc:
            simple_fm.main(["--file", capture_file, "--torch-device", "cpu",
                            "--mode", mode, "--deemph", "75"])
        assert exc.value.code == 2


def _jax_cli(argv, capsysbinary):
    from tpu_sdr.apps import simple_fm as jsimple

    assert jsimple.main(argv) == 0
    return np.frombuffer(capsysbinary.readouterr().out, dtype="<i2")


def test_cli_exact_is_byte_equal_to_the_jax_cli(capture_file, capsysbinary):
    args = ["--file", capture_file, "--mode", "exact"]
    got = _run(args + ["--torch-device", "cpu"], capsysbinary)
    exp = _jax_cli(args, capsysbinary)
    assert len(got) > 10_000
    assert got.tobytes() == exp.tobytes()


@pytest.mark.parametrize("extra", [["--mode", "boxcar"],
                                   ["--mode", "fir", "--deemph", "75"],
                                   ["--mode", "boxcar", "--deemph", "50"]])
def test_cli_float_modes_match_the_jax_cli(capture_file, capsysbinary, extra):
    """Within the float tolerance of the JAX CLI's s16 (whose fir chain
    runs split-bf16 weights, the port f32: >= 80 dB), and the tone no worse
    than the JAX CLI's by more than 1 dB."""
    args = ["--file", capture_file, *extra]
    got = _run(args + ["--torch-device", "cpu"], capsysbinary).astype(float)
    exp = _jax_cli(args, capsysbinary).astype(float)
    assert got.shape == exp.shape and len(got) > 10_000
    err = got - exp
    assert 10 * np.log10(np.mean(exp ** 2) / max(np.mean(err ** 2),
                                                 1e-30)) >= 80.0
    tone = synth.tone_snr(got, 1_000.0, 32_000, skip=1500)
    assert tone >= synth.tone_snr(exp, 1_000.0, 32_000, skip=1500) - 1.0


def test_cli_requires_cuda_by_default(capture_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simple_fm.main(["--file", capture_file, "--mode", "fused"])


def test_port_never_imports_jax(capture_file):
    """Import every module of the port and run the slice, CLI included,
    in a fresh interpreter; jax must stay out of sys.modules."""
    code = f"""
import sys, io, pkgutil, importlib
import numpy as np
import tpu_sdr_torch
for m in pkgutil.walk_packages(tpu_sdr_torch.__path__, "tpu_sdr_torch."):
    importlib.import_module(m.name)
from tpu_sdr_torch.ops.fused_fm import FusedWbfmStreamer
from tpu_sdr_torch.models.wbfm import WbfmStreamer
from tpu_sdr_torch.apps import simple_fm
buf = np.fromfile({capture_file!r}, dtype=np.uint8)
assert FusedWbfmStreamer(device="cpu").demodulate(buf).size > 0
assert WbfmStreamer(device="cpu").demodulate(buf).size > 0
sys.stdout = io.TextIOWrapper(io.BytesIO())
assert simple_fm.main(["--file", {capture_file!r}, "--mode", "fused",
                       "--torch-device", "cpu"]) == 0
sys.stdout = sys.__stdout__
print("JAX_LOADED", "jax" in sys.modules)
"""
    env = {k: v for k, v in os.environ.items() if k != "TPU_SDR_PLATFORM"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_LOADED False" in proc.stdout, proc.stdout + proc.stderr


def _pcm_of(argv, capsysbinary):
    pcm = _run(argv, capsysbinary).astype(np.float64)
    assert len(pcm) > 20_000
    return synth.tone_snr(pcm, 1_000.0, 32_000, skip=4000)


@pytest.mark.parametrize("mode", ["fused", "fir"])
def test_cli_live_dongle_through_the_port_api(capsysbinary, mode):
    """A fake dongle synthesising a station, opened by the port's own api
    and fed by its own BlockFeeder: the 1 kHz tone survives."""
    from tpu_sdr_torch.control import fake

    fake.clear_fake_devices()
    fake.register_fake_device(fake.FakeDeviceSpec(
        serial="live0001",
        source_factory=lambda: fake.SynthFmSource(capture_rate=1_020_000)))
    try:
        snr = _pcm_of(["--mode", mode, "--blocks", "6", "--torch-device",
                       "cpu"], capsysbinary)
    finally:
        fake.clear_fake_devices()
    assert snr > 20, f"tone lost on the live path: {snr:.1f} dB"


def test_cli_rtl_tcp_source_from_the_jax_server(capsysbinary):
    """The port's rtl_tcp client against the JAX package's server on a
    synthesising fake dongle, over a real socket."""
    import threading
    import time

    from tpu_sdr import api
    from tpu_sdr.control import fake
    from tpu_sdr.stream.rtl_tcp_server import RtlTcpServer

    fake.clear_fake_devices()
    fake.register_fake_device(fake.FakeDeviceSpec(
        serial="tcp00001",
        source_factory=lambda: fake.SynthFmSource(capture_rate=1_020_000)))
    sdr = api.RtlSdr.open_with_index(0)
    srv = RtlTcpServer(sdr, "127.0.0.1", 0, queue_limit=32)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    deadline = time.time() + 5
    while srv.bound_port is None and time.time() < deadline:
        time.sleep(0.01)
    try:
        snr = _pcm_of(["--tcp", f"127.0.0.1:{srv.bound_port}", "--mode",
                       "fused", "--blocks", "6", "--torch-device", "cpu"],
                      capsysbinary)
    finally:
        srv.stop()
        t.join(timeout=5)
        sdr.close()
        fake.clear_fake_devices()
    assert snr > 20, f"tone lost over the tcp path: {snr:.1f} dB"


def _stereo_rds_file(tmp_path, pi, ps):
    from tpu_sdr_torch.models import rds as R

    groups = [R.make_group_0a(pi, 10, seg, ps[2 * seg: 2 * seg + 2])
              for seg in range(4)]
    bits = np.concatenate([np.concatenate(groups)] * 4)
    n = int(np.ceil((len(bits) + 120) / 1187.5 * 1_020_000))
    n -= n % (6 * 85)
    u8, _, _ = synth.synth_wbfm_stereo_u8(n, capture_rate=1_020_000,
                                          rds_bits=bits)
    path = tmp_path / "st_rds.bin"
    path.write_bytes(bytes(u8))
    return str(path)


def test_cli_stereo_rds_matches_the_jax_cli(tmp_path, capsysbinary):
    """``--mode stereo --rds``: interleaved L/R within 80 dB of the JAX
    CLI's s16 (its front split-bf16, the port's f32), and the same
    ``[rds]`` lines on stderr."""
    pi, ps = 0xD00D, "STEREO+R"
    args = ["--file", _stereo_rds_file(tmp_path, pi, ps), "--mode", "stereo",
            "--rds"]
    assert simple_fm.main(args + ["--torch-device", "cpu"]) == 0
    cap = capsysbinary.readouterr()
    got, got_err = np.frombuffer(cap.out, dtype="<i2"), cap.err.decode()
    from tpu_sdr.apps import simple_fm as jsimple

    assert jsimple.main(args) == 0
    cap = capsysbinary.readouterr()
    exp = np.frombuffer(cap.out, dtype="<i2")
    assert got.shape == exp.shape and len(got) > 20_000
    err = got.astype(float) - exp
    assert 10 * np.log10(np.mean(exp.astype(float) ** 2)
                         / max(np.mean(err ** 2), 1e-30)) >= 80.0
    assert synth.tone_snr(got[0::2].astype(float), 800.0, 32_000,
                          skip=2000) > 30
    rds = [ln for ln in got_err.splitlines() if ln.startswith("[rds]")]
    assert rds == [ln for ln in cap.err.decode().splitlines()
                   if ln.startswith("[rds]")]
    assert f"[rds] PI: {pi:04X}" in rds and f"[rds] PS: '{ps}'" in rds


def test_cli_trace_writes_a_chrome_trace(capture_file, tmp_path, capsysbinary):
    """``--trace DIR``: one ``torch.profiler`` Chrome trace in DIR naming
    the run's operations (on the card, also the kernels), with the
    program's spans on a track of their own, on the operations' time
    axis: each graph replay's span (on the CPU the step itself) holds the
    aten operations it launched."""
    import json

    from tpu_sdr_torch.utils import profiling

    out = tmp_path / "trace"
    pcm = _run(["--file", capture_file, "--mode", "fused", "--torch-device",
                "cpu", "--trace", str(out)], capsysbinary)
    assert len(pcm) > 0
    files = list(out.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    track = [e for e in events if e.get("args", {}).get("name")
             == profiling.TRACK]
    assert len(track) == 1
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert {e["tid"] for e in spans} == {track[0]["tid"]}
    replays = [e for e in spans if e["name"] == "FusedWbfmStreamer.replay"]
    assert replays and {"FusedWbfmStreamer.capture",
                        "FusedWbfmStreamer.unpack"} <= {e["name"] for e in spans}
    aten = [e["ts"] for e in events if e.get("cat") == "cpu_op"
            and e["name"].startswith("aten::")]
    for r in replays:
        assert any(r["ts"] <= t <= r["ts"] + r["dur"] for t in aten), r
