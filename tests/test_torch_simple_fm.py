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
    """``--mode stereo`` and ``--rds`` are still refused (exit 2, naming the
    JAX CLI); ``--mode exact`` and ``--deemph``, refused until they were
    ported, now write audio."""
    argv = ["--file", capture_file, "--torch-device", "cpu", *extra]
    if extra in (["--mode", "stereo"], ["--rds"]):
        with pytest.raises(SystemExit) as exc:
            simple_fm.main(argv)
        assert exc.value.code == 2
        assert "tpu_sdr.apps.simple_fm" in capsysbinary.readouterr().err.decode()
        return
    pcm = _run(argv, capsysbinary)
    n_complex = os.path.getsize(capture_file) // 2
    assert abs(len(pcm) - n_complex * 16 // (6 * 85)) <= 2048


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
