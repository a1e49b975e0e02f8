"""The port's six host CLIs against the JAX package's, on the same fake
dongles (``TPU_SDR_FAKE_DEVICES`` or explicit fake specs in each package's
own registry), after ``tests/test_cli.py:227-313``: ``rtl_tcp``,
``rtl_test``, ``rtl_sdr_capture``, ``rtl_eeprom``, ``device_list`` and
``demo_device_id``.  Each pair of runs gives equal exit codes, stdout,
stderr and files (``rtl_tcp``'s log lines with the ports it was handed,
its loggers' package names and the reason the client's connection ended
masked).  Their option sets are the JAX CLIs', with no ``--torch-device``:
they run no data plane.  And the modules this slice added import neither
``jax`` nor ``tpu_sdr``, each alone in a fresh process.
"""

import argparse
import importlib
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from tpu_sdr.control import fake as jfake
from tpu_sdr_torch.control import fake as tfake
from tpu_sdr_torch.stream.feeder import RtlTcpClientSource

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPS = ("rtl_tcp", "rtl_test", "rtl_sdr_capture", "rtl_eeprom", "device_list",
        "demo_device_id")
FAKES = (jfake, tfake)


@pytest.fixture
def fakes(monkeypatch):
    """Empty fake registries in both packages, emptied again after."""
    for f in FAKES:
        f.clear_fake_devices()
    yield monkeypatch
    for f in FAKES:
        f.clear_fake_devices()


def _both(app, argv, capsys, register=None):
    """Run ``app``'s JAX CLI, then the port's, each on its own package's
    fakes (``register(fake_module)`` adds them); returns [(rc, out, err)]."""
    runs = []
    for pkg, fake in (("tpu_sdr", jfake), ("tpu_sdr_torch", tfake)):
        fake.clear_fake_devices()
        if register:
            register(fake)
        main = importlib.import_module(f"{pkg}.apps.{app}").main
        try:
            rc = main(list(argv))
        except SystemExit as e:
            rc = e.code
        out, err = capsys.readouterr()
        runs.append((rc, out, err))
        fake.clear_fake_devices()
    return runs


@pytest.mark.parametrize("argv,n", [([], 2), (["--probe"], 2), ([], 0),
                                    (["--probe"], 1)])
def test_device_list_is_the_jax_clis(fakes, capsys, argv, n):
    fakes.setenv("TPU_SDR_FAKE_DEVICES", str(n))
    jax, port = _both("device_list", argv, capsys)
    assert port == jax
    assert port[0] == 0 and ("device(s):" in port[1] if n else
                             "no RTL-SDR devices visible" in port[1])


@pytest.mark.parametrize("argv", [[], ["--fd", "-1"]])
def test_demo_device_id_is_the_jax_clis(fakes, capsys, argv):
    fakes.setenv("TPU_SDR_FAKE_DEVICES", "1")
    jax, port = _both("demo_device_id", argv, capsys)
    assert port == jax
    assert "opened, tuner=r820t" in port[1]


@pytest.mark.parametrize("argv,n", [
    (["-d", "1", "--blocks", "3"], 2),
    (["--find", "serial=00000002", "--blocks", "2"], 2),
    (["--find", "serial=nope"], 1),
    (["-d", "0", "-f", "serial=1"], 1),
    ([], 1),
    (["-d", "0"], 0),
])
def test_rtl_test_is_the_jax_clis(fakes, capsys, argv, n):
    """The counter test pattern read and checked (the port's native
    count_pattern_breaks), and every usage error."""
    fakes.setenv("TPU_SDR_FAKE_DEVICES", str(n))
    jax, port = _both("rtl_test", argv, capsys)
    assert port == jax
    if "--blocks" in argv:
        assert port[0] == 0 and " 0 discontinuities" in port[1]
    else:
        assert port[0] == 1 and port[2]


def _synth_dongle(fake):
    fake.register_fake_device(fake.FakeDeviceSpec(
        serial="cap00001",
        source_factory=lambda: fake.SynthFmSource(capture_rate=1_020_000)))


def test_rtl_sdr_capture_to_a_file_is_the_jax_clis(fakes, capsys, tmp_path):
    files, runs = [], []
    for pkg, fake in (("tpu_sdr", jfake), ("tpu_sdr_torch", tfake)):
        fake.clear_fake_devices()
        _synth_dongle(fake)
        out = tmp_path / f"{pkg}.bin"
        main = importlib.import_module(f"{pkg}.apps.rtl_sdr_capture").main
        runs.append((main([str(out), "-f", "94.9M", "-s", "1020k", "-n", "255k",
                           "-g", "28.0"]), capsys.readouterr()))
        files.append(out.read_bytes())
        fake.clear_fake_devices()
    assert runs[0] == runs[1] and runs[1][0] == 0
    assert files[0] == files[1] and len(files[1]) == 255_000
    assert "Tuner gain set to 28.00 dB." in runs[1][1].err


def test_rtl_sdr_capture_to_stdout_is_the_jax_clis(fakes, capsysbinary):
    runs = []
    for pkg, fake in (("tpu_sdr", jfake), ("tpu_sdr_torch", tfake)):
        fake.clear_fake_devices()
        fake.register_fake_device(fake.FakeDeviceSpec(serial="cap00002"))
        main = importlib.import_module(f"{pkg}.apps.rtl_sdr_capture").main
        runs.append((main(["-", "-n", "131072", "-b", "16384"]),
                     capsysbinary.readouterr()))
        fake.clear_fake_devices()
    assert runs[0] == runs[1] and runs[1][0] == 0
    assert runs[1][1].out == bytes(range(256)) * 512


def _eeprom() -> bytes:
    def desc(s):
        raw = s.encode("utf-16-le")
        return bytes([len(raw) + 2, 0x03]) + raw

    e = bytearray(256)
    e[0:2] = b"\x28\x32"
    e[2:4] = (0x0BDA).to_bytes(2, "little")
    e[4:6] = (0x2838).to_bytes(2, "little")
    e[6] = 0xA5
    e[7] = 0x01
    strings = desc("Realtek") + desc("RTL2838UHIDIR") + desc("00000101")
    e[9:9 + len(strings)] = strings
    return bytes(e)


@pytest.mark.parametrize("crafted", [True, False])
def test_rtl_eeprom_is_the_jax_clis(fakes, capsys, tmp_path, crafted):
    images = []
    runs = []
    for pkg, fake in (("tpu_sdr", jfake), ("tpu_sdr_torch", tfake)):
        fake.clear_fake_devices()
        fake.register_fake_device(fake.FakeDeviceSpec(
            serial="ee000001", eeprom=_eeprom() if crafted else b""))
        out = tmp_path / "image.bin"
        main = importlib.import_module(f"{pkg}.apps.rtl_eeprom").main
        rc = main(["-o", str(out)])
        o, e = capsys.readouterr()
        runs.append((rc, o.replace(str(out), "<image>"), e))
        images.append(out.read_bytes())
        fake.clear_fake_devices()
    assert runs[0] == runs[1] and images[0] == images[1]
    if crafted:
        assert "Serial:           00000101" in runs[1][1]


def _rtl_tcp(pkg: str) -> tuple:
    """The CLI in a subprocess on one fake dongle: wait for it to listen,
    stream 4096 bytes to a client, interrupt it.  Returns (rc, stdout,
    stderr with the port numbers masked, the bytes)."""
    env = dict(os.environ, TPU_SDR_FAKE_DEVICES="1")
    env.pop("TPU_SDR_PLATFORM", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.apps.rtl_tcp", "-p", "0", "-f", "94.9M",
         "-s", "1.02M", "-g", "29.7", "-n", "8"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        err = [proc.stderr.readline()]
        while "Listening on" not in err[-1] and err[-1]:
            err.append(proc.stderr.readline())
        port = int(re.search(r":(\d+) \(max", err[-1]).group(1))
        client = RtlTcpClientSource("127.0.0.1", port)
        data = client.read_block(4096)
        client.close()
        while "Connection" not in err[-1]:
            err.append(proc.stderr.readline())
        time.sleep(0.2)
        proc.send_signal(signal.SIGINT)
        out, rest = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    # the ports it was handed, its loggers' package names, and why the
    # connection ended (the client's close races the server's next send)
    text = re.sub(r"\b\d{4,5}\b", "<port>", "".join(err) + rest)
    text = re.sub(r"rtl_tcp:Connection .*", "rtl_tcp:Connection <end>", text)
    return proc.returncode, out, text.replace("tpu_sdr_torch.", "tpu_sdr."), data


def test_rtl_tcp_is_the_jax_clis():
    jax, port = _rtl_tcp("tpu_sdr"), _rtl_tcp("tpu_sdr_torch")
    assert port == jax
    assert port[0] == 0 and port[1].endswith("bye!\n")
    assert "Tuned to 94900000 Hz" in port[1] and port[3] == bytes(range(256)) * 16


def _options(main, argv=("--help",)):
    """The option strings (and positional names) of the parser ``main``
    builds."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        seen["p"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            main(list(argv))
    finally:
        argparse.ArgumentParser.parse_args = real
    return {s for a in seen["p"]._actions for s in a.option_strings} | {
        a.dest for a in seen["p"]._actions if not a.option_strings}


@pytest.mark.parametrize("app", APPS)
def test_host_cli_options_are_the_jax_clis(app):
    jax_opts = _options(importlib.import_module(f"tpu_sdr.apps.{app}").main)
    port = _options(importlib.import_module(f"tpu_sdr_torch.apps.{app}").main)
    assert port == jax_opts and "--torch-device" not in port


@pytest.mark.parametrize("name", [
    "tpu_sdr_torch.native", "tpu_sdr_torch.native.io",
    "tpu_sdr_torch.stream.rtl_tcp_server",
    *(f"tpu_sdr_torch.apps.{a}" for a in APPS)])
def test_new_module_imports_neither_tpu_sdr_nor_jax(name):
    code = (f"import sys, importlib; importlib.import_module({name!r}); "
            "bad = sorted(k for k in sys.modules "
            "if k.split('.')[0] in ('tpu_sdr', 'jax')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, TPU_SDR_PLATFORM="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
