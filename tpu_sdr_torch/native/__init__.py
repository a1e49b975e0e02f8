"""Native host runtime of the port: ctypes over ``tpu_sdr_torch/csrc/tpusdr_io.cpp``.

The port's copy of ``tpu_sdr.native``: a fixed-block ring buffer with
backpressure and drop accounting, an fd reader pump thread that keeps
Python out of the byte path, and the host byte maps (u8 I/Q unpack and
fs/4 rotation, f32 -> s16, the test-pattern check, rtl_tcp command
framing).  It is host C++, no GPU kernel: ``g++`` builds it, not nvcc.

The shared library is built at first use into ``tpu_sdr_torch/_build/``
under a name that carries a hash of the source and the flags, so a build
of an older source is never loaded.  A file under the current name that
does not load or lacks an entry point (a build cut short, a foreign file)
is rebuilt and the new build is loaded.  The build writes a file of its
own (``<name>.tmp<pid>``), loads it under that name and renames it into
place, so concurrent processes (``pytest -n``) never load half a library
and never reuse a stale handle of the same name.

Where the interpreter's headers are found, the same build is also the
CPython module ``_tpusdr_io`` (loaded from the same file, bound once a
load): its ``f32_to_s16`` reads a numpy array through the buffer protocol,
with no ctypes in the call.  Without them the library is built as before
and ``f32_to_s16`` calls the loop through ctypes.

Every entry point of :mod:`tpu_sdr_torch.native.io` has a numpy fallback:
``available()`` is False without ``g++`` or with ``TPU_SDR_NO_NATIVE`` set.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "tpusdr_io.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
MODULE = "_tpusdr_io"  # the CPython module's name (PyInit__tpusdr_io)


def _python_flags() -> tuple[str, ...]:
    """The flags that build the CPython module too: none where the
    interpreter's headers are missing."""
    include = sysconfig.get_path("include")
    if not os.path.exists(os.path.join(include, "Python.h")):
        return ()
    return ("-DTSDR_PYTHON", f"-I{include}")


# -ffp-contract=off: no fused multiply-adds, so the float map rounds as the
# numpy fallback does on every machine (-march=native would contract it)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared",
             "-ffp-contract=off", *_python_flags())

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_module = None  # the CPython module of the loaded build, or None
_tried = False
build_seconds = 0.0  # the build this process ran; 0.0 when one was reused


def library_path() -> str:
    """Where the build of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtpusdr_io_{h.hexdigest()[:16]}.so")


def _build(path: str) -> str | None:
    """Compile the source into ``<path>.tmp<pid>``; that path, or None."""
    global build_seconds
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        return None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    t0 = time.monotonic()
    done = subprocess.run([cxx, *CXX_FLAGS, SRC, "-o", tmp, "-lpthread"],
                          capture_output=True)
    build_seconds = time.monotonic() - t0
    return tmp if done.returncode == 0 else None


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.tsdr_ring_create.restype = c.c_void_p
    lib.tsdr_ring_create.argtypes = [c.c_size_t, c.c_size_t]
    lib.tsdr_ring_destroy.argtypes = [c.c_void_p]
    lib.tsdr_ring_push.restype = c.c_int
    lib.tsdr_ring_push.argtypes = [c.c_void_p, c.c_char_p]
    lib.tsdr_ring_pop.restype = c.c_int
    lib.tsdr_ring_pop.argtypes = [c.c_void_p, c.c_void_p, c.c_int]
    lib.tsdr_ring_count.restype = c.c_size_t
    lib.tsdr_ring_count.argtypes = [c.c_void_p]
    lib.tsdr_ring_dropped.restype = c.c_uint64
    lib.tsdr_ring_dropped.argtypes = [c.c_void_p]
    lib.tsdr_ring_set_eof.argtypes = [c.c_void_p]
    lib.tsdr_ring_eof.restype = c.c_int
    lib.tsdr_ring_eof.argtypes = [c.c_void_p]
    lib.tsdr_pump_start.restype = c.c_void_p
    lib.tsdr_pump_start.argtypes = [c.c_void_p, c.c_int, c.c_int, c.c_int]
    lib.tsdr_pump_stop.argtypes = [c.c_void_p]
    lib.tsdr_pump_blocks.restype = c.c_uint64
    lib.tsdr_pump_blocks.argtypes = [c.c_void_p]
    lib.tsdr_u8_iq_to_planar_f32.argtypes = [
        c.c_void_p, c.c_size_t, c.c_int, c.c_float, c.c_void_p, c.c_void_p]
    lib.tsdr_rotate_fs4_u8.argtypes = [
        c.c_void_p, c.c_void_p, c.c_size_t, c.c_int]
    lib.tsdr_f32_to_s16.argtypes = [c.c_void_p, c.c_size_t, c.c_float,
                                    c.c_void_p]
    lib.tsdr_count_pattern_breaks.restype = c.c_uint64
    lib.tsdr_count_pattern_breaks.argtypes = [
        c.c_void_p, c.c_size_t, c.POINTER(c.c_int)]
    lib.tsdr_parse_tcp_commands.restype = c.c_size_t
    lib.tsdr_parse_tcp_commands.argtypes = [
        c.c_void_p, c.c_size_t, c.c_void_p, c.c_void_p, c.c_size_t]


def _open(path: str):
    """The library at ``path`` through ctypes, and its CPython module where
    the build has one.  AttributeError when an entry point is missing,
    ImportError when the module is."""
    lib = ctypes.CDLL(path)
    _declare(lib)
    if "-DTSDR_PYTHON" not in CXX_FLAGS:
        return lib, None
    loader = importlib.machinery.ExtensionFileLoader(MODULE, path)
    module = importlib.util.module_from_spec(
        importlib.util.spec_from_file_location(MODULE, path, loader=loader))
    loader.exec_module(module)
    return lib, module


def _load_or_build():
    path = library_path()
    if os.path.exists(path):
        try:
            return _open(path)
        except (OSError, AttributeError, ImportError):
            pass  # incomplete or foreign: build anew below
    tmp = _build(path)
    if tmp is None:
        return None, None
    try:
        bound = _open(tmp)
    except (OSError, AttributeError, ImportError):
        os.remove(tmp)
        return None, None
    os.replace(tmp, path)
    return bound


def load() -> ctypes.CDLL | None:
    """The bound native library, built on first use; None when it cannot
    be built or ``TPU_SDR_NO_NATIVE`` is set."""
    global _lib, _module, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            if not os.environ.get("TPU_SDR_NO_NATIVE"):
                _lib, _module = _load_or_build()
        return _lib


def available() -> bool:
    return load() is not None


def module():
    """The loaded build's CPython module (``f32_to_s16``, ``s16_counts``);
    None where the native library is not available or was built without
    the interpreter's headers."""
    return _module if available() else None


from tpu_sdr_torch.native.io import (  # noqa: E402,F401
    NativePump,
    NativeRing,
    count_pattern_breaks,
    f32_to_s16,
    parse_tcp_commands,
    rotate_fs4_u8,
    u8_iq_to_planar_f32,
)
