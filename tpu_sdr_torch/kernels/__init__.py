"""Build and bind the port's CUDA kernels (``tpu_sdr_torch/csrc/*.cu``).

At first use ``nvcc`` compiles every source (one process a source, all
started together) and links them into one shared library with a plain C
interface, for Hopper only (``sm_90a``), under ``tpu_sdr_torch/_build/``.
The file name carries a hash of the sources and flags, so an edited
source builds anew; the build writes a temporary file
and renames it into place, so concurrent processes never load half a
library.  The library is bound with ``ctypes``: pointers and the stream go
as ``c_void_p``, and every launch returns its CUDA status, which
:func:`check` turns into an exception.  The wrappers decide with
:func:`on_cuda` whether to launch and validate each tensor with
:func:`check_tensor` (or, for a station batch whose rows sit at a stride,
:func:`check_rows`) before its pointer goes to C.

Each wrapper module's launch counter (its ``LAUNCHES``) is registered
here, which ``utils.graphs`` reads to count a graph's launches at replay.
Nothing here builds at import time: the CPU tests import the port without
a compiler or a card.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: "Library | None" = None


LAUNCH_COUNTERS: list[dict[str, int]] = []  # every wrapper's LAUNCHES


def launch_counter(*names: str) -> dict[str, int]:
    """A wrapper's launch counts, from 0, registered in LAUNCH_COUNTERS."""
    counts = dict.fromkeys(names, 0)
    LAUNCH_COUNTERS.append(counts)
    return counts


@dataclass
class Library:
    cdll: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an up-to-date build was reused
    build_log: str        # nvcc's output (ptxas register/smem report)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else nvcc on PATH, else
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA "
                       "toolkit's bin directory on PATH")


def _sources(src_dir: str) -> list[str]:
    return sorted(glob.glob(os.path.join(src_dir, "*.cu")))


def _digest(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build(src_dir: str = SRC_DIR, build_dir: str = BUILD_DIR
          ) -> tuple[str, float, str]:
    """Compile the ``*.cu`` of ``src_dir`` unless an identical build exists
    in ``build_dir``; returns (library path, seconds spent compiling,
    compiler output)."""
    sources = _sources(src_dir)
    path = os.path.join(build_dir, f"libtsdr_torch_{_digest(sources)}.so")
    if os.path.exists(path):
        return path, 0.0, ""
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    nvcc = find_nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in sources]
    t0 = time.monotonic()
    # one nvcc a source, all at once, then one link
    cmds = [[nvcc, *compile_flags, "-c", "-o", o, s]
            for s, o in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs)
              if p.returncode != 0]
    if not failed:
        link_cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *objs]
        link = subprocess.run(link_cmd, capture_output=True, text=True)
        outs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed = [(link_cmd, link.returncode, outs[-1])]
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    seconds = time.monotonic() - t0
    if failed:
        cmd, code, out = failed[0]
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{out}")
    os.replace(tmp, path)
    return path, seconds, "".join(outs)


def bind(path: str) -> ctypes.CDLL:
    """Load a built library and declare its entry points."""
    lib = ctypes.CDLL(path)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tsdr_fm_front.argtypes = [p, ll, i, p, p, i, i, p, p, p]
    lib.tsdr_fm_front.restype = i
    lib.tsdr_fm_front_batch.argtypes = [p, ll, i, ll, p, i, p, ll, p, i, i,
                                        p, ll, p, ll, p]
    lib.tsdr_fm_front_batch.restype = i
    lib.tsdr_fm_resample.argtypes = [p, ll, p, p, i, i, i, p, p, p]
    lib.tsdr_fm_resample.restype = i
    lib.tsdr_fm_resample_batch.argtypes = [p, ll, i, ll, p, ll, p, i, i, i,
                                           p, ll, p, ll, p]
    lib.tsdr_fm_resample_batch.restype = i
    lib.tsdr_pfb_channelize.argtypes = [p, ll, i, i, i, i, p, p, p, p, p, p]
    lib.tsdr_pfb_channelize.restype = i
    lib.tsdr_halo_pull.argtypes = [i, p, p, ll, p, p, p, i, p]
    lib.tsdr_halo_pull.restype = i
    lib.tsdr_ring_shift.argtypes = [i, p, ll, p, p, i, p]
    lib.tsdr_ring_shift.restype = i
    lib.tsdr_shard_halo.argtypes = [i, p, i, ll, i, p, p, i, i, i, i, p, p]
    lib.tsdr_shard_halo.restype = i
    lib.tsdr_enable_peer.argtypes = [i, i]
    lib.tsdr_enable_peer.restype = i
    lib.tsdr_error_string.argtypes = [i]
    lib.tsdr_error_string.restype = ctypes.c_char_p
    return lib


def load() -> Library:
    """The bound kernel library, built on first use."""
    global _loaded
    with _lock:
        if _loaded is None:
            path, seconds, log = build()
            _loaded = Library(bind(path), path, seconds, log)
        return _loaded


def check(status: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = load().cdll.tsdr_error_string(status).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {status} ({msg})")


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, device,
                 shape: tuple | None = None) -> None:
    """Raise unless ``t`` has this device, dtype (and shape) and is
    contiguous: what a kernel takes through a bare pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_rows(t: torch.Tensor, name: str, dtype: torch.dtype, device,
               shape: tuple) -> int:
    """Raise unless ``t`` has this device, dtype and shape and each of its
    rows (``t[i]``) is contiguous: what a kernel takes through a base
    pointer and a row stride.  Returns the row stride in elements."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if shape[0] and not t[0].is_contiguous():
        raise ValueError(f"{name}'s rows must be contiguous")
    if shape[0] > 1 and t.stride(0) < t[0].numel():
        raise ValueError(f"{name}'s rows overlap (row stride {t.stride(0)})")
    return t.stride(0)
