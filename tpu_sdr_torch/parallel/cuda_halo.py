"""The halo exchange as CUDA kernels — the counterpart of
``tpu_sdr/parallel/pallas_halo.py``.

K4 (``pull_left_halo_cuda``) and K5 (``ring_shift_cuda``) are the copy
kernels of ``csrc/halo.cu``.  For each device that holds receiving shards,
one launch on that device's current stream copies every one of them: a
source on the same device is read in place, one on another device over
NVLink once peer access is open (``enable_peer``; a pair that cannot reach
each other raises, nothing goes through the host).  CUDA events order the
streams: the receiving stream waits for the sending device's stream before
the copy, and the sending stream waits for the copy before it may reuse
the source's memory.  Shards that share a device are ordered by its one
stream.

A row of shards is a list of tensors in ``sp`` order, as in
``parallel.halo``, whose functions are the plain versions: a row on the CPU
takes them, a row on CUDA launches the kernel or raises.  Each launch adds
one to :data:`LAUNCHES`.  :func:`all_to_all` is the row's re-shard built
on K5.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from tpu_sdr_torch import kernels
from tpu_sdr_torch.parallel import halo as H

# Kernel launches per wrapper: the main path's proof that it ran the
# kernels.  Only the wrappers' CUDA branches add to these.
LAUNCHES = kernels.launch_counter("halo_pull", "ring_shift")

# Receiving shards one launch takes (kMaxShards in csrc/halo.cu).
MAX_SHARDS = 32


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def enable_peer(dev: int, peer: int) -> None:
    """Let CUDA device ``dev`` read ``peer``'s memory (a no-op once open);
    raise if it cannot."""
    lib = kernels.load().cdll
    status = lib.tsdr_enable_peer(dev, peer)
    if status != 0:
        msg = lib.tsdr_error_string(status).decode()
        raise RuntimeError(f"cuda:{dev} cannot read cuda:{peer}'s memory: "
                           f"CUDA error {status} ({msg})")


def _check_row(xs: Sequence[torch.Tensor]) -> None:
    x0 = xs[0]
    for i, x in enumerate(xs):
        kernels.check_tensor(x, f"shard {i}", x0.dtype, x.device)
        if x.device.type != "cuda":
            raise ValueError(f"shard {i} is on {x.device}; the row is on CUDA")
        if x.shape[1:] != x0.shape[1:]:
            raise ValueError(f"shard {i} of shape {tuple(x.shape)} does not "
                             f"match shard 0's {tuple(x0.shape)}")


def _ptrs(values) -> ctypes.Array:
    return (ctypes.c_void_p * len(values))(*values)


def _launch(name: str, outs, sources, call) -> None:
    """Launch ``call(receivers, n_receivers, stream)`` once per device that
    holds receivers (``outs[r].device``), ordered against the devices of
    their ``sources`` (``sources[r]``: the device receiver r reads, or
    None)."""
    by_device: dict[torch.device, list[int]] = {}
    for r, out in enumerate(outs):
        by_device.setdefault(out.device, []).append(r)
    for dev, receivers in by_device.items():
        if len(receivers) > MAX_SHARDS:
            raise ValueError(f"{len(receivers)} receiving shards on {dev}; "
                             f"one launch takes at most {MAX_SHARDS}")
        peers = {sources[r] for r in receivers} - {None, dev}
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            for peer in peers:
                enable_peer(dev.index, peer.index)
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(peer))
                stream.wait_event(ready)
            recv = (ctypes.c_int * len(receivers))(*receivers)
            status = call(recv, len(receivers), stream.cuda_stream)
        kernels.check(status, name)
        LAUNCHES[name] += 1
        if peers:
            done = torch.cuda.Event()
            done.record(stream)
            for peer in peers:
                torch.cuda.current_stream(peer).wait_event(done)


def pull_left_halo_cuda(xs: Sequence[torch.Tensor], halo: int,
                        left_edge: torch.Tensor | None = None,
                        force_kernel: bool = False) -> list[torch.Tensor]:
    """K4: the last ``halo`` entries (axis 0) of each shard's left
    neighbour; shard 0 gets ``left_edge`` or zeros — the semantics of
    ``pull_left_halo_pallas``.  On a one-shard row the exchange is vacuous
    and returns zeros, then the edge, without a launch, unless
    ``force_kernel`` (the single-card proof that the kernel runs)."""
    if not xs:
        raise ValueError("an empty row of shards")
    if not kernels.on_cuda(xs[0]):
        return H.pull_left_halo(xs, halo, left_edge)
    _check_row(xs)
    x0 = xs[0]
    if halo < 1 or any(x.shape[0] < halo for x in xs):
        raise ValueError(f"halo of {halo} entries does not fit every shard")
    shape = (halo, *x0.shape[1:])
    if left_edge is not None:
        kernels.check_tensor(left_edge, "left_edge", x0.dtype, x0.device)
        if left_edge.numel() != x0[:halo].numel():
            raise ValueError(f"left_edge of {left_edge.numel()} elements, "
                             f"the halo has {x0[:halo].numel()}")
    if len(xs) == 1 and not force_kernel:
        if left_edge is None:
            return [torch.zeros(shape, dtype=x0.dtype, device=x0.device)]
        return [left_edge.reshape(shape).clone()]
    outs = [torch.empty(shape, dtype=x0.dtype, device=x.device) for x in xs]
    size = x0.element_size()
    x_ptrs = _ptrs([x.data_ptr() for x in xs])
    x_bytes = (ctypes.c_longlong * len(xs))(*[x.numel() * size for x in xs])
    out_ptrs = _ptrs([o.data_ptr() for o in outs])
    edge_ptr = None if left_edge is None else left_edge.data_ptr()
    sources = [None] + [x.device for x in xs[:-1]]
    lib = kernels.load().cdll
    _launch("halo_pull", outs, sources,
            lambda recv, n_recv, stream: lib.tsdr_halo_pull(
                len(xs), x_ptrs, x_bytes, outs[0].numel() * size, edge_ptr,
                out_ptrs, recv, n_recv, stream))
    return outs


def ring_shift_cuda(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """K5: shard i's whole tensor lands on shard (i + 1) % n — the
    semantics of ``ring_shift_pallas``; a one-shard row copies its buffer
    to itself through the kernel."""
    if not xs:
        raise ValueError("an empty row of shards")
    if not kernels.on_cuda(xs[0]):
        return H.ring_shift(xs)
    _check_row(xs)
    x0 = xs[0]
    if any(x.shape != x0.shape for x in xs) or x0.numel() == 0:
        raise ValueError("a ring needs non-empty shards of one shape")
    n = len(xs)
    outs = [torch.empty_like(x) for x in xs]
    x_ptrs = _ptrs([x.data_ptr() for x in xs])
    out_ptrs = _ptrs([o.data_ptr() for o in outs])
    sources = [xs[(r - 1) % n].device for r in range(n)]
    lib = kernels.load().cdll
    _launch("ring_shift", outs, sources,
            lambda recv, n_recv, stream: lib.tsdr_ring_shift(
                n, x_ptrs, x0.numel() * x0.element_size(), out_ptrs, recv,
                n_recv, stream))
    return outs


def all_to_all(xs: Sequence[torch.Tensor]) -> list[list[torch.Tensor]]:
    """The all-to-all of a row of n shards in n - 1 steps of K5:
    ``xs[i][j]`` (axis 0 of length n) is bound for shard j, and shard j
    returns ``[xs[0][j], ..., xs[n-1][j]]`` on its own place — the
    exchange of ``lax.all_to_all`` along axis 0.

    Each shard starts a travelling buffer with the slices for the shards
    after it in ring order.  Every step passes all buffers one shard right
    (``ring_shift_cuda``); each buffer's first slice has then reached its
    shard, which keeps it and passes on the rest, so the buffers shrink in
    step and keep one shape across the row."""
    n = len(xs)
    for i, x in enumerate(xs):
        if x.shape[0] != n:
            raise ValueError(f"shard {i} has {x.shape[0]} slices on axis 0 "
                             f"for a row of {n}")
    got: list[list] = [[None] * n for _ in range(n)]
    travel = []
    for i, x in enumerate(xs):
        got[i][i] = x[i]
        travel.append(torch.cat([x[i + 1:], x[:i]]))
    for k in range(1, n):
        travel = ring_shift_cuda(travel)
        for i, t in enumerate(travel):
            got[i][(i - k) % n] = t[0]
        travel = [t[1:] for t in travel]
    return got
