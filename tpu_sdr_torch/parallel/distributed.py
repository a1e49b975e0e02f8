"""Multi-process runtime — the counterpart of
``tpu_sdr/parallel/distributed.py``.

``torch.distributed`` joins the processes: gloo for CPU tensors, NCCL for
CUDA ones.  Nothing tells a program of a cluster, so the caller gives the
rendezvous address (``tcp://host:port``), the world size and its rank.

The layout is the JAX package's: stations shard over the process axis
(``dp``) and time over each process's local devices (``sp``).  So every
halo exchange of the sharded chains stays inside a process, no sample
bytes cross processes (each process feeds only its own stations), and the
only traffic between processes is what a caller gathers on purpose
(:func:`fetch_global`, for validation or an audio sink).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpu_sdr_torch.device import resolve_device
from tpu_sdr_torch.parallel.mesh import Mesh, shard_time

BACKENDS = {"cpu": "gloo", "cuda": "nccl"}


def init_distributed(init_method: str, world_size: int, rank: int, *,
                     device_type: str) -> None:
    """Join the process group (idempotent): ``init_method`` such as
    ``tcp://127.0.0.1:29500``, and the device type of the tensors the
    processes exchange (``'cpu'`` -> gloo, ``'cuda'`` -> NCCL)."""
    if dist.is_initialized():
        return
    if device_type not in BACKENDS:
        raise ValueError(f"device type {device_type!r} not in "
                         f"{sorted(BACKENDS)}")
    dist.init_process_group(BACKENDS[device_type], init_method=init_method,
                            world_size=world_size, rank=rank)


def make_host_mesh(local_devices: Sequence[str | torch.device]) -> Mesh:
    """The ``(processes, local devices)`` mesh: row r holds process r's
    devices (every process names its own, the same on every host), and
    this process computes only its row."""
    devs = [resolve_device(d) for d in local_devices]
    arr = np.empty((dist.get_world_size(), len(devs)), dtype=object)
    for r in range(arr.shape[0]):
        for s, d in enumerate(devs):
            arr[r, s] = d
    return Mesh(arr, process_row=dist.get_rank())


def put_host_local_blocks(mesh: Mesh, local_blocks) -> list:
    """Feeder fan-out: this process's (local_stations, n) blocks cut over
    its own devices; the rows of the other processes stay ``None``.  No
    sample bytes cross processes."""
    row = mesh.process_row
    shards: list = [None] * mesh.devices.shape[0]
    shards[row] = shard_time(Mesh(mesh.devices[row:row + 1]), local_blocks)[0]
    return shards


def fetch_global(x: torch.Tensor) -> np.ndarray:
    """Every process's ``x`` (equal shapes), concatenated along axis 0 in
    rank order, as numpy on every process (``all_gather``).  Validation and
    audio-sink helper; the streaming path never calls it."""
    if not dist.is_initialized():
        return x.cpu().numpy()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts).cpu().numpy()


def multihost_wbfm_apply(chain, local_blocks, *carry):
    """Run a sharded WBFM chain (``wbfm_sharded`` or
    ``wbfm_sharded_fused``) on a host mesh, fed with this process's
    (local_stations, bytes) u8 blocks only."""
    return chain(put_host_local_blocks(chain.mesh, local_blocks), *carry)
