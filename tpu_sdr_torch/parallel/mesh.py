"""Meshes of shards — the counterpart of ``tpu_sdr/parallel/mesh.py``.

A :class:`Mesh` is a ``(dp, sp)`` grid of places with the axis names
``("dp", "sp")``: stations shard over ``dp``, time over ``sp``.  Unlike a
JAX mesh, whose entries are distinct devices, a place is a
``torch.device`` that may repeat: a shard is a place, not a card.
``[torch.device("cuda", 0)] * 4`` puts four time shards on one GPU (their
halo exchange then copies between buffers of one card), and
``[torch.device("cpu")] * 8`` mirrors the 8-device virtual CPU mesh of the
JAX tests.  The caller names every device: a CUDA device that does not
exist raises, it never becomes the CPU.

:func:`shard_time` is the counterpart of placing an array with
``NamedSharding(mesh, P("dp", "sp"))``; ``ShardedWbfm.assemble`` is its
inverse for the chains' audio.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpu_sdr_torch.device import resolve_device


class Mesh:
    """A ``(dp, sp)`` array of ``torch.device``.

    ``process_row``: in a multi-process mesh (``distributed.make_host_mesh``)
    the one ``dp`` row this process owns; ``None`` when this process drives
    every row."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: np.ndarray, process_row: int | None = None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (dp, sp) array, got "
                             f"shape {devices.shape}")
        types = {d.type for d in devices.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh mixes device types {sorted(types)}")
        if process_row is not None and not 0 <= process_row < devices.shape[0]:
            raise ValueError(f"process row {process_row} outside dp="
                             f"{devices.shape[0]}")
        self.devices = devices
        self.process_row = process_row

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def is_cuda(self) -> bool:
        return self.devices.flat[0].type == "cuda"

    @property
    def home(self) -> torch.device:
        """Where gathered results and the streaming carries live: the place
        of this process's first shard."""
        return self.devices[self.process_row or 0, 0]

    @property
    def single_place(self) -> bool:
        """Every shard on one place, all driven by this process: the
        sharded functions then run through ``utils.graphs`` (one CUDA
        graph replay a call on a card, the static-buffer form on the
        CPU)."""
        return self.process_row is None and len(set(self.devices.flat)) == 1

    def local_rows(self) -> list[int]:
        """The ``dp`` rows this process computes."""
        if self.process_row is None:
            return list(range(self.devices.shape[0]))
        return [self.process_row]


def make_mesh(dp: int = 1, sp: int | None = None, *,
              devices: Sequence[str | torch.device]) -> Mesh:
    """Build a ``(dp, sp)`` mesh over ``devices`` (row-major; entries may
    repeat).  ``sp`` defaults to all remaining devices."""
    devs = [resolve_device(d) for d in devices]
    n = len(devs)
    if sp is None:
        if dp < 1 or n % dp:
            raise ValueError(f"{n} devices not divisible by dp={dp}")
        sp = n // dp
    if dp < 1 or sp < 1 or dp * sp > n:
        raise ValueError(f"mesh {dp}x{sp} needs {dp * sp} devices, have {n}")
    arr = np.empty((dp, sp), dtype=object)
    for i, d in enumerate(devs[: dp * sp]):
        arr[i // sp, i % sp] = d
    return Mesh(arr)


def _to(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device).contiguous()


def time_cuts(mesh: Mesh, blocks) -> list[list]:
    """The ``dp x sp`` contiguous cuts of ``(stations, n)`` blocks (numpy
    or torch), stations over ``dp`` and the last axis over ``sp``, as
    views of ``blocks``: ``cuts[d][s]``."""
    dp, sp = mesh.devices.shape
    stations, n = blocks.shape
    if stations % dp or n % sp:
        raise ValueError(f"blocks of shape {tuple(blocks.shape)} do not "
                         f"split over a {dp}x{sp} mesh")
    st, n_loc = stations // dp, n // sp
    return [[blocks[d * st:(d + 1) * st, s * n_loc:(s + 1) * n_loc]
             for s in range(sp)] for d in range(dp)]


def shard_time(mesh: Mesh, blocks) -> list[list[torch.Tensor | None]]:
    """:func:`time_cuts` of ``blocks``, each on its place: ``shards[d][s]``.
    Rows this process does not own are ``None``."""
    cuts = time_cuts(mesh, blocks)
    local = set(mesh.local_rows())
    return [[_to(x, mesh.devices[d, s]) for s, x in enumerate(row)]
            if d in local else [None] * len(row)
            for d, row in enumerate(cuts)]


def replicate(devices: Sequence[torch.device], x) -> list[torch.Tensor]:
    """``x`` on every place (one copy per distinct device, shared by the
    shards that sit on it): the counterpart of ``P()`` placement."""
    copies: dict[torch.device, torch.Tensor] = {}
    for d in devices:
        if d not in copies:
            copies[d] = _to(x, d)
    return [copies[d] for d in devices]
