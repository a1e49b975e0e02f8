"""Halo exchange between time shards as plain tensor copies — the
counterpart of ``tpu_sdr/parallel/halo.py`` (``lax.ppermute``).

The streaming carries of the serial chain (FIR history, the
discriminator's previous sample, the resampler history) become halo
exchanges when time is sharded: each shard needs the trailing samples of
its left neighbour (overlap-save).  A row of shards is a list of tensors,
one per shard in ``sp`` order, each on its own place; an exchange copies
tensors between places (``Tensor.to``), the counterpart of a ``ppermute``
neighbour shift.  Every result is a fresh tensor on its receiver's place,
never a view of a sender's buffer.

:func:`pull_left_halo` and :func:`ring_shift` are also the plain versions
of the K4 and K5 kernels (``parallel.cuda_halo``).
"""

from __future__ import annotations

from typing import Sequence

import torch


def _copy(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=like.device, dtype=like.dtype, copy=True)


def pull_left_halo(xs: Sequence[torch.Tensor], halo: int,
                   left_edge: torch.Tensor | None = None
                   ) -> list[torch.Tensor]:
    """The last ``halo`` entries (along axis 0) of each shard's LEFT
    neighbour, on the shard's own place.

    Non-circular: shard 0 receives ``left_edge`` (the global streaming
    carry, any tensor of ``halo * prod(shape[1:])`` elements) or zeros."""
    if not xs:
        raise ValueError("an empty row of shards")
    if halo < 1:
        raise ValueError(f"halo of {halo} entries")
    for i, x in enumerate(xs):
        if x.shape[0] < halo:
            raise ValueError(f"shard {i} of {x.shape[0]} entries is shorter "
                             f"than the halo of {halo}")
    x0 = xs[0]
    shape = (halo, *x0.shape[1:])
    if left_edge is None:
        out = [torch.zeros(shape, dtype=x0.dtype, device=x0.device)]
    else:
        out = [_copy(left_edge, x0).reshape(shape)]
    for prev, x in zip(xs[:-1], xs[1:]):
        out.append(_copy(prev[prev.shape[0] - halo:], x))
    return out


def push_right_edge(xs_last: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Give every shard its left neighbour's final entries — used to seed
    per-shard recurrences (e.g. the discriminator's previous sample)."""
    return pull_left_halo(xs_last, xs_last[0].shape[0])


def ring_shift(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Circular shift: shard i's whole tensor lands on shard (i + 1) % n
    (each shard returns its left neighbour's, wrapping); a one-shard row
    gets a copy of its own."""
    if not xs:
        raise ValueError("an empty row of shards")
    n = len(xs)
    return [_copy(xs[(i - 1) % n], xs[i]) for i in range(n)]
