"""Streaming-state checkpoint / resume — the counterpart of
``tpu_sdr/stream/checkpoint.py``, in its ``.npz`` format (version 2: the
class name, the captured attribute list ``__attrs__`` and each
attribute's leaf count).

Every streamer keeps its carries (filter histories, fractional phases,
pending bytes) in attributes; each one of ``_STATE_ATTRS`` that the
streamer has is flattened to leaves and stored, and loading puts the
leaves back into the live object's own structure, so the streamer must
be constructed with the same configuration first.  The result is
bit-identical output across a stop and a resume.

The flatten walks tuples, NamedTuples and lists (in field order, as
``jax.tree_util`` does; ``None`` is an empty subtree); its leaves are
tensors, numpy arrays and Python numbers.  A loaded tensor lands on the
live leaf's device and dtype.  The fused streamers' ``_pending`` is a
device tensor once they are fed tensors (``BlockFeeder.device_blocks``):
it saves as numpy like any leaf and loads back onto the live streamer's
device, or as numpy into a streamer not yet fed, whose next tensor block
joins it on the device; either way the resume is bit-equal.  ``pfb_carry`` — the fused wideband
streamer's K3 carry — is captured too: the JAX attribute list lacks it,
so a JAX checkpoint of that streamer drops the carry.

A graphed streamer (``utils.graphs``; since the exact chain and the PSD
joined them, every streamer) holds the static carry buffers of its
graphs; a load assigns new tensors, which its next read copies into
those buffers before the graph replays.  ``FusedWbfmBatchStreamer.phases``
reads and takes a list (its phases live on the device), so they save as
one int a station, as before.
"""

from __future__ import annotations

import numpy as np
import torch

_STATE_ATTRS = (
    "state", "states", "resamp_hist", "resamp_hists", "phase", "phases",
    "_pending", "pfb_carry",
)

_FORMAT_VERSION = 2


def _flatten(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in _flatten(sub)]
    if isinstance(tree, (torch.Tensor, np.ndarray, int, float)):
        return [tree]
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator
    ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(_unflatten(sub, leaves) for sub in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(sub, leaves) for sub in tree)
    return next(leaves)


def _restore(leaf, loaded: np.ndarray):
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(loaded)).to(device=leaf.device,
                                                      dtype=leaf.dtype)
    if isinstance(leaf, np.ndarray):
        return loaded.astype(leaf.dtype, copy=False)
    return type(leaf)(loaded)


def save_stream_state(path: str, streamer) -> None:
    """Serialize a streamer's carries to ``path`` (.npz), recording which
    attributes were captured and how many leaves each flattened to, so
    :func:`load_stream_state` can verify round-trip completeness."""
    saved: list[str] = []
    payload: dict[str, np.ndarray] = {
        "__version__": np.int64(_FORMAT_VERSION),
        "__class__": np.str_(type(streamer).__name__),
    }
    for attr in _STATE_ATTRS:
        if not hasattr(streamer, attr):
            continue
        saved.append(attr)
        leaves = _flatten(getattr(streamer, attr))
        payload[f"{attr}.__n__"] = np.int64(len(leaves))
        for i, leaf in enumerate(leaves):
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().cpu().numpy()
            payload[f"{attr}.{i}"] = np.asarray(leaf)
    payload["__attrs__"] = np.str_(",".join(saved))
    np.savez(path, **payload)


def load_stream_state(path: str, streamer) -> None:
    """Restore carries saved by :func:`save_stream_state` into a freshly
    constructed streamer of the same class and configuration (in place)."""
    data = np.load(path, allow_pickle=False)
    saved_cls = str(data["__class__"])
    if saved_cls != type(streamer).__name__:
        raise ValueError(
            f"checkpoint is for {saved_cls}, not {type(streamer).__name__}")
    live = [a for a in _STATE_ATTRS if hasattr(streamer, a)]
    if "__attrs__" in data:  # format >= 2: completeness both ways
        saved = [a for a in str(data["__attrs__"]).split(",") if a]
        if saved != live:
            raise ValueError(
                f"checkpoint state attrs {saved} != live streamer's {live} "
                "(renamed/added carry attribute? config mismatch?)")
    restored = {}
    for attr in live:
        current = getattr(streamer, attr)
        leaves = _flatten(current)
        nkey = f"{attr}.__n__"
        if nkey in data and int(data[nkey]) != len(leaves):
            raise ValueError(
                f"{attr}: checkpoint has {int(data[nkey])} leaves, live "
                f"state flattens to {len(leaves)} (structure drift)")
        new_leaves = []
        for i, leaf in enumerate(leaves):
            key = f"{attr}.{i}"
            if key not in data:
                raise ValueError(f"checkpoint missing {key} "
                                 f"(config mismatch?)")
            loaded = data[key]
            # pending byte buffers legitimately vary in length; fixed state
            # must match (config mismatch guard)
            if attr != "_pending" and np.shape(loaded) != tuple(np.shape(leaf)):
                raise ValueError(
                    f"{key}: shape {np.shape(loaded)} != "
                    f"{tuple(np.shape(leaf))}")
            new_leaves.append(_restore(leaf, loaded))
        restored[attr] = _unflatten(current, iter(new_leaves))
    # every attribute checked before any is assigned: a failed load leaves
    # the streamer as it was
    for attr, value in restored.items():
        setattr(streamer, attr, value)
