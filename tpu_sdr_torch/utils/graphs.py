"""The port's counterpart of ``jax.jit``: a streamer's per-block step run
as one CUDA graph replay.

The JAX package compiles each streamer's step into one XLA program, traced
once per shape and then dispatched with one call a block.  Here a step
function

    step(static, inputs, carries) -> (outputs, new_carries, aux)

gets one entry per key in :class:`StepGraphs`, where the key is
``static`` (the host values the step branches on: an fs/4 phase, a
resampler index) plus the shapes and dtypes of its inputs and carries.
``inputs`` and ``carries`` are lists of tensors, ``outputs`` and
``new_carries`` lists of tensors, ``aux`` any host value the step derives
from the key alone (a next phase, an output count).

* The first call with a new key runs the step eagerly on the entry's
  static input and carry buffers (on the capture stream: that call builds
  the kernels and creates the library handles and workspaces outside
  capture), then captures the same step over those buffers as a CUDA
  graph.  Every later call with that key copies the block into the static
  input (non-blocking, from a pinned staging buffer or from the card) and
  replays the graph.
* A host input may come as a tuple of numpy pieces of one dtype whose
  concatenation along the last axis is the input (a streamer's residual
  and the head of its read, from :func:`split_residual`): the pieces are
  written one after another into the staging buffer (on the CPU into the
  static input), so no joined copy is built first.  The key holds the
  shape of the whole input, so every split of it replays one graph.
* Each graph ends by writing the new carries into the static carry
  buffers, which the streamer then holds as its carries.  A carry assigned
  from outside (a reset, a checkpoint load, a hand-over) is not one of
  them, and is copied into them before the next replay.
* A step's outputs leave it in one of three forms, one call method
  each (a cache serves one form):

  - ``__call__``, host outputs: packed into one byte tensor inside the
    graph, they come to the host in one D2H copy into a pinned buffer,
    followed by one synchronize; the caller gets numpy arrays.
  - :meth:`StepGraphs.advance`, no outputs (``psd_accumulate``'s form,
    whose state stays on the card until it is read once): a replay is
    the input copy and the graph launch, with no D2H copy and no
    synchronize.  The next call's write into the pinned staging buffer
    waits on an event recorded after the copy out of it, not on the
    device.
  - :meth:`StepGraphs.on_device`, device outputs (the sharded functions,
    whose callers take tensors): each output and each new carry is
    handed out as a copy of its own, made on the card after the replay,
    so that a result kept across calls never changes.

  An output of the graph lives in its memory pool only until the next
  call, so nothing but that copy reads it.
* The launch counters of the kernel wrappers (registered in
  ``tpu_sdr_torch.kernels``) gain the captured step's launches at each
  replay; capture itself adds none.
* A streamer's graphs share one memory pool (``graph_pool_handle``); its
  cache holds the :data:`MAX_KEYS` most recently used keys.  Sharing is
  safe because the graphs of one streamer run one at a time and no output
  outlives its call.  They share the static carries too, so a cache
  belongs to one live streamer.
* Each call records its parts as spans of ``utils.profiling``, named
  after the cache, back to back from the call's start:
  ``<name>.stage`` (the key and its lookup, the switch to the device, the
  wait on the staging buffer's fence, the copy into it, the non-blocking
  H2D enqueue, carries copied in), ``<name>.replay`` (the host's launch of
  the graph and its launch counts; on the CPU the step itself), and in the
  host form ``<name>.sync`` (the D2H enqueue and the host's wait on the
  device) and ``<name>.unpack`` (the outputs' host copies).  A new key's
  eager run and capture is ``<name>.capture`` alone.  The inputs copied on
  the host and the outputs unpacked count into ``profiling.COPIED``.
* :func:`disabled` runs every step eagerly, as ``jax.disable_jit`` does,
  and records no spans.
  A capture that fails raises :class:`GraphCaptureError`, naming the
  streamer and the key; nothing falls back to eager without being asked.

CUDA graphs do not exist on the CPU: there the same step runs eagerly on
the same static buffers (the static-buffer form), so the CPU tests hold
the buffer discipline itself against the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Sequence

import numpy as np
import torch

from tpu_sdr_torch import kernels
from tpu_sdr_torch.utils import profiling

MAX_KEYS = 8  # the graphs a streamer keeps, most recently used first

_disabled = 0


@contextlib.contextmanager
def disabled():
    """Run every step eagerly inside this block (``jax.disable_jit``)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


class GraphCaptureError(RuntimeError):
    """A step could not be captured as a CUDA graph.  The streamer that
    raised it is not to be used again: the eager run of the block that
    precedes a capture has already moved its carries and its residual on,
    and that block's outputs are lost.  Go on with a new streamer (or a
    checkpoint loaded into one), under :func:`disabled` if need be."""


_capture_streams: dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every first call of a key and its capture run on, one a
    device.  It comes from the high-priority pool, so it is never one of
    the default-priority side streams that other code (the feeder's copies)
    takes from PyTorch's round-robin pool."""
    if device not in _capture_streams:
        _capture_streams[device] = torch.cuda.Stream(device, priority=-1)
    return _capture_streams[device]


def split_state(tree) -> tuple[tuple, list[torch.Tensor]]:
    """(host leaves, tensor leaves) of a tree of tuples and NamedTuples in
    field order: the host leaves go into a key, the tensors are carries."""
    host: list = []
    tensors: list[torch.Tensor] = []

    def walk(x):
        if isinstance(x, tuple):
            for sub in x:
                walk(sub)
        elif torch.is_tensor(x):
            tensors.append(x)
        else:
            host.append(x)

    walk(tree)
    return tuple(host), tensors


def join_state(tree, host: Sequence, tensors: Sequence[torch.Tensor]):
    """``tree``'s structure with its host and tensor leaves replaced, in the
    order :func:`split_state` gives them."""
    h, t = iter(host), iter(tensors)

    def walk(x):
        if isinstance(x, tuple):
            subs = [walk(sub) for sub in x]
            return type(x)(*subs) if hasattr(x, "_fields") else tuple(subs)
        return next(t) if torch.is_tensor(x) else next(h)

    return walk(tree)


def split_residual(pending, buf, quantum: int,
                   device: torch.device | None = None) -> tuple[Any, Any, int]:
    """A streamer's read cut into whole quanta along the last axis:
    (the usable part, the new residual, the bytes copied on the host).

    A numpy ``buf`` (or anything ``np.asarray`` takes, in ``pending``'s
    dtype): the usable part is the pieces ``(pending, the head of buf)``,
    a step's host input, or ``()``; the new residual is a copy of the tail
    of ``buf`` under one quantum, owned by the streamer (``buf`` may be
    read-only or reused by its caller).  Where the residual and the read
    together hold no whole quantum, they are joined, which is small.  A
    tensor ``buf`` (say, from ``BlockFeeder.device_blocks``) goes to
    ``device`` and is joined there with one ``torch.cat`` only where a
    residual leads it; the usable part and the residual are views of the
    result.  A residual of the other kind is taken over.  ``buf``'s
    leading axes must be the residual's rows."""
    tensor = isinstance(buf, torch.Tensor)
    if not tensor:
        if isinstance(pending, torch.Tensor):
            pending = pending.cpu().numpy()
        buf = np.asarray(buf, dtype=pending.dtype)
    if buf.shape[:-1] != pending.shape[:-1]:
        raise ValueError(f"a read of shape {tuple(buf.shape)} does not "
                         f"continue rows of shape {tuple(pending.shape[:-1])}")
    if tensor:
        if not isinstance(pending, torch.Tensor):
            pending = torch.from_numpy(np.ascontiguousarray(pending))
        data = buf = buf.to(buf.device if device is None else device)
        copied = 0
        if pending.shape[-1]:
            data = torch.cat([pending.to(buf.device), buf], dim=-1)
            if data.device.type == "cpu":
                copied = data.nbytes
        usable = data.shape[-1] - data.shape[-1] % quantum
        return data[..., :usable], data[..., usable:], copied
    have = pending.shape[-1]
    total = have + buf.shape[-1]
    usable = total - total % quantum
    if usable == 0:
        data = np.concatenate([pending, buf], axis=-1)
        return (), data, data.nbytes
    cut = usable - have
    if cut == buf.shape[-1]:  # no tail: the residual is empty
        return (pending, buf), pending[..., :0], 0
    rest = buf[..., cut:].copy()
    return (pending, buf[..., :cut]), rest, rest.nbytes


def width(block) -> int:
    """The length along the last axis of a usable block from
    :func:`split_residual` (a row's bytes for a u8 read): a tensor's or an
    array's, or its pieces' together (``()`` holds none)."""
    if isinstance(block, tuple):
        return sum(p.shape[-1] for p in block)
    return block.shape[-1]


def _shape(x) -> tuple:
    """An input's shape; pieces give their concatenation's."""
    if isinstance(x, tuple):
        return x[0].shape[:-1] + (sum(p.shape[-1] for p in x),)
    return tuple(x.shape)


def _signature(xs) -> tuple:
    return tuple((_shape(x), str(x[0].dtype)) if isinstance(x, tuple)
                 else (tuple(x.shape), str(x.dtype)) for x in xs)


def _on_host(x) -> bool:
    """A numpy input, or numpy pieces."""
    return isinstance(x, (np.ndarray, tuple))


def _put(dst: np.ndarray, x) -> None:
    """A host input into ``dst``: an array whole, pieces one after
    another along the last axis."""
    if not isinstance(x, tuple):
        np.copyto(dst, x)
        return
    at = 0
    for p in x:
        n = p.shape[-1]
        np.copyto(dst[..., at:at + n], p)
        at += n


def _torch_dtype(x) -> torch.dtype:
    if torch.is_tensor(x):
        return x.dtype
    dtype = x[0].dtype if isinstance(x, tuple) else x.dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, tuple):
        x = np.concatenate(x, axis=-1)
    x = np.ascontiguousarray(x)
    return torch.from_numpy(x if x.flags.writeable else x.copy()).to(device)


def _pack(outputs: Sequence[torch.Tensor], avoid: set[int]
          ) -> torch.Tensor:
    """Every output's bytes in one u8 tensor (one ``cat``; a lone output
    that shares no storage with ``avoid``, the static buffers that the end
    of the step rewrites, goes as it is)."""
    flat = [o.reshape(-1).view(torch.uint8) if o.dtype != torch.bool
            else o.reshape(-1).to(torch.uint8) for o in outputs]
    if len(flat) == 1 and outputs[0].untyped_storage().data_ptr() not in avoid:
        return flat[0]
    return torch.cat(flat)


def _own(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` in storage of its own (a view of a wider tensor is
    copied alone, contiguous)."""
    return x.clone(memory_format=torch.contiguous_format)


@dataclass
class _Entry:
    """One key's static buffers, its graph and what it needs to replay."""

    key: Hashable
    form: str
    inputs: list[torch.Tensor]
    staging: list[torch.Tensor | None]  # pinned host copies of host inputs
    carries: list[torch.Tensor]
    layout: list[tuple] = field(default_factory=list)  # (np dtype, shape)
    unpacked: int = 0                     # the outputs' bytes
    host: torch.Tensor | None = None      # the outputs' bytes on the host
    packed: torch.Tensor | None = None    # the graph's packed outputs
    outs: list[torch.Tensor] = field(default_factory=list)  # device form
    aux: Any = None
    graph: torch.cuda.CUDAGraph | None = None
    # (a wrapper's counter, the launches a replay adds to it)
    launches: list[tuple[dict, dict]] = field(default_factory=list)
    # recorded after the copies out of the staging buffers: the next
    # write into them waits on it
    fence: torch.cuda.Event | None = None


class StepGraphs:
    """One streamer's per-key cache of captured steps (see the module
    docstring).  ``name`` names the streamer in errors."""

    def __init__(self, name: str, step: Callable, device: torch.device):
        self.name = name
        # a streamer's bound method, held weakly: the streamer holds this
        # cache, and a cycle would leave both (pinned buffers, graphs) to
        # the garbage collector, which may run at any allocation
        self._step = (weakref.WeakMethod(step) if hasattr(step, "__self__")
                      else lambda: step)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.captures = 0  # graphs captured (static forms built on the CPU)
        self.replays = 0
        self._entries: OrderedDict[Hashable, _Entry] = OrderedDict()
        self._carries: list[torch.Tensor] | None = None  # shared statics
        self._pool = None
        self._last: _Entry | None = None
        self._form: str | None = None
        self._names = tuple(f"{name}.{part}" for part in
                            ("stage", "replay", "sync", "unpack", "capture"))

    @property
    def keys(self) -> list:
        """The cached keys, least recently used first."""
        return list(self._entries)

    @property
    def graph(self) -> torch.cuda.CUDAGraph | None:
        """The graph of the last call's key (``None`` before it, on the CPU
        or eagerly)."""
        return None if self._last is None else self._last.graph

    def clear(self) -> None:
        """Drop every key's graph: the next call of each key runs eagerly
        and captures again.  The static carries stay."""
        self._entries.clear()
        self._last = None

    def __call__(self, static: Hashable, inputs: Sequence, carries:
                 Sequence[torch.Tensor]
                 ) -> tuple[list[np.ndarray], list[torch.Tensor], Any]:
        """One block: (host outputs, new carries, aux).  ``inputs`` may be
        numpy arrays, tuples of numpy pieces or tensors; ``carries`` are
        the streamer's."""
        return self._call("host", static, inputs, carries)

    def advance(self, static: Hashable, inputs: Sequence,
                carries: Sequence[torch.Tensor]
                ) -> tuple[list[torch.Tensor], Any]:
        """One block of a step without outputs: (new carries, aux).  On the
        card nothing waits for the device."""
        _, new, aux = self._call("none", static, inputs, carries)
        return new, aux

    def on_device(self, static: Hashable, inputs: Sequence,
                  carries: Sequence[torch.Tensor]
                  ) -> tuple[list[torch.Tensor], list[torch.Tensor], Any]:
        """One block: (outputs, new carries, aux), every tensor a copy of
        its own on the device, which the caller owns."""
        return self._call("device", static, inputs, carries)

    def _call(self, form: str, static, inputs, carries):
        if self._form is None:
            self._form = form
        elif form != self._form:
            raise ValueError(f"{self.name}: a cache serves one output form "
                             f"({self._form}), not also {form}")
        if _disabled:
            outputs, new, aux = self._step()(
                static, [_as_tensor(x, self.device) for x in inputs],
                list(carries))
            if form == "device":
                return list(outputs), list(new), aux
            self._check_form(form, outputs)
            if form == "none":
                return [], list(new), aux
            packed = _pack(outputs, set())
            return (self._unpack(packed.cpu(), self._layout(outputs)),
                    list(new), aux)
        t0 = profiling.clock()
        key = (static, _signature(inputs), _signature(carries))
        entry = self._entries.get(key)
        cuda = self.device.type == "cuda"
        with torch.cuda.device(self.device) if cuda else \
                contextlib.nullcontext():
            if entry is None:
                results, copied = self._first(key, form, static, inputs,
                                              carries)
                profiling.span(self._names[4], t0, profiling.clock(), copied)
                return results
            self._entries.move_to_end(key)
            self._last = entry
            staged = self._load(entry, inputs, carries)
            t1 = profiling.clock()
            if cuda:
                entry.graph.replay()
                for counter, launched in entry.launches:
                    for name, n in launched.items():
                        counter[name] += n
                packed = entry.packed
            else:
                packed = self._body(static, entry)
            self.replays += 1
            t2 = profiling.clock()
            if entry.form != "host":
                profiling.span(self._names[0], t0, t1, staged)
                profiling.span(self._names[1], t1, t2)
                return self._results(entry, packed)
            host = self._fetch(entry, packed)
            t3 = profiling.clock()
            outputs = self._unpack(host, entry.layout)
            profiling.step_spans(self._names, t0, t1, t2, t3,
                                 profiling.clock(), staged, entry.unpacked)
            return outputs, entry.carries, entry.aux

    # -- the parts of a call ------------------------------------------------

    def _check_form(self, form: str, outputs) -> None:
        if form == "none" and len(outputs):
            raise ValueError(f"{self.name}: a step without outputs returned "
                             f"{len(outputs)}")

    def _body(self, static, e: _Entry) -> torch.Tensor | None:
        """The step on the entry's static buffers: the packed outputs (host
        form), the new carries written into the static carries."""
        outputs, new, aux = self._step()(static, e.inputs, e.carries)
        if len(new) != len(e.carries):
            raise ValueError(f"{self.name}: the step returned {len(new)} "
                             f"carries for {len(e.carries)}")
        self._check_form(e.form, outputs)
        avoid = {t.untyped_storage().data_ptr() for t in e.carries + e.inputs}
        packed = None
        if e.form == "host":
            packed = _pack(outputs, avoid)
        elif e.form == "device":
            # an output in a static buffer would change under it
            e.outs = [_own(o) if o.untyped_storage().data_ptr() in avoid
                      else o for o in outputs]
        # a new carry that lies in another static carry is read before
        # that one is rewritten
        held = {t.untyped_storage().data_ptr() for t in e.carries}
        new = [c.clone() if c is not s and c.untyped_storage().data_ptr()
               in held else c for s, c in zip(e.carries, new)]
        for s, c in zip(e.carries, new):
            if c is not s:
                s.copy_(c)
        e.layout = self._layout(outputs)
        e.unpacked = sum(int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                         for dtype, shape in e.layout)
        e.aux = aux
        return packed

    @staticmethod
    def _layout(outputs) -> list[tuple]:
        return [(_np_dtype(o.dtype), tuple(o.shape)) for o in outputs]

    @staticmethod
    def _unpack(host: torch.Tensor, layout) -> list[np.ndarray]:
        raw = host.numpy()
        out, at = [], 0
        for dtype, shape in layout:
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            a = raw[at:at + n]
            out.append((a.view(dtype) if dtype != np.bool_ else
                        a.astype(np.bool_)).reshape(shape).copy())
            at += n
        return out

    def _results(self, e: _Entry, packed: torch.Tensor | None):
        """A call's (outputs, carries, aux) in the entry's form."""
        if e.form == "none":
            return [], e.carries, e.aux
        if e.form == "device":
            return ([_own(o) for o in e.outs], [_own(c) for c in e.carries],
                    e.aux)
        return self._unpack(self._fetch(e, packed), e.layout), e.carries, \
            e.aux

    def _fetch(self, e: _Entry, packed: torch.Tensor) -> torch.Tensor:
        """The host form's packed outputs on the host: on the card, one
        D2H copy into the pinned buffer and the wait for it."""
        if self.device.type != "cuda":
            return packed
        e.host.copy_(packed, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return e.host

    def _load(self, e: _Entry, inputs, carries) -> int:
        """The block into the static inputs; carries assigned from outside
        into the static carries.  Returns the bytes copied on the host (an
        input into its staging buffer, or on the CPU into its static
        buffer, once, whether it came whole or in pieces)."""
        staged = False
        copied = 0
        for static, stage, x in zip(e.inputs, e.staging, inputs):
            if x is static:
                continue
            host = _on_host(x)
            if host and stage is None:  # the CPU's static buffer
                _put(static.numpy(), x)
                copied += static.nbytes
                continue
            if stage is not None and (host or x.device.type == "cpu"):
                if not staged and e.fence is not None:
                    e.fence.synchronize()  # the last copy out of it is done
                staged = True
                if host:
                    _put(stage.numpy(), x)
                else:
                    stage.copy_(x)
                copied += stage.nbytes
                x = stage
            elif x.device.type == "cpu" and static.device.type == "cpu":
                copied += static.nbytes
            static.copy_(x, non_blocking=True)
        if staged:
            if e.fence is None:
                e.fence = torch.cuda.Event()
            e.fence.record(torch.cuda.current_stream(self.device))
        for static, c in zip(e.carries, carries):
            if c is not static:
                static.copy_(c)
        return copied

    def _new_entry(self, key, form, inputs, carries) -> _Entry:
        dev = self.device
        cuda = dev.type == "cuda"
        statics = [torch.empty(_shape(x), dtype=_torch_dtype(x),
                               device=dev) for x in inputs]
        staging = [torch.empty(_shape(x), dtype=_torch_dtype(x),
                               pin_memory=True)
                   if cuda and (_on_host(x) or x.device.type == "cpu")
                   else None
                   for x in inputs]
        sig = _signature(carries)
        if self._carries is None or _signature(self._carries) != sig \
                or any(c.device != dev for c in self._carries):
            self._carries = [torch.empty_like(c, device=dev) for c in carries]
        e = _Entry(key, form, statics, staging, self._carries)
        return e, self._load(e, inputs, carries)

    def _first(self, key, form, static, inputs, carries):
        """A new key: the eager step on fresh static buffers, then (on the
        card) its capture over the same buffers.  Returns the results and
        the bytes copied on the host."""
        e, copied = self._new_entry(key, form, inputs, carries)
        if self.device.type != "cuda":
            results = self._results(e, self._body(static, e))
            self._keep(e)
            return results, copied + (e.unpacked if form == "host" else 0)
        cur = torch.cuda.current_stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side = _capture_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            packed = self._body(static, e)
            if form == "host":
                nbytes = packed.numel()
                e.host = torch.empty(nbytes, dtype=torch.uint8,
                                     pin_memory=True)
                e.host.copy_(packed, non_blocking=True)
            elif form == "device":
                results = self._results(e, None)
                # the caller's stream uses them from here
                for t in results[0] + results[1]:
                    t.record_stream(cur)
        side.synchronize()
        if form == "host":
            results = self._unpack(e.host, e.layout), e.carries, e.aux
        elif form == "none":
            results = [], e.carries, e.aux
        n_out = len(e.layout)
        del packed
        e.outs = []
        # the eager call has moved the carries on: capture the step that
        # takes them from here
        before = [(c, dict(c)) for c in kernels.LAUNCH_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        # capture_begin/end rather than torch.cuda.graph, which would also
        # synchronize the device, collect garbage and empty the allocator's
        # cache at every new key.  The collector stays off meanwhile: what
        # it frees may have been used on the capturing stream (a pinned
        # buffer then records an event there, which breaks the capture)
        failure = None
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self._pool,
                                    capture_error_mode="thread_local")
                try:
                    e.packed = self._body(static, e)
                except Exception as err:
                    failure = err
                try:
                    graph.capture_end()
                except Exception as err:
                    failure = failure or err
        finally:
            if collecting:
                gc.enable()
        # capture launches nothing: take its ticks back, keep them
        e.launches = [(c, {k: n - b[k] for k, n in c.items()})
                      for c, b in before]
        for c, b in before:
            c.update(b)
        if failure is not None:
            raise GraphCaptureError(
                f"{self.name}: capturing the step for key {key!r} failed: "
                f"{failure}") from failure
        if form == "host" and e.packed.numel() != nbytes or \
                len(e.layout) != n_out:
            raise GraphCaptureError(f"{self.name}: key {key!r} captured "
                                    f"other outputs than the eager step gave")
        cur.wait_stream(side)
        e.graph = graph
        self._keep(e)
        return results, copied + (e.unpacked if form == "host" else 0)

    def _keep(self, e: _Entry) -> None:
        self._entries[e.key] = e
        while len(self._entries) > MAX_KEYS:
            self._entries.popitem(last=False)
        self._last = e
        self.captures += 1
