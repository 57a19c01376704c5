"""The port's jit unit: ``jit(fn)`` runs a call of ``fn`` on the card as
one CUDA graph, captured once per shape and replayed.

Counterpart of ``jax.jit`` at the JAX package's call sites (bench.py's
step, ``ecckd_tpu/cli/scale_bench.py``): there a repeated call of a
pipeline function costs one dispatch, its host preparation fused around
the kernel.  Here
``pipeline.lw_sw_fluxes`` re-runs its preparation (ops/cuda/plan.py
``prepare``, the ctypes structs, the launch) as Python and small torch
ops on every call; ``jit(pipeline.lw_sw_fluxes)`` records that call's
device work once in a ``torch.cuda.CUDAGraph`` and replays it.

Per key (``key``: ``fn``, every non-tensor argument by value and each
model by identity, each tensor's shape, dtype, device and strides, a
``GasConcs``'s names and values the same way, the table mode
``config.is_fast()`` and the NaN-debugging switch; tensor values never):

* the first call runs ``fn`` eagerly: the warm-up that capture needs
  (gas plans, flat tables, the kernels' libraries and occupancy, all
  cached at first use), so a one-shot caller pays nothing;
* the second call captures ``fn`` on static input buffers that the entry
  owns, then replays it;
* every later call copies each tensor input into its static buffer,
  replays, and returns fresh outputs (copies), as ``jax.jit`` returns
  fresh arrays.

Calls whose tensors all lie on the CPU run ``fn`` eagerly.  A failed
capture raises: there is no eager fallback.

A tensor's device is in the key, so the pieces of a column split over
several cards (parallel/mesh.py ``ColumnShards``, the JAX step's
``@jax.jit`` over a mesh) each get their own entry: a warm-up, a graph
and static buffers on that card, and a replay queued on that card's
current stream.  Nothing waits on the host between cards, and a capture
that fails on any card raises.  Inputs that require grad
while grad is enabled raise ``ValueError``: a graph defines no backward.

An entry holds its models and their caches (``CKDModel._cache``: the
tables the graph reads at their captured addresses), so a model stays
alive, and its ``id`` unused by another, while the entry lives.

Launch counts stay true: the kernel wrappers count a launch in Python,
one count per launch mode (``COUNTERS``; ops/cuda/binding.py
``MODES``, ``launch_chunks``), which capture runs once without running a kernel and
replay does not run at all.  The entry takes back what capture counted
and adds it on every replay.  With NaN debugging on
(``utils.checks``), whose checks read the device and cannot run inside a
graph, capture runs without it and the replayed outputs are checked as
stage "captured call".

The returned callable counts, beside ``entries``, its ``captures`` (graphs
built) and ``replays`` (calls replayed).  In steady state ``captures``
stays flat; a count that grows with the calls means a key that changes
from call to call, each call building its graph again.

While a ``torch.profiler`` records, each call is one ``capture.call``
span (utils/profiling.py, on the clock of the trace's CUDA activity).
It holds ``capture.key`` (``_walk``, one pass over the arguments that
gives the tensors, their devices and the key; ``_card``; the entry's
lookup) and, on a replayed call, in turn ``capture.copy_in``
(the wait for the previous replay's copies out, and the copy into the
static buffers), ``capture.replay`` (``graph.replay()``) and
``capture.copy_out`` (the ``empty_like``s and the copy out).  A key's
first call and its capture are counted (``entries``, ``captures``), not
spanned: they fall in warm-up.  Spans exist only while a profiler
records; otherwise a call enters no range.

This module imports nothing of JAX.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional

import torch

from ecckd_tpu_torch import config
from ecckd_tpu_torch.gases import GasConcs
from ecckd_tpu_torch.models.ckd import CKDModel
from ecckd_tpu_torch.ops.cuda import binding
from ecckd_tpu_torch.ops.cuda.lw import lw_fluxes_cuda
from ecckd_tpu_torch.ops.cuda.lwsw import lwsw_fluxes_cuda
from ecckd_tpu_torch.ops.cuda.sw import sw_fluxes_cuda
from ecckd_tpu_torch.utils import checks, profiling
from ecckd_tpu_torch.utils.tree import tree_leaves, tree_map

COUNTERS = tuple((w, binding.MODES[mode][1])
                 for name, w in (("lwsw", lwsw_fluxes_cuda),
                                 ("lw", lw_fluxes_cuda),
                                 ("sw", sw_fluxes_cuda))
                 for mode in binding.KERNEL_MODES[name]) + (
                     (lwsw_fluxes_cuda, binding.JAC[1]),)
"""The kernel wrappers' launch counts, one per launch mode (the merged
kernel's f64 one too) and the merged kernel's Jacobian's, that a replay
adds back."""


_TENSOR, _GASES, _MODEL, _VALUE = range(4)
_KINDS = {torch.Tensor: _TENSOR, GasConcs: _GASES, CKDModel: _MODEL,
          **dict.fromkeys((int, float, bool, str, type(None)), _VALUE)}
"""How the pass keys an argument, by its exact type; any other type takes
``_kind``."""


def _walk(fn: Callable, args: tuple, kwargs: Dict[str, Any]):
    """One pass over the arguments of ``fn(*args, **kwargs)``, positional
    then keyword by name, each dispatched on its exact type: (the
    tensors, in the order ``tree_leaves((args, sorted kwargs))`` gives
    them; the set of their devices; the key; the ``TypeError`` that
    keying an argument raises, or None).  The key is flat: ``fn``, the
    counts, each argument's parts after a tag that fixes their number,
    the table mode and, last, the NaN-debugging switch."""
    tensors: List[torch.Tensor] = []
    devices: set = set()
    faults: List[TypeError] = []
    names = tuple(sorted(kwargs))
    parts = [fn, len(args), names]
    _scan((*args, *map(kwargs.__getitem__, names)), tensors, devices,
          parts, faults)
    parts += (config.is_fast(), checks.nan_debugging())
    return tensors, devices, tuple(parts), (faults[0] if faults else None)


def _scan(items, tensors: list, devices: set, parts: list, faults: list
          ) -> None:
    """``_walk``'s pass over ``items`` (the arguments, or a ``GasConcs``'s
    values), adding to its tensors, devices, parts and faults."""
    for x in items:
        kind = _KINDS.get(type(x))
        if kind is None:
            kind = _kind(x, tensors, devices, faults)
        if kind is _TENSOR:
            device = x.device
            devices.add(device)
            tensors.append(x)
            parts += (_TENSOR, x.shape, x.dtype, device, x.stride())
        elif kind is _GASES:
            parts += (_GASES, x.names, len(x.values))
            _scan(x.values, tensors, devices, parts, faults)
        elif kind is _MODEL:
            parts += (_MODEL, id(x))
        elif kind is _VALUE:
            parts += (_VALUE, type(x), x)


def _kind(x, tensors: list, devices: set, faults: list) -> Optional[int]:
    """The kind of an argument of an uncommon type (a subclass, a
    container, any other value), or None after recording why it cannot
    be keyed; a container's tensors still join the call's."""
    for kind, cls in ((_TENSOR, torch.Tensor), (_GASES, GasConcs),
                      (_MODEL, CKDModel)):
        if isinstance(x, cls):
            return kind
    inner = [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]
    if inner:
        tensors += inner
        devices.update(t.device for t in inner)
        faults.append(TypeError(
            f"capture.jit: a {type(x).__name__} of tensors is not an "
            "argument it takes; pass the tensors alone"))
        return None
    try:
        hash(x)
    except TypeError:
        faults.append(TypeError(
            f"capture.jit: an argument of type {type(x).__name__} is "
            "neither a tensor, GasConcs, a model nor hashable"))
        return None
    return _VALUE


def key(fn: Callable, args: tuple, kwargs: Dict[str, Any]) -> tuple:
    """The cache key of the call ``fn(*args, **kwargs)``: everything that
    decides what the captured graph does, and no tensor value."""
    _, _, k, fault = _walk(fn, args, kwargs)
    if fault is not None:
        raise fault
    return k


def _card(fn: Callable, tensors: List[torch.Tensor], devices: set
          ) -> Optional[torch.device]:
    """The one CUDA device of the call's tensors, or None if every tensor
    lies on the CPU; raises on inputs that require grad and on tensors
    spread over devices."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"capture.jit({fn.__name__}): an input requires grad and a CUDA "
            f"graph defines no backward; call {fn.__module__}."
            f"{fn.__name__} itself for gradients")
    if all(d.type == "cpu" for d in devices):
        return None
    if len(devices) > 1:
        raise ValueError(
            f"capture.jit({fn.__name__}): tensors on "
            f"{sorted(map(str, devices))}; a captured call reads all its "
            "tensors on one card (a CUDA graph cannot read host memory)")
    return next(iter(devices))


def _counts() -> List[int]:
    return [getattr(w, c) for w, c in COUNTERS]


def _add_counts(delta: List[int], sign: int = 1) -> None:
    for (w, c), d in zip(COUNTERS, delta):
        setattr(w, c, getattr(w, c) + sign * d)


class _Entry:
    """One key's warm-up, graph and static buffers."""

    def __init__(self, args: tuple, kwargs: Dict[str, Any]):
        self.models = [a for a in (*args, *kwargs.values())
                       if isinstance(a, CKDModel)]
        self.caches: List[dict] = []
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: List[torch.Tensor] = []
        self.outputs = None
        self.static_out: List[torch.Tensor] = []
        self.launched: List[int] = []
        self.done: Optional[torch.cuda.Event] = None

    def capture(self, fn: Callable, args: tuple, kwargs: Dict[str, Any],
                device: torch.device) -> None:
        """Capture ``fn`` on clones of the inputs (the static buffers,
        which then hold this call's values), on a capture stream of
        ``device``, the inputs' card.  ``torch.cuda.graph``'s default
        capture stream is made once per process, on the card current at
        its first use: a capture on another card would record nothing
        and launch its kernels outside the capture, which the runtime
        refuses."""
        clone = lambda x: x.clone() if isinstance(x, torch.Tensor) else x
        s_args, s_kwargs = tree_map(clone, (args, kwargs))
        self.inputs = _walk(fn, s_args, s_kwargs)[0]
        # The arrays the models' caches hold, which the graph reads at
        # the addresses it captured.
        self.caches = [dict(m._cache) for m in self.models]
        graph = torch.cuda.CUDAGraph()
        nan = checks.nan_debugging()
        before = _counts()
        checks.enable_nan_debugging(False)
        try:
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(device)):
                self.outputs = fn(*s_args, **s_kwargs)
        finally:
            checks.enable_nan_debugging(nan)
            self.launched = [a - b for a, b in zip(_counts(), before)]
            _add_counts(self.launched, -1)
        self.graph = graph
        self.static_out = [t for t in tree_leaves(self.outputs)
                           if isinstance(t, torch.Tensor)]
        self.done = torch.cuda.Event()

    def replay(self, inputs: List[torch.Tensor], run: Callable):
        """Copy the inputs in (after the previous replay's copies out, on
        whichever stream they ran), replay, copy the outputs out into
        fresh tensors, each step run by ``run`` (profiling.steps).  Each
        copy is one multi-tensor launch (as torch's optimizers use), not
        one per tensor: the host's time per call is what a replay is
        for."""
        stream = torch.cuda.current_stream()
        run("capture.copy_in", self._copy_in, stream, inputs)
        run("capture.replay", self._launch)
        return run("capture.copy_out", self._copy_out, stream)

    def _copy_in(self, stream, inputs: List[torch.Tensor]) -> None:
        stream.wait_event(self.done)
        torch._foreach_copy_(self.inputs, inputs)

    def _launch(self) -> None:
        self.graph.replay()
        _add_counts(self.launched)

    def _copy_out(self, stream):
        fresh = [torch.empty_like(t) for t in self.static_out]
        torch._foreach_copy_(fresh, self.static_out)
        self.done.record(stream)
        it = iter(fresh)
        return tree_map(lambda t: next(it) if isinstance(t, torch.Tensor)
                        else t, self.outputs)


def jit(fn: Callable) -> Callable:
    """``fn`` captured once per key in a CUDA graph and replayed (see the
    module docstring).  The returned callable takes ``fn``'s arguments;
    its ``entries`` maps each key seen to its entry, and ``captures`` and
    ``replays`` count the graphs built and the calls replayed."""
    entries: Dict[tuple, _Entry] = {}

    def lookup(args: tuple, kwargs: Dict[str, Any]):
        tensors, devices, k, fault = _walk(fn, args, kwargs)
        device = _card(fn, tensors, devices)
        if device is None:
            return tensors, None, None, None
        if fault is not None:
            raise fault
        return tensors, device, k, entries.get(k)

    def body(run: Callable, args: tuple, kwargs: Dict[str, Any]):
        tensors, device, k, entry = run("capture.key", lookup, args, kwargs)
        if device is None:
            return fn(*args, **kwargs)
        with torch.cuda.device(device):
            if entry is None:
                entries[k] = _Entry(args, kwargs)
                return fn(*args, **kwargs)
            if entry.graph is None:
                entry.capture(fn, args, kwargs, device)
                call.captures += 1
            out = entry.replay(tensors, run)
            call.replays += 1
        if k[-1]:
            checks.check_stage("captured call", **{
                f"output {i}": t for i, t in enumerate(tree_leaves(out))
                if isinstance(t, torch.Tensor)})
        return out

    @functools.wraps(fn)
    def call(*args, **kwargs):
        run = profiling.steps()
        return run("capture.call", body, run, args, kwargs)

    call.entries = entries
    call.captures = 0
    call.replays = 0
    return call
