"""Column split over devices and processes (counterpart of
``ecckd_tpu.parallel.mesh``).

The physics has no cross-column term, so the one parallel strategy is a
split of the column axis: every (ncol, ...) input is cut into equal
pieces, one per device, lookup tables and models go whole to every
device, and the outputs are joined in column order.  No collective runs
inside the flux computation.

* Local devices: ``split_columns`` places one piece per device once (a
  ``ColumnShards``, the counterpart of arrays placed with the JAX
  package's ``column_sharding`` / ``replicated``), and the pieces stay
  there between calls.  ``map_shards`` runs ``fn`` on every piece and
  leaves each output on its device, with its column offset; kernel
  launches on different cards are asynchronous, so they overlap.
  ``shard_columns_call`` is the one-shot form: split, run, and join the
  outputs on the first device.
* Processes (``distributed_columns_call``, after ``init_distributed``):
  rank r runs ``fn`` on piece r on its own device, and
  ``all_gather_into_tensor`` assembles the whole on every rank.

A batch whose column count does not divide the number of pieces is
padded by repeating its last column (``pad_to_mesh``, the one padding
rule); the padded outputs are dropped.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ecckd_tpu_torch.models.ckd import CKDModel
from ecckd_tpu_torch.utils import profiling
from ecckd_tpu_torch.utils.tree import tree_map

PROCESS_GROUP_TIMEOUT = datetime.timedelta(seconds=120)
"""How long a rank waits for its peers (init and collectives): a dead peer
fails the run instead of hanging it."""


def make_column_mesh(devices: Optional[Sequence] = None
                     ) -> List[torch.device]:
    """The devices the column axis is split over: the given ones, or every
    local CUDA card.  Without a card it raises: a split on the CPU is
    asked for by naming it (``["cpu"]``), never fallen into."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("make_column_mesh: no CUDA card; pass the "
                           "devices (e.g. ['cpu']) to split on the CPU")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def pad_columns(n: int, n_shards: int) -> int:
    """Columns must divide evenly over shards; pad with repeated work
    (cheaper than ragged shards; padded outputs are dropped)."""
    return (n + n_shards - 1) // n_shards * n_shards


def pad_to_mesh(a, n_dev: int):
    """Edge-replicate the leading (column) axis of a numpy array or a
    tensor up to a multiple of ``n_dev``: THE single definition of the
    batch padding rule.  Every per-column input of one call goes through
    it, so all of them keep one column count."""
    n = a.shape[0]
    target = pad_columns(n, n_dev)
    if target == n:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[-1:].expand(target - n, *a.shape[1:])])
    pad = [(0, target - n)] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad, mode="edge")


def _default_batch_leaf(ncol: int) -> Callable[[Any], bool]:
    return lambda x: (isinstance(x, (torch.Tensor, np.ndarray))
                      and x.ndim >= 1 and x.shape[0] == ncol)


def place_leaf(x, device: torch.device):
    """A leaf on ``device``: numpy arrays become tensors, tensors and
    models move (and stay the same object when already there).  A numpy
    array goes to a card through a pinned buffer and an asynchronous copy
    on the current stream: a copy from pageable memory would block the
    host until the card reached it, i.e. until all work queued before it
    had run.  A model's copy on another device is kept in the model's own
    cache, so a stream of chunks moves its tables (and plans its host
    preparation) once per device, not once per chunk."""
    if isinstance(x, np.ndarray):
        if device.type == "cuda":
            return torch.from_numpy(np.ascontiguousarray(x)).pin_memory(
                ).to(device, non_blocking=True)
        return torch.as_tensor(x, device=device)
    if getattr(x, "device", None) == device:
        return x
    if isinstance(x, CKDModel):
        key = ("placed", device)
        if key not in x._cache:
            x._cache[key] = x.to(device)
        return x._cache[key]
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return x


@dataclasses.dataclass(frozen=True)
class ColumnShards:
    """One tree per device, resident there between calls: the column
    pieces of the padded batch leaves and, whole, every other leaf (or,
    from ``map_shards``, each device's outputs).  Piece ``d`` holds
    ``per`` rows from batch column ``offsets[d]`` on; its rows past
    ``ncol``, the column count before padding, are padding."""
    trees: Tuple[Any, ...]
    devices: Tuple[torch.device, ...]
    ncol: int
    offsets: Tuple[int, ...]

    @property
    def per(self) -> int:
        return pad_columns(self.ncol, len(self.devices)) // len(self.devices)

    def span(self, d: int) -> Tuple[int, int]:
        """[lo, hi): the batch columns that piece ``d`` holds in its
        first hi - lo rows; the rest of its rows are padding."""
        lo = self.offsets[d]
        return lo, max(lo, min(lo + self.per, self.ncol))


def split_columns(tree, devices: Sequence[torch.device], ncol: int,
                  batch_leaf=None, replicated_argnums=()) -> ColumnShards:
    """Cut the batch leaves of ``tree`` into one padded piece per device
    and place every piece and every other leaf on its device.

    By default a leaf is a batch leaf if it is a tensor or numpy array
    whose leading extent is ``ncol``.  ``batch_leaf`` (leaf -> bool) marks
    batch leaves explicitly, and ``replicated_argnums`` (positions in
    ``tree``, then a tuple of arguments) keeps whole subtrees replicated:
    a table whose leading extent happens to equal ``ncol`` would
    otherwise be split.  A ``CKDModel`` is one leaf and is never split."""
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    per = pad_columns(ncol, n) // n
    is_batch = batch_leaf or _default_batch_leaf(ncol)
    rep = frozenset(replicated_argnums)
    padded = {}     # id(leaf) -> the leaf padded once for all devices

    def piece(d: int, device: torch.device, whole: bool = False):
        def put(x):
            if not whole and is_batch(x):
                if id(x) not in padded:
                    padded[id(x)] = pad_to_mesh(x, n)
                x = padded[id(x)][d * per:(d + 1) * per]
            return place_leaf(x, device)
        return put

    def place(d: int, device: torch.device):
        if not rep:
            return tree_map(piece(d, device), tree)
        return type(tree)(tree_map(piece(d, device, i in rep), arg)
                          for i, arg in enumerate(tree))

    trees = tuple(place(d, dev) for d, dev in enumerate(devices))
    return ColumnShards(trees=trees, devices=devices, ncol=ncol,
                        offsets=tuple(d * per for d in range(n)))


def map_shards(fn: Callable, shards: ColumnShards) -> ColumnShards:
    """``fn(*tree)`` on every device's piece, queued one device after
    another from this thread (on cards they then run at once).  Each
    output stays on its device, unjoined, with its piece's offset; a
    ``fn`` that returns a changed tree builds the next call's pieces
    where they lie, and nothing crosses devices.  While a
    ``torch.profiler`` records, each piece's call is one
    ``shards.card<i>`` span (``i`` its device's CUDA index, 0 on the
    CPU; utils/profiling.py)."""
    run = profiling.steps()
    return dataclasses.replace(shards, trees=tuple(
        run("shards", fn, *tree, card=device)
        for tree, device in zip(shards.trees, shards.devices)))


def join_shards(shards: ColumnShards):
    """The pieces' outputs (every leaf has a leading column axis) joined
    in column order on the first device, padding dropped."""
    first = shards.devices[0]
    order = sorted(range(len(shards.trees)), key=shards.offsets.__getitem__)
    spans = [shards.span(d) for d in order]
    return tree_map(
        lambda *xs: torch.cat([xs[d][:hi - lo].to(first)
                               for d, (lo, hi) in zip(order, spans)]),
        *shards.trees)


def call_shards(fn: Callable, shards: ColumnShards):
    """``fn(*tree)`` on every device's piece, the outputs joined in column
    order on the first device (map_shards, then join_shards)."""
    return join_shards(map_shards(fn, shards))


def shard_batch(arrays, devices: Sequence[torch.device]):
    """Cut every array (leading axis = columns) into one padded piece per
    device.  Returns (per-device lists of tensors, original ncol)."""
    arrays = list(arrays)
    ncol = int(arrays[0].shape[0])
    shards = split_columns(tuple(arrays), devices, ncol,
                           batch_leaf=lambda x: True)
    return [list(t) for t in shards.trees], ncol


def shard_columns_call(fn: Callable, devices: Sequence[torch.device], args,
                       ncol: int, batch_leaf=None, replicated_argnums=()):
    """Run ``fn(*args)`` split over the columns of ``devices``: each device
    runs ``fn`` on its piece (split_columns: which leaves are split, and
    the escape hatches), and the outputs are joined on the first device.
    This lets the CUDA kernels, which each run on one card, scale over
    the cards of a host: no collective is needed because the physics is
    column-independent.  Outputs must have a leading column axis."""
    return call_shards(fn, split_columns(tuple(args), devices, ncol,
                                         batch_leaf, replicated_argnums))


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> None:
    """Join the process group at ``tcp://<coordinator>`` (host:port) as
    rank ``process_id`` of ``num_processes``: NCCL for a CUDA ``device``
    (the default), Gloo for ``device="cpu"``, with a finite timeout.  A
    no-op for one process or none, unless a coordinator is given, which
    makes a group of one.  Without a card and with no device named it
    raises: Gloo on the CPU is asked for, never fallen into."""
    if not num_processes or (num_processes <= 1 and coordinator is None):
        return
    if coordinator is None or process_id is None:
        raise ValueError("a process group needs --coordinator host:port and "
                         "--process-id")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA card for NCCL; "
                               "pass device='cpu' for a Gloo group on the "
                               "CPU")
        device = "cuda"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=PROCESS_GROUP_TIMEOUT)


def world() -> Tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def distributed_columns_call(fn: Callable, device, args, ncol: int,
                             batch_leaf=None, replicated_argnums=()):
    """Run ``fn(*args)`` split over the columns of the process group: rank
    r computes piece r of the padded batch on ``device``, and
    ``all_gather_into_tensor`` assembles the padded whole on every rank,
    which is then trimmed to ``ncol``.  Every rank passes the same
    ``args``; the split and its escape hatches are split_columns's."""
    rank, size = world()
    device = torch.device(device)
    shards = split_columns(tuple(args), [device] * size, ncol, batch_leaf,
                           replicated_argnums)
    out = fn(*shards.trees[rank])
    gather = (getattr(torch.distributed, "all_gather_single", None)
              or torch.distributed.all_gather_into_tensor)

    def assemble(x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        whole = torch.empty((size * x.shape[0], *x.shape[1:]),
                            dtype=x.dtype, device=x.device)
        gather(whole, x)
        return whole[:ncol]

    return tree_map(assemble, out)
