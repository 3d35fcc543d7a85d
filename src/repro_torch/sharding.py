"""Mesh axes as process groups, and the sharding conventions (PyTorch port).

The twin of ``repro.sharding``.  In the reference every remote movement
runs inside ``shard_map`` and names a *mesh axis* (``"x"``, ``"data"``,
``"model"``); here a mesh axis is a ``torch.distributed`` process group,
registered under its name for the duration of an SPMD body:

* :func:`init_mesh` starts this rank's process group (through a
  ``FileStore``) and makes one group per mesh axis; the returned
  :class:`Mesh` is a context manager that registers its axes;
* :func:`mesh_axis` resolves a name (or a tuple of names) to its
  :class:`MeshAxis`: the group, this rank's index in it (``lax.axis_index``)
  and its size.  A name that is not registered raises; nothing falls back to
  the world group unasked;
* :func:`local_axis` registers an axis of size 1 with no group, where every
  collective is the identity (the reference's size-1 ``shard_map``);
  :func:`axis_scope` registers any axes for the scope of a block;
* :func:`run_spmd` is the counterpart of ``shard_map_compat``: it spawns one
  process per rank, runs one body in each inside its mesh, and returns what
  each rank's body returned;
* :func:`meta_mesh` is one rank of a mesh of any size with no process at
  all: its axes are on the ``"meta"`` backend, where each collective counts
  its call and bytes and returns a ``meta`` tensor of the result's shape.
  The dry run plays rank 0 of the 256- and 512-card production meshes so.

A mesh registers each axis under its name, each pair of axes under the
pair's tuple (a batch over ``("pod", "data")``, a KV sequence over
``("data", "model")``), and the whole world under the tuple of every name.
A tuple's index is row-major over its axes, as a spec over a tuple of axes
lays out its blocks.

The backend follows the cards: NCCL needs one card per rank, so a world on
CUDA whose size fits in the device count takes NCCL, anything else gloo
(:func:`pick_backend`).  The choice is made where the group is created,
logged, and kept on the :class:`Mesh` (``backend``, ``backend_note``).

The role conventions (:class:`Axes`, :func:`kv_cache_spec`) are plain data:
a spec is a tuple of axis names (torch has no ``PartitionSpec``), and
:func:`constrain` is the identity (torch has no sharding constraint).

**The differentiable collectives** are what GSPMD inserts into the
reference's sharded program, written out: pairs of a forward and a backward
collective over one mesh axis, each a ``torch.autograd.Function``, which
the sharded trainer's layers call where the reference's shardings change:

* :func:`copy_to_axis` — the identity, an all-reduce of the gradient (a
  replicated tensor entering work partitioned over the axis);
* :func:`reduce_from_axis` — an all-reduce, the gradient passed through
  (partial sums leaving partitioned work);
* :func:`gather_along` — an all-gather along a dim, the gradient
  reduce-scattered (a sharded weight gathered for partitioned work: FSDP);
* :func:`split_along` — this rank's block along a dim, the gradient
  all-gathered; :func:`unsplit_along` its inverse (an all-gather, the
  gradient's block);
* :func:`broadcast_from` — one rank's tensor to every rank of the axis, the
  gradient summed back to that rank (a layer held by one data rank).

:func:`all_reduce` and :func:`all_gather` are the same collectives without a
gradient.  They go through ``torch.distributed`` on the axis's group, never
through ``xdma.transfer``: the reference's GSPMD collectives are XLA's and
never become XDMA tasks.  Each call counts into this rank's ``collectives``
telemetry bank (:func:`collective_stats`): calls and bytes by op and axis,
and the bytes a gloo group on CUDA tensors copies to the host and back
(``host_hop_bytes``).  A size-1 axis moves and counts nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import logging
import math
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch import op_cost
from repro_torch.runtime import telemetry as _tm

__all__ = ["Axes", "CPU_AXES", "constrain", "kv_cache_spec", "spec",
           "MeshAxis", "Mesh", "mesh_axis", "axis_index", "axis_size",
           "axis_scope", "local_axis", "registered_axes", "axis_over",
           "pick_backend", "view", "init_mesh", "run_spmd", "copy_to_axis",
           "reduce_from_axis", "gather_along", "split_along",
           "unsplit_along", "broadcast_from", "all_reduce", "all_gather",
           "collective_stats", "active_axis", "block_of", "whole_of",
           "replica_of", "HostHop", "meta_mesh", "on_meta", "regroup"]

_LOG = logging.getLogger(__name__)

# how long a rank waits for the others at a collective before it fails
_TIMEOUT_S = 300.0


# -- role conventions (plain data) ---------------------------------------------
@dataclasses.dataclass(frozen=True)
class Axes:
    """Names of the mesh axes playing each role (None = replicated role)."""

    batch: Tuple[str, ...] = ("data",)
    model: Optional[str] = "model"
    seq: Optional[str] = None      # context-parallel axis for long-context decode
    model_size: int = 0            # size of the model axis (0 = unknown)
    batch_size: int = 0            # total DP degree (0 = unknown)

    @property
    def batch_spec(self):
        return self.batch if len(self.batch) > 1 else (self.batch[0] if self.batch else None)


# single-device default (tests); launchers pass explicit Axes via the config
CPU_AXES = Axes(batch=(), model=None, seq=None)


def spec(*names) -> Tuple:
    """A sharding spec: one entry per dim, an axis name, a tuple of names or
    None (replicated)."""
    return tuple(names)


def constrain(x, spec_: Sequence = ()):
    """The identity: torch has no sharding constraint to place."""
    return x


def kv_cache_spec(axes: Axes, n_kv: int, layout: str = "bshd") -> Tuple:
    """Sharding for a KV cache.  KV heads take the model axis when they
    divide it; otherwise the sequence dim takes the model axis — plus the
    context-parallel seq axis.

    layouts: "bshd" (B,S,KV,hd) conventional; "bkhs" (B,KV,hd,S) = XDMA K^T;
    "bksh" (B,KV,S,hd) = XDMA V."""
    m, ms = axes.model, axes.model_size
    b = axes.batch_spec
    if m and ms and n_kv % ms == 0:
        kv_ax, seq_ax = m, axes.seq
    else:
        kv_ax = None
        seq_names = tuple(n for n in ((axes.seq,) if axes.seq else ())
                          + ((m,) if m else ()))
        seq_ax = (seq_names if len(seq_names) > 1
                  else (seq_names[0] if seq_names else None))
    if layout == "bshd":
        return spec(b, seq_ax, kv_ax, None)
    if layout == "bkhs":
        return spec(b, kv_ax, None, seq_ax)
    if layout == "bksh":
        return spec(b, kv_ax, seq_ax, None)
    raise ValueError(layout)


# -- mesh axes ---------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One named mesh axis as this rank sees it: ``group`` is the process
    group of the ranks along the axis (None for a size-1 local axis),
    ``index`` this rank's position in it, ``backend`` the group's backend
    (``"gloo"``, ``"nccl"``, or ``"local"`` with no group)."""

    name: Any
    size: int
    index: int
    group: Any = None
    backend: str = "local"


_AXES: Dict[Any, MeshAxis] = {}


def registered_axes() -> Dict[Any, MeshAxis]:
    """The axes registered now, by name."""
    return dict(_AXES)


def mesh_axis(name) -> MeshAxis:
    """The registered axis ``name`` (a name, or a tuple of names registered
    together); raises ``LookupError`` when it is not registered."""
    key = tuple(name) if isinstance(name, (list, tuple)) else name
    if isinstance(key, tuple) and len(key) == 1:
        key = key[0]
    ax = _AXES.get(key)
    if ax is None:
        raise LookupError(
            f"mesh axis {name!r} is not registered (registered: "
            f"{sorted(map(repr, _AXES))}); run the body inside a Mesh "
            "(init_mesh / run_spmd) or register it with local_axis")
    return ax


def axis_over(names) -> MeshAxis:
    """The registered axis spanning exactly the set ``names`` (one name, or
    several registered together as a tuple); raises ``LookupError`` when
    none is."""
    want = set(names if isinstance(names, (list, tuple, set, frozenset))
               else (names,))
    for key, ax in _AXES.items():
        if set(key if isinstance(key, tuple) else (key,)) == want:
            return ax
    raise LookupError(f"no registered mesh axis spans {sorted(want)} "
                      f"(registered: {sorted(map(repr, _AXES))})")


def active_axis(name) -> Optional[MeshAxis]:
    """The registered axis ``name``; None for no name or one not
    registered (the reference's ``constrain`` outside a mesh)."""
    if name is None:
        return None
    key = tuple(name) if isinstance(name, (list, tuple)) else name
    if isinstance(key, tuple) and len(key) == 1:
        key = key[0]
    return _AXES.get(key)


def axis_index(name) -> int:
    """This rank's index along ``name`` (``lax.axis_index``)."""
    return mesh_axis(name).index


def axis_size(name) -> int:
    return mesh_axis(name).size


@contextlib.contextmanager
def axis_scope(axes: Sequence[MeshAxis]) -> Iterator[None]:
    """Register ``axes`` for the scope of a ``with`` block (an axis of the
    same name registered before comes back after it)."""
    saved = dict(_AXES)
    for ax in axes:
        _AXES[ax.name] = ax
    try:
        yield
    finally:
        _AXES.clear()
        _AXES.update(saved)


def local_axis(name):
    """Register ``name`` as an axis of size 1 with no process group, for the
    scope of a ``with`` block: every collective over it is the identity, as
    in the reference's size-1 ``shard_map``."""
    return axis_scope([MeshAxis(name, 1, 0)])


# -- process groups ---------------------------------------------------------------
def pick_backend(world_size: int, device) -> Tuple[str, str]:
    """``(backend, why)``: NCCL when the ranks run on CUDA, NCCL is built and
    every rank has a card of its own; gloo otherwise (CPU tensors, or more
    ranks than cards: NCCL refuses two ranks on one card)."""
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", f"{world_size} ranks on the CPU: gloo"
    cards = torch.cuda.device_count()
    if not dist.is_nccl_available():
        return "gloo", (f"{world_size} ranks on {cards} card(s): gloo (this "
                        "torch has no NCCL)")
    if world_size > cards:
        return "gloo", (f"{world_size} ranks on {cards} card(s): gloo (NCCL "
                        "needs one card per rank)")
    return "nccl", f"{world_size} ranks on {cards} card(s): NCCL"


@dataclasses.dataclass
class Mesh:
    """This rank's view of an SPMD mesh: a context manager that registers
    one :class:`MeshAxis` per axis name (and the tuple of all names, the
    whole world, when there are several)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device
    backend: str
    backend_note: str
    axes: Dict[Any, MeshAxis]

    @property
    def world_size(self) -> int:
        return math.prod(self.shape)

    def __enter__(self):
        self._scope = axis_scope(list(self.axes.values()))
        self._scope.__enter__()
        return self

    def __exit__(self, *exc):
        return self._scope.__exit__(*exc)


def view(mesh: Mesh, shape: Sequence[int]) -> Mesh:
    """``mesh``'s ranks as a mesh of ``shape`` over the same two axis names:
    a copy of ``mesh`` for its own shape, or ``(1, world)``: a first axis
    of size 1 (no group) and the second over every rank (the world's
    group, the whole world's axis kept).  A context manager, as
    :class:`Mesh` is."""
    shape = tuple(int(s) for s in shape)
    if shape == tuple(mesh.shape):
        return dataclasses.replace(mesh)
    names = mesh.axis_names
    if len(names) != 2 or shape != (1, mesh.world_size):
        raise ValueError(f"no view of mesh {mesh.shape} over {names} as "
                         f"{shape}: only (1, {mesh.world_size})")
    world = mesh.axes[names]
    return dataclasses.replace(mesh, shape=shape, axes={
        names[0]: MeshAxis(names[0], 1, 0),
        names[1]: MeshAxis(names[1], world.size, world.index, world.group,
                           world.backend),
        names: world})


def regroup(mesh: Mesh, axes: Dict[Any, Any], shape: Sequence[int]) -> Mesh:
    """``mesh``'s ranks as a mesh of ``shape`` whose axes are some of
    ``mesh``'s axes or pairs under new names: ``axes`` maps each new name
    (a name, or the tuple of two new names for their pair) to the old one.
    The old axes' groups and indices are kept, so the new mesh's row-major
    order must be the old one's (a (2, 2, 1) ("pod", "data", "model")
    world as (2, 2) ("data", "model"): ``{"data": "pod", "model": "data",
    ("data", "model"): ("pod", "data")}``).  A context manager, as
    :class:`Mesh` is."""
    new = {name: dataclasses.replace(mesh.axes[old], name=name)
           for name, old in axes.items()}
    names = tuple(n for n in axes if not isinstance(n, tuple))
    return dataclasses.replace(mesh, shape=tuple(int(s) for s in shape),
                               axis_names=names, axes=new)


def _axis_sets(axis_names: Tuple[str, ...]) -> List[Tuple[int, ...]]:
    """The positions of every registered axis set, in one order: each axis,
    each pair of axes where there are three or more (a spec may name two of
    them together), and the whole world where there are two or more."""
    n = len(axis_names)
    sets = [(i,) for i in range(n)]
    if n > 2:
        sets += list(itertools.combinations(range(n), 2))
    if n > 1:
        sets.append(tuple(range(n)))
    return sets


def _set_key(axis_names, pos):
    return axis_names[pos[0]] if len(pos) == 1 else tuple(
        axis_names[i] for i in pos)


def _set_place(shape, coords, pos) -> Tuple[int, int]:
    """``(size, index)`` of a rank at ``coords`` along the axes at ``pos``,
    the index row-major over them."""
    size, index = 1, 0
    for i in pos:
        size *= shape[i]
        index = index * shape[i] + coords[i]
    return size, index


def meta_mesh(shape: Sequence[int], axis_names: Sequence[str],
              rank: int = 0) -> Mesh:
    """Rank ``rank`` of a mesh of ``shape`` with no process group: every
    axis, pair and the world registered with this rank's index on the
    ``"meta"`` backend.  A collective over such an axis counts its call and
    bytes in the ``collectives`` (or ``wire``) bank as a real one does and
    returns a ``meta`` tensor of its result's shape; a tensor that is not on
    ``meta`` raises there.  A context manager, as :class:`Mesh` is."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         "differ in length")
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} outside a mesh of {shape}")
    coords = _unravel(rank, shape)
    axes: Dict[Any, MeshAxis] = {}
    for pos in _axis_sets(axis_names):
        key = _set_key(axis_names, pos)
        size, index = _set_place(shape, coords, pos)
        axes[key] = MeshAxis(key, size, index, None, "meta")
    return Mesh(shape, axis_names, rank, torch.device("meta"), "meta",
                f"one rank of {math.prod(shape)} on the meta device: "
                "collectives counted, nothing moved", axes)


def init_mesh(rank: int, shape: Sequence[int], axis_names: Sequence[str], *,
              store_path: str, device="cuda") -> Mesh:
    """Start this rank's default process group (a ``FileStore`` at
    ``store_path``, shared by every rank and new for each world) and one
    group per mesh axis, per pair of axes (three axes or more) and the
    world.  Ranks are laid out row-major over ``shape``, as
    ``jax.make_mesh`` lays out devices.  Every rank must call this with the
    same arguments but its own ``rank``."""
    import torch.distributed as dist
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         "differ in length")
    world = math.prod(shape)
    backend, note = pick_backend(world, device)
    _LOG.info("mesh %s over %s: %s", shape, axis_names, note)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", (dev.index or 0) if backend == "gloo"
                           else rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=_TIMEOUT_S))
    coords = _unravel(rank, shape)
    axes: Dict[Any, MeshAxis] = {}
    for pos in _axis_sets(axis_names):
        key = _set_key(axis_names, pos)
        size, index = _set_place(shape, coords, pos)
        if len(pos) == len(shape):
            axes[key] = MeshAxis(key, size, index, dist.group.WORLD, backend)
            continue
        others = [range(s) for j, s in enumerate(shape) if j not in pos]
        mine = None
        # every rank creates every group, in one order (new_group's
        # contract); a group's ranks ascend row-major over its axes
        for rest in itertools.product(*others):
            fixed = iter(rest)
            base = [None if j in pos else next(fixed)
                    for j in range(len(shape))]
            ranks = []
            for sub in itertools.product(*(range(shape[i]) for i in pos)):
                c = list(base)
                for i, v in zip(pos, sub):
                    c[i] = v
                ranks.append(_ravel(c, shape))
            group = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                mine = group
        axes[key] = MeshAxis(key, size, index, mine, backend)
    return Mesh(shape, axis_names, rank, dev, backend, note, axes)


def _unravel(rank: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def _ravel(coords: Sequence[int], shape: Tuple[int, ...]) -> int:
    r = 0
    for c, s in zip(coords, shape):
        r = r * s + c
    return r


# -- the SPMD launcher ------------------------------------------------------------
def _to_cpu(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, dict):
        return {k: _to_cpu(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_to_cpu(x) for x in v)
    return v


def _worker(rank, body, shape, axis_names, args, device, workdir):
    import torch.distributed as dist
    mesh = init_mesh(rank, shape, axis_names,
                     store_path=os.path.join(workdir, "store"), device=device)
    try:
        with mesh:
            out = body(mesh, *args)
        if device != "cpu":
            torch.cuda.synchronize()
        torch.save(_to_cpu(out), os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_spmd(body: Callable, shape: Sequence[int] = (8,),
             axis_names: Sequence[str] = ("x",), *, workdir: str,
             args: Tuple = (), device="cuda") -> List[Any]:
    """Run ``body(mesh, *args)`` once per rank of a mesh of ``shape``, each
    rank a process of its own (``spawn``), inside its :class:`Mesh`; return
    each rank's result, its tensors moved to the CPU, in rank order.

    ``body`` must be importable by name (a module-level function).  The
    ranks run on ``device``: CUDA by default, the CPU when asked.  A rank
    that raises fails the run: the others are stopped and the error is
    raised here with the rank's traceback.  ``workdir`` (new and empty)
    holds the store and the results."""
    import torch.multiprocessing as mp
    shape = tuple(int(s) for s in shape)
    os.makedirs(workdir, exist_ok=True)
    mp.start_processes(_worker, args=(body, shape, tuple(axis_names),
                                      tuple(args), str(device), workdir),
                       nprocs=math.prod(shape), join=True,
                       start_method="spawn")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False)
            for r in range(math.prod(shape))]


# -- collectives with and without a gradient ---------------------------------------
_LEDGER = _tm.bank("collectives")


def collective_stats() -> Dict[str, int]:
    """This rank's ledger of the collectives below: ``calls:<op>:<axis>``,
    ``bytes:<op>:<axis>`` (the payload this rank handed the collective: its
    block for an all-gather, the whole tensor for a reduce-scatter, an
    all-reduce, a broadcast or a reduce) and ``host_hop_bytes``."""
    return _LEDGER.as_dict()


def _label(name) -> str:
    return "+".join(map(str, name)) if isinstance(name, tuple) else str(name)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class HostHop:
    """Where a payload crosses a collective: gloo works on host memory, so
    on a gloo group a CUDA tensor goes through a host copy and back, the
    bytes of both counted as ``host_hop_bytes`` in ``bank``; elsewhere the
    tensor itself."""

    def __init__(self, ax: MeshAxis, device: torch.device, bank):
        self.hop = ax.backend == "gloo" and device.type == "cuda"
        self.device = device
        self.bank = bank

    def out(self, t: torch.Tensor) -> torch.Tensor:
        if self.hop:
            self.bank.inc("host_hop_bytes", _nbytes(t))
            return t.to("cpu")
        return t

    def back(self, t: torch.Tensor) -> torch.Tensor:
        if self.hop:
            self.bank.inc("host_hop_bytes", _nbytes(t))
            return t.to(self.device)
        return t


def on_meta(ax: MeshAxis, t: torch.Tensor) -> bool:
    """Whether ``ax`` is an axis of a :func:`meta_mesh`, where a collective
    moves nothing and returns a ``meta`` tensor; a tensor that is not on
    ``meta`` raises there, so no real run goes through it unnoticed."""
    if ax.backend != "meta":
        return False
    if t.device.type != "meta":
        raise RuntimeError(
            f"a {t.device.type} tensor at a collective over {ax.name!r}, an "
            "axis of a meta mesh: it counts shapes and moves no data")
    return True


def _begin(op: str, ax: MeshAxis, t: torch.Tensor):
    """Count a call of ``op`` handed ``t``; the module and ``t``'s way
    across (``(None, None)`` on a meta mesh: nothing moves)."""
    _LEDGER.inc(f"calls:{op}:{_label(ax.name)}")
    _LEDGER.inc(f"bytes:{op}:{_label(ax.name)}", _nbytes(t))
    if on_meta(ax, t):
        return None, None
    import torch.distributed as dist
    return dist, HostHop(ax, t.device, _LEDGER)


def _reduce_op(dist, op: str):
    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]


@op_cost.one_op
def _all_reduce(t: torch.Tensor, ax: MeshAxis, op: str = "sum"):
    dist, hop = _begin(f"all_reduce_{op}" if op != "sum" else "all_reduce",
                       ax, t)
    if dist is None:
        return torch.empty_like(t)
    y = hop.out(t.contiguous())
    y = y.clone() if y is t else y            # all_reduce writes in place
    dist.all_reduce(y, _reduce_op(dist, op), group=ax.group)
    return hop.back(y)


@op_cost.one_op
def _all_gather(t: torch.Tensor, ax: MeshAxis, dim: int):
    """The ranks' blocks concatenated along ``dim`` in axis order."""
    dist, hop = _begin("all_gather", ax, t)
    if dist is None:
        shape = list(t.shape)
        shape[dim] *= ax.size
        return t.new_empty(shape)
    src = hop.out(t.contiguous())
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(parts, src, group=ax.group)
    return hop.back(torch.cat(parts, dim))


@op_cost.one_op
def _reduce_scatter(t: torch.Tensor, ax: MeshAxis, dim: int):
    """The sum over the axis of ``t``, this rank's block along ``dim``."""
    if t.shape[dim] % ax.size:
        raise ValueError(f"reduce-scatter over {ax.name!r}: dim {dim} of "
                         f"{tuple(t.shape)} does not split into {ax.size}")
    dist, hop = _begin("reduce_scatter", ax, t)
    if dist is None:
        shape = list(t.shape)
        shape[dim] //= ax.size
        return t.new_empty(shape)
    src = hop.out(t.movedim(dim, 0).contiguous())
    out = torch.empty((src.shape[0] // ax.size,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    # torch 2.13 renames reduce_scatter_tensor (deprecated there)
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    scatter(out, src, group=ax.group)
    return hop.back(out).movedim(0, dim)


@op_cost.one_op
def _broadcast(t: torch.Tensor, ax: MeshAxis, index: int):
    dist, hop = _begin("broadcast", ax, t)
    if dist is None:
        return torch.empty_like(t)
    y = hop.out(t.contiguous())
    y = y.clone() if y is t else y
    dist.broadcast(y, src=dist.get_global_rank(ax.group, index),
                   group=ax.group)
    return hop.back(y)


@op_cost.one_op
def _reduce_to(t: torch.Tensor, ax: MeshAxis, index: int):
    """The sum over the axis at rank ``index``; zeros elsewhere."""
    dist, hop = _begin("reduce", ax, t)
    if dist is None:
        return torch.empty_like(t)
    y = hop.out(t.contiguous())
    y = y.clone() if y is t else y
    dist.reduce(y, dst=dist.get_global_rank(ax.group, index),
                group=ax.group)
    if ax.index != index:
        return torch.zeros_like(t)
    return hop.back(y)


def _block(t: torch.Tensor, ax: MeshAxis, dim: int) -> torch.Tensor:
    n = t.shape[dim]
    if n % ax.size:
        raise ValueError(f"split over {ax.name!r}: dim {dim} of "
                         f"{tuple(t.shape)} does not split into {ax.size}")
    rows = n // ax.size
    return t.narrow(dim, ax.index * rows, rows)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.ax, ctx.dim), None, None


class _SplitAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _block(x, ax, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.ax, ctx.dim), None, None


class _UnsplitAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.ax, ctx.dim).contiguous(), None, None


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, index):
        ctx.ax, ctx.index = ax, index
        return _broadcast(x, ax, index)

    @staticmethod
    def backward(ctx, g):
        return _reduce_to(g, ctx.ax, ctx.index), None, None


def _live(name) -> Optional[MeshAxis]:
    """The axis, or None where it moves nothing (size 1)."""
    ax = mesh_axis(name)
    return None if ax.size == 1 else ax


def copy_to_axis(x: torch.Tensor, name) -> torch.Tensor:
    """The identity forward; the gradient all-reduced over ``name``: a
    tensor replicated over the axis entering work partitioned over it, whose
    gradient each rank holds only a part of."""
    ax = _live(name)
    return x if ax is None else _CopyTo.apply(x, ax)


def reduce_from_axis(x: torch.Tensor, name) -> torch.Tensor:
    """The sum over ``name`` forward (an all-reduce); the gradient passed
    through: partial sums leaving work partitioned over the axis."""
    ax = _live(name)
    return x if ax is None else _ReduceFrom.apply(x, ax)


def gather_along(x: torch.Tensor, name, dim: int) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` (an all-gather); the
    gradient reduce-scattered back to this rank's block: a weight sharded
    over the axis gathered for work partitioned over it (FSDP)."""
    ax = _live(name)
    return x if ax is None else _GatherAlong.apply(x, ax, dim % x.dim())


def split_along(x: torch.Tensor, name, dim: int) -> torch.Tensor:
    """This rank's block along ``dim``; the gradient all-gathered: a tensor
    replicated over the axis, each rank working on its own block."""
    ax = _live(name)
    return x if ax is None else _SplitAlong.apply(x, ax, dim % x.dim())


def unsplit_along(x: torch.Tensor, name, dim: int) -> torch.Tensor:
    """The inverse of :func:`split_along`: the ranks' blocks concatenated
    along ``dim``, the gradient's block taken back: partitioned work whose
    result is replicated over the axis from here on."""
    ax = _live(name)
    return x if ax is None else _UnsplitAlong.apply(x, ax, dim % x.dim())


def broadcast_from(x: torch.Tensor, name, index: int) -> torch.Tensor:
    """Rank ``index``'s ``x`` on every rank of ``name`` (every rank passes
    a tensor of its shape and dtype); the gradient summed back to rank
    ``index``, zeros on the others."""
    ax = _live(name)
    return x if ax is None else _BroadcastFrom.apply(x, ax, int(index))


def all_reduce(t: torch.Tensor, name, op: str = "sum") -> torch.Tensor:
    """``op`` (``"sum"`` or ``"max"``) over ``name``, without a gradient."""
    ax = _live(name)
    return t.detach().clone() if ax is None else _all_reduce(t.detach(), ax,
                                                              op)


def all_gather(t: torch.Tensor, name, dim: int = 0) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim``, without a gradient."""
    ax = _live(name)
    return (t.detach().clone() if ax is None
            else _all_gather(t.detach(), ax, dim % t.dim()))


# -- a weight's part for the work on this rank, by its shape ----------------------
def block_of(w: Optional[torch.Tensor], name, whole: int, dim: int):
    """This rank's block along ``dim`` of a weight that is ``whole`` long
    there unsharded: the weight itself where it is sharded over ``name``
    already, else its block through :func:`split_along`."""
    if w is None or w.shape[dim] != whole:
        return w
    return split_along(w, name, dim)


def replica_of(w: Optional[torch.Tensor], name, whole: int, dim: int):
    """A weight whole along ``dim`` for work every rank of ``name`` repeats
    in full: gathered (the gradient's block taken back, each rank holding
    the whole gradient) where it is sharded there, else the weight itself."""
    if w is None or w.shape[dim] == whole:
        return w
    return unsplit_along(w, name, dim)


def whole_of(w: Optional[torch.Tensor], name, whole: int, dim: int):
    """A weight whole along ``dim`` for work partitioned over ``name``:
    gathered (the gradient reduce-scattered) where it is sharded there, else
    through :func:`copy_to_axis` (the gradient summed over the axis)."""
    if w is None:
        return None
    if w.shape[dim] == whole:
        return copy_to_axis(w, name)
    return gather_along(w, name, dim)
