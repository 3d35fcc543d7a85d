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
  each rank's body returned.

The backend follows the cards: NCCL needs one card per rank, so a world on
CUDA whose size fits in the device count takes NCCL, anything else gloo
(:func:`pick_backend`).  The choice is made where the group is created,
logged, and kept on the :class:`Mesh` (``backend``, ``backend_note``).

The role conventions (:class:`Axes`, :func:`kv_cache_spec`) are plain data:
a spec is a tuple of axis names (torch has no ``PartitionSpec``), and
:func:`constrain` is the identity (torch has no sharding constraint).
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

__all__ = ["Axes", "CPU_AXES", "constrain", "kv_cache_spec", "spec",
           "MeshAxis", "Mesh", "mesh_axis", "axis_index", "axis_size",
           "axis_scope", "local_axis", "registered_axes", "pick_backend",
           "init_mesh", "run_spmd"]

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


def init_mesh(rank: int, shape: Sequence[int], axis_names: Sequence[str], *,
              store_path: str, device="cuda") -> Mesh:
    """Start this rank's default process group (a ``FileStore`` at
    ``store_path``, shared by every rank and new for each world) and one
    group per mesh axis.  Ranks are laid out row-major over ``shape``, as
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
    for i, name in enumerate(axis_names):
        others = [range(s) for j, s in enumerate(shape) if j != i]
        mine = None
        # every rank creates every group, in one order (new_group's contract)
        for rest in itertools.product(*others):
            ranks = []
            for k in range(shape[i]):
                c = list(rest)
                c.insert(i, k)
                ranks.append(_ravel(c, shape))
            group = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                mine = group
        axes[name] = MeshAxis(name, shape[i], coords[i], mine, backend)
    if len(axis_names) > 1:
        axes[axis_names] = MeshAxis(axis_names, world, rank, dist.group.WORLD,
                                    backend)
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
