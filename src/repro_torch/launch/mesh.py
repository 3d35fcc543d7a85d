"""Production mesh shapes + sharding-spec inference for params / optimizer /
caches (PyTorch port: the twin of ``repro.launch.mesh``).

A spec is the port's tuple (:func:`repro_torch.sharding.spec`): one entry
per leading dim, an axis name, a tuple of names or None, trailing Nones
stripped as ``PartitionSpec`` canonicalises them.  Spec inference is
path-based over the parameter pytree (``repro_torch._pytree``'s paths), so
model code and launcher cannot drift.  A tree of shapes holds tensors (on
the ``meta`` device: no storage) or ``(shape, dtype)`` tuples.

A mesh here is a shape and its axis names: :class:`MeshSpec`, or the
:class:`repro_torch.sharding.Mesh` a rank sees inside
:func:`repro_torch.sharding.run_spmd`, which builds the process groups of a
mesh.  :func:`make_production_mesh` gives the assignment's (16, 16) data x
model mesh, (2, 16, 16) pod x data x model for two pods, and refuses a
world smaller than it (unless asked for the shape alone, as the dry run
asks).  :func:`axes_for` puts ``train_4k`` and ``prefill_32k`` on a batch
over ``("pod", "data")`` on the two-pod mesh (FSDP shards over the pair
too), and ``long_500k`` on a context-parallel cache: ``seq="data"``, its
KV sequence over ``seq``, or over ``("data", "model")`` where the KV heads
do not divide the model axis (:func:`repro_torch.sharding.kv_cache_spec`).

:func:`shard_tree` and :func:`gather_tree` are the counterpart of
``jax.device_put(state, NamedSharding)`` and of reading a sharded array
back whole: each rank keeps its block of every leaf by the leaf's fitted
spec (a dim over a tuple of axes takes them row-major, as
:func:`repro_torch.sharding.init_mesh` lays out ranks), and the blocks are
all-gathered back into whole leaves.  :func:`state_specs` fits a model's
train-state specs to a mesh, as the reference's launcher does before its
``device_put``; :func:`serving_specs` fits its parameter specs without
FSDP (the reference's dry run shards parameters over the data axis only
for training) and :func:`serving_cache_specs` a decode cache's, for sharded
prefill and decode.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import NamedTuple, Tuple

import torch

from repro_torch import _pytree
from repro_torch import sharding as S
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.sharding import Axes

__all__ = ["MeshSpec", "make_production_mesh", "axes_for",
           "infer_param_specs", "infer_state_specs", "cache_specs",
           "fit_specs", "batch_input_specs", "state_shapes", "state_specs",
           "spec_leaves", "local_shape", "shard_tree", "gather_tree",
           "mesh_axes", "serving_specs", "serving_cache_specs"]


class MeshSpec(NamedTuple):
    """A mesh's shape and axis names (the process groups come from
    ``run_spmd(body, mesh.shape, mesh.axis_names, ...)``)."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False,
                         check_world: bool = True) -> MeshSpec:
    """The assignment's mesh; raises when the world (the ranks of the
    initialised process group, else the visible cards) is smaller.  With
    ``check_world=False`` the mesh is a shape with no ranks behind it: the
    dry run plays one of its ranks on meta tensors
    (:func:`repro_torch.sharding.meta_mesh`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if not check_world:
        return MeshSpec(shape, axes)
    import torch.distributed as dist
    world = (dist.get_world_size() if dist.is_initialized()
             else torch.cuda.device_count())
    if world < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}; found {world}. "
            "The port builds a mesh's process groups with "
            "repro_torch.sharding.run_spmd, one rank a device.")
    return MeshSpec(shape, axes)


def _sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def axes_for(mesh, shape: ShapeConfig) -> Axes:
    """Axis roles for a given input shape on a given mesh (DESIGN.md §5)."""
    sizes = _sizes(mesh)
    names = tuple(mesh.axis_names)
    batch = tuple(n for n in ("pod", "data") if n in names)
    model = "model" if "model" in names else None
    dp = 1
    for n in batch:
        dp *= sizes[n]
    seq = None
    if shape.kind == "decode" and (shape.global_batch < dp
                                   or shape.seq_len >= (1 << 18)):
        # long-context decode: batch can't fill DP -> context-parallel cache
        batch = tuple(n for n in batch if n == "pod")
        if shape.global_batch < 2:
            batch = ()
        seq = "data"
    msize = sizes[model] if model else 0
    bsize = 1
    for n in batch:
        bsize *= sizes[n]
    return Axes(batch=batch, model=model, seq=seq, model_size=msize,
                batch_size=bsize if batch else 0)


# ---------------------------------------------------------------------------
# trees of shapes
# ---------------------------------------------------------------------------
def _as_meta(tree):
    """``tree`` with every ``(shape, dtype)`` leaf as a meta tensor (no
    storage), so one flattener walks every tree of shapes."""
    if isinstance(tree, tuple) and len(tree) == 2 \
            and isinstance(tree[0], tuple) and isinstance(tree[1], torch.dtype):
        return torch.empty(tree[0], dtype=tree[1], device="meta")
    if isinstance(tree, dict):
        return {k: _as_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_meta(v) for v in tree)
    return tree


def _keys(path) -> Tuple[str, ...]:
    return tuple(str(k) for _, k in path)


def _map_shapes(fn, tree):
    """``fn(keys, shape)`` over every leaf of a tree of shapes; the specs it
    returns take the leaves' places."""
    return _pytree.tree_map_with_path(
        lambda path, t: fn(_keys(path), tuple(t.shape)), _as_meta(tree))


def spec_leaves(spec_tree, shape_tree):
    """The specs of ``spec_tree`` in ``shape_tree``'s leaf order (a spec is
    a tuple, so the shape tree says where the leaves are): a tree of
    tensors or of ``(shape, dtype)`` tuples."""
    out = []
    for path, _ in _pytree.flatten_with_paths(_as_meta(shape_tree)):
        spec = spec_tree
        for _, k in path:
            spec = spec[k]
        out.append(spec)
    return out


def _canonical(spec) -> Tuple:
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


# ---------------------------------------------------------------------------
# parameter / optimizer / cache specs
# ---------------------------------------------------------------------------
_COL = re.compile(r"^(wq|wk|wv|bq|bk|bv|w_gate|w_up|b_up|w_z|w_x|conv_w)$")
_ROW = re.compile(r"^(wo|w_down|w_out|b_down)$")


def _param_rule(path: Tuple[str, ...], ndim: int, axes: Axes,
                shape: Tuple[int, ...] = ()) -> Tuple:
    m = axes.model
    name = path[-1]
    stacked = 1 if any(p in ("blocks", "encoder") for p in path) else 0
    lead = (None,) * stacked

    def pad(spec):  # right-pad to ndim, then strip trailing Nones (canonical)
        spec = lead + spec
        spec = spec + (None,) * (ndim - len(spec))
        return _canonical(spec)

    if name in ("embed",):
        return pad((m, None))
    if name == "head":
        return pad((None, m))
    if name == "router":
        return pad((None, None))
    if "ffn" in path and name in ("w_gate", "w_up", "w_down") \
            and ndim - stacked == 3:
        n_exp = shape[stacked] if shape else 0
        if axes.model_size and n_exp and n_exp % axes.model_size == 0:
            return pad((m, None, None))      # experts over model (EP)
        if name == "w_down":
            return pad((None, m, None))      # TP experts: d_ff sharded
        return pad((None, None, m))
    if name.startswith("r_") and ndim - stacked == 3:
        return pad((m, None, None))          # sLSTM recurrent per-head
    if _COL.match(name):
        if ndim - stacked == 1:
            return pad((m,))
        return pad((None, m))
    if _ROW.match(name):
        if ndim - stacked == 1:
            return pad((None,))
        return pad((m, None))
    if name in ("w_B", "w_C", "w_dt"):
        return pad((None, None))
    if name == "norm" and "mamba" in path:
        return pad((m,))
    return pad(())                            # scales, biases, scalars


def infer_param_specs(params, axes: Axes, *, fsdp: bool = False,
                      fsdp_min_elems: int = 1 << 20):
    """TP specs from path rules; with ``fsdp=True`` large leaves
    additionally shard a free dimension over the DP axes (ZeRO-3 / FSDP).
    Serving keeps fsdp=False (replicated)."""
    def rule(keys, shape):
        spec = _param_rule(keys, len(shape), axes, shape)
        if fsdp and axes.batch and len(shape) >= 2 \
                and math.prod(shape) >= fsdp_min_elems:
            dp = max(1, axes.batch_size)
            parts = list(spec + (None,) * (len(shape) - len(spec)))
            for i, ax in enumerate(parts):
                if ax is None and shape[i] % dp == 0 and shape[i] >= dp:
                    parts[i] = axes.batch_spec
                    break
            spec = _canonical(parts)
        return spec
    return _map_shapes(rule, params)


def infer_state_specs(state_shapes, axes: Axes, *, zero: bool = True,
                      fsdp: bool = True):
    """Specs for {"params","opt","step"}; FSDP shards params over DP axes,
    ZeRO shards Adam moments of any still-replicated leading dim over DP."""
    pspecs = infer_param_specs(state_shapes["params"], axes, fsdp=fsdp)
    flat_specs = spec_leaves(pspecs, state_shapes["params"])

    def zero_specs(moments):
        specs = iter(flat_specs)

        def rule(_, shape):
            spec = next(specs)
            if not zero or not axes.batch or len(shape) < 2:
                return spec
            parts = spec + (None,) * (len(shape) - len(spec))
            if parts[0] is None:
                return _canonical((axes.batch_spec,) + parts[1:])
            return _canonical(parts)
        return _map_shapes(rule, moments)

    return {"params": pspecs,
            "opt": {"mu": zero_specs(state_shapes["opt"]["mu"]),
                    "nu": zero_specs(state_shapes["opt"]["nu"]),
                    "count": ()},
            "step": ()}


def cache_specs(cfg: ModelConfig, cache_shapes, axes: Axes):
    """Specs mirroring :func:`repro_torch.models.lm.init_cache`'s tree."""
    from repro_torch.sharding import kv_cache_spec
    b = axes.batch_spec
    m = axes.model
    k_layout = "bkhs" if cfg.xdma_cache else "bshd"
    v_layout = "bksh" if cfg.xdma_cache else "bshd"
    k_spec = tuple(kv_cache_spec(axes, cfg.n_kv_heads, k_layout))
    v_spec = tuple(kv_cache_spec(axes, cfg.n_kv_heads, v_layout))
    cross_spec = tuple(kv_cache_spec(axes, cfg.n_kv_heads, "bshd"))

    def rule(path: Tuple[str, ...], shape) -> Tuple:
        ndim = len(shape)
        stacked = 1 if path[0] in ("blocks", "cross") else 0
        lead = (None,) * stacked
        name = path[-1]
        if name in ("k", "v"):
            if path[0] == "cross":
                return _canonical(lead + cross_spec)
            return _canonical(lead + (k_spec if name == "k" else v_spec))
        if name == "conv":
            return _canonical(lead + (b, None, m))
        if name == "h":                        # mamba state (B,Hm,P,N)
            return _canonical(lead + (b, m, None, None))
        if "mlstm" in path:                    # (B,H,hd,hd)/(B,H,hd)/(B,H)
            return _canonical(lead + (b, m) + (None,) * (ndim - stacked - 2))
        if "slstm" in path:                    # (B, H*hd)
            return _canonical(lead + (b, m))
        if name in ("pos", "len"):
            return _canonical(lead if name == "len" else ())
        return ()

    return _map_shapes(rule, cache_shapes)


def fit_specs(mesh, spec_tree, shape_tree):
    """Drop spec axes whose size doesn't divide the dimension (an input
    shards evenly).  E.g. kv=2 heads cannot shard over model=16 -> that dim
    is replicated at the input."""
    sizes = _sizes(mesh)

    def ax_size(ax):
        names = ax if isinstance(ax, tuple) else (ax,)
        return math.prod(sizes[n] for n in names)

    specs = iter(spec_leaves(spec_tree, shape_tree))

    def fit(_, shape):
        spec = next(specs)
        parts = (tuple(spec) + (None,) * len(shape))[:len(shape)]
        return _canonical(
            ax if (ax is not None and shape[i] % ax_size(ax) == 0) else None
            for i, ax in enumerate(parts))

    return _map_shapes(fit, shape_tree)


def batch_input_specs(batch_shapes, axes: Axes):
    """Specs of a batch (``configs.specs.batch_specs`` or tensors): the
    batch dim over the DP axes."""
    b = axes.batch_spec

    def rule(keys, shape):
        # (3, B, S) positions; embeds / audio_embeds and ids: B first
        return _canonical((None, b) if keys[-1] == "positions" else (b,))

    return _map_shapes(rule, batch_shapes)


# ---------------------------------------------------------------------------
# a train state on a mesh: fitted specs, each rank's blocks, whole leaves
# ---------------------------------------------------------------------------
def state_shapes(cfg: ModelConfig):
    """The whole train state's tree as meta tensors (shapes and dtypes
    only): what :func:`state_specs` fits and a checkpoint restores into."""
    from repro_torch.models import lm
    from repro_torch.optim.adamw import adamw_init
    params = lm.init_params(cfg, device="meta")
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


@functools.lru_cache(maxsize=16)
def _state_specs(cfg: ModelConfig, shape: Tuple[int, ...],
                 axis_names: Tuple[str, ...]):
    shapes = state_shapes(cfg)
    specs = infer_state_specs(shapes, cfg.axes, fsdp=cfg.fsdp)
    return fit_specs(MeshSpec(shape, axis_names), specs, shapes), shapes


def state_specs(cfg: ModelConfig, mesh):
    """``cfg``'s train-state specs (``{"params", "opt", "step"}``: FSDP
    over the batch axes when ``cfg.fsdp``, the Adam moments ZeRO-sharded)
    fitted to ``mesh``, as the reference's launcher shards its state.
    Returns ``(specs, shapes)``, the shapes a tree of meta tensors."""
    return _state_specs(cfg, tuple(mesh.shape), tuple(mesh.axis_names))


def mesh_axes(axes: Axes, mesh) -> Axes:
    """``axes`` with the sizes of ``mesh``: the model axis's size (the
    MoE rule splits experts or ``d_ff`` by it, :func:`repro_torch.sharding.
    kv_cache_spec` heads or the sequence) and the batch axes' product."""
    sizes = _sizes(mesh)
    bsize = math.prod(sizes[n] for n in axes.batch) if axes.batch else 0
    return dataclasses.replace(
        axes, model_size=sizes[axes.model] if axes.model else 0,
        batch_size=bsize)


@functools.lru_cache(maxsize=16)
def _serving_specs(cfg: ModelConfig, shape: Tuple[int, ...],
                   axis_names: Tuple[str, ...]):
    from repro_torch.models import lm
    mesh = MeshSpec(shape, axis_names)
    params = lm.init_params(cfg, device="meta")
    specs = infer_param_specs(params, mesh_axes(cfg.axes, mesh), fsdp=False)
    return fit_specs(mesh, specs, params), params


def serving_specs(cfg: ModelConfig, mesh):
    """``cfg``'s parameter specs for serving, fitted to ``mesh``: the
    tensor-parallel path rules of :func:`infer_param_specs` with no FSDP,
    so every weight is replicated over the batch axes.  Returns ``(specs,
    shapes)``, the shapes a tree of meta tensors (``shard_tree(params,
    specs, mesh)`` gives a rank its blocks)."""
    return _serving_specs(cfg, tuple(mesh.shape), tuple(mesh.axis_names))


def serving_cache_specs(cfg: ModelConfig, cache_shapes, mesh):
    """The specs of a decode cache (``lm.init_cache``'s tree, whole
    shapes) fitted to ``mesh``: :func:`cache_specs` with the mesh's axis
    sizes, a dim that does not split over its axes replicated."""
    specs = cache_specs(cfg, cache_shapes, mesh_axes(cfg.axes, mesh))
    return fit_specs(mesh, specs, cache_shapes)


def _entry_names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _block_of(entry, sizes, index) -> Tuple[int, int]:
    """``(count, i)``: how many blocks a dim splits into over ``entry``
    and this rank's, the axes taken row-major."""
    count, i = 1, 0
    for n in _entry_names(entry):
        count *= sizes[n]
        i = i * sizes[n] + index[n]
    return count, i


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """A leaf's block shape under its fitted spec."""
    sizes = _sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(tuple(spec)[:len(out)]):
        count = math.prod(sizes[n] for n in _entry_names(entry))
        if out[d] % count:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {entry!r} ({count} blocks)")
        out[d] //= count
    return tuple(out)


def _indices(mesh) -> dict:
    """This rank's index along each mesh axis: the mesh's own (a
    :class:`repro_torch.sharding.Mesh`), else the registered axes'."""
    axes = getattr(mesh, "axes", None) or {}
    return {n: (axes[n].index if n in axes else S.axis_index(n))
            for n in mesh.axis_names}


def shard_tree(tree, specs, mesh, device=None):
    """This rank's block of every leaf of ``tree`` by its fitted spec (a
    spec tree matching ``tree``), each block a tensor of its own, on
    ``device`` (the leaf's own when None): a tree on the host puts only
    this rank's blocks on the card."""
    sizes, index = _sizes(mesh), _indices(mesh)
    flat = _pytree.leaves(tree)
    out = []
    for t, spec in zip(flat, spec_leaves(specs, tree)):
        seen = [n for e in spec for n in _entry_names(e)]
        if len(seen) != len(set(seen)):
            raise ValueError(f"spec {spec!r} names an axis twice")
        for d, entry in enumerate(spec):
            count, i = _block_of(entry, sizes, index)
            if count > 1:
                if t.shape[d] % count:
                    raise ValueError(f"dim {d} of {tuple(t.shape)} does "
                                     f"not split over {entry!r}")
                rows = t.shape[d] // count
                t = t.narrow(d, i * rows, rows)
        out.append(t.clone() if device is None
                   else t.to(device, copy=True))
    return _pytree.unflatten(tree, out)


def gather_tree(tree, specs, mesh, device=None):
    """Every leaf of ``tree`` (this rank's blocks) whole again on every
    rank: an all-gather over each axis of its fitted spec, the innermost
    axis of a tuple first.  Runs in every rank of the mesh, no gradient.
    With ``device`` (``"cpu"``) each whole leaf moves there as soon as it
    is gathered, so the card holds one whole leaf at a time."""
    flat = _pytree.leaves(tree)
    out = []
    for t, spec in zip(flat, spec_leaves(specs, tree)):
        for d, entry in enumerate(spec):
            for n in reversed(_entry_names(entry)):
                t = S.all_gather(t, n, d)
        out.append(t if device is None else t.to(device))
    return _pytree.unflatten(tree, out)
