"""train_step: microbatched (gradient-accumulation) loss/grad/update
(PyTorch port: the twin of ``repro.train.step``).

The global batch is split into ``shape.microbatches`` slices run in turn —
activation memory scales with the microbatch, gradients accumulate in f32
in microbatch order.  Gradients come from autograd over the port's plain
torch model, as the reference's come from ``jax.grad`` over plain ``jnp``.

The *explicit* data-parallel path, :func:`make_dp_train_step`, runs in
every rank of a :func:`repro_torch.sharding.run_spmd` body: each rank takes
its block of the global batch, computes its gradients, and syncs them
through the XDMA movement plane — every leaf's all-reduce is a
``reduce``-endpoint descriptor (the int8 Quantize/Dequantize wire codec
when ``compressed=True``, lowering to :func:`repro_torch.core.remote.
compressed_psum`), submitted through a :class:`~repro_torch.runtime.
DistributedScheduler` when one is given, so a ``capture()`` trace records
the complete DP gradient traffic of a step.

The state is ``{"params", "opt", "step"}``.  :func:`init_state` holds f32
master parameters and f32 AdamW moments, as the reference does, on the
card unless given ``device="cpu"``; the model casts each weight to
``cfg.dtype`` where it uses it, so an update smaller than a ``cfg.dtype``
step still lands in the master.

**The sharded trainer** is :func:`make_train_step` with ``mesh=`` and
``cfg.axes`` set (``launch.mesh.axes_for``; ``cfg.fsdp``), in every rank
of a :func:`repro_torch.sharding.run_spmd` body: the counterpart of the
reference's GSPMD step.  Each rank holds its blocks of the state by the
fitted train-state specs (:func:`init_state` with ``mesh=``), takes its
data block of every microbatch, runs the model tensor-parallel and FSDP
(:mod:`repro_torch.models.lm`), and accumulates f32 gradients on the
parameters' shardings (reduce-scattered over the data axis each
microbatch); AdamW then updates the shards.  Its collectives are
``torch.distributed``'s, counted in :func:`repro_torch.sharding.
collective_stats`, not XDMA tasks.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from repro_torch import _pytree
from repro_torch import sharding as S
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import MN, Endpoint, describe
from repro_torch.core import api as xdma
from repro_torch.core.descriptor import reduce_descriptor
from repro_torch.layers import embedding as E
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["TrainState", "init_state", "loss_fn", "dp_grad_sync",
           "dp_param_broadcast", "make_dp_train_step", "make_train_step"]

_F32 = torch.float32


class TrainState(dict):
    """{"params", "opt", "step"} — a plain pytree dict."""


def init_state(cfg: ModelConfig, seed: int = 0, *, device=None, mesh=None
               ) -> Dict[str, Any]:
    """A fresh train state on ``device`` (the card unless given ``"cpu"``):
    the port's seeded f32 master parameters, f32 AdamW moments, step 0.

    With ``mesh`` (the sharded trainer, every rank of the mesh calling it):
    the whole parameters are drawn once from the seed on ``device`` (the
    single-process state's values), one weight at a time, and kept on the
    host; this rank puts its blocks by ``cfg``'s fitted state specs on
    ``device``, so the card never holds the whole state; its moments are
    zeros of its moment blocks' shapes."""
    if mesh is None:
        params = lm.init_params(cfg, seed, device=device)
        dev = _pytree.leaves(params)[0].device
        return {"params": params, "opt": adamw_init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}
    from repro_torch.launch import mesh as M
    dev = torch.device("cuda" if device is None else device)
    specs, shapes = M.state_specs(cfg, mesh)
    # on meta (the dry run) the whole tree is shapes only, and the host
    # holds nothing
    store = None if dev.type == "meta" else "cpu"
    params = M.shard_tree(lm.init_params(cfg, seed, device=dev, store=store),
                          specs["params"], mesh, device=dev)
    step = torch.zeros((), dtype=torch.int32, device=dev)

    def zeros(name):
        return _pytree.unflatten(shapes["opt"][name], [
            torch.zeros(M.local_shape(t.shape, sp, mesh), dtype=_F32,
                        device=dev)
            for t, sp in zip(_pytree.leaves(shapes["opt"][name]),
                             M.spec_leaves(specs["opt"][name],
                                           shapes["opt"][name]))])
    return {"params": params,
            "opt": {"mu": zeros("mu"), "nu": zeros("nu"),
                    "count": torch.zeros((), dtype=torch.int32, device=dev)},
            "step": step}


def _logz_and_label_logit(logits, labels, ax):
    """Each token's ``logsumexp`` over the vocabulary and its label's
    logit; with ``ax`` the logits are this rank's vocabulary block over it
    (vocab-parallel: the running max and the sum of exponentials reduced
    over the axis, each label's logit from the rank that holds it)."""
    if ax is None:
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return logz, ll
    n = logits.shape[-1]
    top = S.all_reduce(logits.detach().amax(-1), ax.name, op="max")
    total = S.reduce_from_axis(torch.exp(logits - top[..., None]).sum(-1),
                               ax.name)
    logz = top + torch.log(total)
    ids = labels.long() - ax.index * n
    mine = (ids >= 0) & (ids < n)
    ll = torch.gather(logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    ll = S.reduce_from_axis(torch.where(mine, ll, torch.zeros_like(ll)),
                            ax.name)
    return logz, ll


def loss_fn(cfg: ModelConfig, params, batch, *, mesh=None,
            aux_weight: float = 0.01, z_weight: float = 1e-4):
    """``(nll + aux_weight * aux + z_weight * zloss, metrics)`` over f32
    logits.  Under the sharded trainer the batch is this rank's data block
    and the logits its vocabulary block: the loss and the metrics are this
    rank's share of the global batch's means (their sum over the data axis
    is the mean; the MoE aux, global already, enters as its ``1 / dp``
    share), the logits never gathered."""
    sh = lm.shards_of(cfg)
    logits, aux = lm.forward(cfg, params, batch, mesh=mesh)
    labels = batch["labels"]
    logits = logits.to(_F32)
    logz, ll = _logz_and_label_logit(logits, labels, E.vocab_axis(cfg))
    if sh is None:
        nll = (logz - ll).mean()
        zloss = (logz ** 2).mean()
    else:
        count = labels.numel() * sh.dp
        nll = (logz - ll).sum() / count
        zloss = (logz ** 2).sum() / count
        # the MoE aux is a pmean over the whole mesh, the same on every
        # rank: each data rank's share of it
        aux = aux / sh.dp
    total = nll + aux_weight * aux + z_weight * zloss
    return total, {"nll": nll, "aux": aux, "zloss": zloss}


def _value_and_grad(cfg, params, batch, mesh=None):
    """``(loss, metrics, grads)``: ``grads`` in ``params``' leaf order, a
    leaf the loss does not reach ``None`` (``jax.grad`` gives zeros)."""
    leaves = _pytree.leaves(params)
    live = [p.detach().requires_grad_(p.is_floating_point()) for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, _pytree.unflatten(params, live), batch,
                                mesh=mesh)
        want = [i for i, p in enumerate(live) if p.requires_grad]
        got = torch.autograd.grad(loss, [live[i] for i in want],
                                  allow_unused=True)
    grads = [None] * len(live)
    for i, g in zip(want, got):
        grads[i] = g
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _zeros_f32(leaves):
    return [torch.zeros(p.shape, dtype=_F32, device=p.device) for p in leaves]


def _accumulate(acc, grads, n_micro: int):
    """``acc += g.float() / n_micro`` leaf by leaf (a missing gradient adds
    nothing)."""
    for a, g in zip(acc, grads):
        if g is not None:
            a.add_(g.to(_F32) / n_micro)


def _to(batch, dev):
    return {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
            for k, v in batch.items()}


# -- the explicit DP path: gradient sync as movement-plane tasks -------------
def dp_grad_sync(grads, axis: str, axis_size: int, *, compressed: bool = True,
                 scheduler=None):
    """All-reduce-mean a gradient pytree through the movement plane: one
    :func:`repro_torch.core.descriptor.reduce_descriptor` task per leaf (the
    int8 wire codec when ``compressed`` — lowered to ``compressed_psum``).

    Call in every rank of an SPMD body whose mesh registers ``axis``.  With
    a scheduler, every leaf is submitted as its own task, so a ``capture()``
    ledger records one ``reduce`` event per leaf; without one, each leaf
    goes through ``xdma.transfer`` directly."""
    desc = reduce_descriptor(axis, axis_size, compressed=compressed)
    leaves = _pytree.leaves(grads)
    if scheduler is None:
        outs = [xdma.transfer(g, desc) for g in leaves]
    else:
        futs = [scheduler.submit(g, desc, label=f"dp_grad[{i}]")
                for i, g in enumerate(leaves)]
        scheduler.flush()
        outs = [f.result() for f in futs]
    for i, g in enumerate(outs):      # one leaf's copy alive at a time
        outs[i] = g / axis_size
    return _pytree.unflatten(grads, outs)


@functools.lru_cache(maxsize=None)
def _bcast_desc(dsts: tuple) -> Any:
    return describe(Endpoint.local(MN), Endpoint.multicast(dsts))


def dp_param_broadcast(params, *, scheduler, src: Optional[str] = None,
                       replicas=None, label: str = "dp_bcast"):
    """Broadcast a parameter pytree from the primary data-parallel replica
    to every peer through the movement plane: one *multicast* descriptor
    per matrix leaf, tree-routed over the scheduler's fabric
    (:meth:`~repro_torch.runtime.DistributedScheduler.submit_multicast`),
    so a hop shared by several replicas carries each weight once.

    ``src`` defaults to the fabric's first node and ``replicas`` to every
    other node.  Leaves of rank < 2 (scalars, step counters) replicate
    outside the plane.  Returns the per-replica parameter pytrees in
    ``replicas`` order, each leaf bit-identical to the source."""
    topo = scheduler.topology
    nodes = list(topo.nodes)
    if src is None:
        src = nodes[0]
    if replicas is None:
        replicas = [n for n in nodes if n != src]
    replicas = list(replicas)
    leaves = _pytree.leaves(params)
    futs = {}
    for i, leaf in enumerate(leaves):
        if getattr(leaf, "ndim", 0) < 2:
            continue                      # counters ride outside the plane
        mat = leaf if leaf.ndim == 2 else leaf.reshape(-1, leaf.shape[-1])
        futs[i] = scheduler.submit_multicast(
            mat, _bcast_desc(tuple(replicas)), src=src,
            label=f"{label}[{i}]")
    scheduler.flush()
    out = []
    for node in replicas:
        rleaves = list(leaves)
        for i, f in futs.items():
            rleaves[i] = f.result_at(node).reshape(leaves[i].shape)
        out.append(_pytree.unflatten(params, rleaves))
    return out


def _axis_size(mesh, axis: str) -> int:
    return int(dict(zip(mesh.axis_names, mesh.shape))[axis])


def make_dp_train_step(cfg: ModelConfig, shape: ShapeConfig,
                       opt_cfg: Optional[AdamWConfig] = None, *, mesh,
                       axis: str = "dp", compressed: bool = True,
                       scheduler=None):
    """The explicit data-parallel trainer: per-rank microbatched grads,
    gradient sync through :func:`dp_grad_sync` (the movement plane),
    optimizer update on the replicated mean grads.

    ``train_step(state, batch)`` runs in every rank of an SPMD body whose
    mesh (``mesh``: the :class:`repro_torch.sharding.Mesh`, or anything
    with ``shape`` and ``axis_names``) registers ``axis``; every rank passes
    the same state and the global batch, and takes its block of rows
    (:func:`_data_block`), as ``shard_map`` with ``P(axis)`` hands each
    device its block.  Every byte this step moves between ranks is an XDMA
    task."""
    opt_cfg = opt_cfg or AdamWConfig()
    n = _axis_size(mesh, axis)
    n_micro = max(1, shape.microbatches)

    def local_grads(params, batch):
        """Microbatch-accumulated grads (f32) and loss on this rank's
        block."""
        if n_micro == 1:
            loss, _, grads = _value_and_grad(cfg, params, batch)
            return loss, [torch.zeros(p.shape, dtype=_F32, device=p.device)
                          if g is None else g.to(_F32)
                          for p, g in zip(_pytree.leaves(params), grads)]
        leaves = _pytree.leaves(params)
        acc = _zeros_f32(leaves)
        loss = torch.zeros((), dtype=_F32, device=leaves[0].device)
        for mb in _split_micro(batch, n_micro, mrope=False):
            l, _, grads = _value_and_grad(cfg, params, mb)
            _accumulate(acc, grads, n_micro)
            loss = loss + l / n_micro
        return loss, acc

    def train_step(state, batch):
        params = state["params"]
        dev = _pytree.leaves(params)[0].device
        loss, grads = local_grads(params, _to(_data_block(batch, axis), dev))
        grads = dp_grad_sync(_pytree.unflatten(params, grads), axis, n,
                             compressed=compressed, scheduler=scheduler)
        # the loss mean rides the plane too (uncompressed scalar reduce)
        loss = xdma.transfer(loss, reduce_descriptor(axis, n)) / n
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, params, grads, state["opt"])
        state = {"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}
        return state, dict(loss=loss, **opt_metrics)

    return train_step


def _split_micro(batch, n_micro: int, *, mrope: bool = True):
    """The microbatches of a batch, in order: rows of the batch dim, which
    is dim 1 of M-RoPE's (3, B, S) positions (``mrope``, as
    ``make_train_step`` reads them) and dim 0 of every other leaf."""
    out = [dict() for _ in range(n_micro)]
    for k, x in batch.items():
        if x.dim() == 0:
            for mb in out:
                mb[k] = x
            continue
        b_axis = 1 if mrope and x.dim() >= 3 and x.shape[0] == 3 else 0
        B = x.shape[b_axis]
        if B % n_micro:
            raise ValueError(f"batch leaf {k!r}: batch {B} does not split "
                             f"into {n_micro} microbatches")
        for i, part in enumerate(torch.chunk(x, n_micro, dim=b_axis)):
            out[i][k] = part
    return out


def make_train_step(cfg: ModelConfig, shape: ShapeConfig,
                    opt_cfg: Optional[AdamWConfig] = None, *, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    microbatches in order, their f32 gradients accumulated as ``acc +
    g / n_micro``, then AdamW.  The metrics are the microbatches' mean
    ``nll``, ``aux`` and ``zloss``, the mean ``loss``, and ``lr`` and
    ``grad_norm`` of the update.  The state passed in is not modified.

    With ``mesh`` and ``cfg.axes`` naming its axes this is the sharded
    trainer (see the module's docstring): every rank of ``mesh`` calls the
    step with its blocks of the state and the same global batch; the
    metrics are the global batch's, equal on every rank."""
    opt_cfg = opt_cfg or AdamWConfig()
    n_micro = max(1, shape.microbatches)
    sharded = mesh is not None and (cfg.axes.model is not None
                                    or bool(cfg.axes.batch))

    def train_step(state, batch):
        sh = lm.shards_of(cfg) if sharded else None
        if sharded and sh is None:
            raise LookupError(f"the sharded step for cfg.axes {cfg.axes} "
                              "runs inside its mesh (run_spmd)")
        params = state["params"]
        leaves = _pytree.leaves(params)
        dev = leaves[0].device
        acc = _zeros_f32(leaves)
        loss = torch.zeros((), dtype=_F32, device=dev)
        per_micro = []
        for mb in _split_micro(_to(batch, dev), n_micro):
            l, metrics, grads = _value_and_grad(
                cfg, params, _data_block(mb, sh and sh.data), mesh=mesh)
            _accumulate(acc, grads, n_micro)
            del grads
            loss = loss + l / n_micro
            per_micro.append(metrics)
        if n_micro == 1:
            metrics = per_micro[0]
        else:
            metrics = {k: torch.stack([m[k] for m in per_micro]).mean()
                       for k in per_micro[0]}
        shards = None
        if sh is not None:
            if sh.data is not None:        # each rank's share of the means
                keys = sorted(metrics)
                sums = S.all_reduce(torch.stack(
                    [loss] + [metrics[k] for k in keys]), sh.data)
                loss = sums[0]
                metrics = dict(zip(keys, sums[1:].unbind()))
            from repro_torch.launch import mesh as M
            specs, shapes = M.state_specs(cfg, mesh)
            shards = (M.spec_leaves(specs["params"], shapes["params"]),
                      M.spec_leaves(specs["opt"]["mu"], shapes["opt"]["mu"]),
                      sh.data)
        new_params, new_opt, opt_metrics = adamw_update(
            opt_cfg, params, _pytree.unflatten(params, acc), state["opt"],
            shards=shards)
        del acc
        state = {"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}
        return state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def _data_block(batch, data):
    """This rank's rows of every batch leaf over the ``data`` axis: dim 1
    of M-RoPE's (3, B, S) ``positions``, dim 0 of the others
    (``launch.mesh.batch_input_specs``)."""
    if data is None:
        return batch
    ax = S.mesh_axis(data)
    out = {}
    for k, v in batch.items():
        if v.dim() == 0:
            out[k] = v
            continue
        dim = 1 if k == "positions" and v.dim() == 3 else 0
        if v.shape[dim] % ax.size:
            raise ValueError(f"batch leaf {k!r}: {v.shape[dim]} rows do not "
                             f"split over {ax.size} ranks of {data!r}")
        rows = v.shape[dim] // ax.size
        out[k] = v.narrow(dim, ax.index * rows, rows)
    return out
