"""AdamW + cosine schedule + global-norm clipping over parameter pytrees
(PyTorch port: the twin of ``repro.optim.adamw``).

Plain functions on the port's pytrees (``repro_torch._pytree``: dict keys
sorted, tuples in order).  Moments are f32 whatever the parameters' dtype;
weight decay applies to leaves of rank >= 2.  A ``None`` gradient (a leaf
the loss does not reach, as autograd reports it) counts as zeros, as
``jax.grad`` returns them: the leaf's moments decay and its weight still
decays.  The schedule, the bias corrections and the clip scale are 0-d f32
tensors on the parameters' device, so a step never waits for the host.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import _pytree
from repro_torch import sharding as S

__all__ = ["AdamWConfig", "cosine_schedule", "clip_by_global_norm",
           "adamw_init", "adamw_update"]

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step):
    """The learning rate at ``step`` (a tensor or a number): linear warmup
    to ``lr``, then a cosine down to ``min_lr_frac * lr``; an f32 tensor."""
    step = torch.as_tensor(step).to(_F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _global_norm(leaves, device):
    """sqrt of the sum of squares, the leaves added in flatten order."""
    total = torch.zeros((), dtype=_F32, device=device)
    for g in leaves:
        if g is not None:
            total = total + torch.sum(torch.square(g.to(_F32)))
    return torch.sqrt(total)


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _names(spec):
    return frozenset(n for e in spec if e is not None
                     for n in (e if isinstance(e, tuple) else (e,)))


def _sharded_norm(leaves, specs, device):
    """The global norm of gradients sharded by ``specs``: each set of axes'
    local sums of squares all-reduced over exactly those axes."""
    parts = {}
    for g, sp in zip(leaves, specs):
        if g is not None:
            key = _names(sp)
            parts[key] = (parts.get(key, torch.zeros((), dtype=_F32,
                                                      device=device))
                          + torch.sum(torch.square(g.to(_F32))))
    total = torch.zeros((), dtype=_F32, device=device)
    for key in sorted(parts, key=sorted):
        part = parts[key]
        if key:
            part = S.all_reduce(part, S.axis_over(key).name)
        total = total + part
    return torch.sqrt(total)


def _zero_rows(pspec, mspec, ndim: int, data) -> bool:
    """Whether a leaf's moments are ZeRO-sharded over ``data`` on dim 0
    where its parameter is not (its only difference allowed)."""
    p = tuple(pspec) + (None,) * (ndim - len(pspec))
    m = tuple(mspec) + (None,) * (ndim - len(mspec))
    if p == m:
        return False
    if m[0] == data and p[0] is None and m[1:] == p[1:]:
        return True
    raise ValueError(f"moment spec {mspec!r} against parameter spec "
                     f"{pspec!r}: only dim 0 over {data!r} may differ")


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to a global norm of at most max_norm, norm)``."""
    leaves = _pytree.leaves(grads)
    dev = leaves[0].device if leaves else None
    norm = _global_norm(leaves, dev)
    scale = _clip_scale(norm, max_norm)
    return _pytree.tree_map_with_path(
        lambda _, g: (g.to(_F32) * scale).to(g.dtype), grads), norm


def adamw_init(params):
    """f32 moments shaped like ``params`` and an int32 step count, on the
    parameters' device."""
    leaves = _pytree.leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda _, p: torch.zeros(p.shape, dtype=_F32,  # noqa: E731
                                     device=p.device)
    return {"mu": _pytree.tree_map_with_path(zeros, params),
            "nu": _pytree.tree_map_with_path(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(cfg: AdamWConfig, params, grads, opt_state, *,
                 shards=None):
    """One AdamW step: ``(new_params, new_opt_state, {"lr", "grad_norm"})``.

    ``grads`` has the structure of ``params``; a ``None`` leaf counts as
    zeros.  The gradients are clipped to ``cfg.clip_norm`` first (each leaf
    scaled as it is used, so no clipped copy of the whole tree is held).

    ``shards`` (the sharded trainer, every rank of the mesh calling it):
    ``(param_specs, moment_specs, data_axis)``, the fitted specs of the
    parameters and of their moments in leaf order; every leaf is then this
    rank's block (see the module's docstring)."""
    flat_p = _pytree.leaves(params)
    flat_g = _flatten_up_to(params, grads)
    flat_mu = _pytree.leaves(opt_state["mu"])
    flat_nu = _pytree.leaves(opt_state["nu"])
    dev = flat_p[0].device
    zero = [False] * len(flat_p)
    if shards is None:
        gnorm = _global_norm(flat_g, dev)
    else:
        pspecs, mspecs, data = shards
        gnorm = _sharded_norm(flat_g, pspecs, dev)
        zero = [_zero_rows(ps, ms, p.dim(), data)
                for p, ps, ms in zip(flat_p, pspecs, mspecs)]
    scale = _clip_scale(gnorm, cfg.clip_norm)
    count = opt_state["count"] + 1
    lr = cosine_schedule(cfg, count)
    cf = count.to(_F32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=_F32, device=dev), cf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=_F32, device=dev), cf)

    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu, z in zip(flat_p, flat_g, flat_mu, flat_nu, zero):
        if z:                     # this rank's rows of a replicated leaf
            ax = S.mesh_axis(data)
            rows = p.shape[0] // ax.size
            p = p.narrow(0, ax.index * rows, rows)
            g = None if g is None else g.narrow(0, ax.index * rows, rows)
        # the reference's expressions op by op; the in-place steps write
        # only buffers made here, so a leaf's temporaries stay few
        g = (torch.zeros(p.shape, dtype=_F32, device=p.device) if g is None
             else (g.to(_F32) * scale).to(g.dtype).to(_F32))
        mu = torch.mul(mu, cfg.b1).add_(torch.mul(g, 1 - cfg.b1))
        nu = torch.mul(nu, cfg.b2).add_(torch.mul(g, 1 - cfg.b2).mul_(g))
        del g
        step = torch.div(mu, b1c).div_(
            torch.div(nu, b2c).sqrt_().add_(cfg.eps))
        if p.dim() >= 2:
            step.add_(torch.mul(p.to(_F32), cfg.weight_decay))
        new = torch.sub(p.to(_F32), step.mul_(lr)).to(p.dtype)
        del step
        new_p.append(S.all_gather(new, data, 0) if z else new)
        new_mu.append(mu)
        new_nu.append(nu)
    return (_pytree.unflatten(params, new_p),
            {"mu": _pytree.unflatten(opt_state["mu"], new_mu),
             "nu": _pytree.unflatten(opt_state["nu"], new_nu),
             "count": count},
            {"lr": lr, "grad_norm": gnorm})


def _flatten_up_to(params, grads):
    """``grads``' leaves in ``params``' order, ``None`` where a gradient is
    missing (a ``None`` subtree is an empty node to the flattener)."""
    out = []

    def walk(p, g):
        if isinstance(p, dict):
            for k in sorted(p):
                walk(p[k], None if g is None else g.get(k))
        elif isinstance(p, (list, tuple)):
            for i, v in enumerate(p):
                walk(v, None if g is None else g[i])
        elif p is not None:
            out.append(g)
    walk(params, grads)
    return out
