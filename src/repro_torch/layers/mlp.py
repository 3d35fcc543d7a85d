"""Feed-forward blocks: SwiGLU (LM family) and GeLU (whisper).

Under a registered model axis (``cfg.axes.model``, the sharded trainer)
both run tensor-parallel: ``w_gate`` / ``w_up`` / ``b_up`` column-parallel,
``w_down`` row-parallel, its partial sums reduced over the axis, and the
replicated ``b_down`` added once after the reduce."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch import sharding as S

from ._init import Init


def init_swiglu(init: Init, d: int, d_ff: int):
    return {
        "w_gate": init.normal((d, d_ff), d ** -0.5),
        "w_up": init.normal((d, d_ff), d ** -0.5),
        "w_down": init.normal((d_ff, d), d_ff ** -0.5),
    }


def _tp_weights(cfg, p, x, names):
    """``(x, weights, axis name)``: ``x`` entering the work partitioned over
    the model axis, and this rank's block of each named weight along its
    ``d_ff`` dim (0 for ``w_down``, else the last)."""
    ax = S.active_axis(cfg.axes.model)
    if ax is None:
        return x, [p.get(n) for n in names], None
    ws = [S.block_of(p.get(n), ax.name, cfg.d_ff,
                     0 if n == "w_down" else p[n].dim() - 1) for n in names]
    return S.copy_to_axis(x, ax.name), ws, ax.name


def _reduce(y, m):
    return y if m is None else S.reduce_from_axis(y, m)


def swiglu(cfg, p, x):
    dt = x.dtype
    x, (wg, wu, wd), m = _tp_weights(cfg, p, x, ("w_gate", "w_up", "w_down"))
    h = F.silu(x @ wg.to(dt)) * (x @ wu.to(dt))
    return _reduce(h @ wd.to(dt), m)


def init_gelu_mlp(init: Init, d: int, d_ff: int):
    return {
        "w_up": init.normal((d, d_ff), d ** -0.5),
        "b_up": init.zeros((d_ff,)),
        "w_down": init.normal((d_ff, d), d_ff ** -0.5),
        "b_down": init.zeros((d,)),
    }


def gelu_mlp(cfg, p, x):
    dt = x.dtype
    x, (wu, bu, wd), m = _tp_weights(cfg, p, x, ("w_up", "b_up", "w_down"))
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(x @ wu.to(dt) + bu.to(dt), approximate="tanh")
    return _reduce(h @ wd.to(dt), m) + p["b_down"].to(dt)
