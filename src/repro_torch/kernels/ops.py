"""Public wrappers for the port's kernels (the twin of ``repro.kernels.ops``).

``relayout`` lowers a layout pair through the generic AGU kernel
(:mod:`.agu`); pairs outside kernel coverage (no common loop-nest
refinement, row-stride padding, rank > 2) take the reference's recorded
fallback — the plain layout composition — and
:func:`repro_torch.kernels.agu.agu_stats` records the reason.
"""
from __future__ import annotations

import torch

from repro_torch.core import layouts as L

from . import agu
from .fused_rmsnorm_relayout import rmsnorm_relayout
from .quant import quantize_tiled

__all__ = ["relayout", "rmsnorm_relayout", "quantize_tiled"]


def relayout(x: torch.Tensor, *, src_layout: L.Layout, dst_layout: L.Layout,
             transpose: bool = False, d_buf: int = 9,
             tally: bool = True) -> torch.Tensor:
    """``src_layout`` -> ``dst_layout`` (optionally swapping the last two
    logical dims) through kernel 1 where the planner covers the pair, the
    plain composition elsewhere; ``tally=False`` leaves ``agu_stats()``
    alone (the ``auto`` backend's empty chains, which the reference lowers
    without the AGU kernel and does not count)."""
    logical = src_layout.logical_shape(tuple(x.shape))
    plan, reason = agu.plan_relayout(src_layout, dst_layout, logical,
                                     transpose=transpose, d_buf=d_buf)
    if plan is not None:
        if tally:
            agu.record_plan(plan)
        return plan.run(x)
    if tally:
        agu.record_fallback(reason)
    return agu.relayout_plain(x, src_layout, dst_layout, transpose)
