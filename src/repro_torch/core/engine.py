"""XDMA local engine: layout-transforming copies within one memory (PyTorch port).

The twin of ``repro.core.engine``.  Two lowerings of one local descriptor:

* :func:`xdma_copy` — the plain composition: reader (physical -> logical
  view), plugin cascade, writer (logical -> physical), in PyTorch ops.  It
  is the reference's fused-XLA path, which ``backend="fused"`` and the
  recorded fallbacks take.
* :func:`xdma_copy_pallas` — ``backend="pallas"``: the generic AGU relayout,
  which in the port is the hand-written Hopper kernel
  (:mod:`repro_torch.kernels.agu`).  Pure relayouts and relayout+transpose
  on 2D logical data lower through it; other chains fall back to
  :func:`xdma_copy`, and ``agu_stats()`` records why.  ``backend="auto"`` lowers an empty chain the same way, untallied (the
  reference jits :func:`xdma_copy` there: the same bytes).
"""
from __future__ import annotations

import torch

from . import layouts as L
from . import plugins as P
from .descriptor import XDMADescriptor

__all__ = ["xdma_copy", "xdma_copy_pallas", "reader", "writer"]


def reader(x: torch.Tensor, layout: L.Layout) -> torch.Tensor:
    """XDMA Frontend read side: stream physical buffer out in logical order."""
    return layout.to_logical(x)


def writer(x: torch.Tensor, layout: L.Layout) -> torch.Tensor:
    """XDMA Frontend write side: stream logical data into the physical layout."""
    return layout.from_logical(x)


def xdma_copy(x, desc: XDMADescriptor):
    """One XDMA task on a local memory: src layout -> plugins -> dst layout.

    ``x`` is the *physical* source buffer.  Returns the *physical* destination
    buffer (a :class:`QTensor` / :class:`CTensor` when the chain ends in a
    payload plugin).
    """
    if isinstance(x, P.CTensor):
        # compressed carrier in this memory: relayout the dense values, keep
        # the mask side-channel on the stream (Decompress consumes it)
        logical = P.CTensor(values=reader(x.values, desc.src_layout),
                            mask=x.mask)
    else:
        logical = reader(x, desc.src_layout)
    desc.validate(tuple(logical.shape))
    logical = P.apply_chain(desc.plugins, logical)
    if isinstance(logical, P.QTensor):
        return P.QTensor(values=writer(logical.values, desc.dst_layout),
                         scales=logical.scales)
    if isinstance(logical, P.CTensor):
        return P.CTensor(values=writer(logical.values, desc.dst_layout),
                         mask=logical.mask)
    return writer(logical, desc.dst_layout)


def xdma_copy_pallas(x, desc: XDMADescriptor, *, tally: bool = True):
    """Lowering through the generic AGU kernel (kernel 1).

    Supports pure relayout and relayout+transpose on 2D logical data for any
    layout pair the pattern planner covers.  Other plugin chains fall back to
    :func:`xdma_copy` (tallied in ``agu_stats()`` unless ``tally=False``).
    """
    from repro_torch.kernels import agu, ops as kops

    pure_transpose = (len(desc.plugins) == 1
                      and isinstance(desc.plugins[0], P.Transpose))
    if desc.plugins and not pure_transpose:
        if tally:
            agu.record_fallback("plugin-chain")
        return xdma_copy(x, desc)
    return kops.relayout(x, src_layout=desc.src_layout,
                         dst_layout=desc.dst_layout,
                         transpose=pure_transpose, d_buf=desc.d_buf,
                         tally=tally)
