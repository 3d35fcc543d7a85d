"""Kernel 4: RMSNorm on the stream fused with the MN -> tiled relayout (the
twin of ``repro.kernels.fused_rmsnorm_relayout``).

The paper's Prefill workload (§III-C): KV-cache rows are RMSNormed *while*
being moved into the GeMM-optimal tiled layout.  On a CUDA tensor
:func:`rmsnorm_relayout` launches ``csrc/rmsnorm_relayout.cu``, which keeps
each row in registers between its sum of squares and its store; on a CPU
tensor it takes the plain version, the oracle of :mod:`.ref` applied to the
rows the reference's grid covers (on a meta tensor too while the dry run
counts: one op to ``launch.op_cost``).

Shapes follow the reference: the columns must be a whole number of tiles
(the reference's reshape fails otherwise), and rows past ``(m // tm) * tm``
are dropped (its grid covers ``m // tm`` row tiles).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.launch import op_cost

from . import _build, maps, ref

__all__ = ["rmsnorm_relayout", "rmsnorm_relayout_plain", "norm_args", "NORM"]

NORM = _build.register(_build.Kernel(
    "rmsnorm_relayout", "rmsnorm_relayout.cu", "xdma_rmsnorm_relayout",
    [ctypes.c_void_p] * 4,
    replaces="src/repro/kernels/fused_rmsnorm_relayout.py:43"))


class _NormArgs(ctypes.Structure):
    _fields_ = [("rows", ctypes.c_int64), ("cols", ctypes.c_int64),
                ("tm", ctypes.c_int64), ("tn", ctypes.c_int64),
                ("dtype", ctypes.c_int64), ("w_dtype", ctypes.c_int64),
                ("eps", ctypes.c_double)]


def rmsnorm_relayout_plain(x: torch.Tensor, weight: Optional[torch.Tensor],
                           tile_shape: Tuple[int, int], *,
                           eps: float = 1e-6) -> torch.Tensor:
    """The plain version: :func:`.ref.rmsnorm_relayout_ref` on the rows the
    reference's grid covers."""
    rows = maps.tiled_rows(x, tile_shape, "rmsnorm_relayout")
    return ref.rmsnorm_relayout_ref(x[:rows], weight, tile_shape, eps)


def norm_args(x: torch.Tensor, weight: Optional[torch.Tensor],
              tile_shape: Tuple[int, int], eps: float) -> _NormArgs:
    """Kernel 4's arguments for ``x`` (m, n) into ``tile_shape`` tiles."""
    a = _NormArgs()
    a.rows = maps.tiled_rows(x, tile_shape, "rmsnorm_relayout")
    a.cols = x.shape[1]
    a.tm, a.tn = tile_shape
    a.dtype = maps.dtype_code(x.dtype)
    a.w_dtype = -1 if weight is None else maps.dtype_code(weight.dtype)
    a.eps = eps
    return a


def _launch(x, weight, tile_shape, eps):
    x = x.contiguous()      # a strided view is copied once
    if weight is not None:
        if weight.device != x.device or tuple(weight.shape) != (x.shape[1],):
            raise ValueError(f"the weight must be ({x.shape[1]},) on "
                             f"{x.device}, not {tuple(weight.shape)} on "
                             f"{weight.device}")
        weight = weight.contiguous()
    a = norm_args(x, weight, tile_shape, eps)
    tm, tn = tile_shape
    out = torch.empty((a.rows // tm, a.cols // tn, tm, tn), dtype=x.dtype,
                      device=x.device)
    NORM(ctypes.addressof(a), x.data_ptr(),
         None if weight is None else weight.data_ptr(), out.data_ptr())
    return out


@op_cost.one_op
def rmsnorm_relayout(x: torch.Tensor, weight: Optional[torch.Tensor],
                     tile_shape: Tuple[int, int], *, eps: float = 1e-6,
                     d_buf: int = 9) -> torch.Tensor:
    """RMSNorm each row of ``x`` (m, n), times ``weight`` (n,) when given,
    into ``MNM{tm}N{tn}`` tiles ``(m // tm, n // tn, tm, tn)`` of x's dtype.

    ``d_buf`` is the reference's TPU burst depth; it picks only the
    reference's grid and never the result, and the CUDA kernel tiles its
    work its own way (a thread group per row)."""
    tile_shape = tuple(int(t) for t in tile_shape)
    if op_cost.plain_on(x):
        return rmsnorm_relayout_plain(x, weight, tile_shape, eps=eps)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no rmsnorm_relayout kernel for {x.device}")
    return _launch(x, weight, tile_shape, eps)
