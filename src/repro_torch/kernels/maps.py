"""Layouts as kernel arguments: the small arrays the CUDA kernels index with.

A :class:`~repro_torch.core.layouts.Layout` maps a logical coordinate to a
physical element offset one logical dim at a time: dim ``d`` with tile
``t`` contributes ``(i // t) * sgrid + (i % t) * stile``, where ``sgrid``
and ``stile`` are the row-major strides of its grid and tile physical dims
after the permutation (an untiled dim has ``t = 1``).  Stride padding only
widens the strides.  The same numbers drive ``csrc/xdma_common.cuh``'s
``dim_offset``.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from repro_torch.core import layouts as L

__all__ = ["DimMap", "dim_maps", "physical_dims", "inner_axis",
           "dtype_code", "DTYPE_CODES", "tiled_rows"]

# dtype codes shared with csrc/xdma_common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(dtype: torch.dtype) -> int:
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise NotImplementedError(
            f"the datapath kernels run float32/bfloat16/float16 streams, "
            f"not {dtype}") from None


class DimMap(ctypes.Structure):
    _fields_ = [("tile", ctypes.c_int64), ("sgrid", ctypes.c_int64),
                ("stile", ctypes.c_int64)]


def _strides(layout: L.Layout, logical_shape: Sequence[int]):
    rank = len(logical_shape)
    dims = layout._phys_dims(rank)
    extents = [layout._phys_extent(tuple(logical_shape), dk) for dk in dims]
    strides = [0] * len(dims)
    acc = 1
    for i in range(len(dims) - 1, -1, -1):
        strides[i] = acc
        acc *= extents[i]
    return dims, extents, strides


def dim_maps(layout: L.Layout, logical_shape: Sequence[int]
             ) -> List[Tuple[int, int, int]]:
    """Per logical dim: ``(tile, grid stride, tile stride)``."""
    layout.check(tuple(logical_shape))
    dims, _, strides = _strides(layout, logical_shape)
    stride_of = dict(zip(dims, strides))
    out = []
    for d in range(len(logical_shape)):
        t = layout.dim_tile(len(logical_shape), d)
        if t > 1:
            out.append((t, stride_of[(d, "grid")], stride_of[(d, "tile")]))
        else:
            out.append((1, stride_of[(d, "plain")], 0))
    return out


def physical_dims(layout: L.Layout, logical_shape: Sequence[int]
                  ) -> List[Tuple[int, int, int]]:
    """Per physical dim, post-perm: ``(extent, logical dim, weight)`` — its
    index times ``weight`` adds to that logical (padded) coordinate."""
    layout.check(tuple(logical_shape))
    dims, extents, _ = _strides(layout, logical_shape)
    rank = len(logical_shape)
    return [(e, d, layout.dim_tile(rank, d) if kind == "grid" else 1)
            for e, (d, kind) in zip(extents, dims)]


def inner_axis(layout: L.Layout, rank: int) -> int:
    """The logical dim the layout's innermost physical dim indexes."""
    return layout._phys_dims(rank)[-1][0]


def tiled_rows(x: torch.Tensor, tile_shape: Tuple[int, int], what: str) -> int:
    """The rows of ``x`` (m, n) that the reference's fused kernels write into
    ``tile_shape`` tiles, ``(m // tm) * tm`` (their grid covers m // tm row
    tiles); raises where their reshape fails, on columns that are not a whole
    number of tiles."""
    if x.dim() != 2:
        raise ValueError(f"{what} takes an (m, n) array, not {tuple(x.shape)}")
    m, n = x.shape
    tm, tn = tile_shape
    if tm <= 0 or tn <= 0 or n % tn:
        raise ValueError(f"{n} columns are not a whole number of {tn}-wide "
                         f"tiles")
    return (m // tm) * tm
