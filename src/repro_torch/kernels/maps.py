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
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import layouts as L

__all__ = ["DimMap", "dim_maps", "physical_dims",
           "dtype_code", "DTYPE_CODES", "INT_CODES", "tiled_rows", "Term",
           "Tile2", "Lead",
           "tile2", "run_axis", "fit_to"]

# dtype codes shared with csrc/xdma_common.cuh: the float streams every
# kernel runs, and the streams kernel 3 runs as well (integers, bool,
# float8: every stream the reference's datapath takes)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
INT_CODES = {torch.int8: 3, torch.uint8: 4, torch.int16: 5, torch.int32: 6,
             torch.int64: 7, torch.bool: 8, torch.uint16: 9,
             torch.uint32: 10, torch.float8_e4m3fn: 11,
             torch.float8_e5m2: 12}


def dtype_code(dtype: torch.dtype, integers: bool = False) -> int:
    """The dtype's code; the codes of :data:`INT_CODES` only where
    ``integers`` (kernel 3)."""
    code = DTYPE_CODES.get(dtype)
    if code is None and integers:
        code = INT_CODES.get(dtype)
    if code is None:
        kinds = "float32/bfloat16/float16" + (
            ", int8/uint8/int16/int32/int64, uint16/uint32, bool and "
            "float8_e4m3fn/float8_e5m2" if integers else "")
        why = (": the reference has no float64 stream (JAX runs with x64 "
               "off and takes a float64 array as float32)"
               if dtype == torch.float64 else "")
        raise NotImplementedError(f"the kernel runs {kinds} streams, not "
                                  f"{dtype}{why}")
    return code


class DimMap(ctypes.Structure):
    _fields_ = [("tile", ctypes.c_int64), ("sgrid", ctypes.c_int64),
                ("stile", ctypes.c_int64)]


class Term(ctypes.Structure):
    """One tile axis's share of one side's element offset
    (``csrc/xdma_common.cuh``): the layout map of the logical axis it
    indexes, and an int64 index vector over the tile axis (0: none)."""
    _fields_ = [("map", DimMap), ("idx", ctypes.c_int64)]


class Tile2(ctypes.Structure):
    """The rank-2 tiled copy's geometry (``xdma::Tile2``)."""
    _fields_ = [("rows", ctypes.c_int64), ("cols", ctypes.c_int64),
                ("prows", ctypes.c_int64), ("pcols", ctypes.c_int64),
                ("src_r", Term), ("src_c", Term),
                ("dst_r", DimMap), ("dst_c", DimMap),
                ("load_axis", ctypes.c_int64), ("store_axis", ctypes.c_int64),
                ("vs", ctypes.c_int64), ("vd", ctypes.c_int64)]


class Lead(ctypes.Structure):
    """One leading axis of kernel 3's batched rank-2 pass
    (``csrc/block_datapath.cu``): its extent, its source term (the layout
    map and a leading-axis gather's composed indices) and its destination
    map."""
    _fields_ = [("extent", ctypes.c_int64), ("src", Term), ("dst", DimMap)]


def run_axis(terms: Sequence[Tuple[int, int, int]], extents: Sequence[int],
             pack: int, indexed: Sequence[bool] = (False, False)
             ) -> Tuple[int, int]:
    """``(axis, width)``: the tile axis (0 rows, 1 columns) whose term has
    unit stride, and the elements an access moves along it — ``pack`` where
    ``pack`` consecutive positions, starting at a multiple of ``pack``, are
    consecutive and ``pack``-aligned in memory over the whole ``extents``
    of that axis, else 1.  ``terms`` are the two axes' ``(tile, sgrid,
    stile)`` maps; an indexed (gathered) axis never moves packs."""
    def unit(m):
        return (m[0] > 1 and m[2] == 1) or (m[0] == 1 and m[1] == 1)

    axis = next((ax for ax in (1, 0) if unit(terms[ax])), None)
    if axis is None:
        return 1, 1
    run, other = terms[axis], terms[1 - axis]
    strides = [run[1]] if run[0] > 1 else []
    strides += [other[1]] + ([other[2]] if other[0] > 1 else [])
    ok = (not indexed[axis] and extents[axis] % pack == 0
          and (run[0] == 1 or run[0] % pack == 0)
          and all(st % pack == 0 for st in strides))
    return axis, pack if ok else 1


def tile2(extent: Sequence[int], pads: Sequence[int],
          src_terms: Sequence[Tuple[int, int, int]],
          src_index: Sequence[Optional[torch.Tensor]],
          dst_maps: Sequence[Tuple[int, int, int]], pack: int) -> Tile2:
    """The tiled copy of a ``extent`` (rows, cols) space whose destination
    pads it by ``pads``.  ``src_terms`` are the source maps that a tile row
    and a tile column index (after any swap), ``src_index`` their index
    vectors (int64 tensors that outlive the launch, or None); ``pack`` is
    the elements of one 16-byte access."""
    t = Tile2()
    t.rows, t.cols = extent
    t.prows, t.pcols = extent[0] + pads[0], extent[1] + pads[1]
    for term, m, idx in ((t.src_r, src_terms[0], src_index[0]),
                         (t.src_c, src_terms[1], src_index[1])):
        term.map = DimMap(*m)
        term.idx = 0 if idx is None else idx.data_ptr()
    t.dst_r, t.dst_c = DimMap(*dst_maps[0]), DimMap(*dst_maps[1])
    t.load_axis, t.vs = run_axis(src_terms, extent, pack,
                                 [i is not None for i in src_index])
    t.store_axis, t.vd = run_axis(dst_maps, (t.prows, t.pcols), pack)
    return t


def fit_to(t: Tile2, src: torch.Tensor, dst: Optional[torch.Tensor],
           lead: Sequence[Lead] = ()) -> Tile2:
    """Word accesses on a side whose buffer is not 16-byte aligned (a pack
    needs an aligned base; the kernels refuse a pack on one that is not),
    at its base or at the offset of some index of a ``lead`` axis (kernel
    3's batched pass adds those offsets to the base)."""
    pack = 16 // src.element_size()

    def steps(m):
        return [m.sgrid] + ([m.stile] if m.tile > 1 else [])

    live = [ld for ld in lead if ld.extent > 1]
    if src.data_ptr() % 16 or any(st % pack for ld in live
                                  for st in steps(ld.src.map)):
        t.vs = 1
    if dst is not None and (dst.data_ptr() % 16 or any(
            st % pack for ld in live for st in steps(ld.dst))):
        t.vd = 1
    return t


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
