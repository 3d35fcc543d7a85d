"""Relayout entry points: thin wrappers over the generic AGU kernel (the twin
of ``repro.kernels.relayout``).

tile / untile / tiled-transpose / mn-transpose — the paper's Fig. 4 /
Table III traffic — are all instances of kernel 1 (:mod:`.agu`).
``tile_block`` / ``untile_block`` are the 2D special case of
``Layout.from_logical`` / ``Layout.to_logical`` applied to a block.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import layouts as L

from .agu import agu_relayout, eff_d_buf

__all__ = ["tile", "untile", "tiled_transpose", "mn_transpose",
           "tile_block", "untile_block", "eff_d_buf"]


def tile_block(x: torch.Tensor, tm: int, tn: int) -> torch.Tensor:
    """Logical (M, N) block -> physical (M//tm, N//tn, tm, tn) tile block."""
    m, n = x.shape
    return x.reshape(m // tm, tm, n // tn, tn).permute(0, 2, 1, 3)


def untile_block(blk: torch.Tensor) -> torch.Tensor:
    """Physical (gm, gn, tm, tn) tile block -> logical (gm*tm, gn*tn) block."""
    gm, gn, tm, tn = blk.shape
    return blk.permute(0, 2, 1, 3).reshape(gm * tm, gn * tn)


def _tiled(tile_shape: Tuple[int, int]) -> L.Layout:
    return L.tiled_layout(*tile_shape)


def tile(x: torch.Tensor, tile_shape: Tuple[int, int], *,
         d_buf: int = 9) -> torch.Tensor:
    """MN -> MNMtmNtn (Prefill 2)."""
    return agu_relayout(x, src_layout=L.MN, dst_layout=_tiled(tile_shape),
                        d_buf=d_buf)


def untile(x: torch.Tensor, *, d_buf: int = 9) -> torch.Tensor:
    """MNMtmNtn -> MN (Prefill 1); the tile geometry comes from the buffer."""
    tm, tn = x.shape[-2], x.shape[-1]
    return agu_relayout(x, src_layout=_tiled((tm, tn)), dst_layout=L.MN,
                        d_buf=d_buf)


def tiled_transpose(x: torch.Tensor, *, d_buf: int = 9) -> torch.Tensor:
    """MNMtmNtn -> MNMtmNtn, logically transposed (the KV-cache Load op)."""
    gm, gn, tm, tn = x.shape
    lay = _tiled((tm, tn))
    return agu_relayout(x, src_layout=lay, dst_layout=lay, transpose=True,
                        d_buf=d_buf)


def mn_transpose(x: torch.Tensor, *, block: int = 128,
                 d_buf: int = 9) -> torch.Tensor:
    """MN -> MN, transposed.  ``block`` is retained for API compatibility;
    the planner picks the geometry from the pattern."""
    del block
    return agu_relayout(x, src_layout=L.MN, dst_layout=L.MN, transpose=True,
                        d_buf=d_buf)
