"""Pure-torch oracles for the relayout kernels (the twin of
``repro.kernels.ref``'s relayout part).

Kept deliberately naive and independent of the kernel code paths: reshapes
and transposes on logical views only.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["tile_ref", "untile_ref", "tiled_transpose_ref", "mn_transpose_ref"]


def tile_ref(x: torch.Tensor, tile_shape: Tuple[int, int]) -> torch.Tensor:
    m, n = x.shape
    tm, tn = tile_shape
    return x.reshape(m // tm, tm, n // tn, tn).permute(0, 2, 1, 3).contiguous()


def untile_ref(x: torch.Tensor) -> torch.Tensor:
    gm, gn, tm, tn = x.shape
    return x.permute(0, 2, 1, 3).reshape(gm * tm, gn * tn)


def tiled_transpose_ref(x: torch.Tensor) -> torch.Tensor:
    gm, gn, tm, tn = x.shape
    logical = untile_ref(x)
    return tile_ref(logical.T, (tm, tn))


def mn_transpose_ref(x: torch.Tensor) -> torch.Tensor:
    return x.T.contiguous()
