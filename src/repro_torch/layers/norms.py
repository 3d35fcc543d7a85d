"""RMS normalization (f32 accumulation, compute-dtype output).  The
reference's ``layer_norm`` has no caller and is not ported."""
from __future__ import annotations

import torch

from repro_torch import sharding as S

from ._init import Init


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    w = weight.to(torch.float32)
    if zero_centered:                      # gemma convention: weight stored as w-1
        w = 1.0 + w
    return (y * w).to(dt)


def rms_norm_tp(x: torch.Tensor, weight: torch.Tensor, whole: int, axis,
                eps: float = 1e-6) -> torch.Tensor:
    """:func:`rms_norm` of a feature dim ``whole`` long of which ``x`` holds
    this rank's block over ``axis`` (``weight`` its block too): the sum of
    squares summed over the axis, its gradient summed back, since every
    rank's block reads it."""
    dt = x.dtype
    xf = x.to(torch.float32)
    ss = S.copy_to_axis(S.reduce_from_axis(
        torch.sum(xf * xf, dim=-1, keepdim=True), axis), axis)
    y = xf * torch.rsqrt(ss / whole + eps)
    return (y * weight.to(torch.float32)).to(dt)


def init_rms(init: Init, d: int):
    return {"scale": init.ones((d,))}
