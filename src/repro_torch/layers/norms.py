"""RMS normalization (f32 accumulation, compute-dtype output).  The
reference's ``layer_norm`` has no caller and is not ported."""
from __future__ import annotations

import torch

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


def init_rms(init: Init, d: int):
    return {"scale": init.ones((d,))}
