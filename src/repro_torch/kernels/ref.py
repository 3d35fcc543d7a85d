"""Pure-torch oracles for the port's kernels (the twin of
``repro.kernels.ref``).

Kept deliberately naive and independent of the kernel code paths: reshapes
and transposes on logical views only.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["tile_ref", "untile_ref", "tiled_transpose_ref", "mn_transpose_ref",
           "rmsnorm_relayout_ref", "quantize_tiled_ref", "attention_ref"]


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


def rmsnorm_relayout_ref(x: torch.Tensor, weight, tile_shape: Tuple[int, int],
                         eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.to(torch.float32)
    return tile_ref(y.to(x.dtype), tile_shape)


def quantize_tiled_ref(x: torch.Tensor, tile_shape: Tuple[int, int]):
    xf = x.to(torch.float32)
    amax = xf.abs().amax(-1, keepdim=True)
    # amax * f32(1 / 127), not the quotient amax / 127: XLA compiles the
    # reference's division by the constant 127.0 into this multiply wherever
    # it is traced (its Pallas kernel, jit), so this is the reference's result
    # bit for bit
    scale = torch.where(amax > 0, amax * (1 / 127), torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    # a NaN quotient (a NaN element, or inf / inf in a row whose amax is inf)
    # becomes 0, as the reference's float -> int8 conversion makes it
    q = torch.where(torch.isnan(q), 0.0, q).to(torch.int8)
    return tile_ref(q, tile_shape), scale


def attention_ref(q, k, v, *, causal=True, window=None):
    """Naive attention oracle. q (BH,Sq,hd), k/v (BH,Sk,hd)."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqh,bkh->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * hd ** -0.5
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    if causal:
        s = torch.where(kp <= qp, s, -1e30)
    if window is not None:
        s = torch.where(kp > qp - window, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p,
                        v.to(torch.float32)).to(q.dtype)
