"""A cumulative sum in the reference's order of adds."""
from __future__ import annotations

import torch

_BLOCK = 16


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.cumsum(x, axis=dim)`` as XLA computes it on the CPU: one add at
    a time in the input's dtype within blocks of 16, each block's total
    carried into the next by the same rule, applied to the totals.
    ``torch.cumsum`` accumulates f32 in float64 on the CPU and scans in
    parallel on the card; a scan over a long decay (the SSD and mLSTM
    chunks) turns that last-bit difference into the exponent of a decay."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _BLOCK:
        out = _sequential(x)
    else:
        nb = -(-n // _BLOCK)
        xb = torch.nn.functional.pad(x, (0, nb * _BLOCK - n))
        inner = _sequential(xb.reshape(x.shape[:-1] + (nb, _BLOCK)))
        carry = cumsum(inner[..., -1], -1)
        carry = torch.cat([torch.zeros_like(carry[..., :1]), carry[..., :-1]],
                          -1)
        out = (inner + carry[..., None]).reshape(xb.shape)[..., :n]
    return out.movedim(-1, dim)


def _sequential(x: torch.Tensor) -> torch.Tensor:
    parts, acc = [], torch.zeros_like(x[..., 0])
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
        parts.append(acc)
    return torch.stack(parts, -1)
