"""Rotary position embeddings: standard RoPE and M-RoPE (Qwen2-VL).

M-RoPE splits the head dim into (temporal, height, width) sections, each
rotated by its own position stream; text tokens carry identical t/h/w ids so
M-RoPE degenerates to RoPE on text (arXiv:2409.12191 §2.1).  The math runs
in f32, as the reference's.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _angles(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """positions (...,) -> angles (..., dim//2) in f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    return positions.to(torch.float32)[..., None] * inv


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S) -> rotated x (same dtype)."""
    return _rotate(x, _angles(positions, x.shape[-1], theta))


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Sequence[int] = (16, 24, 24),
                theta: float = 10000.0) -> torch.Tensor:
    """x (B, S, H, hd), positions (3, B, S); sections are per-axis *pair*
    counts summing to hd//2 (Qwen2-VL uses (16, 24, 24) for hd=128)."""
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    parts, start = [], 0
    for axis, sec in enumerate(sections):
        parts.append(_angles(positions[axis], hd, theta)[..., start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, -1))


def rope_for(cfg, x, positions):
    """Dispatch on config: M-RoPE if cfg.mrope and 3-row positions given."""
    if getattr(cfg, "mrope", False) and positions.dim() == 3:
        hd = x.shape[-1]
        t = hd // 2 - 2 * (3 * hd // 16)
        return apply_mrope(x, positions, (t, 3 * hd // 16, 3 * hd // 16),
                           cfg.rope_theta)
    if positions.dim() == 3:
        positions = positions[0]
    return apply_rope(x, positions, cfg.rope_theta)
