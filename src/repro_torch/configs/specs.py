"""input_specs: ``(shape, dtype)`` stand-ins for every (arch x shape) cell
(PyTorch port: the twin of ``repro.configs.specs``).

No allocation: a spec is a ``(shape, dtype)`` tuple, and the parameter
counts come from :func:`repro_torch.models.lm.init_params` on the ``meta``
device.  Modality frontends are stubs: VLM cells get precomputed patch
embeddings (+ 3-axis M-RoPE ids), audio cells precomputed frame embeddings.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from .base import ModelConfig, ShapeConfig

__all__ = ["batch_specs", "decode_token_specs", "count_params"]


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Model-input ``(shape, dtype)`` specs for a train/prefill step."""
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    if cfg.family == "vlm":
        specs["embeds"] = ((B, S, cfg.d_model), torch.bfloat16)
        specs["positions"] = ((3, B, S), torch.int32)
    elif cfg.family == "audio":
        specs["audio_embeds"] = ((B, cfg.encoder_seq, cfg.d_model),
                                 torch.bfloat16)
        specs["tokens"] = ((B, S), torch.int32)
    else:
        specs["tokens"] = ((B, S), torch.int32)
    if shape.kind == "train":
        specs["labels"] = ((B, S), torch.int32)
    return specs


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B = shape.global_batch
    if cfg.family == "vlm":
        return {"embeds": ((B, 1, cfg.d_model), torch.bfloat16)}
    return {"tokens": ((B, 1), torch.int32)}


def count_params(cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active) parameter counts, from ``init_params`` on the meta
    device (no allocation).  Active = total minus the (1 - k/E) share of
    the expert weights."""
    from repro_torch import _pytree
    from repro_torch.models import lm
    shapes = lm.init_params(cfg, device="meta")
    total = 0
    expert = 0
    for path, leaf in _pytree.flatten_with_paths(shapes):
        n = math.prod(leaf.shape)
        total += n
        keys = tuple(str(k) for _, k in path)
        if (any(k in ("w_gate", "w_up", "w_down") for k in keys)
                and "ffn" in keys and cfg.n_experts and leaf.dim() >= 3
                and cfg.n_experts in tuple(leaf.shape)):
            expert += n
    active = total - expert + (expert * cfg.top_k // max(cfg.n_experts, 1))
    return total, active
