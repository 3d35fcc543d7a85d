"""Architecture registry: ``get_config(arch)``, ``smoke_config(arch)``.  One
module per assigned architecture (PyTorch port: the twin of
``repro.configs``; the arch modules are the reference's data)."""
from __future__ import annotations

import importlib
from typing import Dict

from .base import ModelConfig, ShapeConfig, SHAPES, LayerSpec, ATTN, MAMBA, MLSTM, SLSTM

ARCHS = (
    "phi4_mini_3p8b",
    "gemma3_27b",
    "qwen3_1p7b",
    "qwen2_0p5b",
    "jamba_1p5_large_398b",
    "mixtral_8x7b",
    "qwen3_moe_30b_a3b",
    "xlstm_125m",
    "qwen2_vl_7b",
    "whisper_small",
)

_ALIASES = {
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "gemma3-27b": "gemma3_27b",
    "qwen3-1.7b": "qwen3_1p7b",
    "qwen2-0.5b": "qwen2_0p5b",
    "jamba-1.5-large-398b": "jamba_1p5_large_398b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "xlstm-125m": "xlstm_125m",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "whisper-small": "whisper_small",
}


def _module(arch: str):
    name = _ALIASES.get(arch, arch)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def shape_skips(arch: str) -> Dict[str, str]:
    """shape name -> reason, for cells documented as skipped (DESIGN.md §4)."""
    return getattr(_module(arch), "SKIPS", {})
