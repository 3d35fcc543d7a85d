"""phi4-mini-3.8b [dense]: 32L d=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
RoPE + SwiGLU + GQA [arXiv:2412.08905]."""
import dataclasses

from .base import ATTN, LayerSpec, ModelConfig

SKIPS = {"long_500k": "pure full-attention arch (no sub-quadratic path)"}


def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b", family="dense",
        d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=200064,
        period=(LayerSpec(ATTN),), n_periods=32,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), name="phi4-mini-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, n_periods=2)
