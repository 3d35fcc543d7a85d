"""qwen2-0.5b [dense]: 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
GQA with QKV bias, tied embeddings [arXiv:2407.10671]."""
import dataclasses

from .base import ATTN, LayerSpec, ModelConfig

SKIPS = {"long_500k": "pure full-attention arch (no sub-quadratic path)"}


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab=151936,
        period=(LayerSpec(ATTN),), n_periods=24,
        rope_theta=1_000_000.0, qkv_bias=True, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), name="qwen2-smoke",
        d_model=56, n_heads=7, n_kv_heads=1, head_dim=8,
        d_ff=112, vocab=256, n_periods=2)
