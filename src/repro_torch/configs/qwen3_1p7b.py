"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
qk_norm, GQA, tied embeddings."""
import dataclasses

from .base import ATTN, LayerSpec, ModelConfig

SKIPS = {"long_500k": "pure full-attention arch (no sub-quadratic path)"}


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-1.7b", family="dense",
        d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=6144, vocab=151936,
        period=(LayerSpec(ATTN),), n_periods=28,
        rope_theta=1_000_000.0, qk_norm=True, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), name="qwen3-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, n_periods=2)
