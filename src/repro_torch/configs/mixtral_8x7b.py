"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention (4096) [arXiv:2401.04088]."""
import dataclasses

from .base import ATTN, LayerSpec, ModelConfig

SKIPS = {}  # SWA caps the KV cache -> long_500k runs


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b", family="moe",
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=32000,
        period=(LayerSpec(ATTN, window=4096, moe=True),), n_periods=32,
        n_experts=8, top_k=2, d_ff_expert=14336,
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), name="mixtral-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        period=(LayerSpec(ATTN, window=8, moe=True),), n_periods=2,
        n_experts=4, top_k=2, d_ff_expert=64)
