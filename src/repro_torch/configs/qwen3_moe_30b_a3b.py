"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) d_ff_expert=768
vocab=151936, MoE 128 experts top-8, qk_norm [hf:Qwen/Qwen3-30B-A3B]."""
import dataclasses

from .base import ATTN, LayerSpec, ModelConfig

SKIPS = {"long_500k": "pure full-attention arch (no sub-quadratic path)"}


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe",
        d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=768, vocab=151936,
        period=(LayerSpec(ATTN, moe=True),), n_periods=48,
        n_experts=128, top_k=8, d_ff_expert=768,
        rope_theta=1_000_000.0, qk_norm=True,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), name="qwen3-moe-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab=256,
        period=(LayerSpec(ATTN, moe=True),), n_periods=2,
        n_experts=8, top_k=2, d_ff_expert=32)
