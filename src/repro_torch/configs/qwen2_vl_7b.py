"""qwen2-vl-7b [vlm]: 28L d=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
M-RoPE, dynamic resolution [arXiv:2409.12191].  Backbone only: the vision
frontend is a stub — input_specs provides precomputed patch embeddings merged
into the sequence plus 3-axis (t,h,w) position ids."""
import dataclasses

from .base import ATTN, LayerSpec, ModelConfig

SKIPS = {"long_500k": "pure full-attention arch (no sub-quadratic path)"}


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
        d_ff=18944, vocab=152064,
        period=(LayerSpec(ATTN),), n_periods=28,
        rope_theta=1_000_000.0, qkv_bias=True, mrope=True,
        vision_seq=1024,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), name="qwen2-vl-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, n_periods=2, vision_seq=8)
