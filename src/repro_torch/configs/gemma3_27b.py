"""gemma3-27b [dense]: 62L d=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
5:1 local:global attention (window 1024), qk-norm, tied embeddings, 128k ctx.
62 = 6*10 + 2 -> period of 6 scanned 10x, tail of 2 local layers."""
import dataclasses

from .base import ATTN, LayerSpec, ModelConfig

WINDOW = 1024
SKIPS = {}  # long_500k runs: 5/6 of layers are windowed; decode is O(cache)


def config() -> ModelConfig:
    local = LayerSpec(ATTN, window=WINDOW)
    return ModelConfig(
        name="gemma3-27b", family="dense",
        d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=21504, vocab=262144,
        period=(local, local, local, local, local, LayerSpec(ATTN)),
        n_periods=10, tail=(local, local),
        rope_theta=1_000_000.0, qk_norm=True,
        tie_embeddings=True, embed_scale=True,
    )


def smoke() -> ModelConfig:
    local = LayerSpec(ATTN, window=8)
    return dataclasses.replace(
        config(), name="gemma3-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        period=(local, LayerSpec(ATTN)), n_periods=2, tail=(local,))
