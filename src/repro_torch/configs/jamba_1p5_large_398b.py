"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba:attention 7:1 interleave [arXiv:2403.19887].
Period of 8 = [attn, (mamba, mamba-MoE) x ...] scanned 9x; MoE on alternating
layers (4 of 8)."""
import dataclasses

from .base import ATTN, MAMBA, LayerSpec, ModelConfig

SKIPS = {}  # hybrid SSM: long_500k runs (state is O(1); attn is 1-in-8)


def config() -> ModelConfig:
    period = (
        LayerSpec(ATTN),
        LayerSpec(MAMBA, moe=True),
        LayerSpec(MAMBA),
        LayerSpec(MAMBA, moe=True),
        LayerSpec(MAMBA),
        LayerSpec(MAMBA, moe=True),
        LayerSpec(MAMBA),
        LayerSpec(MAMBA, moe=True),
    )
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab=65536,
        period=period, n_periods=9,
        n_experts=16, top_k=2, d_ff_expert=24576,
        ssm_d_inner=16384, ssm_state=16, ssm_heads=128,
        rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    period = (LayerSpec(ATTN), LayerSpec(MAMBA, moe=True), LayerSpec(MAMBA))
    return dataclasses.replace(
        config(), name="jamba-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        period=period, n_periods=2,
        n_experts=4, top_k=2, d_ff_expert=64,
        ssm_d_inner=128, ssm_state=8, ssm_heads=4)
