"""whisper-small [audio]: enc-dec, 12L each, d=768 12H (kv=12) d_ff=3072
vocab=51865 [arXiv:2212.04356].  Backbone only: the conv frontend is a stub —
input_specs provides precomputed frame embeddings (1500 frames).  GeLU FFN;
RoPE replaces learned absolute positions (DESIGN.md hardware-adaptation note)."""
import dataclasses

from .base import ATTN, LayerSpec, ModelConfig

SKIPS = {"long_500k": "full-attention enc-dec; 512k decoder context out of family"}

ENCODER_SEQ = 1500


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="audio",
        d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab=51865,
        period=(LayerSpec(ATTN),), n_periods=12,
        encoder_layers=12, encoder_seq=ENCODER_SEQ,
        ffn_kind="gelu", norm_eps=1e-5,
    )


def smoke() -> ModelConfig:
    return dataclasses.replace(
        config(), name="whisper-smoke",
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
        n_periods=2, encoder_layers=2, encoder_seq=16)
