"""xlstm-125m [ssm]: 12L d=768 4H hd=192 vocab=50304, d_ff=0 (blocks carry
their own projections).  sLSTM + mLSTM mix (3:1 mLSTM:sLSTM per period)
[arXiv:2405.04517]."""
import dataclasses

from .base import MLSTM, SLSTM, LayerSpec, ModelConfig

SKIPS = {}  # recurrent: long_500k runs (state O(1))


def config() -> ModelConfig:
    period = (LayerSpec(MLSTM, ffn=False), LayerSpec(MLSTM, ffn=False),
              LayerSpec(MLSTM, ffn=False), LayerSpec(SLSTM, ffn=False))
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
        d_ff=0, vocab=50304,
        period=period, n_periods=3,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    period = (LayerSpec(MLSTM, ffn=False), LayerSpec(SLSTM, ffn=False))
    return dataclasses.replace(
        config(), name="xlstm-smoke",
        d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, vocab=256,
        period=period, n_periods=2)
