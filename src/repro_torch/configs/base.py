"""Model configuration schema + the layer-period block description (PyTorch
port: the twin of ``repro.configs.base``, dtypes as torch dtypes).

Every assigned architecture is expressed as a :class:`ModelConfig` whose
``period`` (a tuple of :class:`LayerSpec`) describes one repeating block of
layers; the model loops over ``n_periods`` stacked copies plus an optional
unstacked ``tail`` (e.g. gemma3's 62 = 6*10 + 2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.sharding import Axes

# layer kinds
ATTN = "attn"       # (optionally windowed) self-attention
MAMBA = "mamba"
MLSTM = "mlstm"
SLSTM = "slstm"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = ATTN
    window: Optional[int] = None    # sliding-window size (attn only)
    moe: bool = False               # MoE FFN instead of dense
    ffn: bool = True                # has an FFN sublayer at all

    def cache_kind(self) -> str:
        return {ATTN: "kv", MAMBA: "ssm", MLSTM: "mlstm", SLSTM: "slstm"}[self.kind]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    period: Tuple[LayerSpec, ...]
    n_periods: int
    tail: Tuple[LayerSpec, ...] = ()

    # attention details
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    mrope: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_wire_int8: bool = False

    # SSM (mamba)
    ssm_d_inner: int = 0
    ssm_state: int = 16
    ssm_heads: int = 0

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0            # frames from the (stubbed) conv frontend

    # vlm
    vision_seq: int = 0             # patch embeddings from the stubbed frontend

    # embedding / misc
    ffn_kind: str = "swiglu"        # swiglu | gelu (whisper)
    tie_embeddings: bool = False
    embed_scale: bool = False
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    axes: Axes = Axes(batch=(), model=None)
    remat: str = "block"            # none | block — activation checkpoint policy
    fsdp: bool = False              # params sharded over DP (train); grads follow
    xdma_cache: bool = False        # XDMA layout-optimal KV cache: K stored as
                                    # K^T (B,KV,hd,S), V as (B,KV,S,hd) — the
                                    # paper's relayout-on-store applied to serving

    # -- derived ------------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return len(self.period) * self.n_periods + len(self.tail)

    def with_axes(self, axes: Axes) -> "ModelConfig":
        return dataclasses.replace(self, axes=axes)

    def validate(self) -> None:
        assert self.n_heads % self.n_kv_heads == 0, (self.n_heads, self.n_kv_heads)
        if any(l.moe for l in self.period + self.tail):
            assert self.n_experts > 0 and self.top_k > 0 and self.d_ff_expert > 0
        if any(l.kind == MAMBA for l in self.period + self.tail):
            assert self.ssm_d_inner > 0 and self.ssm_heads > 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets lowered in the dry-run."""

    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode
    microbatches: int = 1           # gradient-accumulation steps (train only)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train", microbatches=8),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
