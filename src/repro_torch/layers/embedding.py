"""Token embedding and LM head."""
from __future__ import annotations

import torch

from ._init import Init


def init_embed(init: Init, cfg):
    p = {"embed": init.normal((cfg.vocab, cfg.d_model), 1.0)}
    if not cfg.tie_embeddings:
        p["head"] = init.normal((cfg.d_model, cfg.vocab), cfg.d_model ** -0.5)
    return p


def embed(cfg, p, tokens):
    # the rows gathered, then cast: the same bits as the reference's cast of
    # the whole table first, without a vocab x d_model copy
    x = p["embed"][tokens].to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                             device=x.device)
    return x


def lm_head(cfg, p, x):
    w = (p["embed"].T if cfg.tie_embeddings else p["head"]).to(cfg.dtype)
    return x @ w
