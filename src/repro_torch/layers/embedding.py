"""Token embedding and LM head.

Under a registered model axis (``cfg.axes.model``, the sharded trainer)
both are vocab-parallel where the vocabulary splits over it
(:func:`vocab_axis`): each rank holds a block of the vocabulary, looks up
only the tokens in it (zeros for the others, reduced over the axis), and
the head returns this rank's block of the logits (B, S, V / size).  A
vocabulary that does not split (whisper's 51865 over 2) is replicated, as
the fitted specs leave it, and every rank computes the whole logits."""
from __future__ import annotations

import torch

from repro_torch import sharding as S

from ._init import Init


def init_embed(init: Init, cfg):
    p = {"embed": init.normal((cfg.vocab, cfg.d_model), 1.0)}
    if not cfg.tie_embeddings:
        p["head"] = init.normal((cfg.d_model, cfg.vocab), cfg.d_model ** -0.5)
    return p


def vocab_axis(cfg):
    """The registered model axis the vocabulary splits over, or None."""
    ax = S.active_axis(cfg.axes.model)
    return ax if ax is not None and cfg.vocab % ax.size == 0 else None


def embed(cfg, p, tokens):
    ax = vocab_axis(cfg)
    if ax is not None:
        w = S.block_of(p["embed"], ax.name, cfg.vocab, 0)
        n = w.shape[0]
        ids = tokens.long() - ax.index * n
        mine = (ids >= 0) & (ids < n)
        x = w[ids.clamp(0, n - 1)].to(cfg.dtype)
        x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
        x = S.reduce_from_axis(x, ax.name)
    else:
        # the rows gathered, then cast: the same bits as the reference's
        # cast of the whole table first, without a vocab x d_model copy
        x = p["embed"][tokens].to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                             device=x.device)
    return x


def lm_head(cfg, p, x):
    w = (p["embed"].T if cfg.tie_embeddings else p["head"]).to(cfg.dtype)
    ax = vocab_axis(cfg)
    if ax is not None:                      # column-parallel over the vocab
        return S.copy_to_axis(x, ax.name) @ S.block_of(w, ax.name,
                                                       cfg.vocab, 1)
    return x @ w
