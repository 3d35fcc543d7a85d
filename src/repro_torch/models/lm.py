"""Stacked decoder LM covering the dense / MoE / hybrid / SSM / VLM /
audio families (PyTorch port: the twin of ``repro.models.lm``).

The depth is ``n_periods`` stacked copies of a heterogeneous ``period``
(tuple of LayerSpec) plus an optional unstacked ``tail``; the parameters and
caches of a period slot are stacked on a leading ``n_periods`` axis, as the
reference's are, and a Python loop walks the copies where the reference
scans.  ``mesh=`` reaches the MoE slots (:func:`repro_torch.layers.moe.
moe_apply`); called in every rank of an SPMD body, the batch is the rank's
block.

Modes:
  forward(...)                       train / prefill logits (+ MoE aux)
  prefill(...)                       logits + filled decode cache
  decode_step(...)                   one token with cache

Entry points that make tensors (:func:`init_params`, :func:`init_cache`,
:func:`params_from_numpy`) put them on the card unless given
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import _pytree
from repro_torch.configs.base import (ATTN, MAMBA, MLSTM, SLSTM, LayerSpec,
                                      ModelConfig)
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers import mamba as M
from repro_torch.layers import mlp as F
from repro_torch.layers import moe as MOE
from repro_torch.layers import xlstm as X
from repro_torch.layers._init import Init
from repro_torch.layers.norms import init_rms, rms_norm
from repro_torch.layers.rope import rope_for

__all__ = ["init_params", "forward", "prefill", "decode_step", "init_cache",
           "params_from_numpy", "period_slice"]

def _device(device):
    return torch.device("cuda" if device is None else device)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_slot(init: Init, cfg: ModelConfig, spec: LayerSpec):
    p: Dict[str, Any] = {"norm_mix": init_rms(init, cfg.d_model)}
    if spec.kind == ATTN:
        p["attn"] = A.init_attn(init, cfg)
        if cfg.encoder_layers:          # decoder w/ cross-attention (whisper)
            p["norm_cross"] = init_rms(init, cfg.d_model)
            p["cross"] = A.init_attn(init, cfg, cross=True)
    elif spec.kind == MAMBA:
        p["mamba"] = M.init_mamba(init, cfg)
    elif spec.kind == MLSTM:
        p["mlstm"] = X.init_mlstm(init, cfg)
    elif spec.kind == SLSTM:
        p["slstm"] = X.init_slstm(init, cfg)
    if spec.ffn:
        p["norm_ffn"] = init_rms(init, cfg.d_model)
        if spec.moe:
            p["ffn"] = MOE.init_moe(init, cfg)
        elif cfg.ffn_kind == "gelu":
            p["ffn"] = F.init_gelu_mlp(init, cfg.d_model, cfg.d_ff)
        else:
            p["ffn"] = F.init_swiglu(init, cfg.d_model, cfg.d_ff)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None):
    """The port's own seeded initializer: the reference's tree, shapes,
    dtypes (f32 masters) and standard deviations, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card unless
    given ``"cpu"``).  The values are not JAX's."""
    cfg.validate()
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    init = Init(gen, dev)
    params: Dict[str, Any] = {"embed": E.init_embed(init, cfg)}
    params["blocks"] = tuple(_init_slot(init.stacked(cfg.n_periods), cfg, spec)
                             for spec in cfg.period)
    params["tail"] = tuple(_init_slot(init, cfg, spec) for spec in cfg.tail)
    params["norm_final"] = init_rms(init, cfg.d_model)
    if cfg.encoder_layers:
        enc_cfg = dataclasses.replace(cfg, encoder_layers=0)  # no cross
        params["encoder"] = _init_slot(init.stacked(cfg.encoder_layers),
                                       enc_cfg, LayerSpec(ATTN))
        params["enc_norm"] = init_rms(init, cfg.d_model)
    return params


# ---------------------------------------------------------------------------
# the reference's trees, through numpy
# ---------------------------------------------------------------------------
def _leaf_from_numpy(a, device):
    if isinstance(a, (int, float, bool, np.generic)):
        a = np.asarray(a)
    if not isinstance(a, np.ndarray):
        return a
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = a.copy(order="C")           # torch takes only writable arrays
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        # bf16 crosses as its bits (a uint16 view, or ml_dtypes' bfloat16)
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device=None):
    """The reference's parameter (or ``init_cache``) tree, its leaves numpy
    arrays, as the port's tree on ``device`` (the card unless given
    ``"cpu"``): same keys and nesting, tensors stacked over ``n_periods``
    stay stacked.  bf16 crosses as a ``uint16`` view (or ml_dtypes'
    bfloat16); a 0-d ``pos`` counter stays on the CPU, where the port keeps
    it."""
    dev = _device(device)
    out = _pytree.tree_map_with_path(
        lambda path, a: _leaf_from_numpy(a, dev), tree)
    if isinstance(out, dict) and isinstance(out.get("pos"), torch.Tensor) \
            and out["pos"].dim() == 0:
        out["pos"] = out["pos"].cpu()
    return out


def period_slice(tree, i: int):
    """Period ``i`` of a tree stacked over ``n_periods``."""
    return _pytree.tree_map_with_path(lambda path, a: a[i], tree)


def _stack(trees):
    """The inverse of :func:`period_slice` over every period's tree."""
    flat = [_pytree.leaves(t) for t in trees]
    return _pytree.unflatten(trees[0], [torch.stack(ls) for ls in zip(*flat)])


# ---------------------------------------------------------------------------
# one sublayer slot
# ---------------------------------------------------------------------------
def _constrain_slot_params(cfg, tree):
    """The identity with no mesh axis set; with one, the reference pins each
    weight's sharding (the identity here) and casts matrices to the compute
    dtype inside the layer loop."""
    if cfg.axes.model is None and not cfg.axes.batch:
        return tree

    def cast(path, w):
        return (w.to(cfg.dtype) if w.dim() >= 2 and w.is_floating_point()
                else w)
    return _pytree.tree_map_with_path(cast, tree)


def _ffn(cfg, spec, p, x, mesh):
    """The FFN sublayer: ``(x + ffn(norm(x)), aux)``."""
    h = rms_norm(x, p["norm_ffn"]["scale"], cfg.norm_eps)
    if spec.moe:
        out, aux = MOE.moe_apply(cfg, p["ffn"], h, mesh=mesh)
        return x + out, aux
    if cfg.ffn_kind == "gelu":
        return x + F.gelu_mlp(cfg, p["ffn"], h), _zero_aux(x)
    return x + F.swiglu(cfg, p["ffn"], h), _zero_aux(x)


def _apply_slot(cfg, spec: LayerSpec, p, x, positions, *, cache=None,
                cache_pos=None, enc_out=None, cross_cache=None, mesh=None,
                causal=True):
    """One slot: ``(x, new_cache, aux)``."""
    aux = _zero_aux(x)
    new_cache = {}
    h = rms_norm(x, p["norm_mix"]["scale"], cfg.norm_eps)
    if spec.kind == ATTN:
        kv_cache = None if cache is None else {"k": cache["k"], "v": cache["v"]}
        out, kv_cache = A.attn_apply(cfg, p["attn"], h, positions,
                                     causal=causal, window=spec.window,
                                     cache=kv_cache, cache_pos=cache_pos)
        if kv_cache is not None:
            new_cache.update(kv_cache)
        x = x + out
        if enc_out is not None or cross_cache is not None:
            hc = rms_norm(x, p["norm_cross"]["scale"], cfg.norm_eps)
            out, _ = A.attn_apply(cfg, p["cross"], hc, positions,
                                  causal=False, kv_x=enc_out,
                                  cache=cross_cache, apply_rope=False,
                                  cross=True)
            x = x + out
    else:
        apply = {MAMBA: lambda: M.mamba_apply(cfg, p["mamba"], h, cache=cache),
                 MLSTM: lambda: X.mlstm_apply(cfg, p["mlstm"], h, cache=cache),
                 SLSTM: lambda: X.slstm_apply(cfg, p["slstm"], h, cache=cache)}
        out, mc = apply[spec.kind]()
        if mc is not None:
            new_cache.update(mc)
        x = x + out
    if spec.ffn:
        x, aux = _ffn(cfg, spec, p, x, mesh)
    return x, new_cache, aux


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------
def _slot_cache(cfg, spec: LayerSpec, B, max_len, dtype, lead, dev):
    z = lambda shape, dt=dtype: torch.zeros(lead + shape, dtype=dt,  # noqa: E731
                                            device=dev)
    if spec.kind == ATTN:
        smax = min(spec.window, max_len) if spec.window else max_len
        KV, hd = cfg.n_kv_heads, cfg.head_dim
        if cfg.xdma_cache:
            # XDMA layout-optimal: K stored transposed, V dot-contiguous
            return {"k": z((B, KV, hd, smax)), "v": z((B, KV, smax, hd))}
        return {"k": z((B, smax, KV, hd)), "v": z((B, smax, KV, hd))}
    f32 = torch.float32
    if spec.kind == MAMBA:
        di, N, Hm = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        return {"conv": z((B, M.CONV_K - 1, di)),
                "h": z((B, Hm, di // Hm, N), f32)}
    H, hd = cfg.n_heads, cfg.head_dim
    if spec.kind == MLSTM:
        return {"mlstm": (z((B, H, hd, hd), f32), z((B, H, hd), f32),
                          torch.full(lead + (B, H), -1e30, dtype=f32,
                                     device=dev))}
    if spec.kind == SLSTM:
        shape = (B, H * hd)
        return {"slstm": (z(shape, f32), z(shape, f32), z(shape, f32),
                          torch.full(lead + shape, -1e30, dtype=f32,
                                     device=dev))}
    raise ValueError(spec.kind)


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               dtype=torch.bfloat16, *, device=None):
    """The decode cache, on ``device`` (the card unless given ``"cpu"``):
    the reference's tree, period slots stacked over ``n_periods``.  ``pos``
    is a 0-d int32 tensor on the CPU (host-side control state; a ragged
    batch's (B,) positions live on the card)."""
    dev = _device(device)
    lead = (cfg.n_periods,)
    cache = {
        "blocks": tuple(_slot_cache(cfg, s, B, max_len, dtype, lead, dev)
                        for s in cfg.period),
        "tail": tuple(_slot_cache(cfg, s, B, max_len, dtype, (), dev)
                      for s in cfg.tail),
        "pos": torch.zeros((), dtype=torch.int32),
    }
    if cfg.encoder_layers:
        kv = (cfg.n_periods, B, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        cache["cross"] = {
            "k": torch.zeros(kv, dtype=dtype, device=dev),
            "v": torch.zeros(kv, dtype=dtype, device=dev),
            "len": torch.full((cfg.n_periods,), cfg.encoder_seq,
                              dtype=torch.int32, device=dev),
        }
    return cache


# ---------------------------------------------------------------------------
# encoder (whisper)
# ---------------------------------------------------------------------------
def _encode(cfg, params, audio_embeds):
    enc_cfg = dataclasses.replace(cfg, encoder_layers=0)
    spec = LayerSpec(ATTN)
    x = audio_embeds.to(cfg.dtype)
    pos = torch.arange(x.shape[1], device=x.device)[None].expand(x.shape[:2])
    for i in range(cfg.encoder_layers):
        p = _constrain_slot_params(enc_cfg, period_slice(params["encoder"], i))
        x, _, _ = _apply_slot(enc_cfg, spec, p, x, pos, causal=False)
    return rms_norm(x, params["enc_norm"]["scale"], cfg.norm_eps)


def _inputs(cfg, params, batch):
    if "embeds" in batch:
        x = batch["embeds"].to(cfg.dtype)
        B, S = x.shape[:2]
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = E.embed(cfg, params["embed"], tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = _encode(cfg, params, batch["audio_embeds"])
    return x, positions, enc_out


# ---------------------------------------------------------------------------
# forward (train / prefill without cache)
# ---------------------------------------------------------------------------
def forward(cfg: ModelConfig, params, batch, *, mesh=None):
    """batch: {tokens (B,S)} or {embeds}, optional {positions}, optional
    {audio_embeds} for enc-dec.  Returns (logits, aux): aux sums the MoE
    slots' load-balance losses."""
    x, positions, enc_out = _inputs(cfg, params, batch)
    aux_total = _zero_aux(x)
    for i in range(cfg.n_periods):
        slot_params = _constrain_slot_params(
            cfg, period_slice(params["blocks"], i))
        for spec, p in zip(cfg.period, slot_params):
            x, _, a = _apply_slot(cfg, spec, p, x, positions,
                                  enc_out=enc_out, mesh=mesh)
            aux_total = aux_total + a
    for spec, p in zip(cfg.tail, params["tail"]):
        x, _, a = _apply_slot(cfg, spec, p, x, positions, enc_out=enc_out,
                              mesh=mesh)
        aux_total = aux_total + a
    x = rms_norm(x, params["norm_final"]["scale"], cfg.norm_eps)
    return E.lm_head(cfg, params["embed"], x), aux_total


# ---------------------------------------------------------------------------
# prefill (fills cache) and decode
# ---------------------------------------------------------------------------
def _write_kv_cache(cfg, attn_p, x_normed, positions, slot_cache):
    """Project K/V from the normed input and write them into the cache
    (rolled for sliding-window layers; transposed under ``xdma_cache``)."""
    B, S, _ = x_normed.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    dt, xd = slot_cache["k"].dtype, x_normed.dtype

    def proj(w, b):
        y = x_normed @ attn_p[w].to(xd)
        return (y + attn_p[b].to(xd) if b in attn_p else y).reshape(B, S, KV,
                                                                     hd)
    k, v = proj("wk", "bk"), proj("wv", "bv")
    if cfg.qk_norm:
        k = rms_norm(k, attn_p["k_norm"])
    k = rope_for(cfg, k, positions)
    smax = slot_cache["k"].shape[3] if cfg.xdma_cache else slot_cache["k"].shape[1]
    if S >= smax:
        shift = S % smax
        kk = torch.roll(k[:, S - smax:], shift, dims=1)
        vv = torch.roll(v[:, S - smax:], shift, dims=1)
        if cfg.xdma_cache:
            # relayout fused into the store (paper: transform-on-transfer)
            return dict(slot_cache,
                        k=kk.permute(0, 2, 3, 1).to(dt).contiguous(),
                        v=vv.permute(0, 2, 1, 3).to(dt).contiguous())
        return dict(slot_cache, k=kk.to(dt), v=vv.to(dt))
    ck, cv = slot_cache["k"].clone(), slot_cache["v"].clone()
    if cfg.xdma_cache:
        ck[:, :, :, :S] = k.permute(0, 2, 3, 1).to(dt)      # (B,KV,hd,S)
        cv[:, :, :S, :] = v.permute(0, 2, 1, 3).to(dt)      # (B,KV,S,hd)
    else:
        ck[:, :S] = k.to(dt)
        cv[:, :S] = v.to(dt)
    return dict(slot_cache, k=ck, v=cv)


def _prefill_slot(cfg, spec, p, x, positions, slot_cache, *, enc_out=None,
                  mesh=None):
    """Apply one slot in prefill mode, producing both output and cache."""
    h = rms_norm(x, p["norm_mix"]["scale"], cfg.norm_eps)
    if spec.kind == ATTN:
        out, _ = A.attn_apply(cfg, p["attn"], h, positions, causal=True,
                              window=spec.window)
        new_cache = _write_kv_cache(cfg, p["attn"], h, positions, slot_cache)
        x = x + out
        if enc_out is not None:
            hc = rms_norm(x, p["norm_cross"]["scale"], cfg.norm_eps)
            out, _ = A.attn_apply(cfg, p["cross"], hc, positions,
                                  causal=False, kv_x=enc_out, apply_rope=False)
            x = x + out
    else:
        apply = {MAMBA: M.mamba_apply, MLSTM: X.mlstm_apply,
                 SLSTM: X.slstm_apply}[spec.kind]
        name = {MAMBA: "mamba", MLSTM: "mlstm", SLSTM: "slstm"}[spec.kind]
        out, new_cache = apply(cfg, p[name], h, cache=slot_cache)
        x = x + out
    if spec.ffn:
        x, _ = _ffn(cfg, spec, p, x, mesh)
    return x, new_cache


def prefill(cfg: ModelConfig, params, batch, cache, *, mesh=None):
    """Run the prompt through the model, writing KV/state caches.

    Returns (logits_last (B,1,V), cache)."""
    x, positions, enc_out = _inputs(cfg, params, batch)
    B = x.shape[0]
    cache = dict(cache)
    if cfg.encoder_layers:
        # cross K/V of every decoder period, from the first slot's weights
        cross = params["blocks"][0]["cross"]
        dt = cfg.dtype
        k = torch.stack([(enc_out @ cross["wk"][i].to(dt)).reshape(
            B, -1, cfg.n_kv_heads, cfg.head_dim) for i in range(cfg.n_periods)])
        v = torch.stack([(enc_out @ cross["wv"][i].to(dt)).reshape(
            B, -1, cfg.n_kv_heads, cfg.head_dim) for i in range(cfg.n_periods)])
        cache["cross"] = {"k": k.to(dt), "v": v.to(dt),
                          "len": cache["cross"]["len"]}
    per_period = []
    for i in range(cfg.n_periods):
        slot_params = _constrain_slot_params(
            cfg, period_slice(params["blocks"], i))
        slot_caches = period_slice(cache["blocks"], i)
        new = []
        for spec, p, c in zip(cfg.period, slot_params, slot_caches):
            x, nc = _prefill_slot(cfg, spec, p, x, positions, c,
                                  enc_out=enc_out, mesh=mesh)
            new.append(nc)
        per_period.append(tuple(new))
    new_tail = []
    for spec, p, c in zip(cfg.tail, params["tail"], cache["tail"]):
        x, nc = _prefill_slot(cfg, spec, p, x, positions, c, enc_out=enc_out,
                              mesh=mesh)
        new_tail.append(nc)
    x = rms_norm(x, params["norm_final"]["scale"], cfg.norm_eps)
    logits = E.lm_head(cfg, params["embed"], x[:, -1:])
    cache.update(blocks=_stack(per_period), tail=tuple(new_tail),
                 pos=torch.tensor(x.shape[1], dtype=torch.int32))
    return logits, cache


def decode_step(cfg: ModelConfig, params, tokens, cache, *, mesh=None):
    """One decode step.  tokens (B,1) (or embeds (B,1,d)); returns
    (logits (B,1,V), new cache).  The cache passed in is not modified."""
    pos = cache["pos"]
    if tokens.dim() == 3:
        x = tokens.to(cfg.dtype)
    else:
        x = E.embed(cfg, params["embed"], tokens)
    B = x.shape[0]
    if pos.dim() >= 1:
        # ragged batch: per-request positions, shape (B,) -> (B, 1)
        positions = pos.to(torch.int32)[:, None].to(x.device)
        cache_pos = pos.to(x.device)
    else:
        cache_pos = int(pos)
        positions = torch.full((B, 1), cache_pos, dtype=torch.int32,
                               device=x.device)
    cross = cache.get("cross")
    per_period = []
    for i in range(cfg.n_periods):
        slot_params = _constrain_slot_params(
            cfg, period_slice(params["blocks"], i))
        slot_caches = period_slice(cache["blocks"], i)
        cross_i = None if cross is None else period_slice(cross, i)
        new = []
        for spec, p, c in zip(cfg.period, slot_params, slot_caches):
            x, nc, _ = _apply_slot(cfg, spec, p, x, positions, cache=c,
                                   cache_pos=cache_pos, cross_cache=cross_i,
                                   mesh=mesh)
            new.append(dict(c, **nc))
        per_period.append(tuple(new))
    new_tail = []
    for spec, p, c in zip(cfg.tail, params["tail"], cache["tail"]):
        x, nc, _ = _apply_slot(cfg, spec, p, x, positions, cache=c,
                               cache_pos=cache_pos, mesh=mesh)
        new_tail.append(dict(c, **nc))
    x = rms_norm(x, params["norm_final"]["scale"], cfg.norm_eps)
    logits = E.lm_head(cfg, params["embed"], x)
    new_cache = dict(cache, blocks=_stack(per_period), tail=tuple(new_tail),
                     pos=pos + 1)
    return logits, new_cache
