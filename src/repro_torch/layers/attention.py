"""GQA attention: flash-chunked train/prefill, cached decode, cross-attention.

The twin of ``repro.layers.attention``, in plain torch (the reference's
layers run ``chunked_attention``, not the flash kernel): scores never
materialize beyond (q_chunk x kv_chunk) tiles, with an f32 running max and
denominator; bf16 dots take f32 inputs and accumulate in f32 (the
reference's ``preferred_element_type``).

Under a registered model axis (``cfg.axes.model``, the sharded trainer)
the training sublayer, self- or cross-attention, runs tensor-parallel in
the reference's three regimes, picked
as its ``attn_apply`` picks them: head-parallel when the query and KV heads
both divide the axis; the KV heads repeated to the query heads when only
the query heads do; otherwise sequence-parallel, each rank a block of query
rows over the whole K / V on the dense schedule.  With no axis registered
the schedule is the block-sparse one, as the reference's without a mesh.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch import sharding as SH

from .norms import rms_norm
from .rope import rope_for
from ._init import Init

NEG_INF = -1e30
_F32 = torch.float32


def init_attn(init: Init, cfg, *, cross: bool = False):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init.normal((d, H * hd), d ** -0.5),
        "wk": init.normal((d, KV * hd), d ** -0.5),
        "wv": init.normal((d, KV * hd), d ** -0.5),
        "wo": init.normal((H * hd, d), (H * hd) ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = init.zeros((H * hd,))
        p["bk"] = init.zeros((KV * hd,))
        p["bv"] = init.zeros((KV * hd,))
    if cfg.qk_norm:
        p["q_norm"] = init.ones((hd,))
        p["k_norm"] = init.ones((hd,))
    return p


def _chunk_of(n: int, want: int) -> int:
    c = max(1, min(want, n))
    while n % c:
        c -= 1
    return c


def _chunk_pairs(nq, nk, qc, kc, q_offset, Sk, causal, window
                 ) -> List[Tuple[int, int]]:
    """Static block-sparse schedule: (qi, kj) chunk pairs intersecting the
    attention mask band; fully-masked pairs are never emitted."""
    pairs = []
    for qi in range(nq):
        q_lo = q_offset + qi * qc
        q_hi = q_lo + qc - 1
        for kj in range(nk):
            k_lo, k_hi = kj * kc, kj * kc + kc - 1
            if causal and k_lo > q_hi:
                continue                      # entirely in the future
            if window is not None and k_hi <= q_lo - window:
                continue                      # entirely beyond the window
            pairs.append((qi, kj))
    return pairs


def _blocks(q, k, v, q_chunk, kv_chunk):
    """q -> (nq, B, KV, G, qc, hd) scaled by hd^-0.5 in f32 and rounded back;
    k, v -> (nk, B, KV, kc, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qc, kc = _chunk_of(Sq, q_chunk), _chunk_of(Sk, kv_chunk)
    nq, nk = Sq // qc, Sk // kc
    qt = (q.to(_F32) * hd ** -0.5).to(q.dtype)
    qt = qt.reshape(B, nq, qc, KV, G, hd).permute(1, 0, 3, 4, 2, 5)
    kt = k.reshape(B, nk, kc, KV, hd).permute(1, 0, 3, 2, 4)
    vt = v.reshape(B, nk, kc, KV, hd).permute(1, 0, 3, 2, 4)
    return qt, kt, vt, (B, Sq, H, hd, KV, G, qc, kc, nq, nk)


def _pair_update(m, l, acc, qb, kb, vb, qp, kp, causal, window):
    """One (q-chunk, kv-chunk) step of the online softmax."""
    s = torch.einsum("bkgqh,bkch->bkgqc", qb.to(_F32), kb.to(_F32))
    if causal or window is not None:
        bias = torch.zeros((qp.numel(), kp.numel()), dtype=_F32,
                           device=s.device)
        if causal:
            bias = torch.where(kp[None, :] <= qp[:, None], bias, NEG_INF)
        if window is not None:
            bias = torch.where(kp[None, :] > qp[:, None] - window, bias,
                               NEG_INF)
        s = s + bias
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bkgqc,bkch->bkgqh", p.to(vb.dtype).to(_F32), vb.to(_F32))
    return m_new, l, acc


def _finish(acc, l, B, Sq, H, hd, dtype):
    out = acc / torch.clamp(l, min=1e-30)[..., None]   # (nq,B,KV,G,qc,hd)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, hd).to(dtype)


def chunked_attention_dense(q, k, v, *, causal=True, window=None,
                            q_offset=0, q_chunk=1024, kv_chunk=1024):
    """Flash attention, dense schedule (every q-chunk scans every
    kv-chunk): the reference's schedule when q is sequence-sharded."""
    qt, kt, vt, (B, Sq, H, hd, KV, G, qc, kc, nq, nk) = _blocks(
        q, k, v, q_chunk, kv_chunk)
    dev = q.device
    outs = []
    for qi in range(nq):
        qp = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((B, KV, G, qc), NEG_INF, dtype=_F32, device=dev)
        l = torch.zeros((B, KV, G, qc), dtype=_F32, device=dev)
        acc = torch.zeros((B, KV, G, qc, hd), dtype=_F32, device=dev)
        for kj in range(nk):
            kp = kj * kc + torch.arange(kc, device=dev)
            m, l, acc = _pair_update(m, l, acc, qt[qi], kt[kj], vt[kj], qp,
                                     kp, causal, window)
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H, hd).to(q.dtype)


def chunked_attention(q, k, v, *, causal=True, window=None,
                      q_offset=0, q_chunk=1024, kv_chunk=1024):
    """Flash-style attention with block-sparse pair scheduling.

    q (B,Sq,H,hd); k,v (B,Sk,KV,hd); f32 running max/denominator, one pass
    over the valid (q-chunk, kv-chunk) pairs in the reference's order."""
    qt, kt, vt, (B, Sq, H, hd, KV, G, qc, kc, nq, nk) = _blocks(
        q, k, v, q_chunk, kv_chunk)
    dev = q.device
    # each q-chunk's running state in a list, stacked once at the end: an
    # in-place write into a stacked buffer would overwrite what autograd
    # saved for the backward
    m = [torch.full((B, KV, G, qc), NEG_INF, dtype=_F32, device=dev)
         for _ in range(nq)]
    l = [torch.zeros((B, KV, G, qc), dtype=_F32, device=dev)
         for _ in range(nq)]
    acc = [torch.zeros((B, KV, G, qc, hd), dtype=_F32, device=dev)
           for _ in range(nq)]
    for qi, kj in _chunk_pairs(nq, nk, qc, kc, q_offset, k.shape[1], causal,
                               window):
        qp = q_offset + qi * qc + torch.arange(qc, device=dev)
        kp = kj * kc + torch.arange(kc, device=dev)
        m[qi], l[qi], acc[qi] = _pair_update(m[qi], l[qi], acc[qi], qt[qi],
                                             kt[kj], vt[kj], qp, kp, causal,
                                             window)
    return _finish(torch.stack(acc), torch.stack(l), B, Sq, H, hd, q.dtype)


def _mask_valid(s, length, Smax):
    """Mask scores (B,KV,G,Smax) beyond the valid cache prefix.  ``length``
    is a scalar (uniform batch) or a (B,) vector of per-request lengths
    (continuous batching, where ragged requests share one decode step)."""
    pos = torch.arange(Smax, device=s.device)
    if isinstance(length, torch.Tensor):
        # compared on the device: no read of the length on the host
        lv = torch.clamp(length.to(s.device), max=Smax)
        if lv.dim():
            valid = pos[None] < lv[:, None]                   # (B, Smax)
            return torch.where(valid[:, None, None, :], s, NEG_INF)
        return torch.where((pos < lv)[None, None, None], s, NEG_INF)
    valid = pos < min(int(length), Smax)
    return torch.where(valid[None, None, None], s, NEG_INF)


def decode_attention(q, k_cache, v_cache, length, *, rolling=False):
    """q (B,1,H,hd); caches (B,Smax,KV,hd); length = #valid tokens.

    ``rolling=True`` marks a circular window cache: once full, every slot is
    valid (slot order is irrelevant because K carries RoPE already)."""
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qh = q[:, 0].reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qh.to(_F32),
                     k_cache.to(_F32)) * hd ** -0.5
    s = _mask_valid(s, length, Smax)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).to(_F32),
                       v_cache.to(_F32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_xdma(q, kt_cache, v_cache, length):
    """Decode against the XDMA layout-optimal cache: K stored transposed
    (B,KV,hd,Smax), V stored (B,KV,Smax,hd)."""
    B, _, H, hd = q.shape
    KV, Smax = kt_cache.shape[1], kt_cache.shape[3]
    G = H // KV
    qh = q[:, 0].reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bkhs->bkgs", qh.to(_F32),
                     kt_cache.to(_F32)) * hd ** -0.5
    s = _mask_valid(s, length, Smax)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bksh->bkgh", p.to(v_cache.dtype).to(_F32),
                       v_cache.to(_F32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _is_vector(pos) -> bool:
    return isinstance(pos, torch.Tensor) and pos.dim() >= 1


def _slot(cache_pos, Smax, window):
    """The cache slot a decode step writes: the rolled position of a window
    cache, else the position clamped to the last slot."""
    if _is_vector(cache_pos):
        return (cache_pos % Smax if window is not None
                else torch.clamp(cache_pos, max=Smax - 1))
    p = int(cache_pos)
    return p % Smax if window is not None else min(p, Smax - 1)


def _plus_one(cache_pos):
    return cache_pos + 1 if _is_vector(cache_pos) else int(cache_pos) + 1


def attn_apply(cfg, p, x, positions, *, causal=True, window=None,
               cache=None, cache_pos=None, kv_x=None, apply_rope=True,
               cross=False, cache_slots=None):
    """Full attention sublayer.

    train/prefill: ``cache=None`` -> flash-chunked attention over x (or kv_x
    for cross-attention).  decode: ``cache`` = {"k","v"} (B,Smax,KV,hd), or
    under ``cfg.xdma_cache`` K (B,KV,hd,Smax) and V (B,KV,Smax,hd), plus
    ``cache_pos`` — a scalar (uniform batch) or a (B,) vector of per-request
    positions (ragged continuous batching); returns (out, new_cache).  The
    cache passed in is not modified.  ``cache_slots`` is the whole cache's
    slot count (``min(window, max_len)``, or ``max_len``); sharded decode
    reads from it whether a sequence the KV heads leave to the model axis
    is split or whole (:func:`seq_block`).
    """
    tp = SH.active_axis(cfg.axes.model)
    if tp is not None:
        is_cross = cross or kv_x is not None
        if cache is not None:
            return _attn_cached_tp(cfg, p, x, positions, window=window,
                                   cache=cache, cache_pos=cache_pos,
                                   cross=is_cross, rope=apply_rope, ax=tp,
                                   slots=cache_slots)
        return _attn_tp(cfg, p, x, positions,
                        causal=causal and not is_cross, window=window, ax=tp,
                        kv_x=kv_x if is_cross else None,
                        rope=apply_rope and not is_cross), None
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    mspec, ms = cfg.axes.model, cfg.axes.model_size
    head_ok = bool(mspec) and bool(ms) and H % ms == 0 and KV % ms == 0
    head_repeat = (not head_ok) and bool(mspec) and bool(ms) and H % ms == 0
    q_seq_ax = (None if head_ok or head_repeat or not mspec
                else (mspec if S > 1 else None))

    def proj(y, w, b=None):
        o = y @ w.to(dt)
        if b is not None:
            o = o + b.to(dt)
        return o

    q = proj(x, p["wq"], p.get("bq")).reshape(B, S, H, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])

    is_cross = cross or (kv_x is not None)
    if cache is not None and is_cross:
        # cross-attn decode: encoder K/V precomputed in cache, never updated
        out = decode_attention(q, cache["k"], cache["v"], cache["len"])
        return proj(out.reshape(B, S, H * hd), p["wo"]), cache

    src = kv_x if is_cross else x
    k = proj(src, p["wk"], p.get("bk")).reshape(B, src.shape[1], KV, hd)
    v = proj(src, p["wv"], p.get("bv")).reshape(B, src.shape[1], KV, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"])
    if apply_rope and not is_cross:
        q = rope_for(cfg, q, positions)
        k = rope_for(cfg, k, positions)

    if cache is None:
        k_att, v_att = k, v
        if head_repeat and S > 1:
            k_att = torch.repeat_interleave(k, H // KV, dim=2)
            v_att = torch.repeat_interleave(v, H // KV, dim=2)
        impl = (chunked_attention_dense if q_seq_ax is not None
                else chunked_attention)
        out = impl(q, k_att, v_att, causal=causal and not is_cross,
                   window=window, q_chunk=min(1024, S),
                   kv_chunk=min(1024, src.shape[1]))
    else:
        out, cache = _write_and_attend(cfg, q, k, v, cache, cache_pos,
                                       window)

    y = proj(out.reshape(B, S, H * hd), p["wo"])
    return y, cache


def _write_and_attend(cfg, q, k, v, cache, cache_pos, window):
    """Decode: write the new K / V (B, S, KV, hd) at ``cache_pos``'s slot
    and attend over the cache; returns ``(out, new cache)``."""
    B, S = q.shape[:2]
    if cfg.xdma_cache:
        # XDMA layout-optimal cache: K stored transposed, V dot-contiguous
        Smax = cache["k"].shape[3]
        slot = _slot(cache_pos, Smax, window)
        dt_c = cache["k"].dtype
        ck, cv = cache["k"].clone(), cache["v"].clone()
        if _is_vector(cache_pos):
            bidx = torch.arange(B, device=ck.device)
            ck[bidx, :, :, slot] = k[:, 0].to(dt_c)
            cv[bidx, :, slot, :] = v[:, 0].to(dt_c)
        else:
            ck[:, :, :, slot] = k[:, 0].to(dt_c)
            cv[:, :, slot, :] = v[:, 0].to(dt_c)
        cache = dict(cache, k=ck, v=cv)
        return decode_attention_xdma(q, ck, cv, _plus_one(cache_pos)), cache
    Smax = cache["k"].shape[1]
    slot = _slot(cache_pos, Smax, window)
    ck, cv = cache["k"].clone(), cache["v"].clone()
    if _is_vector(cache_pos):
        bidx = torch.arange(B, device=ck.device)
        ck[bidx, slot] = k[:, 0].to(ck.dtype)
        cv[bidx, slot] = v[:, 0].to(cv.dtype)
    else:
        ck[:, slot:slot + S] = k.to(ck.dtype)
        cv[:, slot:slot + S] = v.to(cv.dtype)
    cache = dict(cache, k=ck, v=cv)
    return decode_attention(q, ck, cv, _plus_one(cache_pos),
                            rolling=window is not None), cache


def kv_seq_axis(cfg, ax):
    """The registered axis a KV cache's sequence splits over, by
    :func:`repro_torch.sharding.kv_cache_spec`: the context-parallel
    ``cfg.axes.seq`` where the KV heads divide the model axis ``ax`` (they
    take it), else ``(seq, model)`` as one axis (the pair's group), or the
    model axis alone with no ``seq``; None where nothing splits the
    sequence."""
    seq = cfg.axes.seq
    heads = cfg.n_kv_heads % ax.size == 0
    names = ((seq,) if seq else ()) + (() if heads else (ax.name,))
    return SH.axis_over(names) if names else None


def seq_block(sl, ax, slots=None):
    """``(lo, Smax, axis)`` of a KV leaf whose sequence the axis ``ax``
    takes (:func:`kv_seq_axis`: ``seq``, the model axis, or the pair),
    holding ``sl`` slots in this rank: its first global slot, the whole
    cache's slots and the axis its softmax merges over.  The fitted spec
    splits ``Smax`` slots evenly over the axis (``lo = r sl``) and keeps
    a count the axis does not divide whole on every rank (``lo = 0``, no
    merge: each rank writes and attends over its own copy, as the
    reference does with a replicated cache).  ``slots`` is ``Smax``; without it a block's ``sl`` the axis
    divides tells a split cache, and any other needs ``slots`` (a whole
    cache of ``sl`` slots and a block of ``sl n`` look alike)."""
    n = ax.size
    if slots is None:
        if sl % n:
            raise ValueError(
                f"a KV block of {sl} slots over the {ax.name!r} axis of {n} "
                "is a whole cache or a split one: pass the cache's max_len")
        slots = sl * n
    if slots % n == 0 and sl * n == slots:
        return ax.index * sl, slots, ax.name
    if slots % n and sl == slots:
        return 0, slots, None
    raise ValueError(f"a KV leaf of {sl} slots is neither the whole cache "
                     f"of {slots} nor its block over the {ax.name!r} axis "
                     f"of {n}")


def _write_slots(cfg, k, v, cache, cache_pos, window, lo, Smax):
    """Decode on a sequence-split cache: the new K / V (B, 1, KV, hd)
    into this rank's block, slots ``[lo, lo + block)`` of ``Smax``, where
    the step's slot falls in it (per row for a ragged ``cache_pos``: each
    row writes its own slot or, where another rank owns it, its block's
    value back, so the shapes do not depend on the positions)."""
    xdma = cfg.xdma_cache
    sl = cache["k"].shape[3 if xdma else 1]
    local = _slot(cache_pos, Smax, window)
    dt = cache["k"].dtype
    ck, cv = cache["k"].clone(), cache["v"].clone()
    if _is_vector(cache_pos):
        local = local.to(ck.device) - lo
        own = (local >= 0) & (local < sl)
        at = torch.clamp(local, 0, sl - 1)
        bidx = torch.arange(local.shape[0], device=ck.device)
        if xdma:
            ck[bidx, :, :, at] = torch.where(
                own[:, None, None], k[:, 0].to(dt), ck[bidx, :, :, at])
            cv[bidx, :, at, :] = torch.where(
                own[:, None, None], v[:, 0].to(dt), cv[bidx, :, at, :])
        else:
            ck[bidx, at] = torch.where(own[:, None, None], k[:, 0].to(dt),
                                       ck[bidx, at])
            cv[bidx, at] = torch.where(own[:, None, None], v[:, 0].to(dt),
                                       cv[bidx, at])
        return dict(cache, k=ck, v=cv)
    if not lo <= local < lo + sl:
        return cache
    at = local - lo
    if xdma:
        ck[:, :, :, at] = k[:, 0].to(dt)
        cv[:, :, at, :] = v[:, 0].to(dt)
    else:
        ck[:, at] = k[:, 0].to(dt)
        cv[:, at] = v[:, 0].to(dt)
    return dict(cache, k=ck, v=cv)


def _attend_slots(q, k_blk, v_blk, length, lo, Smax, xdma, axis):
    """Decode attention over a cache whose slots are split over ``axis``:
    this rank holds slots ``[lo, lo + block)`` of ``Smax`` (layout
    ``bshd``, or the XDMA pair K ``bkhs`` / V ``bksh``) and every rank the
    whole query (B, 1, H, hd).  Each scores its block against its slots'
    global indices, masked beyond ``length`` (a scalar or (B,)); the
    softmax is merged over the axis (the row max all-reduced, then the
    rescaled denominators and weighted V summed): the reference's
    psum-merged attention.  With ``axis`` None the block is the whole
    cache and nothing is merged."""
    B, _, H, hd = q.shape
    KV = k_blk.shape[1 if xdma else 2]
    sl = k_blk.shape[3 if xdma else 1]
    G = H // KV
    qh = q[:, 0].reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bkhs->bkgs" if xdma else "bkgh,bskh->bkgs",
                     qh.to(_F32), k_blk.to(_F32)) * hd ** -0.5
    idx = lo + torch.arange(sl, device=s.device)
    if _is_vector(length):
        lv = torch.clamp(length.to(s.device), max=Smax)
        s = torch.where((idx[None] < lv[:, None])[:, None, None, :], s,
                        NEG_INF)
    elif isinstance(length, torch.Tensor):       # 0-d: the cross cache's
        lv = torch.clamp(length.to(s.device), max=Smax)
        s = torch.where((idx < lv)[None, None, None], s, NEG_INF)
    else:
        s = torch.where((idx < min(int(length), Smax))[None, None, None], s,
                        NEG_INF)
    mx = s.amax(-1)
    if axis is not None:
        mx = SH.all_reduce(mx, axis, "max")
    pr = torch.exp(s - mx[..., None])
    acc = torch.einsum("bkgs,bksh->bkgh" if xdma else "bkgs,bskh->bkgh",
                       pr.to(v_blk.dtype).to(_F32), v_blk.to(_F32))
    both = torch.cat([acc, pr.sum(-1)[..., None]], -1)
    if axis is not None:
        both = SH.all_reduce(both, axis)
    out = both[..., :hd] / both[..., hd:]
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _attn_cached_tp(cfg, p, x, positions, *, window, cache, cache_pos,
                    cross, rope, ax, slots=None):
    """The cached sublayer (one decode token, self- or cross-attention) in
    every rank of the model axis ``ax``, the cache this rank's block by
    ``kv_cache_spec`` (``launch.mesh.serving_cache_specs``) and the
    weights this rank's blocks by the serving specs:

    * KV heads that divide the axis: the cache holds this rank's KV heads;
      the rank projects its query heads and their K / V from its columns,
      writes its slot and attends on its heads (``decode_attention`` /
      ``decode_attention_xdma``), the output projection row-parallel and
      reduced over the axis (``_attn_tp``'s head-parallel branch).  Under
      a context-parallel ``seq`` axis each rank's heads are split by
      sequence over it: the rank that owns the step's slot writes it and
      :func:`_attend_slots` merges the softmax over ``seq``;
    * otherwise the cache holds slots ``[r Smax / n, (r + 1) Smax / n)``
      of every head, ``r`` and ``n`` over the model axis, or over the pair
      ``(seq, model)`` under a ``seq`` axis (:func:`kv_seq_axis`): the
      query and the new K / V are whole on every rank (each rank's columns
      all-gathered over the model axis: activations, not weights), the
      rank that owns the step's slot writes it, and :func:`_attend_slots`
      merges the softmax over the split's axis; the output projection
      takes this rank's rows of ``wo`` (a reduce) or ``wo`` whole.

    Where the split does not divide the slots (``slots``, the cross
    cache's the encoder's frames) the cache is whole on every rank: each
    writes and attends over its own copy (:func:`seq_block`).  The cache
    is never gathered."""
    B, S, d = x.shape
    if S != 1:
        raise ValueError(f"sharded decode takes one token a step, not {S}")
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    m, n, r = ax.name, ax.size, ax.index
    heads = KV % n == 0
    split = kv_seq_axis(cfg, ax)

    def proj(w, b, whole):
        """The projection's heads: this rank's (heads split), else whole."""
        wt, bt = p[w], p.get(b)
        if heads:
            wt, bt = SH.block_of(wt, m, whole, 1), SH.block_of(bt, m, whole, 0)
        y = x @ wt.to(dt)
        if bt is not None:
            y = y + bt.to(dt)
        if not heads and wt.shape[1] != whole:     # this rank's columns
            y = SH.all_gather(y, m, -1)
        return y.reshape(B, S, -1, hd)

    q = proj("wq", "bq", H * hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
    if cross:
        # encoder K / V precomputed in the cache, never updated
        if split is None:
            out = decode_attention(q, cache["k"], cache["v"], cache["len"])
        else:
            lo, smax, merge = seq_block(cache["k"].shape[1], split,
                                        cfg.encoder_seq)
            out = _attend_slots(q, cache["k"], cache["v"], cache["len"],
                                lo, smax, False, merge)
    else:
        k, v = proj("wk", "bk", KV * hd), proj("wv", "bv", KV * hd)
        if cfg.qk_norm:
            k = rms_norm(k, p["k_norm"])
        if rope:
            q, k = rope_for(cfg, q, positions), rope_for(cfg, k, positions)
        if split is None:
            out, cache = _write_and_attend(cfg, q, k, v, cache, cache_pos,
                                           window)
        else:
            lo, smax, merge = seq_block(
                cache["k"].shape[3 if cfg.xdma_cache else 1], split, slots)
            cache = _write_slots(cfg, k, v, cache, cache_pos, window, lo,
                                 smax)
            out = _attend_slots(q, cache["k"], cache["v"],
                                _plus_one(cache_pos), lo, smax,
                                cfg.xdma_cache, merge)
    flat = out.reshape(B, S, -1)
    wo = p["wo"]
    if heads:
        wo = SH.block_of(wo, m, H * hd, 0)
    elif wo.shape[0] == H * hd:                    # whole: no reduce
        return flat @ wo.to(dt), cache
    else:
        blk = wo.shape[0]
        flat = flat[..., r * blk:(r + 1) * blk]
    return SH.reduce_from_axis(flat @ wo.to(dt), m), cache


def _attn_tp(cfg, p, x, positions, *, causal, window, ax, kv_x=None,
             rope=True):
    """The training sublayer tensor-parallel over ``ax``, in every rank of
    it: ``x`` (B, S, d) and the output replicated over the axis, the
    weights sharded by their specs (a weight whole along a dim its rule
    shards was fitted out of the spec; :func:`repro_torch.sharding.block_of`
    and ``whole_of`` tell by its shape).  Cross-attention passes ``kv_x``
    (B, Sk, d), replicated over the axis, whose K / V the queries of ``x``
    read (``rope`` off, not causal), in the same regime.

    * head-parallel (the query and KV heads divide the axis): each rank its
      query heads and their KV heads, the output projection row-parallel,
      its partial sums reduced over the axis;
    * repeat (only the query heads divide): each rank computes the KV heads
      its query heads read, from ``wk`` / ``wv`` gathered whole (a spec can
      split them through half a head), each repeated to its query heads;
    * sequence-parallel (neither): each rank its block of query rows
      (``q_offset = index * ceil(S / size)``, the last block padded where
      the axis does not divide S, as GSPMD pads an uneven split) over the
      whole K / V on the dense schedule, every weight gathered whole, its
      output rows gathered along S and the padding dropped.

    The input (and ``kv_x``) enters through ``copy_to_axis`` and so do
    ``q_norm`` / ``k_norm``, whose gradients each rank holds a part of."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    m, ms, r = ax.name, ax.size, ax.index
    x = SH.copy_to_axis(x, m)
    src = x if kv_x is None else SH.copy_to_axis(kv_x, m)
    Sk = src.shape[1]

    def rope_to(t, pos):
        return rope_for(cfg, t, pos) if rope else t
    q_norm = SH.copy_to_axis(p["q_norm"], m) if cfg.qk_norm else None
    k_norm = SH.copy_to_axis(p["k_norm"], m) if cfg.qk_norm else None

    def proj(y, w, b=None):
        o = y @ w.to(dt)
        return o if b is None else o + b.to(dt)

    def weight(name, whole, dim, fn):
        return fn(p.get(name), m, whole, dim)

    if H % ms == 0:
        Hl = H // ms
        q = proj(x, weight("wq", H * hd, 1, SH.block_of),
                 weight("bq", H * hd, 0, SH.block_of)).reshape(B, S, Hl, hd)
        if KV % ms == 0:                      # head-parallel
            def kv(w, b):
                return proj(src, weight(w, KV * hd, 1, SH.block_of),
                            weight(b, KV * hd, 0, SH.block_of)).reshape(
                                B, Sk, KV // ms, hd)
            k, v = kv("wk", "bk"), kv("wv", "bv")
            idx = None
        else:                                 # K / V repeated to H heads
            G = H // KV
            lo, hi = r * Hl // G, ((r + 1) * Hl - 1) // G + 1

            def kv(w, b):
                wf = weight(w, KV * hd, 1, SH.whole_of)[:, lo * hd:hi * hd]
                bf = weight(b, KV * hd, 0, SH.whole_of)
                bf = None if bf is None else bf[lo * hd:hi * hd]
                return proj(src, wf, bf).reshape(B, Sk, hi - lo, hd)
            k, v = kv("wk", "bk"), kv("wv", "bv")
            idx = torch.div(r * Hl + torch.arange(Hl, device=x.device), G,
                            rounding_mode="floor") - lo
        if cfg.qk_norm:
            q, k = rms_norm(q, q_norm), rms_norm(k, k_norm)
        q, k = rope_to(q, positions), rope_to(k, positions)
        if idx is not None:
            k, v = k[:, :, idx], v[:, :, idx]
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                q_chunk=min(1024, S),
                                kv_chunk=min(1024, Sk))
        y = out.reshape(B, S, Hl * hd) @ weight("wo", H * hd, 0,
                                                 SH.block_of).to(dt)
        return SH.reduce_from_axis(y, m)

    # sequence-parallel: blocks of ceil(S / ms) query rows, the last padded
    # where the axis does not divide S (the padded rows' outputs dropped)
    Sl = -(-S // ms)
    pad = Sl * ms - S
    xq, pq = x, positions
    if pad:
        xq = torch.nn.functional.pad(x, (0, 0, 0, pad))
        pq = torch.nn.functional.pad(positions, (0, pad))
    q = proj(xq[:, r * Sl:(r + 1) * Sl], weight("wq", H * hd, 1, SH.whole_of),
             weight("bq", H * hd, 0, SH.whole_of)).reshape(B, Sl, H, hd)
    k = proj(src, weight("wk", KV * hd, 1, SH.whole_of),
             weight("bk", KV * hd, 0, SH.whole_of)).reshape(B, Sk, KV, hd)
    v = proj(src, weight("wv", KV * hd, 1, SH.whole_of),
             weight("bv", KV * hd, 0, SH.whole_of)).reshape(B, Sk, KV, hd)
    if cfg.qk_norm:
        q, k = rms_norm(q, q_norm), rms_norm(k, k_norm)
    q = rope_to(q, pq[..., r * Sl:(r + 1) * Sl])
    k = rope_to(k, positions)
    out = chunked_attention_dense(q, k, v, causal=causal, window=window,
                                  q_offset=r * Sl, q_chunk=min(1024, S),
                                  kv_chunk=min(1024, Sk))
    y = out.reshape(B, Sl, H * hd) @ weight("wo", H * hd, 0,
                                            SH.whole_of).to(dt)
    return SH.unsplit_along(y, m, 1)[:, :S]
