"""Mixture-of-Experts with capacity-based top-k routing and explicit
expert-parallel dispatch through the XDMA remote engine (PyTorch port: the
twin of ``repro.layers.moe``).

Distributed path (``cfg.axes.model`` set + a mesh): the reference runs the
MoE sublayer under ``shard_map``; here the caller is already one rank of an
SPMD body (:func:`repro_torch.sharding.run_spmd`), ``x`` is this rank's
block (its batch shard, replicated over the model axis) and ``p`` the whole
parameter tree, of which the rank reads its own shard (experts
``[r E / n, (r + 1) E / n)`` on the expert-parallel paths, a ``d_ff_expert``
slice on the tensor-parallel one).  Tokens are sequence-split across the
model axis; each rank routes its slice locally (sort-based), builds an
(E, C, d) dispatch buffer and exchanges it with an ``all_to_all`` endpoint
descriptor — optionally with Quantize/Dequantize on the wire.  The expert
FFN runs on the local expert shard; the return path mirrors the dispatch;
an all-gather of one-hop ``multicast_axis`` transfers rebuilds the sequence.

Local path (tests / no mesh): same math, no collectives.

Where the reference leaves an order to XLA the port fixes it: the top-k
breaks ties toward the lower expert id (``lax.top_k``), the dispatch sorts
stably, and the combine sums a token's k contributions in increasing
position of the expert-sorted order, with no atomics, so the card and the
CPU give the same bits.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding as S
from repro_torch.core import api as xdma
from repro_torch.core import plugins as XP
from repro_torch.core.api import XDMAQueue
from repro_torch.core.descriptor import (Endpoint, XDMADescriptor,
                                         reduce_descriptor)

from ._init import Init

__all__ = ["init_moe", "moe_apply", "ep_enabled"]


def init_moe(init: Init, cfg):
    """The reference's MoE parameters (shapes, f32, standard deviations),
    drawn from the port's seeded initializer."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    return {
        "router": init.normal((d, E), d ** -0.5),
        "w_gate": init.normal((E, d, f), d ** -0.5),
        "w_up": init.normal((E, d, f), d ** -0.5),
        "w_down": init.normal((E, f, d), f ** -0.5),
    }


def _route(cfg, router_w, tokens):
    """tokens (T, d) -> (gates (T,k), expert ids (T,k), aux load-balance loss)."""
    # an f32 product, whatever the parameters' dtype (jnp promotes)
    logits = tokens.to(torch.float32) @ router_w.to(torch.float32)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k: the k largest, ties to the lower index (a stable sort keeps
    # equal probabilities in index order)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style aux loss: E * sum_e f_e * P_e
    E = cfg.n_experts
    f_e = torch.bincount(eidx.reshape(-1), minlength=E).to(torch.float32)
    f_e = f_e / torch.clamp(f_e.sum(), min=1.0)
    p_e = probs.mean(0)
    aux = E * torch.sum(f_e * p_e)
    return gates, eidx, aux


def _capacity(cfg, T: int) -> int:
    """Slots an expert, as the reference computes it (Python floats)."""
    return int(cfg.capacity_factor * cfg.top_k * T // cfg.n_experts) + 1


def _dispatch(cfg, tokens, eidx, gates, capacity):
    """Sort-based local dispatch. Returns (buffer (E,C,d), slot (T*k,), keep,
    order, tok_of)."""
    T, d = tokens.shape
    k, E, C = cfg.top_k, cfg.n_experts, capacity
    flat_e = eidx.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se = flat_e[order]
    tok_of = torch.div(order, k, rounding_mode="floor")
    counts = torch.bincount(se, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=tokens.device) - starts[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, torch.full_like(pos, E * C))
    # The expert-order permute is the XDMA GatherScatter stage (index-driven
    # reorder on the stream).  Kept rows land in distinct slots, dropped ones
    # nowhere (the reference adds them to a sentinel row it then drops), so
    # one copy of the kept rows fills the buffer.
    permute = XP.GatherScatter(indices=tok_of, axis=0)
    contrib = permute(tokens)
    buf = torch.zeros((E * C, d), dtype=tokens.dtype, device=tokens.device)
    buf.index_copy_(0, slot[keep], contrib[keep])
    return buf.reshape(E, C, d), slot, keep, order, tok_of


def _expert_ffn(cfg, p, buf):
    """buf (E_local, C*, d) -> same shape; SwiGLU per expert."""
    dt = buf.dtype
    g = torch.bmm(buf, p["w_gate"].to(dt))
    u = torch.bmm(buf, p["w_up"].to(dt))
    return torch.bmm(F.silu(g) * u, p["w_down"].to(dt))


def _combine(cfg, out_buf, slot, keep, order, gates, T, d):
    """Each token's k weighted expert outputs summed into its row, in
    increasing position of ``order`` (the order in which the reference's
    scatter-add sees them), one add at a time from zero: no atomics."""
    k = cfg.top_k
    flat = torch.cat([out_buf.reshape(-1, d),
                      out_buf.new_zeros((1, d))], 0)
    vals = flat[torch.clamp(slot, max=flat.shape[0] - 1)]
    w = gates.reshape(-1)[order].to(vals.dtype)[:, None]
    contrib = vals * w * keep[:, None].to(vals.dtype)        # sorted order
    # position in `order` of each (token, choice), then each token's k
    # positions ascending
    where = torch.empty_like(order)
    where[order] = torch.arange(order.numel(), dtype=order.dtype,
                                device=order.device)
    where = torch.sort(where.reshape(T, k), dim=1).values
    y = torch.zeros((T, d), dtype=out_buf.dtype, device=out_buf.device)
    for j in range(k):
        y = y + contrib[where[:, j]]
    return y


# -- every remaining collective as a movement-plane task ---------------------
def _pmean(x, axes, n_total: int):
    """pmean through the plane: a reduce-endpoint sum, then the local divide."""
    return xdma.transfer(x, reduce_descriptor(axes, n_total)) / n_total


@functools.lru_cache(maxsize=None)
def _hop_desc(axis: str, n: int) -> XDMADescriptor:
    perm = tuple((i, (i + 1) % n) for i in range(n))
    return XDMADescriptor(dst=Endpoint.multicast_axis(axis, perm))


def _ring_all_gather(x, axis_name: str, n: int):
    """``lax.all_gather(x, axis, axis=1, tiled=True)`` as n-1 rotating
    one-hop broadcasts (``multicast_axis`` transfers), each recorded as a
    ``multicast`` endpoint in the capture ledger.

    ``x`` is ``(B, S_local, d)``; returns ``(B, n * S_local, d)`` ordered by
    source rank, exactly like the tiled all-gather it replaces.
    """
    if n == 1:
        return x
    parts = [x]
    for _ in range(n - 1):
        parts.append(xdma.transfer(parts[-1], _hop_desc(axis_name, n)))
    stacked = torch.stack(parts)          # [j] = shard of rank (i - j) % n
    idx = S.axis_index(axis_name)
    order = torch.remainder(idx - torch.arange(n, device=x.device), n)
    ordered = stacked[order]              # [s] = shard of rank s
    B, Sl, d = x.shape
    return ordered.movedim(0, 1).reshape(B, n * Sl, d)


def _dispatch_queue(model_axis: str, dtype, wire_plugins) -> XDMAQueue:
    """The expert-parallel exchange as the Controller's task queue: task 0 is
    the dispatch all-to-all, task 1 the mirrored return, with the wire
    plugins on the pre host and Dequantize on the post host."""
    pre = tuple(wire_plugins)
    post = (XP.Dequantize(dtype),) if pre else ()
    return XDMAQueue([
        XDMADescriptor(dst=Endpoint.all_to_all(model_axis, split_axis=0,
                                               concat_axis=1),
                       pre=pre, post=post),
        XDMADescriptor(dst=Endpoint.all_to_all(model_axis, split_axis=1,
                                               concat_axis=0),
                       pre=pre, post=post),
    ], name="moe_dispatch")


def _moe_tokens(cfg, p, tokens, *, model_axis: Optional[str], n_model: int,
                wire_plugins=(), scheduler=None, overlap_chunks: int = 2):
    """Core MoE on a (T, d) token slab; a2a over model_axis when distributed.

    With a :class:`~repro_torch.runtime.DistributedScheduler` the dispatch
    buffer is split into ``overlap_chunks`` capacity slices, each running
    its own dispatch-a2a -> expert FFN -> return-a2a chain on alternating
    links; slot indexing is unchanged, so the math matches the unchunked
    queue path.
    """
    T, d = tokens.shape
    E = cfg.n_experts
    gates, eidx, aux = _route(cfg, p["router"], tokens)
    capacity = _capacity(cfg, T)

    queue = (None if model_axis is None
             else _dispatch_queue(model_axis, tokens.dtype, wire_plugins))
    chunked = queue is not None and scheduler is not None and overlap_chunks > 1
    buf, slot, keep, order, tok_of = _dispatch(cfg, tokens, eidx, gates,
                                               capacity)

    if chunked:
        # pad the *buffer* (not the capacity) to a chunk multiple: slot/keep
        # were computed with the real capacity, so token dropping is the
        # unchunked path's and the pad slots are never referenced
        cap_pad = -(-capacity // overlap_chunks) * overlap_chunks
        if cap_pad != capacity:
            buf = F.pad(buf, (0, 0, 0, cap_pad - capacity))
        links = scheduler.topology.link_names
        Cc = cap_pad // overlap_chunks
        # simulated FFN cost: 3 (Eloc, n*Cc, d)x(d, f) einsums per chunk at a
        # nominal accelerator rate, enough to place compute on the timeline
        ffn_s = 6.0 * E * Cc * d * cfg.d_ff_expert / 50e12
        futs = []
        for c in range(overlap_chunks):
            sub = buf[:, c * Cc:(c + 1) * Cc]
            f_out = scheduler.submit(sub, queue.descriptors[0],
                                     link=links[c % len(links)],
                                     label=f"a2a_dispatch[{c}]")
            f_ffn = scheduler.submit_compute(
                lambda b: _expert_ffn(cfg, p, b), f_out,
                resource="expert_ffn", cost_s=ffn_s,
                label=f"expert_ffn[{c}]")
            futs.append(scheduler.submit(f_ffn, queue.descriptors[1],
                                         link=links[c % len(links)],
                                         label=f"a2a_return[{c}]"))
        scheduler.flush()
        out = torch.cat([f.result() for f in futs], dim=1)
        out = out[:, :capacity]          # drop the pad slots before combine
    else:
        if queue is not None:
            # (E, C, d) -> (E_local, n_model*C, d): the XDMA dispatch tunnel
            buf = queue.run_task(buf, 0)
        out = _expert_ffn(cfg, p, buf)
        if queue is not None:
            out = queue.run_task(out, 1)
    y = _combine(cfg, out, slot, keep, order, gates, T, d)
    return y, aux


def _expert_ffn_tp(cfg, p, buf, model_axis, n_model):
    """TP experts: d_ff sharded over the model axis; the per-layer all-reduce
    is a ``reduce``-endpoint XDMA task (the plane's spelling of psum)."""
    out = _expert_ffn(cfg, p, buf)
    return xdma.transfer(out, reduce_descriptor(model_axis, n_model))


def ep_enabled(cfg, n_model: int) -> bool:
    return cfg.n_experts % n_model == 0


def _shard(w, dim: int, n: int, r: int):
    """Block ``r`` of ``n`` of ``w`` along ``dim`` (a ``P`` spec's slice)."""
    size = w.shape[dim] // n
    return w.narrow(dim, r * size, size)


def moe_apply(cfg, p, x, *, mesh=None, scheduler=None, overlap_chunks: int = 2):
    """x (B, S, d) -> (y, aux_loss).

    Distributed (cfg.axes.model set + mesh given; called in every rank of
    the mesh, ``x`` this rank's batch block):
      * EP path (E %% n_model == 0, S %% n_model == 0): sequence-split tokens,
        XDMA all_to_all dispatch to the expert shard, mirrored return.
      * EP without the split (too few tokens, e.g. decode): every model rank
        routes the whole block; the a2a moves only the token buffer.
      * TP path (otherwise): tokens replicated over model, expert d_ff
        sharded, one reduce task (Megatron-style).
    Local (tests / no mesh): same math, no collectives.

    ``scheduler`` (a :class:`~repro_torch.runtime.DistributedScheduler`)
    routes the EP dispatch through chunked per-link FIFOs (see
    :func:`_moe_tokens`); pass a fresh one per call.
    """
    B, Sq, d = x.shape
    axes = cfg.axes
    if axes.model is None or mesh is None:
        y, aux = _moe_tokens(cfg, p, x.reshape(-1, d), model_axis=None,
                             n_model=1)
        return y.reshape(B, Sq, d), aux

    n_model = S.axis_size(axes.model)
    r = S.axis_index(axes.model)
    all_axes = tuple(mesh.axis_names)
    n_total = int(mesh.world_size)
    wire = (XP.Quantize(),) if getattr(cfg, "moe_wire_int8", False) else ()
    use_ep = ep_enabled(cfg, n_model) and Sq % n_model == 0 and Sq >= n_model
    tp_ok = cfg.d_ff_expert % n_model == 0

    if ep_enabled(cfg, n_model):
        pl = {"router": p["router"],
              **{w: _shard(p[w], 0, n_model, r)
                 for w in ("w_gate", "w_up", "w_down")}}
    elif tp_ok:
        pl = {"router": p["router"],
              "w_gate": _shard(p["w_gate"], 2, n_model, r),
              "w_up": _shard(p["w_up"], 2, n_model, r),
              "w_down": _shard(p["w_down"], 1, n_model, r)}
    else:
        pl = p

    if use_ep:
        # split the sequence across model ranks
        Sl = Sq // n_model
        xs = x[:, r * Sl:(r + 1) * Sl]
        y, aux = _moe_tokens(cfg, pl, xs.reshape(-1, d),
                             model_axis=axes.model, n_model=n_model,
                             wire_plugins=wire, scheduler=scheduler,
                             overlap_chunks=overlap_chunks)
        y = _ring_all_gather(y.reshape(B, Sl, d), axes.model, n_model)
    elif ep_enabled(cfg, n_model):
        # decode-scale EP: every model rank routes the full block (identical
        # dispatch); the a2a moves only the (E, C, d) token buffer, never the
        # expert weights
        y, aux = _moe_tokens(cfg, pl, x.reshape(-1, d),
                             model_axis=axes.model, n_model=n_model,
                             wire_plugins=wire, scheduler=scheduler,
                             overlap_chunks=overlap_chunks)
        y = y.reshape(x.shape)
    else:
        tokens = x.reshape(-1, d)
        gates, eidx, aux = _route(cfg, pl["router"], tokens)
        T = tokens.shape[0]
        buf, slot, keep, order, _ = _dispatch(cfg, tokens, eidx, gates,
                                              _capacity(cfg, T))
        if tp_ok:
            out = _expert_ffn_tp(cfg, pl, buf, axes.model, n_model)
        else:
            out = _expert_ffn(cfg, pl, buf)    # replicated experts (fallback)
        y = _combine(cfg, out, slot, keep, order, gates, T, d).reshape(x.shape)
    aux = _pmean(aux, all_axes, n_total)
    return y, aux
