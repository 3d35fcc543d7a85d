"""Mixture-of-Experts with capacity-based top-k routing and explicit
expert-parallel dispatch through the XDMA remote engine (PyTorch port: the
twin of ``repro.layers.moe``).

Distributed path (``cfg.axes.model`` set + a mesh): the reference runs the
MoE sublayer under ``shard_map``; here the caller is already one rank of an
SPMD body (:func:`repro_torch.sharding.run_spmd`), ``x`` is this rank's
block (its batch shard, replicated over the model axis) and ``p`` the whole
parameter tree or this rank's model-axis block of it (the sharded
trainer's), told apart by shape: experts ``[r E / n, (r + 1) E / n)`` on
the expert-parallel paths, a ``d_ff_expert`` slice on the tensor-parallel
one.  Tokens are sequence-split across the
model axis; each rank routes its slice locally (sort-based), builds an
(E, C, d) dispatch buffer and exchanges it with an ``all_to_all`` endpoint
descriptor — optionally with Quantize/Dequantize on the wire.  The expert
FFN runs on the local expert shard; the return path mirrors the dispatch;
an all-gather of one-hop ``multicast_axis`` transfers rebuilds the sequence.

**Gradients.**  Each plane transfer of the distributed path is an
``autograd.Function`` whose forward is the ``xdma.transfer`` it always was
and whose backward is the transpose ``jax.vjp`` takes through the
reference's ``shard_map`` body: an all-to-all's is the mirrored
all-to-all (with the int8 wire only the scales carry a gradient, the
values being integers, so the mirrored all-to-all moves the scales'
cotangent, one f32 a row), a ``reduce``'s is a ``reduce``, the ring
all-gather's is this rank's block of the (replicated) output's gradient.
The inputs enter as ``shard_map`` hands them in: ``x``, the router and
replicated experts sum their gradient over the model axis
(``copy_to_axis``; the sequence split is ``split_along``), and an output
replicated over the axis divides its gradient by the axis size.  So the
sharded MoE's gradient is the reference's sharded one, which is not the
single-process layer's: routing, capacity and the aux loss belong to each
(data block, sequence slice) on the expert-parallel path, to each data
block on the others.

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
    # a scatter-add of a fixed size (the reference's .at[].add), which runs
    # on meta tensors too: the dry run counts the routed step
    flat = eidx.reshape(-1)
    f_e = torch.zeros(E, dtype=torch.float32, device=flat.device).index_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=flat.device))
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
    counts = torch.zeros(E, dtype=se.dtype, device=se.device).index_add(
        0, se, torch.ones_like(se))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=tokens.device) - starts[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, torch.full_like(pos, E * C))
    # The expert-order permute is the XDMA GatherScatter stage (index-driven
    # reorder on the stream).  As in the reference, every row is added into
    # a buffer of one row more, the dropped ones (zeroed) into the sentinel
    # row it then drops: shapes that do not depend on the routing.  Kept
    # rows land in distinct slots, so each holds its one row exactly (a
    # -0.0 added to the buffer's +0.0 is +0.0, as in the reference).
    permute = XP.GatherScatter(indices=tok_of, axis=0)
    contrib = torch.where(keep[:, None], permute(tokens),
                          torch.zeros((), dtype=tokens.dtype,
                                      device=tokens.device))
    buf = torch.zeros((E * C + 1, d), dtype=tokens.dtype,
                      device=tokens.device).index_add(0, slot, contrib)
    return buf[:-1].reshape(E, C, d), slot, keep, order, tok_of


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
# Each is an autograd.Function: the forward is the plane's transfer, the
# backward the transpose jax.vjp takes through the reference's shard_map body
# (with replication checks off), a plane transfer too.
class _PlanePmean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, n_total, n_model):
        ctx.axes, ctx.n_total, ctx.n_model = axes, n_total, n_model
        return xdma.transfer(x, reduce_descriptor(axes, n_total)) / n_total

    @staticmethod
    def backward(ctx, g):
        # shard_map's transpose of an out spec P() divides the cotangent by
        # the mesh's size, and pmean's transpose is a pmean.  A rank's
        # cotangent here is its loss share's over the data axis and whole on
        # every model rank: the sum over the mesh counts it n_model times.
        g = xdma.transfer(g, reduce_descriptor(ctx.axes, ctx.n_total))
        return g / (ctx.n_total * ctx.n_model), None, None, None


def _pmean(x, axes, n_total: int, n_model: int):
    """pmean through the plane: a reduce-endpoint sum, then the local divide."""
    return _PlanePmean.apply(x, axes, n_total, n_model)


class _PlaneReduce(torch.autograd.Function):
    """psum over an axis as a ``reduce`` task; its transpose is a psum."""

    @staticmethod
    def forward(ctx, x, axis, n):
        ctx.desc = reduce_descriptor(axis, n)
        return xdma.transfer(x, ctx.desc)

    @staticmethod
    def backward(ctx, g):
        return xdma.transfer(g, ctx.desc), None, None


class _ReplicaMean(torch.autograd.Function):
    """The identity on an output replicated over the model axis; the
    gradient divided by the axis size, as ``shard_map``'s transpose divides
    the cotangent of an out spec that does not name the axis."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


@functools.lru_cache(maxsize=None)
def _a2a_desc(axis: str, split_axis: int, concat_axis: int) -> XDMADescriptor:
    return XDMADescriptor(dst=Endpoint.all_to_all(axis, split_axis=split_axis,
                                                  concat_axis=concat_axis))


def _amax_vjp(x, ds):
    """``x``'s gradient through ``Quantize``'s scales for their cotangent
    ``ds`` (one f32 a row), as ``jax.vjp`` takes it: each row's ``amax /
    127`` reaching its largest |x|, shared among ties."""
    xf = x.to(torch.float32)
    ax = xf.abs()
    amax = ax.amax(-1, keepdim=True)
    at = (ax == amax).to(torch.float32)
    damax = torch.where(amax > 0, ds / 127.0, torch.zeros_like(ds))
    return (torch.sign(xf) * at * (damax / at.sum(-1, keepdim=True))
            ).to(x.dtype)


def _row_dot(q, g):
    """``sum(q * g)`` over each row, in f32, as (..., 1)."""
    return (q.to(torch.float32) * g.to(torch.float32)).sum(-1, keepdim=True)


def _scales_vjp(y, g):
    """The cotangent of the scales the int8 wire delivered, on the side that
    dequantized them into ``y``: ``sum(q * g)`` over each row (the int8
    values ``q`` carry none).  ``q`` is recovered from ``y``: a row with a
    nonzero scale ``s`` holds a value of +-127 (its amax), so ``|y|``'s row
    maximum is ``127 s`` rounded as ``y`` is, and ``round(127 y / max|y|)``
    is ``q``: in bf16 each of the two is off by at most 2^-9 relative, which
    moves the quotient by at most 127 * 2^-8 < 0.497; in f16 and f32 (in
    their normal range) by less."""
    yf = y.to(torch.float32)
    top = yf.abs().amax(-1, keepdim=True)
    q = torch.where(top > 0, torch.round(yf * 127.0 / top),
                    torch.zeros_like(yf))
    return _row_dot(q, g)


def _quantize_vjp(x, g):
    """The plain version of the int8 wire's backward: ``x``'s gradient
    through ``Dequantize(Quantize(x))`` for the output's whole cotangent
    ``g``, moved back to the source side first (the bytes of ``g`` on the
    wire, where the kernel path moves one f32 a row)."""
    return _amax_vjp(x, _row_dot(XP.Quantize()(x).values, g))


class _PlaneA2A(torch.autograd.Function):
    """Task ``i`` of the dispatch queue, an all-to-all (split ``s``, concat
    ``c``).  The backward is the mirrored all-to-all (split ``c``, concat
    ``s``) of the cotangent; where the wire carries the int8 codec, of the
    scales' cotangent alone (:func:`_scales_vjp`, on this side, where the
    Dequantize ran), whose source side then takes the codec's own gradient
    (:func:`_amax_vjp`), as the reference's transpose does."""

    @staticmethod
    def forward(ctx, x, queue, i):
        desc = queue.descriptors[i]
        ep = desc.remote
        ctx.back = _a2a_desc(ep.axis, ep.concat_axis, ep.split_axis)
        ctx.wire = any(isinstance(pl, XP.Quantize) for pl in desc.pre)
        y = queue.run_task(x, i)
        if ctx.wire:
            ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        if not ctx.wire:
            return xdma.transfer(g.contiguous(), ctx.back), None, None
        x, y = ctx.saved_tensors
        ds = xdma.transfer(_scales_vjp(y, g.contiguous()), ctx.back)
        return _amax_vjp(x, ds), None, None


@functools.lru_cache(maxsize=None)
def _hop_desc(axis: str, n: int) -> XDMADescriptor:
    perm = tuple((i, (i + 1) % n) for i in range(n))
    return XDMADescriptor(dst=Endpoint.multicast_axis(axis, perm))


class _RingGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, n):
        ctx.axis, ctx.n = axis_name, n
        parts = [x]
        for _ in range(n - 1):
            parts.append(xdma.transfer(parts[-1], _hop_desc(axis_name, n)))
        stacked = torch.stack(parts)      # [j] = shard of rank (i - j) % n
        idx = S.axis_index(axis_name)
        order = torch.remainder(idx - torch.arange(n, device=x.device), n)
        ordered = stacked[order]          # [s] = shard of rank s
        B, Sl, d = x.shape
        return ordered.movedim(0, 1).reshape(B, n * Sl, d)

    @staticmethod
    def backward(ctx, g):
        # the output is replicated over the axis and its gradient whole on
        # every rank: this rank's slice takes its own block
        Sl = g.shape[1] // ctx.n
        r = S.axis_index(ctx.axis)
        return g[:, r * Sl:(r + 1) * Sl].contiguous(), None, None


def _ring_all_gather(x, axis_name: str, n: int):
    """``lax.all_gather(x, axis, axis=1, tiled=True)`` as n-1 rotating
    one-hop broadcasts (``multicast_axis`` transfers), each recorded as a
    ``multicast`` endpoint in the capture ledger.

    ``x`` is ``(B, S_local, d)``; returns ``(B, n * S_local, d)`` ordered by
    source rank, exactly like the tiled all-gather it replaces.  The
    gradient is this rank's block of the output's.
    """
    if n == 1:
        return x
    return _RingGather.apply(x, axis_name, n)


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
            buf = _PlaneA2A.apply(buf, queue, 0)
        out = _expert_ffn(cfg, p, buf)
        if queue is not None:
            out = _PlaneA2A.apply(out, queue, 1)
    y = _combine(cfg, out, slot, keep, order, gates, T, d)
    return y, aux


def _expert_ffn_tp(cfg, p, buf, model_axis, n_model):
    """TP experts: d_ff sharded over the model axis; the per-layer all-reduce
    is a ``reduce``-endpoint XDMA task (the plane's spelling of psum)."""
    return _PlaneReduce.apply(_expert_ffn(cfg, p, buf), model_axis, n_model)


def ep_enabled(cfg, n_model: int) -> bool:
    return cfg.n_experts % n_model == 0


def _block(w, dim: int, n: int, r: int, whole: int):
    """Block ``r`` of ``n`` of ``w`` along ``dim`` (a ``P`` spec's slice);
    ``w`` itself where it is the block already (not ``whole`` long there)."""
    if w.shape[dim] != whole:
        return w
    size = whole // n
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
    :func:`_moe_tokens`); pass a fresh one per call.  It has no backward.
    """
    B, Sq, d = x.shape
    axes = cfg.axes
    if axes.model is None or mesh is None:
        y, aux = _moe_tokens(cfg, p, x.reshape(-1, d), model_axis=None,
                             n_model=1)
        return y.reshape(B, Sq, d), aux

    m = axes.model
    n_model = S.axis_size(m)
    r = S.axis_index(m)
    all_axes = tuple(mesh.axis_names)
    n_total = int(mesh.world_size)
    wire = (XP.Quantize(),) if getattr(cfg, "moe_wire_int8", False) else ()
    use_ep = ep_enabled(cfg, n_model) and Sq % n_model == 0 and Sq >= n_model
    tp_ok = cfg.d_ff_expert % n_model == 0
    E, f = cfg.n_experts, cfg.d_ff_expert

    # shard_map's in specs: the router replicated (its gradient summed over
    # the axis), the experts by expert, by d_ff, or replicated
    pl = {"router": S.copy_to_axis(p["router"], m)}
    if ep_enabled(cfg, n_model):
        pl.update({w: _block(p[w], 0, n_model, r, E)
                   for w in ("w_gate", "w_up", "w_down")})
    elif tp_ok:
        pl.update(w_gate=_block(p["w_gate"], 2, n_model, r, f),
                  w_up=_block(p["w_up"], 2, n_model, r, f),
                  w_down=_block(p["w_down"], 1, n_model, r, f))
    else:
        pl.update({w: S.copy_to_axis(p[w], m)
                   for w in ("w_gate", "w_up", "w_down")})

    if use_ep:
        # split the sequence across model ranks
        Sl = Sq // n_model
        xs = S.split_along(x, m, 1)
        y, aux = _moe_tokens(cfg, pl, xs.reshape(-1, d), model_axis=m,
                             n_model=n_model, wire_plugins=wire,
                             scheduler=scheduler,
                             overlap_chunks=overlap_chunks)
        y = _ring_all_gather(y.reshape(B, Sl, d), m, n_model)
    elif ep_enabled(cfg, n_model):
        # decode-scale EP: every model rank routes the full block (identical
        # dispatch); the a2a moves only the (E, C, d) token buffer, never the
        # expert weights
        y, aux = _moe_tokens(cfg, pl, S.copy_to_axis(x, m).reshape(-1, d),
                             model_axis=m, n_model=n_model,
                             wire_plugins=wire, scheduler=scheduler,
                             overlap_chunks=overlap_chunks)
        y = _ReplicaMean.apply(y.reshape(x.shape), n_model)
    else:
        tokens = S.copy_to_axis(x, m).reshape(-1, d)
        gates, eidx, aux = _route(cfg, pl["router"], tokens)
        T = tokens.shape[0]
        buf, slot, keep, order, _ = _dispatch(cfg, tokens, eidx, gates,
                                              _capacity(cfg, T))
        if tp_ok:
            out = _expert_ffn_tp(cfg, pl, buf, m, n_model)
        else:
            out = _expert_ffn(cfg, pl, buf)    # replicated experts (fallback)
        y = _combine(cfg, out, slot, keep, order, gates, T, d)
        y = _ReplicaMean.apply(y.reshape(x.shape), n_model)
    aux = _pmean(aux, all_axes, n_total, n_model)
    return y, aux
