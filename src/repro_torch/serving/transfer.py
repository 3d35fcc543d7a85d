"""XDMA KV-cache movement — the paper's §III-C workloads on live caches
(PyTorch port).

The twin of ``repro.serving.transfer``.  *Prefill store*: KV rows are
RMSNormed while they are relaid into the tiled layout, one fused stream
(kernel 2 on the card).  *Load*: the cache is streamed back transposed
for the q.K^T access pattern, one pass (kernel 3).  *Cross-stage
transfer*: the cache moves from a prefill rank to a decode rank through an
XDMA tunnel (a ``peer`` endpoint) with the relayout fused on the wire.

Every movement goes through :func:`repro_torch.core.api.transfer`: each
workload is one descriptor built once per call signature (the CFG phase),
and the store+load round trip is also an
:class:`~repro_torch.core.api.XDMAQueue` (:func:`kv_roundtrip_queue`).
:func:`kv_roundtrips_overlapped` puts stores on a topology's ``h2d`` link
and loads on its ``d2h`` link, so shard i+1's store overlaps shard i's
load.  The multicast fan-outs (:func:`replica_weight_broadcast`,
:func:`prefix_cache_fanout`) ride ``DistributedScheduler.submit_multicast``.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import _pytree
from repro_torch.core import (MN, Endpoint, RMSNormPlugin, Transpose,
                              XDMAQueue, autotune, describe, layout_for_dtype,
                              tiled_layout, xdma, xdma_copy)
from repro_torch.core.layouts import dtype_info

__all__ = ["kv_prefill_store", "kv_load_transposed", "kv_roundtrip_queue",
           "kv_plane_descs", "kv_cache_roundtrip", "kv_roundtrips_overlapped",
           "replica_weight_broadcast", "prefix_cache_fanout",
           "cross_stage_transfer"]


def _name(dtype) -> str:
    return dtype_info(dtype)[1]


def _as_matrix(kv: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """(B, S, KV, hd) -> (B, S, KV*hd): the paper's (seq x d_kv) KV matrix."""
    B, S, KV, hd = kv.shape
    return kv.reshape(B, S, KV * hd), (B, S, KV, hd)


@functools.lru_cache(maxsize=None)
def _store_desc(dtype_name: str, d_buf: int, eps: float):
    return describe(MN, layout_for_dtype(dtype_name), RMSNormPlugin(eps=eps),
                    d_buf=d_buf)


def kv_prefill_store(kv: torch.Tensor, *, norm_weight=None, d_buf: int = 9,
                     eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm-on-stream + tile: (B,S,KV,hd) -> (B, S/tm, d/128, tm, 128)."""
    mat, _ = _as_matrix(kv)
    if norm_weight is None:
        return xdma.transfer(mat, _store_desc(_name(mat.dtype), d_buf, eps))
    # a weight makes the descriptor identity-cached: a per-call descriptor
    # would grow the CFG cache without bound, so run the engine directly
    desc = describe(MN, layout_for_dtype(mat.dtype),
                    RMSNormPlugin(eps=eps, weight=norm_weight), d_buf=d_buf)
    return xdma_copy(mat, desc)


@functools.lru_cache(maxsize=None)
def _load_desc(tm: int, tn: int, d_buf: int):
    return describe(tiled_layout(tm, tn), MN, Transpose(), d_buf=d_buf)


def kv_load_transposed(tiled: torch.Tensor, *, d_buf: int = 9) -> torch.Tensor:
    """Stream the tiled cache back as K^T (d_kv, S) matrices, transpose fused."""
    tm, tn = tiled.shape[-2], tiled.shape[-1]
    return xdma.transfer(tiled, _load_desc(tm, tn, d_buf))


def kv_roundtrip_queue(dtype=torch.float32, *, d_buf: int = 9,
                       eps: float = 1e-6) -> XDMAQueue:
    """Store-then-load as one in-order task queue: norm+tile on the way in,
    transpose+untile on the way out."""
    tiled = layout_for_dtype(dtype)
    tm, tn = tiled.tile
    return XDMAQueue([
        _store_desc(_name(dtype), d_buf, eps),
        _load_desc(tm, tn, d_buf),
    ], name="kv_roundtrip")


# -- live-cache streaming: the serving engine's per-step KV movement ---------
@functools.lru_cache(maxsize=None)
def kv_plane_descs(S: int, d: int, dtype_name: str):
    """Value-preserving store/load descriptor pair for streaming a live cache
    shard through the plane: the tiled relayout round trip when the shard
    is tile-aligned (an exact inverse pair), a plain copy otherwise."""
    tiled = autotune.best_layout((int(S), int(d)), dtype_name,
                                 candidates=(layout_for_dtype(dtype_name),))
    if tiled is not None:
        return describe(MN, tiled, d_buf=9), describe(tiled, MN, d_buf=9)
    return describe(MN, MN), describe(MN, MN)


def kv_cache_roundtrip(leaf: torch.Tensor, *, scheduler, lane: int = 0,
                       label: str = "kv"):
    """Submit one cache tensor's store+load round trip onto the scheduler's
    fabric: the store on link-pair ``lane``'s first link (h2d), the load on
    its second (d2h), per-shard order kept by the future dependency.
    Returns the load future; ``result()`` is the (matrix-shaped) leaf,
    bit-equal to the input."""
    names = scheduler.topology.link_names
    if leaf.ndim >= 3:
        mat = leaf.reshape(-1, leaf.shape[-2] * leaf.shape[-1])
    else:
        mat = leaf
    store, load = kv_plane_descs(int(mat.shape[-2]), int(mat.shape[-1]),
                                 _name(mat.dtype))
    n_pairs = max(1, len(names) // 2)
    si = (2 * (lane % n_pairs)) % len(names)
    li = (si + 1) % len(names)
    f_store = scheduler.submit(mat, store, link=names[si],
                               label=f"{label}:store")
    return scheduler.submit(f_store, load, link=names[li],
                            label=f"{label}:load")


# -- distributed runtime: store/load overlapped across links -----------------
def kv_roundtrips_overlapped(kvs: Sequence[torch.Tensor], *, scheduler=None,
                             d_buf: int = 9, eps: float = 1e-6):
    """Store+load every (B, S, KV, hd) KV shard, stores on the first link
    and loads on the second, so the store of shard i+1 overlaps the load of
    shard i.  Returns ``(outs, scheduler)``; each out is bit-identical to
    ``kv_load_transposed(kv_prefill_store(kv))``."""
    from repro_torch.runtime import DistributedScheduler, Topology

    if scheduler is None:
        scheduler = DistributedScheduler(Topology.host_device(1),
                                         name="kv_roundtrip")
    names = scheduler.topology.link_names
    store_link, load_link = names[0], names[1 % len(names)]
    futures = []
    for kv in kvs:
        mat, _ = _as_matrix(kv)
        desc_s = _store_desc(_name(mat.dtype), d_buf, eps)
        f_store = scheduler.submit(mat, desc_s, link=store_link,
                                   label="kv_store")
        tile = layout_for_dtype(mat.dtype).tile
        f_load = scheduler.submit(f_store, _load_desc(tile[0], tile[1], d_buf),
                                  link=load_link, label="kv_load")
        futures.append(f_load)
    scheduler.flush()
    return [f.result() for f in futures], scheduler


# -- multicast fan-out: weights and shared prefixes to many replicas --------
@functools.lru_cache(maxsize=None)
def _fanout_desc(dsts: Tuple, layout):
    return describe(Endpoint.local(MN), Endpoint.multicast(dsts, layout))


def replica_weight_broadcast(params, *, scheduler, src: Optional[str] = None,
                             replicas: Optional[Sequence[str]] = None,
                             label: str = "weights"):
    """Distribute one parameter tree to every serving replica through the
    multicast plane: one tree-routed descriptor per weight matrix, so a link
    feeding several replicas carries each matrix once.  ``src`` defaults to
    the fabric's first node, ``replicas`` to every other node.  Returns
    ``{replica: params}``, each matrix leaf bit-identical to the source;
    leaves of rank < 2 are shared as they are."""
    topo = scheduler.topology
    nodes = list(topo.nodes)
    if src is None:
        src = nodes[0]
    if replicas is None:
        replicas = [n for n in nodes if n != src]
    replicas = list(replicas)
    leaves = _pytree.leaves(params)
    futs = {}
    for i, leaf in enumerate(leaves):
        if getattr(leaf, "ndim", 0) < 2:
            continue
        mat = leaf if leaf.ndim == 2 else leaf.reshape(-1, leaf.shape[-1])
        futs[i] = scheduler.submit_multicast(
            mat, _fanout_desc(tuple(replicas), MN), src=src,
            label=f"{label}[{i}]")
    scheduler.flush()
    out = {}
    for node in replicas:
        rleaves = list(leaves)
        for i, f in futs.items():
            rleaves[i] = f.result_at(node).reshape(leaves[i].shape)
        out[node] = _pytree.unflatten(params, rleaves)
    return out


def prefix_cache_fanout(pages: torch.Tensor, *, scheduler,
                        src: Optional[str] = None,
                        dsts: Optional[Sequence[str]] = None,
                        layout="auto", label: str = "prefix"):
    """Fan one shared prompt prefix's KV pages out to every decode replica as
    one multicast tree; each destination's ``"auto"`` layout resolves
    against its own delivery link.  Returns the
    :class:`~repro_torch.runtime.MulticastFuture`."""
    topo = scheduler.topology
    nodes = list(topo.nodes)
    if src is None:
        src = nodes[0]
    if dsts is None:
        dsts = [n for n in nodes if n != src]
    mat = pages if pages.ndim == 2 else pages.reshape(-1, pages.shape[-1])
    desc = _fanout_desc(tuple(dsts), layout)
    fut = scheduler.submit_multicast(mat, desc, src=src, label=label)
    scheduler.flush()
    return fut


@functools.lru_cache(maxsize=None)
def _tunnel_desc(axis_name: str, perm: Tuple[Tuple[int, int], ...],
                 transpose: bool, d_buf: int):
    pre = (Transpose(),) if transpose else ()
    return describe(Endpoint.local(MN), Endpoint.peer(axis_name, perm, MN),
                    pre=pre, d_buf=d_buf)


def cross_stage_transfer(kv: torch.Tensor, axis_name: str,
                         perm: Sequence[Tuple[int, int]], *,
                         transpose: bool = False, d_buf: int = 9):
    """Move a cache shard prefill-rank -> decode-rank through one XDMA
    tunnel, optionally transposing in flight.  Call in every rank of an
    SPMD body whose mesh registers ``axis_name``."""
    mat, orig = _as_matrix(kv)
    desc = _tunnel_desc(axis_name, tuple(tuple(p) for p in perm),
                        bool(transpose), d_buf)
    out = xdma.transfer(mat, desc)
    if transpose:
        return out                                      # (B, d_kv, S)
    return out.reshape(orig)
