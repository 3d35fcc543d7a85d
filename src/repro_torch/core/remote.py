"""XDMA remote engine: cross-rank transfers with in-flight transformation
(PyTorch port).

The twin of ``repro.core.remote``.  Paper §II-A: two half-XDMAs coordinate
through a CFG phase (the descriptor forwarded to the remote side) and a
Data phase (the link carries only payload).  Here the CFG phase is the
lowering cached per descriptor in every rank (SPMD: every rank lowers the
same descriptor), and the Data phase is one ``torch.distributed``
collective per payload leaf.

This module is a lowering backend of :func:`repro_torch.core.api.transfer`
for the remote endpoint kinds.  Every function here runs inside an SPMD
body, one call per rank, with ``axis_name`` naming a mesh axis registered
in :mod:`repro_torch.sharding` (a process group):

* :func:`xdma_ppermute`   — point-to-point tunnel, one ``all_to_all_single``
  with one non-empty split per sending rank (a rank no pair sends to gets
  zeros, as ``lax.ppermute`` gives);
* :func:`xdma_all_to_all` — the MoE-dispatch pattern (``tiled=True``);
* :func:`xdma_psum`       — the plain all-reduce of a ``reduce`` endpoint;
* :func:`compressed_psum` — all-reduce with an int8 wire: Quantize before a
  reduce-scatter, a local f32 sum of the dequantized shards in rank order
  (fused multiply-adds, as the reference's jitted program computes it),
  re-Quantize, all-gather.

Pre-writer plugins run before the collective, post-reader plugins after it,
on the device of the payload.  A ``QTensor`` / ``CTensor`` payload crosses
as one collective per leaf, values first.  Non-reducing collectives move
the payload as bytes, so any dtype crosses gloo and NCCL alike.

**The host hop.**  Gloo works on host memory; where a gloo group gets a
CUDA tensor, this module copies it to the host and back itself, and counts
the bytes of both copies in the ``wire`` telemetry bank
(``host_hop_bytes``), beside each collective's calls and payload bytes by
op and backend.  NCCL moves CUDA tensors in place; a size-1 local axis
(:func:`repro_torch.sharding.local_axis`) moves nothing, and an axis of a
:func:`repro_torch.sharding.meta_mesh` counts and moves nothing.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch import sharding as S
from repro_torch.launch import op_cost
from repro_torch.runtime import telemetry as _tm

from . import plugins as P

__all__ = [
    "xdma_ppermute",
    "xdma_all_to_all",
    "xdma_psum",
    "compressed_psum",
    "compressed_psum_with_feedback",
    "wire_stats",
]

_BANK = _tm.bank("wire")


def wire_stats():
    """This rank's wire counters: ``calls:<op>``, ``bytes:<op>`` (payload
    this rank handed the collective), ``backend:<name>`` (calls by backend)
    and ``host_hop_bytes`` (device <-> host copies of gloo on CUDA)."""
    return _BANK.as_dict()


# -- the collectives, on one mesh axis -------------------------------------------
def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    return b.view(dtype).reshape(shape)


def _count(op: str, ax: S.MeshAxis, nbytes: int) -> None:
    _BANK.inc(f"calls:{op}")
    _BANK.inc(f"backend:{ax.backend}")
    _BANK.inc(f"bytes:{op}", int(nbytes))


@op_cost.one_op
def _exchange(flat: torch.Tensor, send, recv, ax: S.MeshAxis) -> torch.Tensor:
    """``all_to_all_single`` of a byte vector: its first ``send[j]`` bytes
    after those for lower ranks to rank ``j`` of the axis, ``recv[j]`` from
    it, concatenated in rank order."""
    flat = flat[:sum(send)]
    _count("all_to_all", ax, flat.numel())
    if S.on_meta(ax, flat):
        return flat.new_empty(sum(recv))
    if ax.group is None:                 # size-1 axis: the bytes stay
        return flat[:recv[0]].clone()
    import torch.distributed as dist
    wire = S.HostHop(ax, flat.device, _BANK)
    src = wire.out(flat)
    out = torch.empty(sum(recv), dtype=torch.uint8, device=src.device)
    dist.all_to_all_single(out, src, list(recv), list(send), group=ax.group)
    return wire.back(out)


@op_cost.one_op
def _all_reduce(t: torch.Tensor, ax: S.MeshAxis) -> torch.Tensor:
    _count("all_reduce", ax, t.numel() * t.element_size())
    if S.on_meta(ax, t):
        return torch.empty_like(t)
    if ax.group is None:
        return t.clone()
    import torch.distributed as dist
    wire = S.HostHop(ax, t.device, _BANK)
    y = wire.out(t)
    y = y.clone() if y is t else y          # all_reduce writes in place
    dist.all_reduce(y, dist.ReduceOp.SUM, group=ax.group)
    return wire.back(y)


@op_cost.one_op
def _all_gather(t: torch.Tensor, ax: S.MeshAxis) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: the ranks' tensors concatenated
    along dim 0 in rank order."""
    b = _as_bytes(t)
    _count("all_gather", ax, b.numel())
    if S.on_meta(ax, t):
        return t.new_empty((ax.size * t.shape[0],) + tuple(t.shape[1:]))
    if ax.group is None:
        return t.clone()
    import torch.distributed as dist
    wire = S.HostHop(ax, t.device, _BANK)
    src = wire.out(b)
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(parts, src, group=ax.group)
    out = wire.back(torch.cat(parts))
    return _from_bytes(out, t.dtype, (ax.size * t.shape[0],) + tuple(t.shape[1:]))


def _ppermute_leaf(x: torch.Tensor, ax: S.MeshAxis,
                   perm: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    me, n = ax.index, ax.size
    b = _as_bytes(x)
    send, recv = [0] * n, [0] * n
    for s, d in perm:
        if s == me:
            send[d] = b.numel()
        if d == me:
            recv[s] = b.numel()
    out = _exchange(b, send, recv, ax)
    if not any(recv):
        return torch.zeros_like(x)
    return _from_bytes(out, x.dtype, x.shape)


def _all_to_all_leaf(x: torch.Tensor, ax: S.MeshAxis, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    n = ax.size
    sa, ca = split_axis % x.ndim, concat_axis % x.ndim
    if x.shape[sa] % n:
        raise ValueError(f"all_to_all: split axis {split_axis} of size "
                         f"{x.shape[sa]} does not divide into {n} ranks")
    shape = tuple(x.shape)
    chunk = shape[:sa] + (shape[sa] // n,) + shape[sa + 1:]
    xs = x.reshape(shape[:sa] + (n, shape[sa] // n) + shape[sa + 1:])
    xs = xs.movedim(sa, 0)
    b = _as_bytes(xs)
    per = b.numel() // n
    out = _exchange(b, [per] * n, [per] * n, ax)
    y = _from_bytes(out, x.dtype, (n,) + chunk).movedim(0, ca)
    return y.reshape(chunk[:ca] + (n * chunk[ca],) + chunk[ca + 1:])


def _check_perm(perm, n: int) -> Tuple[Tuple[int, int], ...]:
    perm = tuple((int(s), int(d)) for s, d in perm)
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute: {perm} sends from or to a rank twice")
    if any(not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: {perm} names a rank outside 0..{n - 1}")
    return perm


def _map_payload(fn, y):
    """``fn`` on each leaf of a payload, values first (a QTensor's scales,
    a CTensor's mask after)."""
    if isinstance(y, P.QTensor):
        return P.QTensor(values=fn(y.values), scales=fn(y.scales))
    if isinstance(y, P.CTensor):
        return P.CTensor(values=fn(y.values), mask=fn(y.mask))
    return fn(y)


# -- the movement-plane backends ---------------------------------------------------
def xdma_psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Uncompressed all-reduce rendezvous (the plain lowering of a
    ``reduce`` endpoint)."""
    ax = S.mesh_axis(axis_name)
    return _map_payload(lambda t: _all_reduce(t, ax), x)


def xdma_ppermute(x, axis_name, perm: Sequence[Tuple[int, int]],
                  pre: Sequence[P.Plugin] = (),
                  post: Sequence[P.Plugin] = ()):
    """One virtual tunnel between rank pairs, plugins fused into the move."""
    ax = S.mesh_axis(axis_name)
    perm = _check_perm(perm, ax.size)
    y = P.apply_chain(pre, x)
    y = _map_payload(lambda t: _ppermute_leaf(t, ax, perm), y)
    return P.apply_chain(post, y)


def xdma_all_to_all(x, axis_name, *, split_axis: int, concat_axis: int,
                    pre: Sequence[P.Plugin] = (),
                    post: Sequence[P.Plugin] = ()):
    """All-to-all with in-flight transforms (the MoE dispatch/return pattern)."""
    ax = S.mesh_axis(axis_name)
    y = P.apply_chain(pre, x)
    y = _map_payload(
        lambda t: _all_to_all_leaf(t, ax, split_axis, concat_axis), y)
    return P.apply_chain(post, y)


def _pad_to(x: torch.Tensor, mult: int) -> Tuple[torch.Tensor, int]:
    n = x.shape[0]
    pad = (-n) % mult
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))], 0)
    return x, pad


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as a fused multiply-add rounds it.
    ``a`` holds int8 values and ``b`` f32 scales, so their product is exact
    in float64, and so is the sum unless ``c`` and the product are more than
    2^29 apart (then a tie may round twice)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _dequant_sum(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``dequant(values, scales).sum(0)`` as the reference's jitted program
    computes it: XLA fuses the dequantize into the sum and contracts each
    step into a fused multiply-add, in rank order from 0."""
    acc = torch.zeros(values.shape[1:], dtype=torch.float32,
                      device=values.device)
    for j in range(values.shape[0]):
        acc = _fma(values[j], scales[j], acc)
    return acc


def compressed_psum(x: torch.Tensor, axis_name, axis_size: int,
                    out_dtype=torch.float32) -> torch.Tensor:
    """All-reduce with int8 wire traffic (about 4x fewer link bytes than f32).

    Reduce-scatter (an all-to-all of Quantized shards, a local f32 sum of
    the dequantized shards in rank order) then an all-gather of the
    re-Quantized partials: both wire phases carry int8 values plus one f32
    scale per 128-lane row.  Bitwise the reference's jitted program."""
    ax = S.mesh_axis(axis_name)
    if ax.size != int(axis_size):
        raise ValueError(f"compressed_psum: axis {axis_name!r} has "
                         f"{ax.size} ranks, not axis_size={axis_size}")
    quant, dequant = P.Quantize(), P.Dequantize(torch.float32)
    shape = tuple(x.shape)
    flat, pad = _pad_to(x.reshape(-1), axis_size * 128)
    rows = flat.reshape(axis_size, -1, 128)           # (shard, row, lane)

    # phase 1: reduce-scatter with a quantized payload
    q = quant(rows)
    qv = _all_to_all_leaf(q.values, ax, 0, 0)
    qs = _all_to_all_leaf(q.scales, ax, 0, 0)
    partial = _dequant_sum(qv, qs)

    # phase 2: all-gather of the re-quantized partials
    q2 = quant(partial)
    gv = _all_gather(q2.values, ax)
    gs = _all_gather(q2.scales, ax)
    full = dequant(P.QTensor(gv, gs))

    out = full.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(shape).to(out_dtype)


def compressed_psum_with_feedback(x: torch.Tensor, err: torch.Tensor,
                                  axis_name, axis_size: int):
    """Error-feedback variant: the quantization residual of this rank's own
    contribution is carried to the next step (EF-SGD), with no extra wire
    bytes.  Returns ``(reduced, new_err)``.  On an f32 stream the residual
    ``x - dequant(quant(x))`` is one fused multiply-add, as XLA contracts
    it in the reference's jitted program."""
    corrected = x + err
    reduced = compressed_psum(corrected, axis_name, axis_size,
                              out_dtype=x.dtype)
    flat = corrected.reshape(-1)
    flat_p, pad = _pad_to(flat, 128)
    q = P.Quantize()(flat_p.reshape(-1, 128))
    n = flat.shape[0]
    if x.dtype == torch.float32:
        new_err = _fma(-q.values, q.scales, flat_p.reshape(-1, 128))
        new_err = new_err.reshape(-1)[:n]
    else:
        local_c = P.Dequantize(torch.float32)(q).reshape(-1)[:n]
        new_err = flat - local_c.to(x.dtype)
    return reduced, new_err.reshape(x.shape)
