"""Cost-model-driven layout autotuning: `auto` layouts searched per fabric.

The port's twin of ``repro.core.autotune``: the candidate space, its order
and every cost are the reference's, float for float (a tie goes to the
first candidate, so the order is part of the contract).  Dtypes may be
torch dtypes or the reference's dtype names; :func:`~repro_torch.core
.layouts.dtype_info` spells cache keys as the reference spells them.

The paper's result is that hardware address generation plus the *right data
layout* unlocks link utilization; PR 4 built the two halves needed to choose
layouts automatically — :func:`~repro_torch.core.layouts.relayout_pair` (burst
analysis of a movement) and :meth:`~repro_torch.runtime.topology.Link.transfer_time`
(what a burst costs on a given fabric).  Following Iris (automatic layout
generation for bandwidth utilization) and DataMaestro (configurable access
patterns), this module closes the loop (DESIGN.md §13):

* :func:`best_layout` — enumerate granule-aligned candidates for one side of
  a movement (the tile lattice of VREG-multiple ``(tm, tn)`` pairs, rank-3
  ``(tb, tm, tn)`` tiles for batched KV/MoE buffers, trailing-dim
  permutations, pad-to-granule strides, every named layout), build each
  candidate's pattern pair against the fixed far side, and score it with the
  link cost model.  Exact search when the candidate set fits the budget;
  beam search over the tile lattice otherwise.
* :func:`resolve_descriptor` — the ``"auto"`` layout spelling: a descriptor
  whose endpoint layout is :data:`~repro_torch.core.layouts.AUTO` gets the tuned
  concrete layout substituted before lowering.  ``xdma.transfer``,
  ``XDMAQueue`` and ``DistributedScheduler`` all resolve through here (the
  scheduler threads the *routed link* in, so the same descriptor tunes
  differently on a host_device fabric than on a ring).
* a bounded LRU keyed on ``(shape, dtype, fabric fingerprint, movement
  signature)`` registered next to the CFG cache (``xdma.clear_cache()``
  drops it too), plus an ``autotune`` telemetry counter bank surfaced by
  :func:`repro_torch.runtime.telemetry.snapshot`.

Scoring refines ``Link.transfer_time`` to be *burst-granular*: each of the
pattern's ``n_bursts`` runs is rounded up to whole beats individually, so a
fabric's beat width genuinely changes candidate ranking (a 96-byte run costs
two beats on a 64-byte link but one on a 96-byte link).  When every burst is
beat-aligned the two models agree exactly — which keeps the
:func:`~repro_torch.core.descriptor.page_layout` picks (all beat-aligned)
bit-identical to the historical strict-max-burst rule.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime import telemetry as _tm
from repro_torch.runtime.topology import Link

from . import layouts as L
from . import plugins as P
from .descriptor import XDMADescriptor

__all__ = ["Movement", "AutotuneResult", "movement_cost", "candidate_layouts",
           "layout_cost", "autotune", "best_layout", "resolve_descriptor",
           "fabric_fingerprint", "clear_cache", "cache_stats",
           "autotune_stats", "DEFAULT_LINK"]

# The fabric assumed when no link is threaded in: one ICI-class link with the
# simulator's defaults (100 GB/s, 1 us, 64 B beats, 50 ns burst issue).
DEFAULT_LINK = Link("autotune-default", "src", "dst")

MAX_TM = 256            # row-tile cap (VMEM panel budget)
MAX_TN = 512            # lane-tile cap
MAX_TB = 8              # rank-3 batch-tile cap
SEARCH_BUDGET = 64      # exact search when the candidate set fits
BEAM_WIDTH = 8          # lattice frontier kept per expansion round

_BANK = _tm.bank("autotune")


@dataclasses.dataclass(frozen=True)
class Movement:
    """One scored movement: the tuned layout on ``side``, ``other`` fixed on
    the far side, optionally a logical transpose, weighted in the total."""

    other: L.Layout
    side: str = "dst"               # which side is being tuned
    transpose: bool = False
    weight: float = 1.0

    def __post_init__(self):
        if self.side not in ("src", "dst"):
            raise ValueError(f"side must be 'src' or 'dst', got {self.side!r}")


@dataclasses.dataclass(frozen=True)
class AutotuneResult:
    """One memoized search outcome.  ``layout`` is None when no candidate was
    feasible for the shape (callers fall back to ``MN``); ``default_cost`` is
    the ``MN`` pick's score under the same movements (inf when infeasible)."""

    layout: Optional[L.Layout]
    cost: float
    default_cost: float
    scored: int
    pruned: int


def fabric_fingerprint(
        link: Optional[Link]) -> Tuple[float, float, int, float, float]:
    """The cost-model-relevant identity of a link (cache-key component).
    Includes ``csr_write_cost``: two fabrics differing only in doorbell
    price must not share cache entries once multicast forks pay one CSR
    write per tree hop."""
    l = link or DEFAULT_LINK
    return (l.bandwidth, l.latency, l.width, l.burst_overhead,
            l.csr_write_cost)


def movement_cost(link: Link, nbytes: int, burst_bytes: int, *,
                  d_buf: int = 9,
                  issue_overhead: Optional[float] = None) -> float:
    """Burst-granular transfer cost: every burst is rounded up to whole beats
    individually (``Link.transfer_time`` rounds the total payload instead).
    Equal to ``transfer_time`` when bursts are beat-aligned and tile the
    payload exactly; strictly more sensitive to beat width otherwise."""
    if nbytes <= 0:
        return link.latency
    burst_bytes = max(1, int(burst_bytes))
    n_bursts = -(-int(nbytes) // burst_bytes)
    beats = -(-burst_bytes // link.width)
    ov = link.burst_overhead if issue_overhead is None else float(issue_overhead)
    return (link.latency
            + n_bursts * beats * link.width / link.bandwidth
            + n_bursts * ov / max(1, int(d_buf)))


def layout_cost(cand: L.Layout, shape: Sequence[int], dtype,
                movements: Sequence[Movement], link: Link,
                d_buf: int = 9) -> float:
    """Weighted cost of ``cand`` across ``movements`` (inf when infeasible:
    tile doesn't divide the shape, or the two walk nests don't compose)."""
    shape = tuple(int(s) for s in shape)
    itemsize, _ = L.dtype_info(dtype)
    nbytes = math.prod(shape) * itemsize
    total = 0.0
    for m in movements:
        try:
            if m.side == "dst":
                pair = L.relayout_pair(m.other, cand, shape,
                                       transpose=m.transpose)
            else:
                pair = L.relayout_pair(cand, m.other, shape,
                                       transpose=m.transpose)
        except ValueError:
            return math.inf
        if pair is None:
            return math.inf
        total += m.weight * movement_cost(
            link, nbytes, pair.burst_length() * itemsize, d_buf=d_buf)
    return total


def _granule(itemsize: int) -> int:
    """VREG sublane granule per dtype width (f32 8, bf16 16, int8 32)."""
    return {4: 8, 2: 16, 1: 32}.get(itemsize, 8)


def _dim_tiles(n: int, step: int, cap: int) -> List[int]:
    return [t for t in range(step, min(n, cap) + 1, step) if n % t == 0]


def candidate_layouts(shape: Sequence[int], dtype, *,
                      tiled_only: bool = False) -> List[L.Layout]:
    """The full (un-beamed) candidate set for one side of a movement over a
    logical ``shape``: named layouts, pad-to-granule strides, and the whole
    tile lattice (use :func:`autotune` for the budgeted search)."""
    fixed, axes = _candidate_space(tuple(int(s) for s in shape),
                                   dtype, tiled_only)
    return fixed + [_lattice_layout(axes, idx)
                    for idx in _lattice_indices(axes)]


def _candidate_space(shape: Tuple[int, ...], dtype, tiled_only: bool):
    """-> (fixed candidates, tile-lattice axes).  The lattice is the cross
    product of per-dim tile-size lists (``axes``); rank-3 shapes get both the
    2D lattice over the trailing dims and a 3D lattice over (tb, tm, tn)."""
    itemsize, _ = L.dtype_info(dtype)
    g = _granule(itemsize)
    M, N = shape[-2], shape[-1]
    fixed: List[L.Layout] = []
    if not tiled_only:
        fixed += [L.MN, L.NM, L.MNP64]
        for q in (g, 128):              # pad-to-granule strides
            p = (-N) % q
            if p:
                fixed.append(L.Layout(None, f"MNP{p}", pad=(0, p)))
    native = L.layout_for_dtype(dtype)
    for lay in (native, L.MNM8N128, L.MNM16N128, L.MNM32N128, L.MNM8N8,
                L.NMM8N128, L.KV4M8N128):
        if lay not in fixed:
            fixed.append(lay)
    tms = _dim_tiles(M, g, MAX_TM)
    tns = _dim_tiles(N, 8, MAX_TN)
    axes: List[Tuple[List[int], ...]] = []
    if tms and tns:
        axes.append((tms, tns))
        if len(shape) >= 3:
            # tb == 1 is the 2D lattice again; only true batch tiles here
            tbs = [t for t in _dim_tiles(shape[-3], 1, MAX_TB) if t > 1]
            if tbs:
                axes.append((tbs, tms, tns))
    return fixed, axes


def _lattice_indices(axes) -> List[Tuple[int, Tuple[int, ...]]]:
    """Every lattice point as (axes-list index, per-dim tile indices)."""
    out = []
    for a, dims in enumerate(axes):
        for idx in _grid(tuple(len(d) for d in dims)):
            out.append((a, idx))
    return out


def _grid(extents: Tuple[int, ...]) -> List[Tuple[int, ...]]:
    pts: List[Tuple[int, ...]] = [()]
    for e in extents:
        pts = [p + (i,) for p in pts for i in range(e)]
    return pts


def _lattice_layout(axes, point) -> L.Layout:
    a, idx = point
    dims = axes[a]
    return L.tiled_layout(*(dims[d][i] for d, i in enumerate(idx)))


def _lattice_size(axes) -> int:
    return sum(math.prod(len(d) for d in dims) for dims in axes)


def _beam_points(axes, score, budget: int) -> Tuple[int, int]:
    """Beam search over the tile lattice: seed each sub-lattice's corners,
    expand the best :data:`BEAM_WIDTH` points one index step per dim, stop
    when a round improves nothing.  ``score(point)`` memoizes externally.
    Returns (points scored, points pruned)."""
    visited: Dict[Tuple[int, Tuple[int, ...]], float] = {}

    def visit(pt):
        if pt not in visited:
            visited[pt] = score(pt)
        return visited[pt]

    frontier: List[Tuple[int, Tuple[int, ...]]] = []
    for a, dims in enumerate(axes):
        ext = tuple(len(d) - 1 for d in dims)
        for corner in _grid(tuple(2 if e else 1 for e in ext)):
            frontier.append((a, tuple(e if c else 0
                                      for c, e in zip(corner, ext))))
    for pt in frontier:
        visit(pt)
    best = min(visited.values())
    while len(visited) < budget:
        ranked = sorted(visited, key=lambda p: (visited[p], p))[:BEAM_WIDTH]
        fresh = []
        for a, idx in ranked:
            ext = tuple(len(d) for d in axes[a])
            for d in range(len(idx)):
                for step in (-1, 1):
                    j = idx[d] + step
                    if 0 <= j < ext[d]:
                        nxt = (a, idx[:d] + (j,) + idx[d + 1:])
                        if nxt not in visited:
                            fresh.append(nxt)
        if not fresh:
            break
        for pt in fresh[:max(0, budget - len(visited))]:
            visit(pt)
        new_best = min(visited.values())
        if new_best >= best:
            break
        best = new_best
    return len(visited), _lattice_size(axes) - len(visited)


def _movements_key(movements: Sequence[Movement]):
    return tuple((m.other.name, m.side, m.transpose, m.weight)
                 for m in movements)


# -- the memo: bounded LRU next to the CFG cache -----------------------------
_CACHE: "collections.OrderedDict[tuple, AutotuneResult]" = \
    collections.OrderedDict()
_CACHE_CAPACITY = 1024


def clear_cache() -> None:
    """Drop every memoized search (also cleared by ``xdma.clear_cache()``)."""
    _CACHE.clear()
    _RESOLVED.clear()


def cache_stats() -> Dict[str, int]:
    return {"hits": _BANK.get("cache_hits"),
            "misses": _BANK.get("cache_misses"),
            "size": len(_CACHE)}


def autotune_stats() -> Dict[str, int]:
    """The ``autotune`` counter bank as a plain dict (plus live cache size):
    searches run, cache hits/misses, candidates scored, beam prunes, and how
    often the tuned pick strictly beat the ``MN`` default."""
    return {"searches": _BANK.get("searches"),
            "cache_hits": _BANK.get("cache_hits"),
            "cache_misses": _BANK.get("cache_misses"),
            "candidates_scored": _BANK.get("candidates_scored"),
            "beam_prunes": _BANK.get("beam_prunes"),
            "wins_vs_default": _BANK.get("wins_vs_default"),
            "resolved_descriptors": _BANK.get("resolved_descriptors"),
            "cache_size": len(_CACHE)}


def autotune(shape: Sequence[int], dtype, *,
             movements: Sequence[Movement] = (),
             link: Optional[Link] = None, d_buf: int = 9,
             candidates: Optional[Sequence[L.Layout]] = None,
             tiled_only: bool = False,
             budget: int = SEARCH_BUDGET) -> AutotuneResult:
    """Search the layout space for one side of a movement; memoized.

    ``movements`` defaults to a plain store (``MN`` fixed on the src side,
    the candidate on the dst).  ``candidates`` restricts the space to an
    explicit list (what :func:`~repro_torch.core.descriptor.page_layout` does to
    stay bit-identical); ``tiled_only`` restricts the generated space to
    tiled layouts (at-rest pools that must stay tile-addressable).
    """
    shape = tuple(int(s) for s in shape)
    _, dtype_name = L.dtype_info(dtype)
    if not movements:
        movements = (Movement(L.MN, "dst"),)
    movements = tuple(movements)
    link = link or DEFAULT_LINK
    key = (shape, dtype_name, fabric_fingerprint(link), int(d_buf),
           _movements_key(movements),
           tuple(c.name for c in candidates) if candidates is not None
           else None, bool(tiled_only))
    hit = _CACHE.get(key)
    if hit is not None:
        _BANK.inc("cache_hits")
        _CACHE.move_to_end(key)
        return hit
    _BANK.inc("cache_misses")
    _BANK.inc("searches")

    def score_of(lay: L.Layout) -> float:
        _BANK.inc("candidates_scored")
        return layout_cost(lay, shape, dtype, movements, link, d_buf)

    best_lay: Optional[L.Layout] = None
    best_cost = math.inf
    scored = 0
    pruned = 0

    # strict < keeps the earliest candidate on ties — named layouts are
    # enumerated first, so a generated tile only wins by a real margin
    def consider(lay: L.Layout, cost: float):
        nonlocal best_lay, best_cost
        if cost < best_cost:
            best_lay, best_cost = lay, cost

    if candidates is not None:
        for lay in candidates:
            consider(lay, score_of(lay))
            scored += 1
    else:
        fixed, axes = _candidate_space(shape, dtype, tiled_only)
        for lay in fixed:
            consider(lay, score_of(lay))
            scored += 1
        lattice_total = _lattice_size(axes)
        if lattice_total and scored + lattice_total <= budget:
            for pt in _lattice_indices(axes):
                lay = _lattice_layout(axes, pt)
                consider(lay, score_of(lay))
            scored += lattice_total
        elif lattice_total:
            def pt_score(pt):
                lay = _lattice_layout(axes, pt)
                c = score_of(lay)
                consider(lay, c)
                return c

            visited, beam_pruned = _beam_points(
                axes, pt_score, max(BEAM_WIDTH, budget - scored))
            scored += visited
            pruned += beam_pruned
            _BANK.inc("beam_prunes", beam_pruned)

    default_cost = layout_cost(L.MN, shape, dtype, movements, link, d_buf)
    if best_lay is not None and best_lay is not L.MN and best_cost < default_cost:
        _BANK.inc("wins_vs_default")
    if math.isinf(best_cost):
        best_lay = None
    result = AutotuneResult(layout=best_lay, cost=best_cost,
                            default_cost=default_cost, scored=scored,
                            pruned=pruned)
    _CACHE[key] = result
    while len(_CACHE) > _CACHE_CAPACITY:
        _CACHE.popitem(last=False)
    return result


def best_layout(shape: Sequence[int], dtype, *,
                movements: Sequence[Movement] = (),
                link: Optional[Link] = None, d_buf: int = 9,
                candidates: Optional[Sequence[L.Layout]] = None,
                tiled_only: bool = False,
                budget: int = SEARCH_BUDGET) -> Optional[L.Layout]:
    """The tuned layout for one side of a movement, or None when no candidate
    is feasible for the shape (callers fall back to ``MN``)."""
    return autotune(shape, dtype, movements=movements, link=link, d_buf=d_buf,
                    candidates=candidates, tiled_only=tiled_only,
                    budget=budget).layout


# Resolved descriptors, memoized so repeated transfers of the same (auto
# descriptor, shape, dtype, fabric) reuse ONE resolved object — the CFG cache
# then hits even for identity-keyed descriptors (unhashable plugin state).
_RESOLVED: "collections.OrderedDict[tuple, XDMADescriptor]" = \
    collections.OrderedDict()
_RESOLVED_CAPACITY = 512


def resolve_descriptor(desc: XDMADescriptor, shape: Sequence[int], dtype, *,
                       link: Optional[Link] = None) -> XDMADescriptor:
    """Substitute concrete layouts for ``auto`` endpoints of ``desc``, tuned
    for the input logical ``shape``/``dtype`` on ``link``.

    An auto *src* always resolves to ``MN``: the src bytes are handed in by
    the caller, so any other pick would reinterpret them and change values.
    An auto *dst* is searched against the src layout — the engine
    materializes that buffer, so every pick is value-preserving (consumers
    read it through the resolved descriptor's dst layout).  A chain of
    exactly one ``Transpose`` scores the transposed movement; chains the
    pattern algebra cannot price (other plugins) resolve to ``MN``.  A pick
    the descriptor cannot validate (channel-lane misalignment) falls back to
    ``MN`` rather than failing the movement.
    """
    if not desc.has_auto:
        return desc
    shape = tuple(int(s) for s in shape)
    key = (desc.cache_key(), shape, L.dtype_info(dtype)[1],
           fabric_fingerprint(link))
    hit = _RESOLVED.get(key)
    if hit is not None:
        _RESOLVED.move_to_end(key)
        return hit
    resolved = _resolve(desc, shape, dtype, link)
    _RESOLVED[key] = resolved
    while len(_RESOLVED) > _RESOLVED_CAPACITY:
        _RESOLVED.popitem(last=False)
    return resolved


def _resolve(desc: XDMADescriptor, shape: Tuple[int, ...], dtype,
             link: Optional[Link]) -> XDMADescriptor:
    _BANK.inc("resolved_descriptors")
    chain = desc.plugins
    transpose = len(chain) == 1 and isinstance(chain[0], P.Transpose)
    pure = not chain or transpose
    src, dst = desc.src, desc.dst

    def tuned(other: L.Layout) -> L.Layout:
        if not pure:
            return L.MN
        lay = best_layout(shape, dtype,
                          movements=(Movement(other, "dst", transpose),),
                          link=link, d_buf=desc.d_buf)
        return lay or L.MN

    if src.layout.is_auto:
        # The src bytes are the caller's: a non-MN pick would REINTERPRET
        # them (changing values), so auto-on-src is "the buffer as handed".
        src = dataclasses.replace(src, layout=L.MN)
    if dst.layout.is_auto:
        dst = dataclasses.replace(dst, layout=tuned(src.layout))
    resolved = XDMADescriptor(src=src, dst=dst, pre=desc.pre, post=desc.post,
                              d_buf=desc.d_buf, channels=desc.channels,
                              backend=desc.backend)
    try:
        resolved.validate(shape)
    except ValueError:
        fallback_src = (dataclasses.replace(desc.src, layout=L.MN)
                        if desc.src.layout.is_auto else desc.src)
        fallback_dst = (dataclasses.replace(desc.dst, layout=L.MN)
                        if desc.dst.layout.is_auto else desc.dst)
        resolved = XDMADescriptor(src=fallback_src, dst=fallback_dst,
                                  pre=desc.pre, post=desc.post,
                                  d_buf=desc.d_buf, channels=desc.channels,
                                  backend=desc.backend)
    return resolved
