"""xdma.transfer(): the single entry point for every XDMA data movement
(PyTorch port).

The twin of ``repro.core.api``.  :func:`transfer` consumes a
:class:`~repro_torch.core.descriptor.XDMADescriptor` and dispatches — from
the descriptor alone — to one of the lowering backends:

* local + backend ``auto``     -> one datapath kernel (``plugin_compiler``)
  when the plugin chain is emit-capable, else the plain composition
  (``engine.xdma_copy``), as the reference's policy records it; an empty
  chain is a pure relayout (``engine.xdma_copy_pallas`` untallied: kernel 1
  on the card)
* local + backend ``fused``    -> ``engine.xdma_copy`` (the plain composition)
* local + backend ``compiled`` -> ``plugin_compiler.compile_local`` (forced)
* local + backend ``pallas``   -> ``engine.xdma_copy_pallas`` (kernel 1, the
  AGU relayout)
* dst peer                     -> ``remote.xdma_ppermute``   (tunnel)
* dst all_to_all               -> ``remote.xdma_all_to_all`` (MoE dispatch)
* dst reduce                   -> ``remote.compressed_psum`` / ``xdma_psum``
* dst multicast (mesh-axis)    -> ``remote.xdma_ppermute``   (rotating hop)

The kernels run on the device of the buffer: a CUDA tensor launches the
hand-written kernels, a CPU tensor takes their plain versions.  Remote
movements run inside an SPMD body, one call per rank, their axis a process
group registered in :mod:`repro_torch.sharding`; each endpoint side with an
emit-capable chain is one datapath kernel
(``plugin_compiler.maybe_compile_side``).  ``auto`` endpoint layouts
resolve through the cost-model autotuner (:func:`_resolve_auto`) before
lowering.  A node-addressed multicast is routed by
``DistributedScheduler.submit_multicast``, as in the reference, and raises
here.

The CFG phase happens **once per descriptor**: the lowered callable is built
on first use and cached by descriptor identity (an LRU, see
:func:`cache_stats`).  :class:`XDMAQueue` is the Controller's in-order task
queue; :meth:`XDMAQueue.submit_to` posts it through a scheduler's rings.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.runtime import telemetry as _tm

from . import autotune as _autotune
from . import engine
from . import plugin_compiler
from . import plugins as P
from . import remote
from .descriptor import XDMADescriptor

__all__ = ["transfer", "XDMAQueue", "cache_stats", "clear_cache",
           "cache_capacity", "set_cache_capacity"]


# -- the movement-plane capture slot -------------------------------------------
# The ambient TransferTrace installed by repro_torch.runtime.trace.capture(),
# or None.  Every chokepoint — transfer(), XDMAQueue, DistributedScheduler —
# shares this one slot; with no capture open the cost is one `is None` check.
_CAPTURE = None


# -- the CFG cache: descriptor -> lowered callable ---------------------------
_BANK = _tm.bank("cfg_cache")


class _CacheStats:
    """View over ``telemetry.bank("cfg_cache")`` with the reference's
    ``cache_stats()`` attribute surface (hits/misses/evictions/size)."""

    __slots__ = ()

    @property
    def hits(self):
        return _BANK.get("hits")

    @property
    def misses(self):
        return _BANK.get("misses")

    @property
    def evictions(self):
        return _BANK.get("evictions")

    @property
    def size(self):
        return len(_CACHE)

    def __repr__(self):
        return (f"_CacheStats(hits={self.hits}, misses={self.misses}, "
                f"evictions={self.evictions}, size={self.size})")


# LRU: key -> (descriptor kept alive so id-keys stay unique, lowered callable).
_CACHE: "collections.OrderedDict[Any, Tuple[XDMADescriptor, Callable]]" = \
    collections.OrderedDict()
_STATS = _CacheStats()
_DEFAULT_CAPACITY = 1024
_CAPACITY = _DEFAULT_CAPACITY


def cache_stats() -> _CacheStats:
    """Hit/miss/eviction counters for the per-descriptor CFG cache."""
    return _STATS


def cache_capacity() -> int:
    """Current CFG-cache capacity (entries)."""
    return _CAPACITY


def set_cache_capacity(n: int) -> None:
    """Bound the CFG cache to ``n`` entries (LRU eviction), evicting now if
    already over.  The capacity survives :func:`clear_cache`."""
    global _CAPACITY
    if n < 1:
        raise ValueError("cache capacity must be >= 1")
    _CAPACITY = int(n)
    _evict_to_capacity()


def _evict_to_capacity() -> None:
    while len(_CACHE) > _CAPACITY:
        _CACHE.popitem(last=False)      # least recently used first
        _BANK.inc("evictions")


# Sibling caches holding compositions of the lowerings above (the
# scheduler's batched rounds) or the searches that pick their layouts: they
# register here so clear_cache() empties them with the CFG cache.
_AUX_CACHES: List["collections.OrderedDict"] = []
_AUX_CACHES.append(_autotune._CACHE)      # memoized layout searches
_AUX_CACHES.append(_autotune._RESOLVED)   # memoized auto-descriptor resolutions


def clear_cache() -> None:
    _CACHE.clear()
    _BANK.clear()
    for aux in _AUX_CACHES:
        aux.clear()


def reset_process_state() -> None:
    """The port's global state as a fresh process has it: the CFG cache and
    its siblings (the autotune memos, the scheduler's round cache), the
    page-geometry and KV-plane descriptor memos (their first calls count
    an autotune search), agu_stats, cfg_stats and every telemetry bank."""
    # the runtime and the serving plane import this module
    from repro_torch.kernels import agu
    from repro_torch.runtime import scheduler
    from repro_torch.serving import transfer

    from . import descriptor
    clear_cache()
    _autotune.clear_cache()
    scheduler._ROUND_CACHE.clear()
    descriptor.page_layout.cache_clear()
    descriptor.page_descriptor.cache_clear()
    transfer.kv_plane_descs.cache_clear()
    agu.clear_agu_stats()
    plugin_compiler.clear_stats()
    _tm.reset()


def _check_ported(desc: XDMADescriptor) -> None:
    """Refuse a node-addressed multicast: it has no single-collective
    lowering; the scheduler forks it into per-hop tree tasks."""
    if desc.movement == "multicast" and desc.remote is None:
        raise ValueError(
            "node-addressed multicast descriptors are routed by "
            "DistributedScheduler.submit_multicast (they fork into per-hop "
            "tree tasks), not lowered by transfer(); use "
            "Endpoint.multicast_axis for the mesh-axis collective spelling")


def _resolve_auto(desc: XDMADescriptor, x, link=None) -> XDMADescriptor:
    """Substitute tuned concrete layouts for ``auto`` endpoints against the
    input buffer.  An auto *src* treats the buffer as already logical.
    ``link`` is the fabric the movement rides (the scheduler threads its
    routed link in; plain ``transfer`` tunes for the default fabric)."""
    if not desc.has_auto:
        return desc
    leaf = x.values if isinstance(x, (P.QTensor, P.CTensor)) else x
    shape = tuple(int(s) for s in leaf.shape)
    if not desc.src.layout.is_auto:
        shape = desc.src.layout.logical_shape(shape)
    return _autotune.resolve_descriptor(desc, shape, leaf.dtype, link=link)


def _distinct(x, out):
    """``out``, or a copy of it where it is the input tensor itself."""
    return out.clone() if out is x and isinstance(x, torch.Tensor) else out


def _fresh(fn: Callable) -> Callable:
    """The reference jits every lowering but ``pallas``, and a jitted call
    hands back a new array even for an identity movement.  Where the plain
    composition hands back its input tensor, copy it: the destination is a
    buffer of its own, and the trace's provenance (keyed by the identity of
    a tensor and of its full aliases) sees the reference's edges."""
    return lambda x: _distinct(x, fn(x))


def _compiled_or(desc: XDMADescriptor, compiled: Optional[Callable]) -> Callable:
    """Compiled datapath with the reference's structural escape hatch:
    payload inputs (QTensor/CTensor) take the plain composition."""
    def run(x):
        if compiled is None or isinstance(x, (P.QTensor, P.CTensor)):
            return engine.xdma_copy(x, desc)
        return compiled(x)
    return run


def _relayout(desc: XDMADescriptor) -> Callable:
    """An empty chain under ``auto``: the AGU lowering (kernel 1 on the
    card, its plain version on the CPU), untallied; payload carriers take
    the composition."""
    def run(x):
        if not isinstance(x, torch.Tensor):
            return engine.xdma_copy(x, desc)
        desc.validate(desc.src_layout.logical_shape(tuple(x.shape)))
        return engine.xdma_copy_pallas(x, desc, tally=False)
    return run


def _lower(desc: XDMADescriptor, *, tally: bool = True) -> Callable:
    """Build the Data-phase callable for a descriptor (the CFG phase);
    ``tally=False`` keeps it out of ``cfg_stats``."""
    if desc.movement != "local":
        return _lower_remote(desc)
    if desc.backend == "pallas":
        return lambda x: engine.xdma_copy_pallas(x, desc)
    if desc.backend == "compiled":
        # forced single-kernel lowering: raises on non-fusible chains
        return _fresh(plugin_compiler.compile_local(desc))
    if desc.backend == "auto":
        compiled = plugin_compiler.maybe_compile_local(desc, tally=tally)
        if compiled is not None:
            return _fresh(_compiled_or(desc, compiled))
        if not desc.plugins:
            return _fresh(_relayout(desc))
    return _fresh(lambda x: engine.xdma_copy(x, desc))


def _lower_remote(desc: XDMADescriptor) -> Callable:
    """Reader -> pre host -> link -> post host -> writer, run in every rank.
    Each endpoint side with a fully emit-capable chain is one datapath
    kernel (reader + pre chain / post chain + writer); other sides keep the
    composition the remote backends apply around the collective."""
    movement, ep = desc.movement, desc.remote
    src_side = dst_side = None
    if movement in ("peer", "all_to_all", "multicast"):
        src_side = plugin_compiler.maybe_compile_side(
            desc.src.layout, desc.pre, side="src", d_buf=desc.d_buf)
        dst_side = plugin_compiler.maybe_compile_side(
            desc.dst.layout, desc.post, side="dst", d_buf=desc.d_buf)

    def run_remote(x):
        fuse_src = (src_side is not None
                    and not isinstance(x, (P.QTensor, P.CTensor)))
        if fuse_src and len(x.shape) >= 2:   # reduce-style flat payloads skip
            desc.validate(desc.src.layout.logical_shape(tuple(x.shape)))
        if fuse_src:
            logical = src_side(x)            # one kernel: reader + pre chain
            pre = ()
        else:
            logical = engine.reader(x, desc.src.layout)
            pre = desc.pre
            if getattr(logical, "ndim", 0) >= 2:
                desc.validate(tuple(logical.shape))
        post = desc.post if dst_side is None else ()
        if movement in ("peer", "multicast"):
            # mesh-axis multicast is the rotating one-hop broadcast: the same
            # collective as peer, recorded as multicast in the ledger
            y = remote.xdma_ppermute(logical, ep.axis, list(ep.perm),
                                     pre=pre, post=post)
        elif movement == "all_to_all":
            y = remote.xdma_all_to_all(logical, ep.axis,
                                       split_axis=ep.split_axis,
                                       concat_axis=ep.concat_axis,
                                       pre=pre, post=post)
        else:
            # reduce: a Quantize/Dequantize pair around the link is the wire
            # codec, which compressed_psum owns (it re-quantizes between its
            # two phases); other plugins run on their hosts.  A Dequantize
            # with no pre Quantize is not a codec: it stays on the post host
            # and fails loudly on a plain tensor.
            pre_rest = tuple(p for p in desc.pre
                             if not isinstance(p, P.Quantize))
            codec = len(pre_rest) != len(desc.pre)
            post_rest = (tuple(p for p in desc.post
                               if not isinstance(p, P.Dequantize))
                         if codec else desc.post)
            y = P.apply_chain(pre_rest, logical)
            if codec:
                deq = [p for p in desc.post if isinstance(p, P.Dequantize)]
                out_dtype = deq[0].dtype if deq else y.dtype
                y = remote.compressed_psum(y, ep.axis, ep.axis_size,
                                           out_dtype=out_dtype)
            else:
                y = remote.xdma_psum(y, ep.axis)
            y = P.apply_chain(post_rest, y)
        if dst_side is not None:
            if not isinstance(y, (P.QTensor, P.CTensor)):
                return dst_side(y)           # one kernel: post chain + writer
            y = P.apply_chain(desc.post, y)  # payload pytree: composition
        if isinstance(y, P.QTensor):
            return P.QTensor(values=engine.writer(y.values, desc.dst.layout),
                             scales=y.scales)
        if isinstance(y, P.CTensor):
            return P.CTensor(values=engine.writer(y.values, desc.dst.layout),
                             mask=y.mask)
        return engine.writer(y, desc.dst.layout)

    return run_remote


def _lowered(desc: XDMADescriptor) -> Callable:
    key = desc.cache_key()
    entry = _CACHE.get(key)
    if entry is not None:
        _BANK.inc("hits")
        _CACHE.move_to_end(key)
        return entry[1]
    _BANK.inc("misses")
    fn = _lower(desc)
    _CACHE[key] = (desc, fn)
    _evict_to_capacity()
    return fn


def transfer(x: Any, desc: XDMADescriptor) -> Any:
    """Execute one XDMA task described entirely by ``desc``.

    ``x`` is the physical buffer at the src endpoint (a tensor on the card,
    or on the CPU where the kernels' plain versions run); the return value
    is the physical buffer at the dst endpoint, on the same device (a
    :class:`~repro_torch.core.plugins.QTensor` / ``CTensor`` when the chain
    ends in ``Quantize`` / ``Compress``).  A remote movement is called in
    every rank of an SPMD body whose mesh registers the endpoint's axis
    (:mod:`repro_torch.sharding`).  An ``auto`` layout resolves for the
    default fabric first.  When a
    :func:`repro_torch.runtime.trace.capture` scope is open the call is
    recorded into its trace; when a
    :func:`repro_torch.runtime.telemetry.session` is open, it is timed as an
    ``xdma.transfer`` span.  Both hooks are one ``is None`` check when off.
    """
    _check_ported(desc)
    desc = _resolve_auto(desc, x)
    tel = _tm._ACTIVE
    if tel is None:
        out = _lowered(desc)(x)
    else:
        with tel.span("xdma.transfer", track="transfer",
                      desc=desc.summary(), movement=desc.movement):
            out = _lowered(desc)(x)
    if _CAPTURE is not None:
        _CAPTURE.record_transfer(x, desc, out)
    return out


# -- the Controller's in-order task queue (paper §II-B) ----------------------
class XDMAQueue:
    """An ordered sequence of XDMA tasks.

    ``run(x)`` chains every task in submission order through its lowering
    (the reference jits the chain into one program; the port has no jit and
    dispatches each task's kernels in order on the current stream);
    ``run_task(x, i)`` executes one task, for call sites that interleave
    compute between tasks.  ``auto`` layouts resolve per task against the
    value reaching it.  Lowerings are memoized per queue, not in the global
    CFG cache.
    """

    def __init__(self, descriptors: Sequence[XDMADescriptor] = (),
                 name: str = "queue"):
        self.name = name
        self._descs: List[XDMADescriptor] = []
        self._tasks: Dict[Tuple, Callable] = {}
        for d in descriptors:
            self.submit(d)

    def submit(self, desc: XDMADescriptor) -> int:
        """Append a task; returns its index in dispatch order."""
        if not isinstance(desc, XDMADescriptor):
            raise TypeError(f"XDMAQueue.submit takes a descriptor, got {type(desc)}")
        _check_ported(desc)
        self._descs.append(desc)
        return len(self._descs) - 1

    @property
    def descriptors(self) -> Tuple[XDMADescriptor, ...]:
        return tuple(self._descs)

    def __len__(self) -> int:
        return len(self._descs)

    def __iter__(self):
        return iter(self._descs)

    @property
    def is_local(self) -> bool:
        return all(not d.is_remote for d in self._descs)

    # -- compile-time contracts ---------------------------------------------
    def out_logical_shape(self, in_logical_shape: Sequence[int]) -> Tuple[int, ...]:
        shape = tuple(in_logical_shape)
        for d in self._descs:
            shape = d.out_logical_shape(shape)
        return shape

    def out_dtype(self, in_dtype):
        dtype = in_dtype
        for d in self._descs:
            dtype = d.out_dtype(dtype)
        return dtype

    # -- execution ----------------------------------------------------------
    def _task(self, i: int, desc: XDMADescriptor, *,
              tally: bool = True) -> Callable:
        # an auto task's resolved form joins the key (resolve_descriptor
        # memoizes, keeping the resolved object stable)
        base = self._descs[i]
        key = (i,) if desc is base else (i, desc.cache_key())
        key += () if tally else ("run",)
        fn = self._tasks.get(key)
        if fn is None:
            fn = self._tasks[key] = _lower(desc, tally=tally)
        return fn

    def run_task(self, x, i: int):
        """Dispatch task ``i`` alone (in-order use is the caller's contract)."""
        desc = _resolve_auto(self._descs[i], x)
        tel = _tm._ACTIVE
        if tel is None:
            out = self._task(i, desc)(x)
        else:
            with tel.span("XDMAQueue.run_task", track="queue",
                          queue=self.name, task=i):
                out = self._task(i, desc)(x)
        if _CAPTURE is not None:
            _CAPTURE.record_transfer(x, desc, out, source="queue",
                                     label=f"{self.name}[{i}]")
        return out

    def run(self, x):
        """Dispatch the whole queue in order."""
        if not self._descs:
            return x

        def chain(v):
            # the reference jits the local tasks into one program, which no
            # CFG phase of the plugin compiler counts: neither do they here
            for i, d in enumerate(self._descs):
                v = self._task(i, _resolve_auto(d, v),
                               tally=d.movement != "local")(v)
            return _distinct(x, v)      # the reference's run is one program

        tel = _tm._ACTIVE
        if tel is None:
            out = chain(x)
        else:
            with tel.span("XDMAQueue.run", track="queue",
                          queue=self.name, tasks=len(self)):
                out = chain(x)
        if _CAPTURE is not None:
            _CAPTURE.record_queue(self, x, out)
        return out

    def submit_to(self, sched, x, *, link=None, tenant: str = "",
                  deps: Sequence = ()):
        """Post the whole queue through a scheduler's descriptor rings: one
        ring post (doorbell) per task, chained in order — the async analogue
        of :meth:`run`, value-identical to it because both dispatch through
        the same per-descriptor lowering.

        ``link=None`` routes the *first* task by the scheduler's round-robin
        policy and pins the rest of the chain to the same link.  Returns the
        final task's :class:`~repro_torch.runtime.scheduler.XDMAFuture`.
        """
        if not self._descs:
            raise ValueError(f"XDMAQueue {self.name!r} is empty: nothing to "
                             "submit")
        fut = None
        for i, d in enumerate(self._descs):
            fut = sched.submit(x if fut is None else fut, d, link=link,
                               deps=tuple(deps) if fut is None else (),
                               tenant=tenant, label=f"{self.name}[{i}]")
            if link is None:
                # pin the rest of the chain to the routed link
                link = sched._tasks[fut.task_id].resource
        return fut

    def summary(self) -> str:
        lines = [f"XDMAQueue({self.name!r}, {len(self)} tasks)"]
        lines += [f"  [{i}] {d.summary()}" for i, d in enumerate(self._descs)]
        return "\n".join(lines)
