"""xdma.transfer(): the single entry point for every XDMA data movement
(PyTorch port, local movements).

The twin of ``repro.core.api``.  :func:`transfer` consumes a
:class:`~repro_torch.core.descriptor.XDMADescriptor` and dispatches — from
the descriptor alone — to one of the local lowering backends:

* backend ``auto``     -> one datapath kernel (``plugin_compiler``) when the
  plugin chain is emit-capable, else the plain composition
  (``engine.xdma_copy``), as the reference's policy records it
* backend ``fused``    -> ``engine.xdma_copy`` (the plain composition)
* backend ``compiled`` -> ``plugin_compiler.compile_local`` (forced)
* backend ``pallas``   -> ``engine.xdma_copy_pallas`` (kernel 1, the AGU
  relayout)

The kernels run on the device of the buffer: a CUDA tensor launches the
hand-written kernels, a CPU tensor takes their plain versions.  Remote
movements (peer, all-to-all, reduce, multicast) and ``auto`` layouts are not
ported yet and raise ``NotImplementedError`` naming their ROADMAP item.

The CFG phase happens **once per descriptor**: the lowered callable is built
on first use and cached by descriptor identity (an LRU, see
:func:`cache_stats`).  :class:`XDMAQueue` is the Controller's in-order task
queue.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.runtime import telemetry as _tm

from . import engine
from . import plugin_compiler
from . import plugins as P
from .descriptor import XDMADescriptor

__all__ = ["transfer", "XDMAQueue", "cache_stats", "clear_cache",
           "cache_capacity", "set_cache_capacity"]


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


def clear_cache() -> None:
    _CACHE.clear()
    _BANK.clear()


def _check_ported(desc: XDMADescriptor) -> None:
    """Refuse what the port cannot lower yet, naming the ROADMAP item."""
    if desc.movement != "local":
        raise NotImplementedError(
            f"{desc.movement} movements lower to collectives, which the port "
            "does not have yet (ROADMAP.md §1 item 6, collectives)")
    if desc.has_auto:
        raise NotImplementedError(
            "'auto' layouts are resolved by the cost-model autotuner, which "
            "the port does not have yet (ROADMAP.md §1 item 4)")


def _compiled_or(desc: XDMADescriptor, compiled: Optional[Callable]) -> Callable:
    """Compiled datapath with the reference's structural escape hatch:
    payload inputs (QTensor/CTensor) take the plain composition."""
    def run(x):
        if compiled is None or isinstance(x, (P.QTensor, P.CTensor)):
            return engine.xdma_copy(x, desc)
        return compiled(x)
    return run


def _lower(desc: XDMADescriptor) -> Callable:
    """Build the Data-phase callable for a local descriptor (the CFG phase)."""
    if desc.backend == "pallas":
        return lambda x: engine.xdma_copy_pallas(x, desc)
    if desc.backend == "compiled":
        # forced single-kernel lowering: raises on non-fusible chains
        return plugin_compiler.compile_local(desc)
    if desc.backend == "auto":
        compiled = plugin_compiler.maybe_compile_local(desc)
        if compiled is not None:
            return _compiled_or(desc, compiled)
    return lambda x: engine.xdma_copy(x, desc)


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
    ends in ``Quantize`` / ``Compress``).  When a
    :func:`repro_torch.runtime.telemetry.session` is open, the call is timed
    as an ``xdma.transfer`` span.
    """
    _check_ported(desc)
    tel = _tm._ACTIVE
    if tel is None:
        return _lowered(desc)(x)
    with tel.span("xdma.transfer", track="transfer",
                  desc=desc.summary(), movement=desc.movement):
        return _lowered(desc)(x)


# -- the Controller's in-order task queue (paper §II-B) ----------------------
class XDMAQueue:
    """An ordered sequence of local XDMA tasks.

    ``run(x)`` chains every task in submission order through its lowering
    (the reference jits the chain into one program; the port has no jit and
    dispatches each task's kernels in order on the current stream);
    ``run_task(x, i)`` executes one task, for call sites that interleave
    compute between tasks.  Lowerings are memoized per queue, not in the
    global CFG cache.
    """

    def __init__(self, descriptors: Sequence[XDMADescriptor] = (),
                 name: str = "queue"):
        self.name = name
        self._descs: List[XDMADescriptor] = []
        self._tasks: Dict[int, Callable] = {}
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
    def _task(self, i: int) -> Callable:
        fn = self._tasks.get(i)
        if fn is None:
            fn = self._tasks[i] = _lower(self._descs[i])
        return fn

    def run_task(self, x, i: int):
        """Dispatch task ``i`` alone (in-order use is the caller's contract)."""
        tel = _tm._ACTIVE
        if tel is None:
            return self._task(i)(x)
        with tel.span("XDMAQueue.run_task", track="queue",
                      queue=self.name, task=i):
            return self._task(i)(x)

    def run(self, x):
        """Dispatch the whole queue in order."""
        def chain(v):
            for i in range(len(self._descs)):
                v = self._task(i)(v)
            return v

        tel = _tm._ACTIVE
        if tel is None:
            return chain(x)
        with tel.span("XDMAQueue.run", track="queue",
                      queue=self.name, tasks=len(self)):
            return chain(x)

    def summary(self) -> str:
        lines = [f"XDMAQueue({self.name!r}, {len(self)} tasks)"]
        lines += [f"  [{i}] {d.summary()}" for i, d in enumerate(self._descs)]
        return "\n".join(lines)
