"""Paged KV-cache pool: fixed-size pages as XDMA descriptor endpoints
(PyTorch port, the twin of ``repro.serving.paged``).

DataMaestro's decoupled-access model applied to serving (DESIGN.md §10): the
KV cache is not a per-request tensor but an addressable *pool* of fixed-size
pages, and every page operation — fill, gather, evict-to-host, re-admit,
defrag migration — is one :func:`repro_torch.core.descriptor.page_descriptor`
movement submitted through a :class:`~repro_torch.runtime.DistributedScheduler`.
Nothing touches page storage except `_submit`, so a
:func:`repro_torch.runtime.trace.capture` around a serving run sees
*every* page byte (``pool.stats["movements"]`` equals the count of
``page:``-labelled trace events).

At rest a page lives in the layout :func:`~repro_torch.core.descriptor.page_layout`
picks for its geometry (the Iris automatic-layout idea, per page); "host"
residence is the pool's bookkeeping of where an evicted page lives; its data
is the logical matrix the evict transfer produced through the lossless
block-sparse wire codec (``Compress``/``Decompress``), on the device of the
transfer, so an evict -> restore round trip is bit-exact and the capture
prices the host link by actual occupancy.

The pool is slot-addressed: ``capacity_pages`` device slots, lowest-free
allocation, and :meth:`defrag` compacts high slots into low free ones with
priced ``page:*:defrag`` copies — the pool's physical address space stays
dense so admission never fails on fragmentation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.core.descriptor import page_descriptor
from repro_torch.runtime import Topology, telemetry as _tm
from repro_torch.runtime.ring import WouldBlock

__all__ = ["Page", "PagedKVPool", "default_serving_topology",
           "paginate", "depaginate", "pages_for_rows", "DEFAULT_PAGE_ROWS"]

DEFAULT_PAGE_ROWS = 32          # divisible by every candidate tile's rows
DEFAULT_SERVING_PAIRS = 2       # h2d/d2h link pairs of the default fabric


def default_serving_topology() -> Topology:
    """The serving fabric used when none is requested: ``host_device(2)``
    (two h2d/d2h DMA link pairs)."""
    return Topology.host_device(DEFAULT_SERVING_PAIRS)


def pages_for_rows(rows: int, page_rows: int) -> int:
    """Number of fixed-size pages covering ``rows`` matrix rows."""
    return max(0, -(-int(rows) // int(page_rows)))


def paginate(mat: torch.Tensor, page_rows: int) -> List[torch.Tensor]:
    """Split a (rows, cols) matrix into fixed (page_rows, cols) pages, the
    last page zero-padded — every page in the pool has identical geometry
    per column width, so one descriptor (CFG phase) serves them all."""
    rows = int(mat.shape[0])
    n = pages_for_rows(rows, page_rows)
    pad = n * page_rows - rows
    if pad:
        mat = torch.cat([mat, mat.new_zeros((pad,) + tuple(mat.shape[1:]))])
    return [mat[i * page_rows:(i + 1) * page_rows] for i in range(n)]


def depaginate(pages: List[torch.Tensor], rows: int) -> torch.Tensor:
    """Inverse of :func:`paginate`: concatenate and trim the zero padding."""
    if not pages:
        return torch.zeros((0, 0), dtype=torch.float32)
    return torch.cat(pages, dim=0)[:rows]


@dataclasses.dataclass
class Page:
    """One pool page: fixed (rows, cols) geometry, a device slot (or host
    residence after eviction), and the physical buffer in its at-rest form
    (page layout on device, logical matrix on host)."""

    pid: int
    slot: int                       # device slot index; -1 when host-resident
    rows: int
    cols: int
    dtype: str
    location: str = "dev"           # "dev" | "host"
    data: Any = None


class PagedKVPool:
    """Slot-addressed pool of fixed-size KV pages; all movement in-plane.

    The pool never runs a transfer itself: an engine binds its per-step
    scheduler (:meth:`bind`), page ops submit onto it, and after the engine
    flushes, :meth:`commit` lands results into the page records.  Labels are
    ``page:<pid>:<op>`` so captures and tests can account for every page
    movement.
    """

    def __init__(self, capacity_pages: int = 64,
                 page_rows: int = DEFAULT_PAGE_ROWS, *,
                 compress_block: int = 8, name: str = "kvpool"):
        if capacity_pages < 1:
            raise ValueError("capacity_pages must be >= 1")
        if page_rows % compress_block:
            raise ValueError(f"page_rows {page_rows} not divisible by the "
                             f"wire compress block {compress_block}")
        self.capacity = int(capacity_pages)
        self.page_rows = int(page_rows)
        self.compress_block = int(compress_block)
        self.name = name
        self._pages: Dict[int, Page] = {}
        self._free_slots: List[int] = list(range(self.capacity))
        self._next_pid = 0
        self._sched = None
        self._lane = 0
        # (page, future, new_location, new_slot) landed by commit()
        self._pending: List[Tuple[Page, Any, str, int]] = []
        # per-instance counter bank, registered so telemetry.snapshot()
        # lists it
        self._bank = _tm.CounterBank(f"pool:{name}")
        _tm.register(self._bank)

    _STAT_KEYS = ("stores", "loads", "evictions", "restores",
                  "defrag_moves", "movements", "peak_used")

    @property
    def stats(self) -> Dict[str, int]:
        """Per-op movement counters as a plain dict (a view over the
        pool's telemetry bank)."""
        return {k: self._bank.get(k) for k in self._STAT_KEYS}

    # -- scheduler binding ---------------------------------------------------
    def bind(self, scheduler) -> None:
        """Attach the scheduler page ops submit onto (an engine rebinds a
        fresh one per serving step; the pool itself holds no fabric)."""
        self._sched = scheduler

    def _require_sched(self):
        if self._sched is None:
            raise RuntimeError("PagedKVPool has no bound scheduler; call "
                               "pool.bind(scheduler) first")
        return self._sched

    def _link(self, kind: str) -> str:
        """Route onto the fabric with the serving link-pair convention
        (store/restore on a pair's first link, load/evict on its second),
        lanes alternating per submission so page i+1 overlaps page i."""
        names = self._require_sched().topology.link_names
        n_pairs = max(1, len(names) // 2)
        si = (2 * (self._lane % n_pairs)) % len(names)
        self._lane += 1
        return names[si] if kind == "out" else names[(si + 1) % len(names)]

    def _submit(self, data, desc, *, kind: str, label: str, deps=()):
        """The pool's single movement primitive — every page byte goes
        through here, so the movement counter and the capture ledger agree
        exactly.

        Honors ring backpressure: on an ``error``-policy scheduler whose
        ring is out of credits, drain one scheduling round (a completion
        returns a credit) and repost — page movement never deadlocks on a
        full ring, it just waits its turn (preemption under ring pressure
        rides on exactly this loop)."""
        sched = self._require_sched()
        link = self._link(kind)
        while True:
            try:
                fut = sched.submit(data, desc, link=link, deps=deps,
                                   label=label)
                break
            except WouldBlock:
                sched.step()
        self._bank.inc("movements")
        return fut

    # -- queries -------------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free_slots)

    @property
    def used_pages(self) -> int:
        return self.capacity - len(self._free_slots)

    def page(self, pid: int) -> Page:
        return self._pages[pid]

    def device_pages(self) -> List[Page]:
        return [p for p in self._pages.values() if p.location == "dev"]

    def fragmentation(self) -> int:
        """Occupied-slot span minus occupancy: >0 means defrag can compact."""
        dev = self.device_pages()
        if not dev:
            return 0
        return (max(p.slot for p in dev) + 1) - len(dev)

    # -- page operations -----------------------------------------------------
    def alloc(self, cols: int, dtype_name: str) -> int:
        """Reserve the lowest free device slot for a new (page_rows, cols)
        page; fill it with :meth:`store`."""
        if not self._free_slots:
            raise MemoryError(f"pool {self.name!r} out of pages "
                              f"({self.capacity} slots)")
        slot = self._free_slots.pop(0)
        pid = self._next_pid
        self._next_pid += 1
        self._pages[pid] = Page(pid, slot, self.page_rows, int(cols),
                                str(dtype_name))
        self._bank.record_max("peak_used", self.used_pages)
        return pid

    def store(self, pid: int, mat, *, deps=(), label: str = "store"):
        """Write one logical (page_rows, cols) matrix into its at-rest page
        layout (MN -> page tiling, h2d-side lane)."""
        p = self._pages[pid]
        if p.location != "dev":
            raise ValueError(f"page {pid} is host-resident; restore it first")
        desc = page_descriptor(p.rows, p.cols, p.dtype, direction="store")
        fut = self._submit(mat, desc, kind="out", deps=deps,
                           label=f"page:{pid}:{label}")
        self._pending.append((p, fut, "dev", p.slot))
        self._bank.inc("stores")
        return fut

    def load(self, pid: int, *, deps=()):
        """Stream one page back as its logical matrix (page tiling -> MN,
        d2h-side lane) for batch composition.  The page stays resident."""
        p = self._pages[pid]
        if p.location != "dev":
            raise ValueError(f"page {pid} is host-resident; restore it first")
        desc = page_descriptor(p.rows, p.cols, p.dtype, direction="load")
        self._bank.inc("loads")
        return self._submit(p.data, desc, kind="in", deps=deps,
                            label=f"page:{pid}:load")

    def evict(self, pid: int, *, deps=()):
        """Evict one page to host residence through the lossless block-sparse
        wire codec; its device slot frees at :meth:`commit`."""
        p = self._pages[pid]
        if p.location != "dev":
            raise ValueError(f"page {pid} already host-resident")
        desc = page_descriptor(p.rows, p.cols, p.dtype, direction="load",
                               wire_compress_rows=self.compress_block)
        fut = self._submit(p.data, desc, kind="in", deps=deps,
                           label=f"page:{pid}:evict")
        self._pending.append((p, fut, "host", -1))
        self._bank.inc("evictions")
        return fut

    def restore(self, pid: int, *, deps=()):
        """Re-admit an evicted page: host logical matrix -> page layout in a
        fresh (lowest-free) slot, through the same wire codec."""
        p = self._pages[pid]
        if p.location != "host":
            raise ValueError(f"page {pid} is not host-resident")
        if not self._free_slots:
            raise MemoryError(f"pool {self.name!r} out of pages for restore")
        slot = self._free_slots.pop(0)
        desc = page_descriptor(p.rows, p.cols, p.dtype, direction="store",
                               wire_compress_rows=self.compress_block)
        fut = self._submit(p.data, desc, kind="out", deps=deps,
                           label=f"page:{pid}:restore")
        self._pending.append((p, fut, "dev", slot))
        self._bank.inc("restores")
        self._bank.record_max("peak_used", self.used_pages)
        return fut

    def free(self, pid: int) -> None:
        """Release a page (device slot returns to the free list)."""
        p = self._pages.pop(pid)
        if p.location == "dev":
            self._free_slots.append(p.slot)
            self._free_slots.sort()

    def defrag(self) -> int:
        """Compact occupied slots downward: while a free slot sits below the
        highest occupied one, migrate that page with a priced page-layout
        copy.  Returns the number of migrations submitted (land via
        :meth:`commit`)."""
        moves = 0
        while self._free_slots:
            lo = self._free_slots[0]
            dev = self.device_pages()
            if not dev:
                break
            hi = max(dev, key=lambda p: p.slot)
            if hi.slot <= lo:
                break
            self._free_slots.pop(0)
            desc = page_descriptor(hi.rows, hi.cols, hi.dtype,
                                   direction="copy")
            fut = self._submit(hi.data, desc, kind="out",
                               label=f"page:{hi.pid}:defrag")
            self._pending.append((hi, fut, "dev", lo))
            self._free_slots.append(hi.slot)
            self._free_slots.sort()
            # record the move eagerly so the loop sees the new slot map
            hi.slot = lo
            self._bank.inc("defrag_moves")
            moves += 1
        return moves

    # -- landing -------------------------------------------------------------
    def commit(self) -> List[Any]:
        """After the bound scheduler flushed, land pending movements: store
        results become the at-rest buffers, evicted pages release their
        slots, restored pages take their reserved ones.  Returns the landed
        futures (the page records now hold their results, so the caller
        may ``release`` them on the scheduler)."""
        landed = [fut for _, fut, _, _ in self._pending]
        for p, fut, loc, slot in self._pending:
            p.data = fut.result()
            if p.location == "dev" and loc == "host":
                self._free_slots.append(p.slot)
                self._free_slots.sort()
            p.location = loc
            if loc == "dev" and slot >= 0:
                p.slot = slot
            elif loc == "host":
                p.slot = -1
        self._pending.clear()
        return landed

    def summary(self) -> str:
        return (f"PagedKVPool({self.name!r}, {self.used_pages}/{self.capacity}"
                f" pages x {self.page_rows} rows, "
                f"host={sum(1 for p in self._pages.values() if p.location == 'host')}, "
                f"moves={self.stats['movements']})")
