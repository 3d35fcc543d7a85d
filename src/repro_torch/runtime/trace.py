"""The application movement ledger: capture every XDMA task, replay anywhere.

The port's twin of ``repro.runtime.trace``.  Payload leaves come from the
scheduler's :func:`~repro_torch.runtime.scheduler._leaves` (the reference's
pytree order).  Provenance is keyed by the identity of each leaf, held
weakly, as in the reference, so the same program wires the same dependency
edges: the port's transfers hand back a new tensor wherever the
reference's jitted lowerings hand back a new array (``api._fresh``).  A
view of a task's output counts as that output only when it is a full alias
(same storage offset, shape, strides and dtype), which is where JAX hands
back the same array (a reshape to the same shape); a slice or a reshape is
a new array there and a new tensor here, with no edge.  There is no tracing
in the port: :func:`_is_tracer` is always False.

The paper's headline system claim (§V, Fig. 10/11) is about *applications*:
serving, training, checkpointing move data through many XDMA tasks, and the
2.3x average speedup comes from pricing that whole timeline with a hardware
address-generator Frontend instead of software DMA issue loops.  To reproduce
it we need a complete record of what an application actually moves — which is
what this module provides (DESIGN.md §9):

* :class:`TransferTrace` — the ledger.  One :class:`TraceEvent` per issued
  XDMA task (descriptor, endpoint kind, payload/wire bytes, burst geometry,
  link, dependency edges) or interleaved compute.
* :func:`capture` — a context manager installing the ambient trace.  The
  movement-plane chokepoints — :func:`repro_torch.core.api.transfer` (plus the
  :class:`~repro_torch.core.api.XDMAQueue` it fronts) and
  :meth:`repro_torch.runtime.scheduler.DistributedScheduler.submit` — record into
  it; with no capture open they pay a single ``is None`` check (zero-cost
  when off).
* :meth:`TransferTrace.replay` — turn the ledger into
  :class:`~repro_torch.runtime.simulator.SimTask`\\ s (through the same
  :func:`~repro_torch.runtime.simulator.queue_sim_tasks` contract path the queue
  benchmarks use) and simulate the whole application timeline on any
  :class:`~repro_torch.runtime.topology.Topology`, under either cost model:

  Both models issue one address per contiguous run of the composed affine
  pattern (``burst_bytes``; one logical row — ``row_bytes`` — when no
  pattern exists: plugin chains, remote exchanges).  They differ in the
  per-issue cost and pipelining:

  - **frontend** (default): the link's hardware burst overhead (~50 ns)
    amortized over ``d_buf`` in-flight bursts (the PR-4 pattern cost model);
  - **sw-AGU** (``sw_agu=True``):
    :data:`~repro_torch.runtime.topology.SW_ISSUE_OVERHEAD` (~1 us) per
    serially-programmed 1D DMA, no pipelining — the paper's software
    baseline.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import api as _api
from repro_torch.core import plugins as XP
from repro_torch.core.api import XDMAQueue
from repro_torch.core.descriptor import XDMADescriptor
from repro_torch.core.layouts import itemsize as _itemsize

from .scheduler import _leaf_nbytes, _leaves
from .simulator import SimReport, SimTask, queue_sim_tasks, simulate
from .topology import SW_ISSUE_OVERHEAD, Topology

__all__ = ["TraceEvent", "TransferTrace", "capture", "current", "replay"]


def _tree_nbytes(value: Any) -> Optional[int]:
    """Payload bytes of a tensor / QTensor / CTensor / container, None when
    no leaf has a size and a dtype."""
    sizes = [n for n in map(_leaf_nbytes, _leaves(value)) if n is not None]
    return sum(sizes) if sizes else None


def _alias_key(leaf: Any) -> Optional[Tuple]:
    """What makes two tensors the same array to a reader: the same storage
    offset, shape, strides and dtype on the same device (None for a leaf
    that is not a tensor)."""
    if not isinstance(leaf, torch.Tensor):
        return None
    # a dim of extent 1 is never stepped: its stride does not matter
    strides = tuple(st if n != 1 else 0
                    for n, st in zip(leaf.shape, leaf.stride()))
    return (str(leaf.device), leaf.data_ptr(), tuple(leaf.shape), strides,
            leaf.dtype)


def _primary_leaf(value: Any):
    if isinstance(value, (XP.QTensor, XP.CTensor)):
        return value.values
    return value


def _is_tracer(leaf: Any) -> bool:
    """The reference skips work on JAX tracers; the port never traces."""
    return False


@dataclasses.dataclass
class TraceEvent:
    """One row of the ledger (mutable: scheduler-submitted events are
    finalized with measured sizes at dispatch time).

    ``nbytes`` is the task's total payload (src read + dst write, the memory-
    port traffic the simulator charges for local movements); ``wire_nbytes``
    is what actually crosses a *remote* link after the pre-host codec
    (int8 values + scales for Quantize, both collective phases for reduce) —
    ``None`` means the link moves the plain payload.  ``burst_bytes`` is the
    contiguous run of the composed affine pattern — the address-issue unit
    of *both* replay cost models; ``row_bytes`` is one logical row, the
    fallback issue unit when no pattern exists (plugin chains, remote
    exchanges).  ``deps`` are ledger event ids (data-flow provenance plus
    any scheduler dependency tokens).  ``ring_occupancy`` is the submitting
    descriptor ring's occupancy right after the doorbell (scheduler submits
    only; None elsewhere) — the queue-pressure axis of the ledger."""

    id: int
    kind: str                            # "xdma" | "compute"
    endpoint: str                        # movement kind, or "compute"
    desc: Optional[XDMADescriptor] = None
    link: Optional[str] = None           # pinned link / compute engine
    deps: Tuple[int, ...] = ()
    logical_shape: Optional[Tuple[int, ...]] = None
    in_dtype: Any = None
    nbytes: Optional[int] = None
    wire_nbytes: Optional[int] = None
    burst_bytes: Optional[int] = None
    row_bytes: Optional[int] = None
    pipeline_depth: int = 1
    cost_s: float = 0.0
    label: str = ""
    source: str = "transfer"             # transfer | queue | scheduler | compute
    ring_occupancy: Optional[int] = None
    # Multicast tree provenance (DESIGN.md §14): every per-hop task of one
    # submit_multicast carries the same ``multicast_group`` id and its own
    # ``(hop src node, hop dst node)`` / served-destination count; the
    # group's first event additionally records ``multicast_spec =
    # (src, ((dst node, layout name), ...), d_buf)`` — enough for replay()
    # to re-synthesize the tree on a *different* fabric and reprice it.
    multicast_group: Optional[int] = None
    multicast_hop: Optional[Tuple[str, str]] = None
    multicast_serves: int = 0
    multicast_spec: Optional[Tuple] = None


def _wire_nbytes(desc: XDMADescriptor, logical_shape, in_dtype) -> Optional[int]:
    """Link-crossing bytes, priced by the pre-host chain's shape/dtype
    contracts: remote movements always cross a link (a reduce crosses twice —
    reduce-scatter + all-gather), and a local movement with a codec on the
    pre host (Quantize) moves the compressed stream.  QTensor scales ride
    along at one f32 per row.  None = the link moves the plain payload.
    (Compress wires depend on runtime occupancy — see ``record_transfer``'s
    concrete-payload fallback.)"""
    codec = any(isinstance(p, XP.Quantize) for p in desc.pre)
    if ((not desc.is_remote and not codec) or logical_shape is None
            or in_dtype is None):
        return None
    try:
        shape = XP.chain_out_shape(desc.pre, tuple(logical_shape))
        dtype = XP.chain_out_dtype(desc.pre, in_dtype)
        w = math.prod(shape) * _itemsize(dtype)
        if codec:
            w += (math.prod(shape[:-1]) if len(shape) > 1 else 1) * 4
    except Exception:
        return None
    if desc.movement == "reduce":
        w *= 2
    return int(w)


def _logical_of(desc: XDMADescriptor, shape, dtype):
    """Logical shape of a physical src buffer; falls back to the plain shape
    for untileable views, None when there is no usable geometry."""
    if shape is None or dtype is None or len(shape) < 2:
        return None
    shape = tuple(int(s) for s in shape)
    try:
        return desc.src.layout.logical_shape(shape)
    except (ValueError, KeyError):
        return shape


class TransferTrace:
    """The movement-plane ledger for one :func:`capture` scope."""

    def __init__(self, name: str = "trace"):
        self.name = name
        self.events: List[TraceEvent] = []
        self._prov: Dict[int, int] = {}      # id(array leaf) -> producing event
        self._alias: Dict[Tuple, int] = {}   # _alias_key(leaf) -> the same
        self._keep: List[Any] = []           # pins for non-weakref-able leaves

    # -- recording (called by the chokepoints) -------------------------------
    def _provenance(self, value: Any) -> Tuple[int, ...]:
        deps: List[int] = []
        for leaf in _leaves(value):
            ev = self._prov.get(id(leaf))
            if ev is None:
                ev = self._alias.get(_alias_key(leaf))
            if ev is not None and ev not in deps:
                deps.append(ev)
        return tuple(deps)

    def _evict(self, key: int, alias: Optional[Tuple], event_id: int) -> None:
        if self._prov.get(key) == event_id:
            del self._prov[key]
        if alias is not None and self._alias.get(alias) == event_id:
            del self._alias[alias]

    def register_value(self, event: TraceEvent, value: Any) -> None:
        """Mark ``value``'s leaves as produced by ``event`` (data-flow edges
        for later tasks consuming them).  The registry holds leaves weakly —
        a collected buffer evicts its own id, so long captures don't pin
        every intermediate (leaves that refuse weakrefs are pinned instead:
        id reuse would silently rewire provenance)."""
        for leaf in _leaves(value):
            key, alias = id(leaf), _alias_key(leaf)
            self._prov[key] = event.id
            if alias is not None:
                self._alias[alias] = event.id
            try:
                weakref.finalize(leaf, self._evict, key, alias, event.id)
            except TypeError:
                self._keep.append(leaf)

    def _event(self, desc: XDMADescriptor, *, logical, dtype, deps, label,
               source, link=None) -> TraceEvent:
        burst = row = None
        if logical is not None and dtype is not None:
            try:
                burst = desc.burst_bytes(logical, dtype)
            except (ValueError, KeyError):
                burst = None
            row = int(logical[-1]) * _itemsize(dtype)
        ev = TraceEvent(
            id=len(self.events), kind="xdma", endpoint=desc.movement,
            desc=desc, link=link, deps=tuple(deps),
            logical_shape=logical, in_dtype=dtype,
            wire_nbytes=_wire_nbytes(desc, logical, dtype),
            burst_bytes=burst, row_bytes=row, pipeline_depth=desc.d_buf,
            label=label or desc.summary(), source=source)
        if logical is not None and dtype is not None:
            try:
                out_shape = desc.out_logical_shape(logical)
                out_dtype = desc.out_dtype(dtype)
                ev.nbytes = int(
                    math.prod(logical) * _itemsize(dtype)
                    + math.prod(out_shape) * _itemsize(out_dtype))
            except Exception:
                ev.nbytes = None
        self.events.append(ev)
        return ev

    def record_transfer(self, x: Any, desc: XDMADescriptor, out: Any, *,
                        source: str = "transfer", label: str = "") -> TraceEvent:
        """One executed ``xdma.transfer``-style task (x -> desc -> out)."""
        leaf = _primary_leaf(x)
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        ev = self._event(desc, logical=_logical_of(desc, shape, dtype),
                         dtype=dtype,
                         deps=self._provenance(x), label=label, source=source)
        if ev.nbytes is None:
            nb_in, nb_out = _tree_nbytes(x), _tree_nbytes(out)
            ev.nbytes = None if nb_in is None else nb_in + (nb_out or 0)
        if ev.wire_nbytes is None and isinstance(out, XP.CTensor):
            try:                     # concrete compressed payload: exact wire
                ev.wire_nbytes = int(out.wire_nbytes())
            except Exception:
                pass
        if ev.wire_nbytes is None and not _is_tracer(leaf):
            # a Compress somewhere on the pre host (e.g. a Decompress follows
            # it, so no CTensor leaves the task): occupancy is runtime state,
            # so evaluate the codec prefix on the concrete payload.  This
            # repeats compression work the lowered program already did —
            # accepted: it only runs under capture, and the lowering does not
            # expose its mid-chain CTensor
            for i, p in enumerate(desc.pre):
                if isinstance(p, XP.Compress):
                    try:
                        ct = XP.apply_chain(desc.pre[:i + 1], x)
                        ev.wire_nbytes = int(ct.wire_nbytes())
                    except Exception:
                        pass
                    break
        self.register_value(ev, out)
        return ev

    def record_queue(self, queue: XDMAQueue, x: Any, out: Any) -> List[TraceEvent]:
        """A fused :class:`XDMAQueue` run: one chained event per task, shapes
        propagated through the queue's compile-time contracts."""
        leaf = _primary_leaf(x)
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        logical = (_logical_of(queue.descriptors[0], shape, dtype)
                   if queue.descriptors else None)
        deps = self._provenance(x)
        evs: List[TraceEvent] = []
        for i, desc in enumerate(queue.descriptors):
            ev = self._event(desc, logical=logical, dtype=dtype, deps=deps,
                             label=f"{queue.name}[{i}]", source="queue")
            if logical is not None:
                try:
                    logical = desc.out_logical_shape(logical)
                    dtype = desc.out_dtype(dtype)
                except Exception:
                    logical = None
            deps = (ev.id,)
            evs.append(ev)
        if evs:
            self.register_value(evs[-1], out)
        return evs

    def record_submit(self, x: Any, desc: XDMADescriptor, link: str, *,
                      deps: Sequence[int] = (), label: str = "",
                      ring_occupancy: Optional[int] = None) -> TraceEvent:
        """A scheduler-submitted task; sizes are finalized at dispatch via
        :meth:`finalize` (the scheduler measures the real payload then).
        ``ring_occupancy`` records the submitting ring's fill level right
        after the doorbell."""
        leaf = _primary_leaf(x)
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        all_deps = tuple(dict.fromkeys(tuple(deps) + self._provenance(x)))
        ev = self._event(desc, logical=_logical_of(desc, shape, dtype),
                         dtype=dtype, deps=all_deps,
                         label=label, source="scheduler", link=link)
        ev.ring_occupancy = ring_occupancy
        return ev

    def record_compute(self, resource: str, cost_s: float, *,
                       deps: Sequence[int] = (), label: str = "") -> TraceEvent:
        ev = TraceEvent(
            id=len(self.events), kind="compute", endpoint="compute",
            link=resource, deps=tuple(deps), cost_s=float(cost_s),
            label=label, source="compute")
        self.events.append(ev)
        return ev

    @staticmethod
    def finalize(ev: TraceEvent, *, nbytes: Optional[int],
                 burst_bytes: Optional[int], value: Any = None) -> None:
        """Fill a submit-time event with dispatch-time facts: the measured
        payload, the routed burst, and — for future-fed tasks whose src
        buffer only materialized at dispatch — the geometry."""
        if nbytes is not None:
            ev.nbytes = int(nbytes)
        if ev.burst_bytes is None:
            ev.burst_bytes = burst_bytes
        if ev.logical_shape is None and ev.desc is not None and value is not None:
            leaf = _primary_leaf(value)
            shape = getattr(leaf, "shape", None)
            dtype = getattr(leaf, "dtype", None)
            logical = _logical_of(ev.desc, shape, dtype)
            ev.logical_shape, ev.in_dtype = logical, dtype
            if logical is not None:
                if ev.row_bytes is None:
                    ev.row_bytes = int(logical[-1]) * _itemsize(dtype)
                if ev.burst_bytes is None:
                    try:
                        ev.burst_bytes = ev.desc.burst_bytes(logical, dtype)
                    except (ValueError, KeyError):
                        pass
                if ev.wire_nbytes is None:
                    # future-fed codec/remote submits get their wire price
                    # the moment the src geometry is known
                    ev.wire_nbytes = _wire_nbytes(ev.desc, logical, dtype)

    # -- queries -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[TraceEvent]:
        return iter(self.events)

    def xdma_events(self) -> List[TraceEvent]:
        return [e for e in self.events if e.kind == "xdma"]

    def labelled(self, prefix: str) -> List[TraceEvent]:
        """Events whose label starts with ``prefix`` — the accounting hook
        for subsystems that tag their traffic (``page:`` for the paged-KV
        pool, ``kv:`` for the fixed-batch engine's cache roundtrips)."""
        return [e for e in self.events if e.label.startswith(prefix)]

    def by_endpoint(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.xdma_events():
            out[e.endpoint] = out.get(e.endpoint, 0) + 1
        return out

    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes or 0 for e in self.xdma_events())

    def per_link_bytes(self) -> Dict[str, int]:
        """Payload bytes per pinned link (scheduler-routed events only) —
        comparable 1:1 with the per-link sums of the submitting scheduler's
        ``sim_tasks()`` (the byte-parity contract)."""
        out: Dict[str, int] = {}
        for e in self.xdma_events():
            if e.link is not None:
                out[e.link] = out.get(e.link, 0) + (e.nbytes or 0)
        return out

    def summary(self) -> str:
        kinds = ", ".join(f"{k}={n}" for k, n in sorted(self.by_endpoint().items()))
        return (f"TransferTrace({self.name!r}, {len(self.events)} events, "
                f"{self.total_bytes} bytes; {kinds or 'empty'})")

    # -- replay --------------------------------------------------------------
    def sim_tasks(self, topology: Topology, *, sw_agu: bool = False) -> List[SimTask]:
        """The ledger as simulator tasks on ``topology``: events pinned to a
        link that exists there keep it, the rest round-robin over the fabric
        (the scheduler's default routing); compute events keep their engine.
        ``sw_agu`` switches the address-generation cost model (see module
        docstring)."""
        links = topology.link_names
        if not links:
            raise ValueError(f"topology {topology.name!r} has no links")
        # Multicast groups whose recorded tree does not fit this fabric (some
        # hop link missing) are re-synthesized from the group's recorded spec:
        # fresh tree, fresh per-hop tasks, downstream deps remapped onto the
        # new delivery hops.  Groups whose links all exist replay unchanged —
        # same-fabric replay keeps per-edge byte parity with the capture.
        groups: Dict[int, List[TraceEvent]] = {}
        for ev in self.events:
            if ev.multicast_group is not None:
                groups.setdefault(ev.multicast_group, []).append(ev)
        resynth: Dict[int, List[SimTask]] = {}    # anchor ev id -> new tasks
        dep_map: Dict[int, Tuple[int, ...]] = {}  # old ev id -> new task ids
        skip: set = set()
        next_id = max((e.id for e in self.events), default=-1) + 1
        for gid, evs in groups.items():
            if all(e.link is not None and e.link in topology for e in evs):
                continue
            anchor = next((e for e in evs if e.multicast_spec is not None),
                          None)
            if anchor is None:
                continue          # no spec recorded: fall through to rr routing
            mc_src, specs, d_buf = anchor.multicast_spec
            try:
                tree = topology.multicast_tree(mc_src, [n for n, _ in specs])
            except ValueError:
                continue          # nodes unknown here: fall through
            new: List[SimTask] = []
            delivery: Dict[str, int] = {}
            for hop in tree.hops:
                tid = next_id
                next_id += 1
                new.append(SimTask(
                    id=tid, resource=hop.link,
                    nbytes=int(anchor.wire_nbytes
                               if anchor.wire_nbytes is not None
                               else anchor.nbytes or 0),
                    deps=(anchor.deps if hop.parent is None
                          else (new[hop.parent].id,)),
                    label=f"{anchor.label}/{hop.src}->{hop.dst}",
                    burst_bytes=anchor.burst_bytes,
                    pipeline_depth=int(d_buf)))
                delivery[hop.dst] = tid
            leaves = tuple(delivery[n] for n, _ in specs)
            for e in evs:
                skip.add(e.id)
                if e.multicast_hop is not None \
                        and e.multicast_hop[1] in delivery:
                    dep_map[e.id] = (delivery[e.multicast_hop[1]],)
                else:
                    dep_map[e.id] = leaves
            resynth[anchor.id] = new
        def _remap(deps: Tuple[int, ...]) -> Tuple[int, ...]:
            return tuple(dict.fromkeys(
                nid for d in deps for nid in dep_map.get(d, (d,))))

        rr = 0
        tasks: List[SimTask] = []
        for ev in self.events:
            if ev.id in skip:
                for t in resynth.pop(ev.id, ()):
                    burst = t.burst_bytes or ev.row_bytes
                    if sw_agu:
                        t = dataclasses.replace(
                            t, burst_bytes=burst,
                            issue_overhead_s=SW_ISSUE_OVERHEAD,
                            pipeline_depth=1)
                    else:
                        t = dataclasses.replace(t, burst_bytes=burst)
                    tasks.append(t)
                continue
            if ev.kind == "compute":
                tasks.append(SimTask(id=ev.id, resource=ev.link or "compute0",
                                     deps=_remap(ev.deps), cost_s=ev.cost_s,
                                     label=ev.label))
                continue
            if ev.link is not None and ev.link in topology:
                res = ev.link
            else:
                res = links[rr % len(links)]
                rr += 1
            task = None
            if (ev.desc is not None and ev.logical_shape is not None
                    and ev.in_dtype is not None):
                # the contract path queue replays use: nbytes + burst geometry
                # derived from the descriptor alone, no execution needed
                try:
                    task = queue_sim_tasks(XDMAQueue([ev.desc], name="ev"),
                                           ev.logical_shape, ev.in_dtype, res,
                                           start_id=ev.id)[0]
                    task = dataclasses.replace(task, deps=_remap(ev.deps),
                                               label=ev.label)
                except (ValueError, KeyError):
                    task = None
            if task is None:
                task = SimTask(id=ev.id, resource=res, nbytes=ev.nbytes or 0,
                               deps=_remap(ev.deps), label=ev.label,
                               burst_bytes=ev.burst_bytes,
                               pipeline_depth=ev.pipeline_depth)
            if ev.wire_nbytes is not None:
                task = dataclasses.replace(task, nbytes=int(ev.wire_nbytes))
            # Both cost models issue one address per contiguous run of the
            # composed pattern; when no pattern exists (plugin chains, remote
            # exchanges) the issue unit is a logical row.  They differ in the
            # per-issue cost and in pipelining: the Frontend amortizes its
            # 50ns over d_buf in-flight bursts, the software loop pays 1us
            # serially per 1D-DMA program.
            burst = task.burst_bytes or ev.burst_bytes or ev.row_bytes
            if sw_agu:
                task = dataclasses.replace(
                    task, burst_bytes=burst,
                    issue_overhead_s=SW_ISSUE_OVERHEAD, pipeline_depth=1)
            else:
                task = dataclasses.replace(task, burst_bytes=burst)
            tasks.append(task)
        return tasks

    def replay(self, topology: Topology, *, sw_agu: bool = False) -> SimReport:
        """Simulate the captured application timeline on ``topology``."""
        return simulate(self.sim_tasks(topology, sw_agu=sw_agu), topology)


def current() -> Optional[TransferTrace]:
    """The ambient capture trace, or None when capture is off."""
    return _api._CAPTURE


@contextlib.contextmanager
def capture(trace: Optional[TransferTrace] = None, *, name: str = "trace"):
    """Open a capture scope: every movement issued through the plane's
    chokepoints records into the yielded :class:`TransferTrace`.  Nested
    captures shadow the outer one (innermost wins)."""
    t = trace if trace is not None else TransferTrace(name=name)
    prev = _api._CAPTURE
    _api._CAPTURE = t
    try:
        yield t
    finally:
        _api._CAPTURE = prev


def replay(trace: TransferTrace, topology: Topology, *,
           sw_agu: bool = False) -> SimReport:
    """Module-level spelling of :meth:`TransferTrace.replay`."""
    return trace.replay(topology, sw_agu=sw_agu)
