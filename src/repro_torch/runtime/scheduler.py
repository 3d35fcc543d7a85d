"""Async XDMA dispatch: per-link descriptor rings, futures, batched rounds.

The port's twin of ``repro.runtime.scheduler``.  What the port changes: a
batched round is the batched tasks' cached lowerings launched in order on
the current stream (the reference jits them into one program), the device
of each input decides where its task runs (there is no ``interpret``), and
payload sizes come from :func:`_leaves`, which flattens tensors, payload
carriers and containers in the reference's pytree order.  The completion
timestamps, the incremental makespan and every counter bank are the
reference's arithmetic, operation for operation.

Paper §II-B gives each *link* its own Controller task queue: tasks on one
link dispatch strictly in order, tasks on different links dispatch
concurrently.  :class:`DistributedScheduler` is that Controller distributed
across a :class:`~repro_torch.runtime.topology.Topology`, with the production
submission shape (DESIGN.md §12): fixed-depth **descriptor rings** instead
of unbounded FIFOs.

* ``submit(x, desc, link=..., deps=..., tenant=...)`` posts one descriptor
  into a per-(link, tenant) :class:`~repro_torch.runtime.ring.DescriptorRing` and
  rings its doorbell — the CSR write the simulator prices via
  ``Link.csr_write_cost``, separately from the data transfer.  It returns an
  :class:`XDMAFuture` immediately — the token other tasks name as a
  dependency (the CFG phase stays compile-time: lowering reuses the
  per-descriptor cache in :mod:`repro_torch.core.api`).  A post consumes a ring
  *credit*; when the ring is full, the ``block`` policy (default) drains
  scheduling rounds until a completion returns one, and the ``error`` policy
  raises :class:`~repro_torch.runtime.ring.WouldBlock` for the caller to handle.
* ``submit_compute(fn, ...)`` enqueues interleaved compute (expert FFN, host
  preprocessing) on a named compute engine so transfer/compute overlap is
  visible to the simulator.
* ``flush()`` drains the rings in *scheduling rounds*: each round takes one
  ready ring head per resource — round-robin over that resource's tenant
  rings, which is what keeps a starved tenant near its fair share under
  adversarial load — and dispatches them together.  Local concrete-array
  tasks form one batched round per scheduling round (cached by the tuple of
  descriptor identities), everything else dispatches through exactly the
  same cached lowering ``xdma.transfer`` uses, so results are
  bit-identical to a serial replay of the same descriptors.  No task falls
  back to another lowering: a task on a CUDA tensor launches its kernels,
  or the round fails.

Every dispatch retires its ring head into a completion queue
(``scheduler.completions``) carrying the simulated span — which resolves
futures, returns the credit, and keeps an *incremental* makespan that is
bit-equal to the full event-driven replay once the rings are drained.
``sim_tasks()`` / ``report()`` still replay the schedule through
:mod:`repro_torch.runtime.simulator` for the full timeline.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _pytree
from repro_torch.core import api as _api
from repro_torch.core import autotune as _autotune
from repro_torch.core import layouts as _L
from repro_torch.core import plugins as _P
from repro_torch.core.descriptor import XDMADescriptor, describe

from . import telemetry as _tm
from .ring import DEFAULT_RING_DEPTH, Completion, DescriptorRing, WouldBlock
from .simulator import SimReport, SimTask, simulate
from .topology import MulticastTree, Topology

__all__ = ["XDMAFuture", "MulticastFuture", "DistributedScheduler"]

# CSR-style counter banks (DESIGN.md §11): per-link byte/burst/stall tallies,
# per-resource queue-occupancy high-water marks, and the ring plane's
# doorbell / credit / fairness counters.  Always counting — the increments
# are dict adds, same cost class as the old ad-hoc stats — while span timing
# stays gated on an active telemetry session.
_LINKS = _tm.bank("links")
_QUEUES = _tm.bank("queues")
_RINGS = _tm.bank("rings")
# The multicast plane (DESIGN.md §14): trees built, hops/forks posted, and
# the wire bytes shared hops avoid moving vs N private unicast copies.
_MCAST = _tm.bank("multicast")

# Batched rounds, shared by every scheduler instance: keyed by the round's
# descriptor identities (same scheme as the CFG cache), each entry the tuple
# of the batched tasks' cached lowerings, launched in order.  A fresh
# scheduler per step reuses them.  Bounded LRU for the same reason the CFG
# cache is: id-keyed descriptor churn must not pin lowerings (and the weight
# tensors they hold) forever.
_ROUND_CACHE: "collections.OrderedDict[Any, Callable]" = collections.OrderedDict()
_ROUND_CACHE_CAPACITY = 256
# Rounds hold CFG-cache lowerings, so xdma.clear_cache() must drop them too:
# a stale round would bypass the cleared cache.
_api._AUX_CACHES.append(_ROUND_CACHE)


def _burst_bytes(desc: XDMADescriptor, value: Any) -> Optional[int]:
    """Pattern-contiguity burst of one dispatched task, from the descriptor's
    composed affine pattern (None when no pattern applies — payload pytrees,
    plugin chains, remote links — which keeps the one-burst pricing)."""
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is None or dtype is None or len(shape) < 2:
        return None
    try:
        return desc.burst_bytes(desc.src.layout.logical_shape(shape), dtype)
    except (ValueError, KeyError):
        return None


def _payload(x: Any) -> Any:
    """The tensor carrying a payload's geometry: a QTensor's or CTensor's
    values, else the value itself.  (The reference reads ``x.values`` where
    present; a torch tensor has a ``values`` method, so the port asks for
    the carrier types instead.)"""
    return x.values if isinstance(x, (_P.QTensor, _P.CTensor)) else x


def _leaves(value: Any) -> List[Any]:
    """The leaves of a payload in the order JAX's pytree flattening gives
    the reference's (:func:`repro_torch._pytree.leaves`)."""
    return _pytree.leaves(value)


def _leaf_nbytes(leaf: Any) -> Optional[int]:
    """Bytes of one leaf with a size and a dtype (a tensor or a numpy
    array / scalar), None for the rest (a Python scalar)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if isinstance(leaf, (np.ndarray, np.generic)):
        return int(leaf.size) * int(leaf.dtype.itemsize)
    return None


def _nbytes(value: Any) -> int:
    """Payload bytes of a tensor / QTensor / CTensor / container."""
    return sum(n for n in map(_leaf_nbytes, _leaves(value)) if n is not None)


class XDMAFuture:
    """Handle for a submitted task: a dependency token and a deferred result."""

    __slots__ = ("_sched", "task_id")

    def __init__(self, sched: "DistributedScheduler", task_id: int):
        self._sched = sched
        self.task_id = task_id

    def done(self) -> bool:
        return self._sched._tasks[self.task_id].done

    def result(self) -> Any:
        """Drain the scheduler until *this* task has dispatched, then return
        its output (the physical dst buffer, exactly as ``xdma.transfer``).
        Later independent tasks stay pending — ``result()`` runs scheduling
        rounds only until this task's completion retires; use ``flush()`` to
        drain everything."""
        t = self._sched._tasks[self.task_id]
        while not t.done:
            self._sched.step()
        if t.value is _RELEASED:
            raise RuntimeError(f"task {t.id}'s output was released")
        return t.value

    def __repr__(self):
        state = "done" if self.done() else "pending"
        return f"XDMAFuture(task={self.task_id}, {state})"


class MulticastFuture:
    """Handle for one tree-routed multicast: the fan of per-destination
    delivery futures plus the synthesized :class:`MulticastTree`.

    ``result()`` returns the per-destination dst buffers in the descriptor's
    destination order; the multicast *completes* only when every leaf hop
    has retired (all-leaves semantics — intermediate forwarding hops alone
    do not complete it)."""

    __slots__ = ("_sched", "tree", "_delivery")

    def __init__(self, sched: "DistributedScheduler", tree: MulticastTree,
                 delivery: "collections.OrderedDict[str, XDMAFuture]"):
        self._sched = sched
        self.tree = tree
        self._delivery = delivery

    @property
    def dsts(self) -> Tuple[str, ...]:
        return tuple(self._delivery)

    def future(self, dst: str) -> XDMAFuture:
        """The delivery future for one destination node."""
        return self._delivery[dst]

    def done(self) -> bool:
        return all(f.done() for f in self._delivery.values())

    def result(self) -> Tuple[Any, ...]:
        """Drain until every destination's delivery hop has dispatched, then
        return the per-destination buffers (descriptor destination order)."""
        return tuple(f.result() for f in self._delivery.values())

    def result_at(self, dst: str) -> Any:
        return self._delivery[dst].result()

    def dst_descriptors(self) -> Dict[str, XDMADescriptor]:
        """The (possibly auto-resolved) delivery-hop descriptor per
        destination — how each dst's layout actually resolved against its
        routed link."""
        return {d: self._sched._tasks[f.task_id].desc
                for d, f in self._delivery.items()}

    def __repr__(self):
        state = "done" if self.done() else "pending"
        return (f"MulticastFuture({len(self._delivery)} dsts, "
                f"{len(self.tree.hops)} hops, {state})")


_RELEASED = object()        # a task output dropped by ``release``


@dataclasses.dataclass
class _Task:
    id: int
    kind: str                            # "xdma" | "compute"
    resource: str
    deps: Tuple[int, ...]
    desc: Optional[XDMADescriptor] = None
    fn: Optional[Callable] = None
    inputs: Tuple[Any, ...] = ()         # arrays or XDMAFutures
    cost_s: float = 0.0
    nbytes: Optional[int] = None
    burst_bytes: Optional[int] = None    # pattern contiguity (link pricing)
    label: str = ""
    tenant: str = ""                     # which per-tenant ring holds it
    csr_writes: int = 0                  # doorbell CSR writes to price
    done: bool = False
    value: Any = None
    round: int = -1
    event: Any = None                    # TraceEvent when a capture was open
    trace: Any = None                    # the TransferTrace owning `event`


class DistributedScheduler:
    """The distributed Controller: descriptor rings per (resource, tenant).

    ``ring_depth`` bounds every ring (credits = free slots); ``backpressure``
    picks the full-ring policy — ``"block"`` (default) drains scheduling
    rounds inside ``submit`` until a credit frees, ``"error"`` raises
    :class:`~repro_torch.runtime.ring.WouldBlock` for the caller to handle.
    Blocking can never deadlock: dependencies must already be submitted, so
    the oldest pending task always sits dep-satisfied at its ring head and
    every round retires at least one descriptor."""

    def __init__(self, topology: Topology, *, name: str = "sched",
                 ring_depth: int = DEFAULT_RING_DEPTH,
                 backpressure: str = "block"):
        if backpressure not in ("block", "error"):
            raise ValueError(f"backpressure must be 'block' or 'error', "
                             f"got {backpressure!r}")
        self.topology = topology
        self.name = name
        self.ring_depth = int(ring_depth)
        self.backpressure = backpressure
        self._tasks: Dict[int, _Task] = {}
        # resource -> tenant -> its descriptor ring (created on first post)
        self._rings: Dict[str, Dict[str, DescriptorRing]] = {
            n: {} for n in topology.link_names}
        self._rr: Dict[str, int] = {}    # per-resource tenant-arbitration cursor
        self._dispatched: Dict[str, List[int]] = {}  # per-resource pop order
        self.completions: List[Completion] = []      # the completion queue
        self._sim_end: Dict[int, float] = {}         # task id -> simulated end
        self._sim_free: Dict[str, float] = {}        # resource -> busy-until
        self._makespan_inc = 0.0         # incremental makespan (== replay)
        self._pending = 0
        self._next_id = 0
        self._next_link = 0              # round-robin routing cursor
        self._rounds = 0

    def _ring(self, resource: str, tenant: str) -> DescriptorRing:
        rings = self._rings.setdefault(resource, {})
        ring = rings.get(tenant)
        if ring is None:
            who = f"{resource}/{tenant}" if tenant else resource
            ring = DescriptorRing(who, self.ring_depth)
            rings[tenant] = ring
        return ring

    # -- submission ----------------------------------------------------------
    def _route(self, desc: XDMADescriptor, link: Optional[str]) -> str:
        if link is not None:
            self.topology.link(link)     # raises on unknown names
            return link
        # Default policy: round-robin over the fabric — the Controller's
        # load-balancing when the descriptor does not pin a link.
        names = self.topology.link_names
        if not names:
            raise ValueError(f"topology {self.topology.name!r} has no links")
        name = names[self._next_link % len(names)]
        self._next_link += 1
        return name

    def _enqueue(self, task: _Task) -> XDMAFuture:
        for d in task.deps:
            if d not in self._tasks:
                raise ValueError(f"dependency on unknown task {d}")
        ring = self._ring(task.resource, task.tenant)
        if ring.is_full:
            _RINGS.inc(f"full:{task.resource}")
            if self.backpressure == "error":
                raise WouldBlock(task.resource, task.tenant, ring.depth)
            # block: drain scheduling rounds until a completion returns a
            # credit.  The ring's own head is pending, so step() always
            # progresses (or raises on a genuine dependency cycle).
            while ring.is_full:
                self.step()
        self._tasks[task.id] = task
        self._pending += 1
        ring.post(task.id)               # descriptor write + doorbell
        _RINGS.inc(f"doorbells:{task.resource}")
        occupied = sum(r.occupancy
                       for r in self._rings[task.resource].values())
        _QUEUES.record_max(f"occupancy_hw:{task.resource}", occupied)
        _RINGS.record_max(f"credits_hw:{task.resource}", occupied)
        return XDMAFuture(self, task.id)

    def _dep_events(self, deps: Tuple[int, ...]) -> Tuple[int, ...]:
        """Ledger event ids of dependency tasks.  Unknown dep ids are left
        for _enqueue's validation to reject with its designed error."""
        return tuple(t.event.id for t in
                     (self._tasks.get(d) for d in deps)
                     if t is not None and t.event is not None)

    @staticmethod
    def _dep_ids(inputs: Sequence[Any], deps: Sequence) -> Tuple[int, ...]:
        ids: List[int] = []
        for obj in list(inputs) + list(deps):
            if isinstance(obj, XDMAFuture):
                if obj.task_id not in ids:
                    ids.append(obj.task_id)
        return tuple(ids)

    def submit(self, x: Any, desc: XDMADescriptor, *,
               link: Optional[str] = None, deps: Sequence = (),
               nbytes: Optional[int] = None, label: str = "",
               tenant: str = "") -> XDMAFuture:
        """Post one XDMA descriptor into a per-(link, tenant) ring; returns
        its future.

        ``x`` is the src physical buffer or the :class:`XDMAFuture` of the
        task producing it; ``deps`` adds ordering-only dependency tokens.
        ``link`` pins the task to a named link (round-robin otherwise).
        ``tenant`` names the submitter's ring on that link — per-tenant rings
        are arbitrated round-robin at dispatch, so one tenant flooding its
        ring cannot starve another.  The post consumes a ring credit; see the
        class docstring for the full-ring ``backpressure`` policy.
        """
        tel = _tm._ACTIVE
        if tel is None:
            return self._submit(x, desc, link, deps, nbytes, label, tenant)
        with tel.span("DistributedScheduler.submit", track="scheduler",
                      desc=desc.summary() if isinstance(desc, XDMADescriptor)
                      else repr(desc)):
            return self._submit(x, desc, link, deps, nbytes, label, tenant)

    def _submit(self, x, desc, link, deps, nbytes, label,
                tenant="") -> XDMAFuture:
        if not isinstance(desc, XDMADescriptor):
            raise TypeError(f"submit takes a descriptor, got {type(desc)}")
        if desc.movement == "multicast" and desc.dst.dsts is not None:
            raise ValueError(
                "node-addressed multicast descriptors fork into per-hop tree "
                "tasks: use submit_multicast(x, desc, src=...) instead of "
                "submit()")
        resource = self._route(desc, link)
        desc = self._resolve_auto(desc, x, resource)
        tid = self._next_id
        self._next_id += 1
        task = _Task(id=tid, kind="xdma", resource=resource,
                     deps=self._dep_ids((x,), deps), desc=desc, inputs=(x,),
                     nbytes=nbytes, label=label or desc.summary(),
                     tenant=tenant, csr_writes=1)
        fut = self._enqueue(task)        # validate before the ledger records:
        cap = _api._CAPTURE              # a rejected submit must not leave a
        if cap is not None:              # phantom event (DESIGN.md §9)
            task.event = cap.record_submit(
                x if not isinstance(x, XDMAFuture) else None, desc,
                task.resource, deps=self._dep_events(task.deps),
                label=task.label,
                ring_occupancy=self._rings[task.resource][tenant].occupancy)
            task.trace = cap
        return fut

    def submit_compute(self, fn: Callable, *inputs: Any,
                       resource: str = "compute0", deps: Sequence = (),
                       cost_s: float = 0.0, label: str = "",
                       tenant: str = "") -> XDMAFuture:
        """Enqueue interleaved compute on a named engine (in-order per
        engine).  ``cost_s`` is its duration in the simulated timeline."""
        tel = _tm._ACTIVE
        if tel is None:
            return self._submit_compute(fn, inputs, resource, deps, cost_s,
                                        label, tenant)
        with tel.span("DistributedScheduler.submit_compute",
                      track="scheduler", resource=resource,
                      label=label or getattr(fn, "__name__", "compute")):
            return self._submit_compute(fn, inputs, resource, deps, cost_s,
                                        label, tenant)

    def _submit_compute(self, fn, inputs, resource, deps, cost_s,
                        label, tenant="") -> XDMAFuture:
        if resource in self.topology:
            raise ValueError(f"{resource!r} is a link; compute engines must "
                             "use a non-link resource name")
        tid = self._next_id
        self._next_id += 1
        task = _Task(id=tid, kind="compute", resource=resource,
                     deps=self._dep_ids(inputs, deps), fn=fn, inputs=inputs,
                     cost_s=float(cost_s), tenant=tenant,
                     label=label or getattr(fn, "__name__", "compute"))
        fut = self._enqueue(task)
        cap = _api._CAPTURE
        if cap is not None:
            task.event = cap.record_compute(resource, task.cost_s,
                                            deps=self._dep_events(task.deps),
                                            label=task.label)
            task.trace = cap
        return fut

    # -- multicast (DESIGN.md §14) -------------------------------------------
    def submit_multicast(self, x: Any, desc: XDMADescriptor, *, src: str,
                         deps: Sequence = (), tenant: str = "",
                         label: str = "",
                         policy: str = "tree") -> MulticastFuture:
        """Fork one node-addressed multicast descriptor into per-hop tasks
        over :meth:`Topology.multicast_tree`.

        ``x`` is the payload at ``src`` (or the :class:`XDMAFuture`
        producing it); ``desc.dst`` must be ``Endpoint.multicast(dsts=...)``.
        Every tree hop becomes one ordinary ring post on its own link — one
        doorbell CSR write and one ring credit per hop, exactly the PR-8
        submission machinery — with each non-root hop data-dependent on the
        hop that feeds it, so a shared edge carries the payload once and the
        simulator prices it once.  A destination layout spelled ``"auto"``
        resolves independently against that destination's routed delivery
        link.  Returns a :class:`MulticastFuture` completing when all leaves
        retire."""
        tel = _tm._ACTIVE
        if tel is None:
            return self._submit_multicast(x, desc, src, deps, tenant, label,
                                          policy)
        with tel.span("DistributedScheduler.submit_multicast",
                      track="scheduler", desc=desc.summary()
                      if isinstance(desc, XDMADescriptor) else repr(desc)):
            return self._submit_multicast(x, desc, src, deps, tenant, label,
                                          policy)

    def _submit_multicast(self, x, desc, src, deps, tenant, label,
                          policy) -> MulticastFuture:
        if not isinstance(desc, XDMADescriptor):
            raise TypeError(f"submit_multicast takes a descriptor, "
                            f"got {type(desc)}")
        if desc.movement != "multicast" or desc.dst.dsts is None:
            raise ValueError("submit_multicast needs a node-addressed "
                             "multicast descriptor (Endpoint.multicast)")
        if desc.pre or desc.post:
            raise ValueError("multicast hops are pure relayouts; plugin "
                             "chains are not supported on multicast "
                             "descriptors yet")
        spec_map = dict(desc.dst.dsts)
        tree = self.topology.multicast_tree(
            src, [n for n, _ in desc.dst.dsts], policy=policy)
        transit = (desc.src.layout if not desc.src.layout.is_auto else _L.MN)
        # the payload geometry, when known at submit: lets per-dst "auto"
        # layouts resolve eagerly against their delivery links, so a child
        # hop can chain off its parent's *resolved* physical layout
        logical = dtype = None
        if not isinstance(x, XDMAFuture):
            leaf = _payload(x)
            shape = getattr(leaf, "shape", None)
            if shape is not None and getattr(leaf, "dtype", None) is not None:
                shape = tuple(int(s) for s in shape)
                try:
                    logical = (transit.logical_shape(shape)
                               if not desc.src.layout.is_auto else shape)
                except (ValueError, KeyError):
                    logical = shape
                dtype = leaf.dtype
        forwards = {h.src for h in tree.hops}
        gid = self._next_id              # group id: unique, pre-allocation
        futs: List[XDMAFuture] = []
        out_layouts: List[_L.Layout] = []
        hop_events: List[Any] = []
        base = label or "mcast"
        for hop in tree.hops:
            lay = spec_map.get(hop.dst, transit)
            if lay.is_auto:
                if logical is not None:
                    probe = describe(_L.MN, lay, d_buf=desc.d_buf)
                    resolved = _autotune.resolve_descriptor(
                        probe, logical, dtype,
                        link=self.topology.link(hop.link))
                    lay = resolved.dst.layout
                elif hop.dst in forwards:
                    raise ValueError(
                        f"destination {hop.dst!r} forwards to other hops, so "
                        "its 'auto' layout needs a concrete payload at "
                        "submit time (future-fed multicast resolves auto "
                        "only on leaf destinations)")
            in_lay = (transit if hop.parent is None
                      else out_layouts[hop.parent])
            hop_desc = describe(in_lay, lay, d_buf=desc.d_buf)
            fut = self._submit(
                x if hop.parent is None else futs[hop.parent], hop_desc,
                hop.link, tuple(deps) if hop.parent is None else (), None,
                f"{base}/{hop.src}->{hop.dst}", tenant)
            futs.append(fut)
            out_layouts.append(lay)
            task = self._tasks[fut.task_id]
            if task.event is not None:
                ev = task.event
                ev.endpoint = "multicast"
                ev.multicast_group = gid
                ev.multicast_hop = (hop.src, hop.dst)
                ev.multicast_serves = len(hop.serves)
                hop_events.append(ev)
        if hop_events:
            # the anchor: enough to re-synthesize the tree on any fabric
            hop_events[0].multicast_spec = (
                src, tuple((n, l.name) for n, l in desc.dst.dsts), desc.d_buf)
        _MCAST.inc("trees")
        _MCAST.inc("hops", len(tree.hops))
        _MCAST.inc("forks", tree.fork_count)
        _MCAST.inc("shared_hops", tree.shared_hop_count)
        if tree.kind == "chain":
            _MCAST.inc("chain_fallbacks")
        if not isinstance(x, XDMAFuture):
            _MCAST.inc("saved_hop_bytes", tree.bytes_saved(_nbytes(x)))
        delivery = collections.OrderedDict(
            (d, futs[tree.delivery(d)]) for d in tree.dsts)
        return MulticastFuture(self, tree, delivery)

    def _resolve_auto(self, desc: XDMADescriptor, x: Any,
                      resource: str) -> XDMADescriptor:
        """Thread the *routed link* into the layout autotuner: an ``auto``
        endpoint tunes for the fabric the task actually rides (DESIGN.md
        §13), so the same descriptor picks differently on a wide-beat link
        than on a narrow one.  Future inputs defer to dispatch time — their
        shape is unknown until the producer retires."""
        if (desc is None or not desc.has_auto
                or isinstance(x, XDMAFuture)):
            return desc
        leaf = _payload(x)                       # QTensor/CTensor payloads
        if getattr(leaf, "shape", None) is None \
                or getattr(leaf, "dtype", None) is None:
            return desc
        link = (self.topology.link(resource)
                if resource in self.topology else None)
        try:
            return _api._resolve_auto(desc, x, link)
        except ValueError:
            return desc                          # lowering reports the error

    # -- dispatch ------------------------------------------------------------
    def _resolve(self, obj: Any) -> Any:
        if isinstance(obj, XDMAFuture):
            return self._tasks[obj.task_id].value
        return obj

    def _ready_heads(self) -> List[_Task]:
        """One ready ring head per resource, round-robin over its tenants.

        The rotating cursor is the credit arbitration: each round a resource
        serves the next tenant (in first-post order) whose head is
        dependency-ready, so a tenant flooding its ring gets at most one
        dispatch per round like everyone else.  With a single tenant this is
        exactly the old FIFO-head behavior, including stall accounting."""
        ready = []
        for res, rings in self._rings.items():
            tenants = [tn for tn, r in rings.items() if not r.is_empty]
            if not tenants:
                continue
            cursor = self._rr.get(res, 0)
            picked = None
            for k in range(len(tenants)):
                tn = tenants[(cursor + k) % len(tenants)]
                t = self._tasks[rings[tn].head()]
                if all(self._tasks[d].done for d in t.deps):
                    picked = t
                    self._rr[res] = (cursor + k + 1) % len(tenants)
                    break
            if picked is not None:
                ready.append(picked)
            else:
                # every occupied ring's head blocked on a dependency while
                # the resource idles: one stall round on this resource
                _LINKS.inc(f"stall_rounds:{res}")
        return ready

    @staticmethod
    def _batchable(t: _Task, x: Any) -> bool:
        # Local tasks batch whatever their lowering (the plain composition or
        # the plugin compiler's datapath kernels) — only the raw pallas
        # relayout backend keeps its own dispatch path, as in the reference.
        return (t.kind == "xdma" and t.desc is not None
                and t.desc.movement == "local" and t.desc.backend != "pallas")

    def _dispatch_round(self, ready: List[_Task]) -> None:
        inputs = [self._resolve(t.inputs[0]) if t.inputs else None
                  for t in ready]
        for i, t in enumerate(ready):
            # auto descriptors fed by futures resolve here, against the
            # producer's now-known output and the task's routed link
            if t.kind == "xdma" and t.desc is not None and t.desc.has_auto:
                t.desc = self._resolve_auto(t.desc, inputs[i], t.resource)
        batch = [i for i, t in enumerate(ready)
                 if self._batchable(t, inputs[i])]
        if len(batch) > 1:
            # One batched round: the cached per-descriptor lowerings, kept
            # as one tuple keyed by the round's descriptor identities and
            # launched in order on the current stream.
            key = tuple((ready[i].desc.cache_key(),) for i in batch)
            fns = _ROUND_CACHE.get(key)
            if fns is None:
                fns = tuple(_api._lowered(ready[i].desc) for i in batch)
                _ROUND_CACHE[key] = fns
                while len(_ROUND_CACHE) > _ROUND_CACHE_CAPACITY:
                    _ROUND_CACHE.popitem(last=False)
            else:
                _ROUND_CACHE.move_to_end(key)
            for i, f in zip(batch, fns):
                ready[i].value = f(inputs[i])
        else:
            batch = []
        fused_ids = set(batch)
        for i, t in enumerate(ready):
            if i not in fused_ids:
                if t.kind == "xdma":
                    t.value = _api._lowered(t.desc)(inputs[i])
                else:
                    t.value = t.fn(*(self._resolve(a) for a in t.inputs))
            if t.nbytes is None:
                t.nbytes = (_nbytes(inputs[i]) + _nbytes(t.value)
                            if t.kind == "xdma" else 0)
            if t.burst_bytes is None and t.kind == "xdma":
                t.burst_bytes = _burst_bytes(t.desc, inputs[i])
            if t.event is not None and t.kind == "xdma":
                # finalize the ledger row with the measured payload, and
                # register this task's output provenance with the trace that
                # OWNS the event (not whatever capture happens to be ambient
                # at flush time — a lazily-drained scheduler must not leak
                # its event ids into an unrelated trace)
                t.trace.finalize(t.event, nbytes=t.nbytes,
                                 burst_bytes=t.burst_bytes,
                                 value=inputs[i])
                t.trace.register_value(t.event, t.value)
            if t.kind == "xdma":
                self._count_dispatch(t)
            t.done = True
            t.round = self._rounds
            self._complete(t)
        self._rounds += 1

    def _complete(self, t: _Task) -> None:
        """Retire a dispatched task's ring head: return its credit, push a
        completion-queue entry, and advance the incremental makespan.

        The span arithmetic mirrors ``simulator.simulate`` operation for
        operation (same dep-max, same ``transfer_time`` call, same doorbell
        add), and per-resource completion order IS the replay's queue order,
        so ``_makespan_inc`` is bit-equal to ``report().makespan`` whenever
        the rings are drained."""
        popped = self._rings[t.resource][t.tenant].pop()
        assert popped == t.id, (popped, t.id)
        self._dispatched.setdefault(t.resource, []).append(t.id)
        self._pending -= 1
        ready = max((self._sim_end[d] for d in t.deps), default=0.0)
        start = max(ready, self._sim_free.get(t.resource, 0.0))
        if t.resource in self.topology:
            link = self.topology.link(t.resource)
            dur = link.transfer_time(
                int(t.nbytes or 0), t.burst_bytes,
                issue_overhead=None,
                pipeline_depth=(t.desc.d_buf if t.desc is not None else 1))
            if t.csr_writes:
                dur += t.csr_writes * link.csr_write_cost
        else:
            dur = max(0.0, float(t.cost_s))
        stop = start + dur
        self._sim_end[t.id] = stop
        self._sim_free[t.resource] = stop
        if stop > self._makespan_inc:
            self._makespan_inc = stop
        self.completions.append(Completion(
            task_id=t.id, resource=t.resource, tenant=t.tenant,
            round=self._rounds, start_s=start, end_s=stop))
        _RINGS.inc(f"tenant_dispatch:{t.tenant or 'default'}")

    def _count_dispatch(self, t: _Task) -> None:
        """Per-link CSR counters for one finalized dispatch: payload bytes
        (exactly the ledger's ``per_link_bytes`` contribution), wire bytes,
        generated bursts, and the amortized address-issue overhead the cost
        model charges (``bursts * burst_overhead / d_buf``)."""
        res = t.resource
        nbytes = int(t.nbytes or 0)
        _LINKS.inc(f"tasks:{res}")
        _LINKS.inc(f"bytes:{res}", nbytes)
        wire = (int(t.event.wire_nbytes)
                if t.event is not None and t.event.wire_nbytes is not None
                else nbytes)
        _LINKS.inc(f"wire_bytes:{res}", wire)
        if t.burst_bytes and nbytes > 0:
            n_bursts = -(-nbytes // int(t.burst_bytes))
        else:
            n_bursts = 1 if nbytes > 0 else 0
        _LINKS.inc(f"bursts:{res}", n_bursts)
        if res in self.topology and n_bursts and t.burst_bytes:
            link = self.topology.link(res)
            depth = t.desc.d_buf if t.desc is not None else 1
            _LINKS.inc(f"issue_ns:{res}",
                       int(round(n_bursts * link.burst_overhead * 1e9
                                 / max(1, int(depth)))))

    def step(self) -> bool:
        """Run one scheduling round; returns False when nothing is pending."""
        ready = self._ready_heads()
        if not ready:
            if self.pending:
                raise ValueError(
                    f"scheduler deadlocked with {self.pending} pending tasks "
                    "(dependency cycle across rings?)")
            return False
        self._dispatch_round(ready)
        return True

    def flush(self) -> None:
        """Drain every ring (runs scheduling rounds until idle)."""
        while self.step():
            pass

    def release(self, futures: Sequence[XDMAFuture]) -> None:
        """Drop the outputs and inputs of finished tasks, those of
        ``futures`` and of the tasks they depend on, once the caller holds
        what it needs (a serving loop moving its cache every step would
        otherwise keep every step's buffers alive).  Their timeline, bytes
        and ledger stay; ``result()`` of a released task raises."""
        todo = [f.task_id for f in futures]
        while todo:
            t = self._tasks[todo.pop()]
            if not t.done:
                raise ValueError(f"task {t.id} has not run; nothing to "
                                 f"release")
            if t.value is not _RELEASED:
                t.value, t.inputs = _RELEASED, ()
                todo.extend(t.deps)

    @property
    def pending(self) -> int:
        return self._pending

    # -- replay --------------------------------------------------------------
    def _sim_order(self) -> List[int]:
        """Task ids in global submission-order slots, each resource's slots
        re-filled in its actual dispatch order (pending tasks keep submission
        order after the dispatched prefix).  With a single tenant per
        resource, dispatch order IS submission order, so this is the
        identity — the replay contract existing call sites pin."""
        ids = sorted(self._tasks)
        per_res: Dict[str, List[int]] = {}
        for tid in ids:
            per_res.setdefault(self._tasks[tid].resource, []).append(tid)
        fill: Dict[str, collections.deque] = {}
        for res, tids in per_res.items():
            done = list(self._dispatched.get(res, ()))
            pend = [i for i in tids if not self._tasks[i].done]
            fill[res] = collections.deque(done + pend)
        return [fill[self._tasks[tid].resource].popleft() for tid in ids]

    def sim_tasks(self) -> List[SimTask]:
        """The recorded schedule as simulator tasks (dispatch order per
        resource — see :meth:`_sim_order`)."""
        out = []
        for tid in self._sim_order():
            t = self._tasks[tid]
            out.append(SimTask(id=t.id, resource=t.resource,
                               nbytes=int(t.nbytes or 0), deps=t.deps,
                               cost_s=t.cost_s, label=t.label,
                               burst_bytes=t.burst_bytes,
                               pipeline_depth=(t.desc.d_buf if t.desc is not None
                                               else 1),
                               csr_writes=t.csr_writes))
        return out

    def report(self) -> SimReport:
        """Deterministic replay of everything dispatched so far.

        .. deprecated:: PR 7
            The per-link byte/burst/stall totals this replay derives are
            mirrored live in ``telemetry.bank("links")`` and surface as
            ``snapshot()["surfaces"]["scheduler_links"]``; keep ``report()``
            for the full timeline (spans, utilization, makespan).
        """
        return simulate(self.sim_tasks(), self.topology)

    def makespan(self) -> float:
        """Simulated seconds to drain everything dispatched so far — the
        serving engines' per-step clock advance.

        O(1) when the rings are drained: the completion queue maintains the
        makespan incrementally with the replay's exact arithmetic.  With
        tasks still pending it falls back to the full replay (which prices
        the undispatched tail too)."""
        if self._pending:
            return self.report().makespan
        return self._makespan_inc

    def summary(self) -> str:
        lines = [f"DistributedScheduler({self.name!r}, "
                 f"{len(self._tasks)} tasks, {self._rounds} rounds, "
                 f"{len(self.completions)} completions)"]
        for res, rings in self._rings.items():
            for tn, ring in rings.items():
                total = ring.occupancy + sum(
                    1 for tid in self._dispatched.get(res, ())
                    if self._tasks[tid].tenant == tn)
                if total:
                    lines.append(f"  {ring.name}: {total} tasks "
                                 f"({total - ring.occupancy} dispatched, "
                                 f"{ring.credits}/{ring.depth} credits)")
        return "\n".join(lines)
