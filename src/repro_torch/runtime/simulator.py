"""Deterministic event-driven replay of an XDMA schedule against a topology.

The port's copy of ``repro.runtime.simulator``: the float arithmetic keeps
the reference's order of operations, so a replay of the same tasks gives
bitwise the same report.

Wall-clock timing on a shared CPU host is too noisy to reproduce the paper's
Fig. 4 link-utilization numbers.  This simulator replaces it: given the task
graph a :class:`~repro_torch.runtime.scheduler.DistributedScheduler` recorded (or a
hand-built one) and a :class:`~repro_torch.runtime.topology.Topology` cost model, it
replays the schedule with *exact* per-link in-order semantics — paper §II-B:
each link's Controller FIFO pops strictly in submission order, links run
concurrently — and reports per-link utilization, contention stalls, and
makespan.  Pure Python, no JAX, bit-deterministic.

Semantics:

* A :class:`SimTask` occupies one resource (a topology link, or a named
  compute engine for interleaved FFN/host work) for its whole duration.
* Tasks on the same resource run in submission order, back to back
  (head-of-line blocking included — that is the in-order FIFO contract).
* A task starts at ``max(resource free, all dep end times)``; the portion of
  that wait caused by the resource still being busy after the data was ready
  is the *contention stall*.
* Link task duration = ``link.transfer_time(nbytes)``; compute task duration
  = ``cost_s``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .topology import Topology

__all__ = ["SimTask", "Span", "SimReport", "simulate", "serialize",
           "queue_sim_tasks", "multicast_sim_tasks", "unicast_sim_tasks"]


@dataclasses.dataclass(frozen=True)
class SimTask:
    """One scheduled task: ``resource`` is a topology link name (transfer) or
    any other string (a compute engine).  ``deps`` are task ids that must end
    before this task may start.

    ``burst_bytes`` / ``issue_overhead_s`` / ``pipeline_depth`` price the
    transfer by its address pattern (see ``Link.transfer_time``): the
    contiguous run of the descriptor's composed affine pattern, the per-burst
    address-issue cost (None = the link's hardware AGU default; pass
    ``topology.SW_ISSUE_OVERHEAD`` for software address generation), and the
    ``d_buf`` stream-buffer depth amortizing it.  All default to the legacy
    one-burst model.

    ``csr_writes`` is the number of doorbell CSR writes this task's
    *configuration* cost — ring-based descriptor submission posts one per
    descriptor — each priced at ``link.csr_write_cost`` on top of the data
    transfer time.  Defaults to 0 (hand-built and replayed schedules price
    pure data movement)."""

    id: int
    resource: str
    nbytes: int = 0
    deps: Tuple[int, ...] = ()
    cost_s: float = 0.0                 # duration when resource is not a link
    label: str = ""
    burst_bytes: Optional[int] = None
    issue_overhead_s: Optional[float] = None
    pipeline_depth: int = 1
    csr_writes: int = 0


@dataclasses.dataclass(frozen=True)
class Span:
    """One task's occupancy on the simulated timeline."""

    task_id: int
    resource: str
    start: float
    end: float
    stall: float                        # contention wait (data ready, link busy)
    label: str = ""

    @property
    def duration(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class SimReport:
    """What the replay produced.  ``link_utilization`` maps every topology
    link to busy_time/makespan (0.0 for idle links); ``aggregate_utilization``
    is the paper's Fig. 4 metric generalized to a fabric: moved bytes over
    makespan * total fabric bandwidth."""

    makespan: float
    spans: List[Span]
    link_busy: Dict[str, float]
    link_utilization: Dict[str, float]
    compute_busy: Dict[str, float]
    total_bytes: int
    aggregate_utilization: float
    contention_stall: float

    @property
    def mean_link_utilization(self) -> float:
        if not self.link_utilization:
            return 0.0
        return sum(self.link_utilization.values()) / len(self.link_utilization)

    def span_of(self, task_id: int) -> Span:
        for s in self.spans:
            if s.task_id == task_id:
                return s
        raise KeyError(f"no span for task {task_id}")

    def summary(self) -> str:
        lines = [f"SimReport(makespan={self.makespan * 1e6:.2f}us, "
                 f"mean_util={self.mean_link_utilization:.3f}, "
                 f"agg_util={self.aggregate_utilization:.3f}, "
                 f"stall={self.contention_stall * 1e6:.2f}us)"]
        for name, util in self.link_utilization.items():
            lines.append(f"  link {name}: util={util:.3f} "
                         f"busy={self.link_busy[name] * 1e6:.2f}us")
        for name, busy in self.compute_busy.items():
            lines.append(f"  compute {name}: busy={busy * 1e6:.2f}us")
        return "\n".join(lines)


def simulate(tasks: Sequence[SimTask], topology: Topology) -> SimReport:
    """Replay ``tasks`` against ``topology`` (see module docstring)."""
    tasks = list(tasks)
    ids = [t.id for t in tasks]
    if len(set(ids)) != len(ids):
        raise ValueError("duplicate task ids in schedule")
    known = set(ids)
    for t in tasks:
        missing = [d for d in t.deps if d not in known]
        if missing:
            raise ValueError(f"task {t.id} depends on unknown tasks {missing}")

    # Per-resource FIFOs in submission order; links first, in topology order,
    # so iteration (and therefore the replay) is deterministic.
    queues: Dict[str, List[SimTask]] = {}
    for name in topology.link_names:
        queues[name] = []
    for t in tasks:
        queues.setdefault(t.resource, []).append(t)

    end: Dict[int, float] = {}
    free: Dict[str, float] = {name: 0.0 for name in queues}
    heads: Dict[str, int] = {name: 0 for name in queues}
    spans: List[Span] = []
    remaining = len(tasks)

    while remaining:
        progressed = False
        for res, q in queues.items():
            while heads[res] < len(q):
                t = q[heads[res]]
                if any(d not in end for d in t.deps):
                    break               # head-of-line blocked: FIFO stalls
                ready = max((end[d] for d in t.deps), default=0.0)
                start = max(ready, free[res])
                if t.resource in topology:
                    link = topology.link(t.resource)
                    dur = link.transfer_time(
                        t.nbytes, t.burst_bytes,
                        issue_overhead=t.issue_overhead_s,
                        pipeline_depth=t.pipeline_depth)
                    if t.csr_writes:
                        dur += t.csr_writes * link.csr_write_cost
                else:
                    dur = max(0.0, float(t.cost_s))
                stop = start + dur
                end[t.id] = stop
                free[res] = stop
                spans.append(Span(task_id=t.id, resource=res, start=start,
                                  end=stop, stall=start - ready, label=t.label))
                heads[res] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            stuck = [t.id for q in queues.values() for t in q
                     if t.id not in end]
            raise ValueError(f"schedule deadlocked (dependency cycle across "
                             f"FIFOs?): unscheduled tasks {stuck}")

    makespan = max((s.end for s in spans), default=0.0)
    link_busy = {name: 0.0 for name in topology.link_names}
    compute_busy: Dict[str, float] = {}
    moved = 0
    stall = 0.0
    for s in spans:
        stall += s.stall
        if s.resource in topology:
            link_busy[s.resource] += s.duration
        else:
            compute_busy[s.resource] = (compute_busy.get(s.resource, 0.0)
                                        + s.duration)
    for t in tasks:
        if t.resource in topology:
            moved += max(0, int(t.nbytes))
    link_util = {name: (busy / makespan if makespan > 0 else 0.0)
                 for name, busy in link_busy.items()}
    total_bw = topology.total_bandwidth
    agg = (moved / (makespan * total_bw)
           if makespan > 0 and total_bw > 0 else 0.0)
    spans.sort(key=lambda s: (s.start, s.resource, s.task_id))
    return SimReport(makespan=makespan, spans=spans, link_busy=link_busy,
                     link_utilization=link_util, compute_busy=compute_busy,
                     total_bytes=moved, aggregate_utilization=agg,
                     contention_stall=stall)


def serialize(tasks: Sequence[SimTask], link: str,
              topology: Optional[Topology] = None) -> List[SimTask]:
    """The in-order baseline: every transfer mapped onto one link, submission
    order preserved (what a single ``XDMAQueue`` FIFO does).  Compute tasks
    keep their own engines — only link traffic is serialized.  Pass the
    ``topology`` to identify transfers exactly (task resource is one of its
    links); without it, any task that moves no bytes is treated as compute
    and left untouched (transfers always have a payload; a zero-cost compute
    task — a barrier or marker — must stay on its own engine)."""
    out = []
    for t in tasks:
        if topology is not None:
            is_transfer = t.resource in topology
        else:
            is_transfer = t.nbytes > 0
        out.append(dataclasses.replace(t, resource=link) if is_transfer else t)
    return out


def queue_sim_tasks(queue, in_shape: Sequence[int], in_dtype,
                    link: str, *, start_id: int = 0) -> List[SimTask]:
    """SimTasks for an :class:`~repro_torch.core.api.XDMAQueue`: one chained task
    per descriptor on ``link``, payload sizes derived from the queue's own
    shape/dtype contracts and burst geometry from the descriptor's composed
    affine pattern (no execution needed)."""
    from repro_torch.core.layouts import itemsize

    tasks: List[SimTask] = []
    shape = tuple(in_shape)
    dtype = in_dtype
    prev: Tuple[int, ...] = ()
    for i, desc in enumerate(queue.descriptors):
        out_shape = desc.out_logical_shape(shape)
        out_dtype = desc.out_dtype(dtype)
        nbytes = (math.prod(shape) * itemsize(dtype)
                  + math.prod(out_shape) * itemsize(out_dtype))
        tid = start_id + i
        tasks.append(SimTask(id=tid, resource=link, nbytes=nbytes, deps=prev,
                             label=f"{queue.name}[{i}]",
                             burst_bytes=desc.burst_bytes(shape, dtype),
                             pipeline_depth=desc.d_buf))
        prev = (tid,)
        shape, dtype = out_shape, out_dtype
    return tasks


def multicast_sim_tasks(topology: Topology, src: str, dsts: Sequence[str],
                        nbytes: int, *, start_id: int = 0,
                        burst_bytes: Optional[int] = None,
                        pipeline_depth: int = 1, csr_writes: int = 1,
                        deps: Sequence[int] = (), label: str = "mcast",
                        policy: str = "tree"):
    """SimTasks for one tree-routed multicast: one task per tree hop, each
    depending on the hop that feeds it, so shared edges carry (and are
    priced for) the payload exactly once.  One doorbell CSR write per hop by
    default — a fork is a real descriptor post at the branching half-XDMA.
    Returns ``(tasks, tree)``; task ids follow the tree's hop order."""
    tree = topology.multicast_tree(src, dsts, policy=policy)
    tasks: List[SimTask] = []
    for i, hop in enumerate(tree.hops):
        hop_deps = (tuple(deps) if hop.parent is None
                    else (start_id + hop.parent,))
        tasks.append(SimTask(id=start_id + i, resource=hop.link,
                             nbytes=nbytes, deps=hop_deps,
                             label=f"{label}/{hop.src}->{hop.dst}",
                             burst_bytes=burst_bytes,
                             pipeline_depth=pipeline_depth,
                             csr_writes=csr_writes))
    return tasks, tree


def unicast_sim_tasks(topology: Topology, src: str, dsts: Sequence[str],
                      nbytes: int, *, start_id: int = 0,
                      burst_bytes: Optional[int] = None,
                      pipeline_depth: int = 1, csr_writes: int = 1,
                      deps: Sequence[int] = (), label: str = "ucast"):
    """The N-unicast baseline for the same movement: each destination gets
    its own private copy of its shortest path (hops chained per destination,
    destinations independent), priced with the exact same cost construction
    as :func:`multicast_sim_tasks` — so with zero shared hops the two
    schedules cost identically (the graceful-degradation contract)."""
    tasks: List[SimTask] = []
    tid = start_id
    for d in tuple(dict.fromkeys(dsts)):
        prev: Tuple[int, ...] = tuple(deps)
        for l in topology.path(src, d):
            tasks.append(SimTask(id=tid, resource=l.name, nbytes=nbytes,
                                 deps=prev, label=f"{label}/{d}/{l.src}->{l.dst}",
                                 burst_bytes=burst_bytes,
                                 pipeline_depth=pipeline_depth,
                                 csr_writes=csr_writes))
            prev = (tid,)
            tid += 1
    return tasks
