"""Link topology: the graph of half-XDMA endpoints the runtime schedules over.

The port's copy of ``repro.runtime.topology`` (pure Python, unchanged: the
cost-model constants below are model parameters, not measurements of any
device).

Paper §II: every *link* owns its own pair of half-XDMAs, so independent
movements on disjoint links proceed concurrently — the Controller's job is to
keep every link saturated.  This module is the static description of that
fabric: nodes are device memories (the half-XDMA attachment points, e.g. the
per-device HBMs of a ``launch/mesh.py`` mesh, or a host DRAM), edges are
:class:`Link`\\ s with a bandwidth / latency / width cost model.

The topology is pure Python with no JAX dependency: the scheduler uses it to
route tasks onto per-link FIFOs, and the simulator replays schedules against
its cost model to produce deterministic Fig. 4-style utilization numbers.

Presets:

* :meth:`Topology.ring` — an n-device unidirectional (or bidirectional) ring,
  the classic ICI neighbour-exchange fabric.
* :meth:`Topology.tpu_mesh` — a 2D/3D torus over a device grid; accepts a
  mesh object with a ``.devices`` grid (nodes = its device memories) or a
  plain shape tuple.
* :meth:`Topology.host_device` — host DRAM <-> device HBM with ``n`` DMA link
  pairs (``h2d{i}`` / ``d2h{i}``), the staging/KV-movement fabric.
* :meth:`Topology.parallel` — ``n`` parallel links between two memories (the
  multi-lane a2a fabric the MoE dispatch chunks over).

Multicast route synthesis (DESIGN.md §14): :meth:`Topology.multicast_tree`
builds the shortest-path tree a point-to-multipoint descriptor forks over —
each physical edge carries the payload once, however many destinations ride
it — with a ring-chain fallback threading the stream through the
destinations in order.  :class:`MulticastTree` carries the per-edge payload
accounting (which destinations each hop serves, hops saved vs N unicasts).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Link", "Topology", "MulticastHop", "MulticastTree",
           "DEFAULT_BANDWIDTH", "DEFAULT_LATENCY", "DEFAULT_DOORBELL_COST"]

# Defaults sized like one ICI link: ~100 GB/s, ~1 us hop latency, 512-bit beats.
DEFAULT_BANDWIDTH = 100e9       # bytes / second
DEFAULT_LATENCY = 1e-6          # seconds
DEFAULT_WIDTH = 64              # bytes per beat (512-bit link)
# One doorbell CSR write over the config bus (a posted 32/64-bit register
# write, not a DMA): the price of *configuration* as distinct from data
# transfer.  Orders of magnitude below a transfer's latency, so descriptor
# posting never dominates — the paper's point in separating the two planes.
DEFAULT_DOORBELL_COST = 20e-9   # seconds per CSR write
# Per-burst re-issue cost of a *hardware* address generator (the Frontend
# computes the next burst address in a pipeline stage); software address
# generation pays the core's loop + DMA-programming cost per burst instead —
# the gap between these two constants is the paper's Fig. 4 axis.
DEFAULT_BURST_OVERHEAD = 50e-9  # seconds per burst, hardware AGU
SW_ISSUE_OVERHEAD = 1e-6        # seconds per burst, software loop + 1D DMA


@dataclasses.dataclass(frozen=True)
class Link:
    """One directed link between two memories, owned by a half-XDMA pair.

    ``bandwidth`` is bytes/s, ``latency`` the per-task fixed cost (CFG + first
    beat), ``width`` the beat size in bytes (transfers are rounded up to whole
    beats, the hardware burst granularity), ``burst_overhead`` the per-burst
    address re-issue cost when a transfer is priced by its address pattern
    (see :meth:`transfer_time`), and ``csr_write_cost`` the price of one
    doorbell CSR write — what ring-based descriptor submission pays per
    posted descriptor, separately from the data transfer itself.
    """

    name: str
    src: str
    dst: str
    bandwidth: float = DEFAULT_BANDWIDTH
    latency: float = DEFAULT_LATENCY
    width: int = DEFAULT_WIDTH
    burst_overhead: float = DEFAULT_BURST_OVERHEAD
    csr_write_cost: float = DEFAULT_DOORBELL_COST

    def __post_init__(self):
        if self.bandwidth <= 0:
            raise ValueError(f"link {self.name!r}: bandwidth must be > 0")
        if self.latency < 0:
            raise ValueError(f"link {self.name!r}: latency must be >= 0")
        if self.width < 1:
            raise ValueError(f"link {self.name!r}: width must be >= 1")
        if self.burst_overhead < 0:
            raise ValueError(f"link {self.name!r}: burst_overhead must be >= 0")
        if self.csr_write_cost < 0:
            raise ValueError(f"link {self.name!r}: csr_write_cost must be >= 0")

    def transfer_time(self, nbytes: int, burst_bytes: Optional[int] = None, *,
                      issue_overhead: Optional[float] = None,
                      pipeline_depth: int = 1) -> float:
        """Deterministic cost model: latency + beat-rounded payload time,
        plus — when the transfer's address pattern is known — a per-burst
        address-issue cost.

        ``burst_bytes`` is the pattern's contiguous run (see
        ``AffinePattern.burst_length``): the transfer needs
        ``ceil(nbytes / burst_bytes)`` generated addresses.  Each costs
        ``issue_overhead`` (default: this link's hardware ``burst_overhead``;
        pass :data:`SW_ISSUE_OVERHEAD` to price software address generation),
        amortized over ``pipeline_depth`` in-flight bursts (the descriptor's
        ``d_buf`` stream-buffer depth — deeper buffers hide more issue
        latency, the paper's Fig. 4 sweep).  ``burst_bytes=None`` keeps the
        plain one-burst model.
        """
        beats = -(-max(0, int(nbytes)) // self.width)       # ceil division
        t = self.latency + (beats * self.width) / self.bandwidth
        if burst_bytes and nbytes > 0:
            n_bursts = -(-int(nbytes) // int(burst_bytes))
            ov = (self.burst_overhead if issue_overhead is None
                  else float(issue_overhead))
            t += n_bursts * ov / max(1, int(pipeline_depth))
        return t

    def utilization(self, nbytes: int, burst_bytes: Optional[int] = None, *,
                    issue_overhead: Optional[float] = None,
                    pipeline_depth: int = 1) -> float:
        """Achieved / peak bandwidth for one transfer under this cost model
        (the paper's Fig. 4 metric for a single link)."""
        if nbytes <= 0:
            return 0.0
        t = self.transfer_time(nbytes, burst_bytes,
                               issue_overhead=issue_overhead,
                               pipeline_depth=pipeline_depth)
        return (nbytes / self.bandwidth) / t

    def summary(self) -> str:
        return (f"{self.name}: {self.src}->{self.dst} "
                f"{self.bandwidth / 1e9:.0f}GB/s +{self.latency * 1e6:.1f}us")


@dataclasses.dataclass(frozen=True)
class MulticastHop:
    """One edge of a multicast tree: the payload crosses ``link`` exactly
    once, serving every destination in ``serves``.  ``parent`` is the index
    (into :attr:`MulticastTree.hops`) of the hop that feeds this one — None
    for hops leaving the tree root."""

    link: str
    src: str
    dst: str
    parent: Optional[int]
    serves: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class MulticastTree:
    """A synthesized point-to-multipoint route (DESIGN.md §14).

    ``hops`` are in topological order (every hop's parent precedes it), so a
    scheduler can fork one task per hop with a dependency on its parent and
    shared edges are priced exactly once.  ``kind`` is ``"tree"`` for the
    greedy shortest-path-tree synthesis, ``"chain"`` for the ring-chain
    route (stream threaded through the destinations in order)."""

    src: str
    dsts: Tuple[str, ...]
    hops: Tuple[MulticastHop, ...]
    kind: str = "tree"

    def delivery(self, dst: str) -> int:
        """Index of the hop that delivers ``dst`` (its write-side edge)."""
        for i, h in enumerate(self.hops):
            if h.dst == dst:
                return i
        raise KeyError(f"no hop delivers {dst!r}")

    @property
    def shared_hops(self) -> Tuple[MulticastHop, ...]:
        """Hops carrying the payload for >= 2 destinations — where the fork
        saves wire traffic vs N unicasts."""
        return tuple(h for h in self.hops if len(h.serves) >= 2)

    @property
    def shared_hop_count(self) -> int:
        return len(self.shared_hops)

    @property
    def unicast_hop_count(self) -> int:
        """Edges N private per-destination copies of these tree paths would
        cross (each hop counted once per destination it serves)."""
        return sum(len(h.serves) for h in self.hops)

    @property
    def saved_hops(self) -> int:
        """Edge crossings the shared tree avoids vs per-destination copies."""
        return self.unicast_hop_count - len(self.hops)

    def bytes_saved(self, nbytes: int) -> int:
        """Wire bytes the shared hops avoid moving for an ``nbytes`` payload."""
        return self.saved_hops * max(0, int(nbytes))

    @property
    def fork_count(self) -> int:
        """Branch points: nodes feeding >= 2 child hops (plus the root when
        it fans out) — each is one stream fork in the half-XDMA."""
        fanout: Dict[Optional[int], int] = {}
        for h in self.hops:
            fanout[h.parent] = fanout.get(h.parent, 0) + 1
        return sum(1 for n in fanout.values() if n >= 2)

    def summary(self) -> str:
        edges = ", ".join(f"{h.src}->{h.dst}(x{len(h.serves)})"
                          for h in self.hops)
        return (f"MulticastTree({self.kind}, {self.src} -> "
                f"{len(self.dsts)} dsts, {len(self.hops)} hops "
                f"[{edges}], saved={self.saved_hops})")


class Topology:
    """A named graph of memories (nodes) and links (directed edges)."""

    def __init__(self, name: str = "topo"):
        self.name = name
        self._nodes: Dict[str, str] = {}            # name -> kind
        self._links: Dict[str, Link] = {}           # insertion-ordered

    # -- construction --------------------------------------------------------
    def add_node(self, name: str, kind: str = "memory") -> str:
        existing = self._nodes.get(name)
        if existing is not None and existing != kind:
            raise ValueError(f"node {name!r} already registered as {existing!r}")
        self._nodes[name] = kind
        return name

    def add_link(self, src: str, dst: str, *, name: Optional[str] = None,
                 bandwidth: float = DEFAULT_BANDWIDTH,
                 latency: float = DEFAULT_LATENCY,
                 width: int = DEFAULT_WIDTH,
                 csr_write_cost: float = DEFAULT_DOORBELL_COST) -> Link:
        self.add_node(src)
        self.add_node(dst)
        if name is None:
            name = f"{src}->{dst}"
        if name in self._links:
            raise ValueError(f"duplicate link name {name!r}")
        link = Link(name=name, src=src, dst=dst, bandwidth=bandwidth,
                    latency=latency, width=width,
                    csr_write_cost=csr_write_cost)
        self._links[name] = link
        return link

    # -- queries -------------------------------------------------------------
    @property
    def nodes(self) -> Tuple[str, ...]:
        return tuple(self._nodes)

    @property
    def links(self) -> Tuple[Link, ...]:
        return tuple(self._links.values())

    @property
    def link_names(self) -> Tuple[str, ...]:
        return tuple(self._links)

    def __contains__(self, link_name: str) -> bool:
        return link_name in self._links

    def link(self, name: str) -> Link:
        try:
            return self._links[name]
        except KeyError:
            raise KeyError(f"no link {name!r} in topology {self.name!r} "
                           f"(links: {list(self._links)})") from None

    def links_between(self, src: str, dst: str) -> Tuple[Link, ...]:
        return tuple(l for l in self._links.values()
                     if l.src == src and l.dst == dst)

    def links_from(self, src: str) -> Tuple[Link, ...]:
        return tuple(l for l in self._links.values() if l.src == src)

    def neighbors(self, node: str) -> Tuple[str, ...]:
        seen: List[str] = []
        for l in self._links.values():
            if l.src == node and l.dst not in seen:
                seen.append(l.dst)
        return tuple(seen)

    @property
    def total_bandwidth(self) -> float:
        return sum(l.bandwidth for l in self._links.values())

    # -- routing -------------------------------------------------------------
    def path(self, src: str, dst: str) -> Tuple[Link, ...]:
        """Shortest directed path (hop count) ``src -> dst`` as the links to
        cross, BFS with insertion-order tie-breaks (bit-deterministic).
        Empty for ``src == dst``; raises ``ValueError`` when unreachable."""
        for n in (src, dst):
            if n not in self._nodes:
                raise ValueError(f"unknown node {n!r} in topology {self.name!r}")
        if src == dst:
            return ()
        hop = self._bfs((src,), dst)
        if hop is None:
            raise ValueError(f"no route {src!r} -> {dst!r} in {self.name!r}")
        return hop[1]

    def _bfs(self, sources: Sequence[str],
             target: str) -> Optional[Tuple[str, Tuple[Link, ...]]]:
        """Multi-source BFS: the nearest route from any of ``sources`` to
        ``target`` as ``(start_node, links)``.  Sources are seeded in the
        given order and neighbours expand in link insertion order, so ties
        resolve deterministically.  None when unreachable."""
        prev: Dict[str, Optional[Tuple[str, Link]]] = {}
        start_of: Dict[str, str] = {}
        frontier: List[str] = []
        for s in sources:
            if s not in prev:
                prev[s] = None
                start_of[s] = s
                frontier.append(s)
        while frontier and target not in prev:
            nxt: List[str] = []
            for node in frontier:
                for l in self.links_from(node):
                    if l.dst not in prev:
                        prev[l.dst] = (node, l)
                        start_of[l.dst] = start_of[node]
                        nxt.append(l.dst)
            frontier = nxt
        if target not in prev:
            return None
        links: List[Link] = []
        node = target
        while prev[node] is not None:
            pnode, l = prev[node]
            links.append(l)
            node = pnode
        return node, tuple(reversed(links))

    def multicast_tree(self, src: str, dsts: Sequence[str], *,
                       policy: str = "tree") -> MulticastTree:
        """Synthesize the point-to-multipoint route ``src -> dsts``.

        ``policy="tree"`` (default) grows a Steiner-ish shortest-path tree
        greedily: destinations are processed nearest-first (BFS distance
        from ``src``, submission order on ties) and each connects to the
        *nearest node already in the tree* — so a ring naturally yields the
        forwarding chain and a torus forks at branch points.
        ``policy="chain"`` forces the ring-chain route — the stream threaded
        ``src -> dsts[0] -> dsts[1] -> ...`` in submission order — which is
        also the fallback when tree growth cannot reach a destination.
        Every physical edge appears once, however many destinations it
        serves (the per-edge payload accounting multicast pricing rests on).
        """
        if policy not in ("tree", "chain"):
            raise ValueError(f"policy must be 'tree' or 'chain', got {policy!r}")
        dsts = tuple(dict.fromkeys(dsts))
        if not dsts:
            raise ValueError("multicast needs at least one destination")
        if src in dsts:
            raise ValueError(f"multicast src {src!r} cannot be a destination")
        for n in (src,) + dsts:
            if n not in self._nodes:
                raise ValueError(f"unknown node {n!r} in topology {self.name!r}")
        kind = policy
        hops = None
        if policy == "tree":
            hops = self._grow_tree(src, dsts)
            if hops is None:
                kind = "chain"               # fallback: thread through dsts
        if hops is None:
            hops = self._grow_chain(src, dsts)
        # per-edge payload accounting: every destination rides each hop on
        # the parent path from its delivery edge back to the root
        serves: List[List[str]] = [[] for _ in hops]
        for d in dsts:
            i = next(j for j, h in enumerate(hops) if h[2] == d)
            while i is not None:
                serves[i].append(d)
                i = hops[i][3]
        return MulticastTree(
            src=src, dsts=dsts, kind=kind,
            hops=tuple(MulticastHop(link=h[0], src=h[1], dst=h[2],
                                    parent=h[3], serves=tuple(sv))
                       for h, sv in zip(hops, serves)))

    def _grow_tree(self, src: str, dsts: Tuple[str, ...]):
        """Greedy SPT growth; hops as [link, src, dst, parent] rows in
        topological order, or None when some destination is unreachable."""
        order = sorted(
            range(len(dsts)),
            key=lambda i: (len(self.path(src, dsts[i]))
                           if self._bfs((src,), dsts[i]) is not None
                           else len(self._nodes) + 1))
        in_tree: Dict[str, Optional[int]] = {src: None}
        hops: List[List] = []
        for i in order:
            d = dsts[i]
            if d in in_tree:
                continue                     # already a forwarding node
            found = self._bfs(tuple(in_tree), d)
            if found is None:
                return None
            start, links = found
            parent = in_tree[start]
            for l in links:
                hops.append([l.name, l.src, l.dst, parent])
                parent = len(hops) - 1
                in_tree[l.dst] = parent
        return hops

    def _grow_chain(self, src: str, dsts: Tuple[str, ...]):
        """Ring-chain route: shortest path src -> dsts[0], then dst -> dst in
        submission order; raises when a segment is unreachable."""
        hops: List[List] = []
        reached: Dict[str, int] = {}
        cur, parent = src, None
        for d in dsts:
            if d in reached:
                parent = reached[d]
                cur = d
                continue
            for l in self.path(cur, d):
                hops.append([l.name, l.src, l.dst, parent])
                parent = len(hops) - 1
                if l.dst not in reached:
                    reached[l.dst] = parent
            cur = d
            parent = reached[d]
        return hops

    def summary(self) -> str:
        lines = [f"Topology({self.name!r}, {len(self._nodes)} nodes, "
                 f"{len(self._links)} links)"]
        lines += [f"  {l.summary()}" for l in self._links.values()]
        return "\n".join(lines)

    # -- presets -------------------------------------------------------------
    @classmethod
    def ring(cls, n: int, *, bidirectional: bool = False,
             bandwidth: float = DEFAULT_BANDWIDTH,
             latency: float = DEFAULT_LATENCY,
             width: int = DEFAULT_WIDTH) -> "Topology":
        """n devices in a ring: dev{i} -> dev{(i+1)%n} (both ways if asked)."""
        if n < 2:
            raise ValueError("ring needs >= 2 devices")
        topo = cls(name=f"ring{n}")
        for i in range(n):
            j = (i + 1) % n
            topo.add_link(f"dev{i}", f"dev{j}", bandwidth=bandwidth,
                          latency=latency, width=width)
            if bidirectional:
                topo.add_link(f"dev{j}", f"dev{i}", bandwidth=bandwidth,
                              latency=latency, width=width)
        return topo

    @classmethod
    def tpu_mesh(cls, mesh_or_shape, *, bandwidth: float = DEFAULT_BANDWIDTH,
                 latency: float = DEFAULT_LATENCY,
                 width: int = DEFAULT_WIDTH) -> "Topology":
        """Torus links over a device grid.

        Accepts a mesh object with a ``.devices`` grid (the duck type of a
        device mesh) — nodes are its device memories,
        named by grid coordinate — or a plain shape tuple.  Each grid axis of
        size > 1 contributes a +1-neighbour torus link per device (wrapping),
        which is the ICI wiring of a TPU pod slice.
        """
        shape = getattr(mesh_or_shape, "devices", None)
        if shape is not None:                       # a Mesh: use its grid
            shape = tuple(mesh_or_shape.devices.shape)
        else:
            shape = tuple(int(s) for s in mesh_or_shape)
        if not shape or any(s < 1 for s in shape):
            raise ValueError(f"bad mesh shape {shape}")
        topo = cls(name=f"tpu_mesh{'x'.join(map(str, shape))}")

        def node(coord):
            return "dev(" + ",".join(map(str, coord)) + ")"

        for coord in itertools.product(*(range(s) for s in shape)):
            topo.add_node(node(coord))
            for ax, size in enumerate(shape):
                if size < 2:
                    continue
                nxt = list(coord)
                nxt[ax] = (coord[ax] + 1) % size
                topo.add_link(node(coord), node(tuple(nxt)),
                              name=f"ici{ax}:{node(coord)}",
                              bandwidth=bandwidth, latency=latency, width=width)
        return topo

    @classmethod
    def host_device(cls, n: int = 1, *, devices: Optional[int] = None,
                    bandwidth: float = DEFAULT_BANDWIDTH / 4,
                    latency: float = 4 * DEFAULT_LATENCY,
                    width: int = DEFAULT_WIDTH) -> "Topology":
        """Host DRAM <-> device HBM with n DMA link pairs (h2d{i}/d2h{i}).

        ``devices=m`` builds the star variant instead: ``m`` distinct
        devices each behind its own link pair (``h2d{i}: host -> dev{i}``,
        ``d2h{i}: dev{i} -> host``).  A star has no shareable intermediate
        hops, so a host-rooted multicast degrades gracefully to exactly N
        unicast costs — the no-sharing baseline in the PR-10 sweep.
        """
        if devices is not None:
            if devices < 1:
                raise ValueError("host_device needs >= 1 device")
            topo = cls(name=f"host_device_star{devices}")
            for i in range(devices):
                topo.add_link("host", f"dev{i}", name=f"h2d{i}",
                              bandwidth=bandwidth, latency=latency, width=width)
                topo.add_link(f"dev{i}", "host", name=f"d2h{i}",
                              bandwidth=bandwidth, latency=latency, width=width)
            return topo
        if n < 1:
            raise ValueError("host_device needs >= 1 link pair")
        topo = cls(name=f"host_device{n}")
        for i in range(n):
            topo.add_link("host", "dev", name=f"h2d{i}", bandwidth=bandwidth,
                          latency=latency, width=width)
            topo.add_link("dev", "host", name=f"d2h{i}", bandwidth=bandwidth,
                          latency=latency, width=width)
        return topo

    @classmethod
    def parallel(cls, n: int, *, src: str = "memA", dst: str = "memB",
                 prefix: str = "link", bandwidth: float = DEFAULT_BANDWIDTH,
                 latency: float = DEFAULT_LATENCY,
                 width: int = DEFAULT_WIDTH) -> "Topology":
        """n parallel links between two memories (multi-lane fabric)."""
        if n < 1:
            raise ValueError("parallel needs >= 1 link")
        topo = cls(name=f"parallel{n}")
        for i in range(n):
            topo.add_link(src, dst, name=f"{prefix}{i}", bandwidth=bandwidth,
                          latency=latency, width=width)
        return topo
