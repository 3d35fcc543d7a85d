"""XDMACfg: the transaction descriptor exchanged in the CFG phase (PyTorch port).

The twin of ``repro.core.descriptor``.  A descriptor names both *ends* of a
movement (:class:`Endpoint`: a local memory with a physical
:class:`~repro_torch.core.layouts.Layout`, or a mesh-axis remote kept here as
data), the plugin chains of the two plugin hosts (``pre`` before the link,
``post`` after it), the stream-buffer depth ``d_buf``, the lane count
``channels`` and the lowering ``backend``.

:func:`from_spec` builds a descriptor from a plain description (layout
tuples, plugin registry names with their fields, arrays as numpy), which is
how a descriptor of the reference crosses into the port.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import layouts as L
from . import plugins as P

__all__ = ["Endpoint", "XDMADescriptor", "describe", "from_spec",
           "reduce_descriptor", "page_layout", "page_descriptor"]

_LOCAL = "local"
_PEER = "peer"
_ALL_TO_ALL = "all_to_all"
_REDUCE = "reduce"
_MULTICAST = "multicast"
_REMOTE_KINDS = (_PEER, _ALL_TO_ALL, _REDUCE)
_KINDS = (_LOCAL,) + _REMOTE_KINDS + (_MULTICAST,)


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """One side of an XDMA movement.

    ``kind`` selects the transport role:

    * ``local``       — a memory in this shard's address space; ``layout`` is
      its physical layout (the half-XDMA Frontend config).
    * ``peer``        — the far side of a point-to-point tunnel over mesh axis
      ``axis`` with device permutation ``perm``.
    * ``all_to_all``  — the MoE-dispatch exchange over ``axis``
      (``split_axis``/``concat_axis`` as in ``lax.all_to_all``).
    * ``reduce``      — an all-reduce rendezvous over ``axis`` with
      ``axis_size`` participants.
    * ``multicast``   — point-to-multipoint (DESIGN.md §14): either
      *node-addressed* (``dsts`` names topology nodes with per-destination
      layouts; tree-routed by the scheduler) or *mesh-axis* (``axis`` +
      ``perm``, the rotating single-hop broadcast an all-gather is built
      from; lowers like ``peer``).

    Remote endpoints still carry a ``layout``: it is the physical layout of
    the buffer at that end, applied by that side's Frontend reader/writer.
    """

    kind: str = _LOCAL
    layout: L.Layout = L.MN
    axis: Optional[str] = None
    perm: Optional[Tuple[Tuple[int, int], ...]] = None
    split_axis: int = 0
    concat_axis: int = 0
    axis_size: Optional[int] = None
    # multicast only: ((node, layout), ...) — each dst may carry its own
    # physical layout, independently resolvable when spelled "auto"
    dsts: Optional[Tuple[Tuple[str, L.Layout], ...]] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown endpoint kind {self.kind!r}; one of {_KINDS}")
        if self.kind == _MULTICAST:
            node_addressed = self.dsts is not None
            mesh_addressed = self.axis is not None
            if node_addressed == mesh_addressed:
                raise ValueError(
                    "multicast endpoint needs either dsts= (node-addressed, "
                    "tree-routed) or axis=+perm= (mesh-axis), not both")
            if node_addressed and not self.dsts:
                raise ValueError("multicast endpoint needs >= 1 destination")
            if mesh_addressed and self.perm is None:
                raise ValueError("mesh-axis multicast needs a device permutation")
        elif self.dsts is not None:
            raise ValueError(f"dsts= only applies to multicast endpoints, "
                             f"not {self.kind!r}")
        if self.is_remote and self.axis is None:
            raise ValueError(f"{self.kind!r} endpoint needs a mesh axis name")
        if self.kind == _PEER and self.perm is None:
            raise ValueError("peer endpoint needs a device permutation")
        if self.kind == _REDUCE and self.axis_size is None:
            raise ValueError("reduce endpoint needs axis_size")

    @property
    def is_remote(self) -> bool:
        # a node-addressed multicast is scheduler-routed (hop descriptors are
        # plain local relayouts), so only the mesh-axis spelling is a remote
        # lowering (it compiles to a collective permute like ``peer``)
        return (self.kind in _REMOTE_KINDS
                or (self.kind == _MULTICAST and self.axis is not None))

    # -- constructors --------------------------------------------------------
    @classmethod
    def local(cls, layout: str | L.Layout = L.MN) -> "Endpoint":
        return cls(kind=_LOCAL, layout=_as_layout(layout))

    @classmethod
    def peer(cls, axis: str, perm: Sequence[Tuple[int, int]],
             layout: str | L.Layout = L.MN) -> "Endpoint":
        return cls(kind=_PEER, layout=_as_layout(layout), axis=axis,
                   perm=tuple((int(a), int(b)) for a, b in perm))

    @classmethod
    def all_to_all(cls, axis: str, split_axis: int = 0, concat_axis: int = 0,
                   layout: str | L.Layout = L.MN) -> "Endpoint":
        return cls(kind=_ALL_TO_ALL, layout=_as_layout(layout), axis=axis,
                   split_axis=split_axis, concat_axis=concat_axis)

    @classmethod
    def reduce(cls, axis: str, axis_size: int,
               layout: str | L.Layout = L.MN) -> "Endpoint":
        return cls(kind=_REDUCE, layout=_as_layout(layout), axis=axis,
                   axis_size=axis_size)

    @classmethod
    def multicast(cls, dsts: Sequence[Any],
                  layout: str | L.Layout = L.MN) -> "Endpoint":
        """Node-addressed multicast: ``dsts`` is a sequence of topology node
        names or ``(node, layout)`` pairs; a bare node inherits ``layout``
        (the default destination layout).  Each destination layout may be
        ``"auto"`` — resolved independently against its routed link."""
        default = _as_layout(layout)
        specs = []
        for d in dsts:
            if isinstance(d, str):
                specs.append((d, default))
            else:
                node, lay = d
                specs.append((str(node), _as_layout(lay)))
        return cls(kind=_MULTICAST, layout=default, dsts=tuple(specs))

    @classmethod
    def multicast_axis(cls, axis: str, perm: Sequence[Tuple[int, int]],
                       layout: str | L.Layout = L.MN) -> "Endpoint":
        """Mesh-axis multicast: the rotating one-hop broadcast (every device
        forwards its shard to the next ring position) an all-gather is made
        of.  Lowers exactly like ``peer`` — same wire traffic, same compiled
        collective — but records the movement as ``multicast`` in the
        ledger."""
        return cls(kind=_MULTICAST, layout=_as_layout(layout), axis=axis,
                   perm=tuple((int(a), int(b)) for a, b in perm))

    def summary(self) -> str:
        if self.kind == _LOCAL:
            return self.layout.name
        if self.kind == _MULTICAST and self.dsts is not None:
            inner = ",".join(f"{n}@{l.name}" for n, l in self.dsts)
            return f"multicast[{inner}]"
        return f"{self.kind}({self.axis})@{self.layout.name}"


def _as_layout(layout: str | L.Layout) -> L.Layout:
    return layout if isinstance(layout, L.Layout) else L.by_name(layout)


@dataclasses.dataclass(frozen=True)
class XDMADescriptor:
    """One XDMA task: src endpoint -> [pre | link | post] -> dst endpoint.

    Attributes mirror the paper's Table II design-time parameters where they
    survive the port: ``Dim_src/dst`` and ``Ext_src/dst`` come out of
    :meth:`src_pattern`/:meth:`dst_pattern`; ``d_buf`` is the stream-buffer
    depth (burst depth of the streamed datapath); ``channels`` is N_C,
    the number of parallel stream lanes (see :meth:`src_patterns`).

    Back-compat: the legacy spelling ``XDMADescriptor(src_layout=..,
    dst_layout=.., plugins=..)`` still works — layouts are wrapped into local
    :class:`Endpoint`\\ s and ``plugins`` lands on the ``pre`` host.  The
    ``plugins`` attribute is always normalized to ``pre + post`` (the full
    on-stream cascade), which is what the local engine fuses.
    ``dataclasses.replace`` works for non-chain fields as-is (the normalized
    ``plugins`` rides along consistently); to replace the chain itself, pass
    ``plugins=()`` alongside the new ``pre=``/``post=``.
    """

    src_layout: Optional[L.Layout] = None    # legacy; folded into .src
    dst_layout: Optional[L.Layout] = None    # legacy; folded into .dst
    plugins: Tuple[P.Plugin, ...] = ()       # normalized to pre + post
    d_buf: int = 9          # paper sweeps 3/5/9; 9 is their perf config
    channels: int = 1       # N_C in Table II (parallel stream lanes)
    src: Optional[Endpoint] = None
    dst: Optional[Endpoint] = None
    pre: Tuple[P.Plugin, ...] = ()           # src-side pre-writer host
    post: Tuple[P.Plugin, ...] = ()          # dst-side post-reader host
    backend: str = "auto"                    # auto | fused | pallas | compiled

    def __post_init__(self):
        set_ = lambda k, v: object.__setattr__(self, k, v)
        src = self.src or Endpoint.local(self.src_layout or L.MN)
        dst = self.dst or Endpoint.local(self.dst_layout or L.MN)
        pre, post = tuple(self.pre), tuple(self.post)
        if self.plugins and (pre or post):
            # ``plugins`` is always normalized to pre+post, so a round-trip
            # through dataclasses.replace() sees all three populated — accept
            # the consistent case, reject a genuinely mixed spelling.
            if tuple(self.plugins) != pre + post:
                raise ValueError(
                    "pass the chain via plugins= (legacy) or pre=/post= "
                    "(endpoint-aware), not both; to change a chain with "
                    "dataclasses.replace, pass plugins=() alongside the new "
                    "pre=/post=")
        elif self.plugins:
            pre = tuple(self.plugins)        # legacy chain = pre-writer host
        set_("src", src)
        set_("dst", dst)
        set_("pre", pre)
        set_("post", post)
        set_("plugins", pre + post)
        set_("src_layout", src.layout)
        set_("dst_layout", dst.layout)
        if src.kind == _MULTICAST:
            raise ValueError("multicast is a destination role; put the "
                             "multicast endpoint on dst")
        if src.is_remote and dst.is_remote:
            raise ValueError("at most one endpoint may be remote "
                             f"({src.summary()} -> {dst.summary()})")
        if self.backend not in ("auto", "fused", "pallas", "compiled"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.backend in ("pallas", "compiled") and self.movement != _LOCAL:
            raise ValueError(f"{self.backend} backend only lowers local movements")

    # -- movement classification --------------------------------------------
    @property
    def movement(self) -> str:
        """One of 'local', 'peer', 'all_to_all', 'reduce', 'multicast' —
        from the descriptor alone; this is what
        :func:`repro_torch.core.api.transfer` dispatches on."""
        if self.dst.kind == _MULTICAST:
            return _MULTICAST
        if self.dst.is_remote:
            return self.dst.kind
        if self.src.is_remote:
            return self.src.kind
        return _LOCAL

    @property
    def is_remote(self) -> bool:
        return self.movement != _LOCAL

    @property
    def has_auto(self) -> bool:
        """True when either endpoint carries the ``auto`` layout placeholder
        — resolved per (shape, dtype, link) by
        :func:`repro_torch.core.autotune.resolve_descriptor` before lowering."""
        return self.src.layout.is_auto or self.dst.layout.is_auto

    @property
    def remote(self) -> Optional[Endpoint]:
        if self.dst.is_remote:
            return self.dst
        if self.src.is_remote:
            return self.src
        return None

    # -- shape/dtype propagation through both hosts -------------------------
    def out_logical_shape(self, in_logical_shape: Sequence[int]) -> Tuple[int, ...]:
        shape = P.chain_out_shape(self.pre, tuple(in_logical_shape))
        return P.chain_out_shape(self.post, shape)

    def out_dtype(self, in_dtype) -> Any:
        dtype = P.chain_out_dtype(self.pre, in_dtype)
        return P.chain_out_dtype(self.post, dtype)

    # -- address-generator exports (paper Table II / Fig 2b) ----------------
    def src_pattern(self, logical_shape: Sequence[int]) -> L.AffinePattern:
        return L.affine_pattern(self.src.layout, logical_shape)

    def dst_pattern(self, in_logical_shape: Sequence[int]) -> L.AffinePattern:
        return L.affine_pattern(self.dst.layout,
                                self.out_logical_shape(in_logical_shape))

    def src_patterns(self, logical_shape: Sequence[int]) -> Tuple[L.AffinePattern, ...]:
        """Per-channel address generators: N_C parallel stream lanes, each
        walking the same nest with a shrunk outermost extent from its own
        base address (the paper's multi-channel Frontend) — this is
        :meth:`~repro_torch.core.layouts.AffinePattern.split` on the pattern IR.
        channels=1 degenerates to [src_pattern]."""
        self.validate(logical_shape)
        return self.src_pattern(logical_shape).split(self.channels)

    def pattern_pair(self, in_logical_shape: Sequence[int]) -> Optional[L.PatternPair]:
        """The composed ``src⁻¹∘dst`` relayout pattern of this movement, when
        the on-stream chain is a pure relayout (empty, or exactly one
        ``Transpose``): the IR the generic AGU kernel, the software-AGU
        baseline, and the link cost model share.  None for plugin-carrying
        chains or incompatible nests."""
        chain = self.plugins
        transpose = len(chain) == 1 and isinstance(chain[0], P.Transpose)
        if chain and not transpose:
            return None
        return L.relayout_pair(self.src.layout, self.dst.layout,
                               tuple(in_logical_shape), transpose=transpose)

    def burst_bytes(self, in_logical_shape: Sequence[int], dtype) -> Optional[int]:
        """Bytes per address-generator burst on the link (pattern contiguity
        → per-link utilization in the simulator).  None when no pattern pair
        exists; the simulator then prices the transfer as one burst."""
        pair = self.pattern_pair(in_logical_shape)
        if pair is None:
            return None
        return pair.burst_length() * L.itemsize(dtype)

    def validate(self, in_logical_shape: Sequence[int]) -> None:
        self.src.layout.check(in_logical_shape)
        self.dst.layout.check(self.out_logical_shape(in_logical_shape))
        if self.d_buf < 1:
            raise ValueError("d_buf must be >= 1")
        if self.channels < 1:
            raise ValueError("channels must be >= 1")
        if self.channels > 1:
            m = in_logical_shape[-2]
            if len(in_logical_shape) == 2:
                if m % self.channels:
                    raise ValueError(
                        f"logical rows {m} not divisible by channels={self.channels}")
                if self.src.layout.is_tiled and (m // self.channels) % self.src.layout.tile[0]:
                    raise ValueError(
                        f"lane rows {m // self.channels} not aligned to src tile "
                        f"rows {self.src.layout.tile[0]}")
            # the lane split partitions the pattern's outermost loop level
            # (for rank-3+ that is the lead batch dim, not the rows the
            # 2D checks above cover) — validate what split() will require
            outer = L.affine_pattern(self.src.layout,
                                     tuple(in_logical_shape)).bounds[0]
            if outer % self.channels:
                raise ValueError(
                    f"outermost address-pattern extent {outer} not divisible "
                    f"by channels={self.channels}")

    def summary(self) -> str:
        def chain(ps):
            return "+".join(p.name for p in ps)
        hosts = "|".join(filter(None, [chain(self.pre), chain(self.post)])) or "copy"
        lanes = f", N_C={self.channels}" if self.channels != 1 else ""
        return (f"{self.src.summary()}->[{hosts}]->{self.dst.summary()} "
                f"(d_buf={self.d_buf}{lanes})")

    def cache_key(self):
        """Hashable identity for the CFG cache: the descriptor itself when
        hashable (dict lookup then uses hash *and* equality, so structurally
        equal descriptors share one CFG phase and hash collisions stay
        harmless).  Falls back to object identity when a plugin carries
        array state (a weight array or tensor), preserving 'one descriptor
        object = one CFG phase'.  Tensors hash by identity but do not compare
        as booleans, so they take the identity key like numpy arrays."""
        for p in self.plugins:
            if dataclasses.is_dataclass(p) and any(
                    isinstance(getattr(p, f.name), torch.Tensor)
                    for f in dataclasses.fields(p)):
                return ("id", id(self))
        try:
            hash(self)
        except TypeError:
            return ("id", id(self))
        return self


def describe(src: str | L.Layout | Endpoint, dst: str | L.Layout | Endpoint,
             *plugins: P.Plugin, d_buf: int = 9, channels: int = 1,
             pre: Sequence[P.Plugin] = (), post: Sequence[P.Plugin] = (),
             backend: str = "auto") -> XDMADescriptor:
    """Convenience constructor: ``describe('MN', 'MNM16N128', Transpose())``.

    ``src``/``dst`` accept layout names, :class:`Layout`\\ s, or full
    :class:`Endpoint`\\ s.  Positional ``plugins`` land on the pre-writer
    host (legacy behaviour); use ``pre=``/``post=`` to place chains on a
    specific host.  ``channels`` sets N_C (Table II) — see
    :meth:`XDMADescriptor.src_patterns`.
    """
    if plugins and pre:
        raise ValueError("pass plugins positionally or via pre=, not both")
    s = src if isinstance(src, Endpoint) else Endpoint.local(src)
    d = dst if isinstance(dst, Endpoint) else Endpoint.local(dst)
    return XDMADescriptor(src=s, dst=d, pre=tuple(plugins) or tuple(pre),
                          post=tuple(post), d_buf=d_buf, channels=channels,
                          backend=backend)


@functools.lru_cache(maxsize=None)
def reduce_descriptor(axis, axis_size: int, *,
                      compressed: bool = False) -> XDMADescriptor:
    """The canonical all-reduce task over ``axis`` (a mesh-axis name, or a
    tuple of names for a multi-axis reduction): a ``reduce`` endpoint that
    lowers to the plain all-reduce, or, when ``compressed``, to the int8
    wire codec (Quantize pre-writer / Dequantize post-reader) of
    ``compressed_psum``.  One lru-cached CFG phase per (axis, size, codec)."""
    pre = (P.Quantize(),) if compressed else ()
    post = (P.Dequantize(),) if compressed else ()
    return XDMADescriptor(dst=Endpoint.reduce(axis, axis_size),
                          pre=pre, post=post)


@functools.lru_cache(maxsize=None)
def page_layout(rows: int, cols: int, dtype_name: str) -> L.Layout:
    """Page-resident physical layout for a (rows, cols) KV page: the
    reference's pick, through the cost-model autotuner over the
    accelerator-native tiled candidate pool (the dtype-native tiling first,
    so it wins ties; plain ``MN`` when nothing tile-aligned fits).
    ``dtype_name`` is spelled as the reference spells it (``"bfloat16"``).
    """
    from . import autotune as _at

    rows, cols = int(rows), int(cols)
    native = L.layout_for_dtype(dtype_name)
    candidates = (native,) + tuple(l for l in (L.MNM8N128, L.MNM16N128,
                                               L.MNM32N128, L.MNM8N8)
                                   if l is not native)
    best = _at.best_layout((rows, cols), dtype_name, candidates=candidates)
    return best or L.MN


@functools.lru_cache(maxsize=None)
def page_descriptor(rows: int, cols: int, dtype_name: str, *,
                    direction: str = "store",
                    wire_compress_rows: int = 0,
                    d_buf: int = 9) -> XDMADescriptor:
    """The canonical descriptor for one fixed-size KV *page* movement (one
    lru-cached CFG phase per page geometry).  A page is a (rows, cols)
    logical matrix held at rest in :func:`page_layout`'s tiling.
    ``direction``: ``"store"`` (``MN`` -> page layout), ``"load"`` (page
    layout -> ``MN``) or ``"copy"`` (page layout -> page layout).
    ``wire_compress_rows > 0`` puts the lossless block-sparse wire codec on
    the stream (``Compress`` before the link, ``Decompress`` after it).
    """
    lay = page_layout(rows, cols, dtype_name)
    pre: Tuple[P.Plugin, ...] = ()
    post: Tuple[P.Plugin, ...] = ()
    if wire_compress_rows:
        if rows % int(wire_compress_rows):
            raise ValueError(f"page rows {rows} not divisible by wire "
                             f"compress block {wire_compress_rows}")
        pre = (P.Compress(block_rows=int(wire_compress_rows)),)
        post = (P.Decompress(),)
    if direction == "store":
        return describe(L.MN, lay, pre=pre, post=post, d_buf=d_buf)
    if direction == "load":
        return describe(lay, L.MN, pre=pre, post=post, d_buf=d_buf)
    if direction == "copy":
        return describe(lay, lay, pre=pre, post=post, d_buf=d_buf)
    raise ValueError(f"unknown page direction {direction!r}; "
                     "one of 'store', 'load', 'copy'")


# -- crossing a plain description into the port ----------------------------
def _layout_from_spec(spec) -> L.Layout:
    if isinstance(spec, L.Layout):
        return spec
    if isinstance(spec, str):
        return L.by_name(spec)
    tup = lambda v: None if v is None else tuple(int(t) for t in v)
    layout = L.Layout(tup(spec.get("tile")), spec.get("name", "MN"),
                      perm=tup(spec.get("perm")), pad=tup(spec.get("pad")))
    try:
        canonical = L.by_name(layout.name)
    except KeyError:
        return layout
    return canonical if canonical == layout else layout


def _value_from_spec(v):
    """Field values: ``{"array": ndarray, "dtype": name}`` (a bf16 array
    crosses as its uint16 view) or a bare ndarray become CPU tensors;
    ``{"dtype": name}`` becomes a torch dtype; anything else is kept."""
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(v))
    if isinstance(v, dict) and "array" in v:
        arr = np.ascontiguousarray(v["array"])
        t = torch.from_numpy(arr)
        dtype = L.torch_dtype(v.get("dtype", arr.dtype.name))
        if dtype != t.dtype:
            if dtype.itemsize != t.element_size():
                raise ValueError(f"array of {arr.dtype} cannot be viewed as "
                                 f"{dtype}")
            t = t.view(dtype)
        return t
    if isinstance(v, dict) and set(v) == {"dtype"}:
        return L.torch_dtype(v["dtype"])
    return v


def _plugin_from_spec(spec) -> P.Plugin:
    if isinstance(spec, P.Plugin):
        return spec
    cls = P.plugin_by_name(spec["name"])
    fields = {k: _value_from_spec(v)
              for k, v in dict(spec.get("fields", {})).items()}
    return cls(**fields)


def _endpoint_from_spec(spec) -> Endpoint:
    if isinstance(spec, Endpoint):
        return spec
    kw: Dict[str, Any] = dict(spec)
    kw["layout"] = _layout_from_spec(kw.get("layout", "MN"))
    if kw.get("perm") is not None:
        kw["perm"] = tuple((int(a), int(b)) for a, b in kw["perm"])
    if kw.get("dsts") is not None:
        kw["dsts"] = tuple((str(n), _layout_from_spec(l)) for n, l in kw["dsts"])
    return Endpoint(**kw)


def from_spec(spec: Dict[str, Any]) -> XDMADescriptor:
    """Build a descriptor from a plain description::

        {"src": {"kind": "local", "layout": {"name": "MN", "tile": None,
                                             "perm": None, "pad": None}},
         "dst": {...},
         "pre": [{"name": "rmsnorm", "fields": {"eps": 1e-6,
                  "weight": {"array": w_uint16, "dtype": "bfloat16"}}}],
         "post": [],
         "d_buf": 9, "channels": 1, "backend": "auto"}

    Layouts may also be given by name; endpoint entries take the
    :class:`Endpoint` fields; plugins are registry names with their dataclass
    fields, arrays as numpy (bf16 as a ``uint16`` view with ``dtype``),
    dtypes as ``{"dtype": name}`` or a name string.
    """
    pre = tuple(_plugin_from_spec(p) for p in spec.get("pre", ()))
    post = tuple(_plugin_from_spec(p) for p in spec.get("post", ()))
    return XDMADescriptor(src=_endpoint_from_spec(spec.get("src", {})),
                          dst=_endpoint_from_spec(spec.get("dst", {})),
                          pre=pre, post=post,
                          d_buf=int(spec.get("d_buf", 9)),
                          channels=int(spec.get("channels", 1)),
                          backend=spec.get("backend", "auto"))
