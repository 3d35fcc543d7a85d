"""Layout algebra for XDMA: the N-D affine address-generator IR (PyTorch port).

The twin of ``repro.core.layouts``.  :class:`Layout` says how a *logical*
array is stored *physically* (tile, perm, pad); :func:`affine_pattern` exports
a layout as the Frontend's generator config; :func:`relayout_pair` composes
the ``src⁻¹∘dst`` pattern that the relayout kernel, the plan and the cost
model share.  The pattern algebra is numpy and carries over unchanged;
:meth:`Layout.to_logical` / :meth:`Layout.from_logical` are torch
permute / reshape / slice / pad on tensors of any device.

Layout names and byte orders (``MNM8N128``, ``NMM8N128``, ``MNP64``, …) are
data formats and stay those of the reference.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "Layout",
    "MN",
    "NM",
    "MNP64",
    "MNM8N128",
    "MNM16N128",
    "MNM32N128",
    "MNM8N8",
    "NMM8N128",
    "KV4M8N128",
    "AUTO",
    "affine_pattern",
    "AffinePattern",
    "PatternPair",
    "relayout_pair",
    "layout_for_dtype",
    "tiled_layout",
    "by_name",
    "torch_dtype",
    "itemsize",
    "dtype_info",
]


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else getattr(dtype, "name", None)
    if name is None:
        name = np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"no torch dtype for {dtype!r}")
    return out


def itemsize(dtype) -> int:
    """Bytes per element of ``dtype`` (any spelling :func:`torch_dtype` takes)."""
    return torch_dtype(dtype).itemsize


def dtype_info(dtype) -> Tuple[int, str]:
    """``(itemsize, name)`` of ``dtype``, the name spelled as the reference
    spells it (``"float32"``, ``"bfloat16"``, ``"int8"``): what its cache
    keys and ``page_layout`` read from ``jnp.dtype(dtype)``."""
    t = torch_dtype(dtype)
    return t.itemsize, str(t).replace("torch.", "")


def _argsort(perm: Sequence[int]) -> Tuple[int, ...]:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Physical layout of a logical (..., M, N) array.

    ``tile``  — tiles the last ``len(tile)`` logical dims: each tiled dim of
                extent ``n`` with tile ``t`` becomes a (grid, tile) dim pair
                ``(n//t, t)``; the physical order is grids-then-tiles
                (``tile=(tm, tn)`` stores (..., M, N) as
                (..., M//tm, N//tn, tm, tn) — the paper's MNMbNn convention).
                ``None`` is row-major.
    ``perm``  — permutes the last ``len(perm)`` *physical* dims after tiling
                (``np.transpose`` axis convention).  ``perm=(1, 0)`` on an
                untiled 2D layout is column-major; ``(1, 0, 2, 3)`` on a tiled
                one is a column-major *tile grid*.
    ``pad``   — extra elements appended to the last ``len(pad)`` logical dims
                before tiling (padded strides; the padding reads back as
                zeros).  A dim that is both tiled and padded needs the tile to
                divide both the extent and the pad.
    """

    tile: Optional[Tuple[int, ...]] = None
    name: str = "MN"
    perm: Optional[Tuple[int, ...]] = None
    pad: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        set_ = lambda k, v: object.__setattr__(self, k, v)
        if self.tile is not None:
            tile = tuple(int(t) for t in self.tile)
            if not tile or any(t < 1 for t in tile):
                raise ValueError(f"bad tile {self.tile}")
            set_("tile", tile)
        if self.perm is not None:
            perm = tuple(int(p) for p in self.perm)
            if sorted(perm) != list(range(len(perm))):
                raise ValueError(f"perm {self.perm} is not a permutation")
            set_("perm", perm if perm != tuple(range(len(perm))) else None)
        if self.pad is not None:
            pad = tuple(int(p) for p in self.pad)
            if any(p < 0 for p in pad):
                raise ValueError(f"bad pad {self.pad}")
            set_("pad", pad if any(pad) else None)

    @property
    def is_auto(self) -> bool:
        """True for the ``AUTO`` placeholder: resolved to a concrete layout by
        the cost-model autotuner (``repro_torch.core.autotune``) before
        lowering."""
        return self.name == "auto"

    @property
    def is_tiled(self) -> bool:
        return self.tile is not None

    @property
    def is_padded(self) -> bool:
        return self.pad is not None

    @property
    def is_permuted(self) -> bool:
        return self.perm is not None

    @property
    def tile_rank(self) -> int:
        return len(self.tile) if self.tile is not None else 0

    # -- per-logical-dim structure -----------------------------------------
    def dim_tile(self, rank: int, d: int) -> int:
        """Tile factor of logical dim ``d`` (1 when untiled)."""
        k = self.tile_rank
        if k and d >= rank - k:
            return self.tile[d - (rank - k)]
        return 1

    def dim_pad(self, rank: int, d: int) -> int:
        """Stride padding of logical dim ``d`` (0 when unpadded)."""
        if self.pad is not None and d >= rank - len(self.pad):
            return self.pad[d - (rank - len(self.pad))]
        return 0

    def _phys_dims(self, rank: int):
        """Physical dim provenance, post-perm: a list of
        ``(logical_dim, kind)`` with kind in {'plain', 'grid', 'tile'}."""
        k = self.tile_rank
        dims = [(d, "plain") for d in range(rank - k)]
        dims += [(d, "grid") for d in range(rank - k, rank)]
        dims += [(d, "tile") for d in range(rank - k, rank)]
        if self.perm is not None:
            off = len(dims) - len(self.perm)
            if off < 0:
                raise ValueError(
                    f"perm {self.perm} longer than physical rank {len(dims)}")
            dims = dims[:off] + [dims[off + p] for p in self.perm]
        return dims

    def _phys_extent(self, logical_shape, dim_kind) -> int:
        d, kind = dim_kind
        n = logical_shape[d] + self.dim_pad(len(logical_shape), d)
        t = self.dim_tile(len(logical_shape), d)
        if kind == "grid":
            return n // t
        if kind == "tile":
            return t
        return n

    # -- shape algebra -----------------------------------------------------
    def check(self, logical_shape: Sequence[int]) -> None:
        rank = len(logical_shape)
        if rank < 2:
            raise ValueError(f"logical shape needs >=2 dims, got {logical_shape}")
        if self.tile_rank > rank:
            raise ValueError(
                f"tile {self.tile} needs >= {self.tile_rank} dims, "
                f"got {tuple(logical_shape)}")
        if self.pad is not None and len(self.pad) > rank:
            raise ValueError(f"pad {self.pad} needs >= {len(self.pad)} dims")
        for d in range(rank):
            t = self.dim_tile(rank, d)
            if t == 1:
                continue
            n, p = logical_shape[d], self.dim_pad(rank, d)
            if n % t or p % t:
                raise ValueError(
                    f"logical {tuple(logical_shape)} not divisible by tile "
                    f"{self.tile} (dim {d}: extent {n}, pad {p}) for {self.name}")
        self._phys_dims(rank)               # validates perm length

    def physical_shape(self, logical_shape: Sequence[int]) -> Tuple[int, ...]:
        self.check(logical_shape)
        return tuple(self._phys_extent(logical_shape, dk)
                     for dk in self._phys_dims(len(logical_shape)))

    def logical_shape(self, physical_shape: Sequence[int]) -> Tuple[int, ...]:
        """Invert :meth:`physical_shape` (the physical rank determines the
        logical rank: rank + tile_rank physical dims)."""
        k = self.tile_rank
        rank = len(physical_shape) - k
        if rank < 2:
            raise ValueError(
                f"{self.name}: physical shape {tuple(physical_shape)} too "
                f"small for tile rank {k}")
        dims = self._phys_dims(rank)
        if len(dims) != len(physical_shape):
            raise ValueError(
                f"{self.name}: physical rank {len(physical_shape)} != "
                f"expected {len(dims)}")
        padded = [0] * rank
        tiles = {}
        for extent, (d, kind) in zip(physical_shape, dims):
            if kind == "tile":
                tiles[d] = extent
            elif kind == "plain":
                padded[d] = extent
            else:
                padded[d] = extent          # grid count; scaled below
        for d, t in tiles.items():
            if t != self.dim_tile(rank, d):
                raise ValueError(
                    f"physical {tuple(physical_shape)} doesn't end with tile "
                    f"{self.tile}")
            padded[d] *= t
        out = tuple(padded[d] - self.dim_pad(rank, d) for d in range(rank))
        if any(n < 1 for n in out):
            raise ValueError(
                f"{self.name}: physical {tuple(physical_shape)} smaller than "
                f"its pad {self.pad}")
        return out

    # -- conversions (these are what XLA fuses into the stream) ------------
    def to_logical(self, x: torch.Tensor) -> torch.Tensor:
        """Physical -> logical view (an on-the-fly gather in the stream engine)."""
        if (self.tile is None and self.perm is None and self.pad is None):
            return x
        k = self.tile_rank
        rank = x.ndim - k
        logical = self.logical_shape(tuple(x.shape))
        if self.perm is not None:
            off = x.ndim - len(self.perm)
            axes = tuple(range(off)) + tuple(off + i
                                             for i in _argsort(self.perm))
            x = x.permute(axes)
        if k:
            lead = rank - k
            axes = tuple(range(lead))
            for i in range(k):
                axes += (lead + i, lead + k + i)
            padded = tuple(logical[d] + self.dim_pad(rank, d)
                           for d in range(rank))
            x = x.permute(axes).reshape(padded)
        if self.pad is not None:
            sl = tuple(slice(None) for _ in range(rank - len(self.pad)))
            sl += tuple(slice(0, n) for n in logical[rank - len(self.pad):])
            x = x[sl]
        return x

    def from_logical(self, x: torch.Tensor) -> torch.Tensor:
        """Logical -> physical buffer (the pre-writer side of the stream),
        returned contiguous.

        Stride padding is written as zeros (the allocation granule's slack)."""
        if (self.tile is None and self.perm is None and self.pad is None):
            return x.contiguous()
        self.check(tuple(x.shape))
        rank = x.ndim
        if self.pad is not None:
            widths = []
            for p in reversed(self.pad):        # F.pad lists the last dim first
                widths += [0, p]
            x = F.pad(x, widths)
        k = self.tile_rank
        if k:
            lead = rank - k
            shape = tuple(x.shape[:lead])
            for d in range(lead, rank):
                t = self.dim_tile(rank, d)
                shape += (x.shape[d] // t, t)
            x = x.reshape(shape)
            axes = tuple(range(lead))
            axes += tuple(lead + 2 * i for i in range(k))        # grids
            axes += tuple(lead + 2 * i + 1 for i in range(k))    # tiles
            x = x.permute(axes)
        if self.perm is not None:
            off = x.ndim - len(self.perm)
            x = x.permute(tuple(range(off)) + tuple(off + p
                                                    for p in self.perm))
        return x.contiguous()

    def nbytes(self, logical_shape: Sequence[int], dtype) -> int:
        """Logical payload bytes (the link traffic; excludes stride padding)."""
        return math.prod(logical_shape) * itemsize(dtype)

    def physical_nbytes(self, logical_shape: Sequence[int], dtype) -> int:
        """Allocated bytes, stride padding included."""
        return (math.prod(self.physical_shape(logical_shape))
                * itemsize(dtype))


# Canonical layouts ---------------------------------------------------------
MN = Layout(None, "MN")
MNM8N128 = Layout((8, 128), "MNM8N128")    # 4-byte dtypes
MNM16N128 = Layout((16, 128), "MNM16N128")  # 2-byte dtypes
MNM32N128 = Layout((32, 128), "MNM32N128")  # 1-byte dtypes
MNM8N8 = Layout((8, 8), "MNM8N8")          # the paper's GeMM-array tile (kept for fidelity)
NM = Layout(None, "NM", perm=(1, 0))       # column-major (SIMD gather side)
MNP64 = Layout(None, "MNP64", pad=(0, 64))  # padded row stride (KV alloc granule)
NMM8N128 = Layout((8, 128), "NMM8N128", perm=(1, 0, 2, 3))  # column-major tile grid
KV4M8N128 = Layout((4, 8, 128), "KV4M8N128")  # rank-3 tile (KV-cache/MoE buffers)

# Placeholder for a layout the cost-model autotuner picks; it behaves as MN if
# it ever reaches a pattern export unresolved.
AUTO = Layout(None, "auto")

_BY_NAME = {l.name: l for l in (MN, MNM8N128, MNM16N128, MNM32N128, MNM8N8,
                                NM, MNP64, NMM8N128, KV4M8N128, AUTO)}


def by_name(name: str) -> Layout:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown layout {name!r}; known: {sorted(_BY_NAME)}") from None


def tiled_layout(*tile: int, grid_colmajor: bool = False,
                 tile_transposed: bool = False,
                 pad_last: int = 0) -> Layout:
    """Interning constructor for tiled layouts: structurally equal tilings are
    the *same object*, so CFG-cache keys built from descriptors dedupe.

    ``tiled_layout(8, 128)`` is the canonical ``MNM8N128`` object; generated
    tiles get systematic names (rank-2 ``MNM{tm}N{tn}``, rank-3
    ``KV{tb}M{tm}N{tn}``, with ``NM`` prefix for a column-major grid, ``T``
    suffix for swapped tile dims, ``P{p}`` for a padded last logical dim).
    """
    tile = tuple(int(t) for t in tile)
    while len(tile) > 2 and tile[0] == 1:   # (1, tm, tn) tiles ARE (tm, tn)
        tile = tile[1:]
    # normalize BEFORE the memo so (1, tm, tn) interns to the (tm, tn) object
    return _tiled_layout(tile, bool(grid_colmajor), bool(tile_transposed),
                         int(pad_last))


@functools.lru_cache(maxsize=None)
def _tiled_layout(tile: Tuple[int, ...], grid_colmajor: bool,
                  tile_transposed: bool, pad_last: int) -> Layout:
    if not 2 <= len(tile) <= 3:
        raise ValueError(f"tiled_layout takes a rank-2/3 tile, got {tile}")
    if len(tile) == 3:
        tb, tm, tn = tile
        name = f"KV{tb}M{tm}N{tn}"
    else:
        tm, tn = tile
        name = f"M{tm}N{tn}"
    rank = len(tile)
    perm = None
    if grid_colmajor or tile_transposed:
        if rank != 2:
            raise ValueError("perm variants are rank-2 only")
        grid = (1, 0) if grid_colmajor else (0, 1)
        tl = (3, 2) if tile_transposed else (2, 3)
        perm = grid + tl
    prefix = "NM" if grid_colmajor else ("MN" if rank == 2 else "")
    name = prefix + name + ("T" if tile_transposed else "")
    pad = (0,) * (rank - 1) + (int(pad_last),) if pad_last else None
    if pad_last:
        name += f"P{int(pad_last)}"
    canonical = _BY_NAME.get(name)
    if canonical is not None and not canonical.is_auto:
        return canonical
    return Layout(tile, name, perm=perm, pad=pad)


def layout_for_dtype(dtype) -> Layout:
    """The reference's dtype-native tiled layout: 4-byte dtypes take
    ``MNM8N128``, 2-byte ``MNM16N128``, 1-byte ``MNM32N128``."""
    size = itemsize(dtype)
    return {4: MNM8N128, 2: MNM16N128, 1: MNM32N128}.get(size, MNM8N128)


# -- N-D affine address-generator config (paper Table II / Fig 2b) ----------
@dataclasses.dataclass(frozen=True)
class AffinePattern:
    """XDMA Frontend address-generator config: addr = base + sum(idx[d]*stride[d]).

    ``bounds`` is the paper's ``Ext`` list (loop extents, outer->inner);
    ``strides`` and ``base`` are in elements.  ``dim`` == len(bounds) is
    Table II's ``Dim``; multi-channel descriptors :meth:`split` the stream
    into N_C lanes, each with its own ``base``.
    """

    bounds: Tuple[int, ...]
    strides: Tuple[int, ...]
    base: int = 0

    @property
    def dim(self) -> int:
        return len(self.bounds)

    @property
    def num_elements(self) -> int:
        return math.prod(self.bounds)

    def addresses(self) -> np.ndarray:
        """Materialize the address stream (testing/small sizes only)."""
        if not self.bounds:
            return np.asarray([self.base])
        idx = np.indices(self.bounds).reshape(self.dim, -1)
        return self.base + (np.asarray(self.strides)[:, None] * idx).sum(0)

    # -- canonicalization & burst analysis ----------------------------------
    def canonical(self) -> "AffinePattern":
        """Drop unit-extent levels and merge adjacent levels that the
        generator walks as one (outer stride == inner extent * inner stride).
        The address stream is unchanged."""
        levels = [(b, s) for b, s in zip(self.bounds, self.strides) if b != 1]
        merged = []
        for b, s in reversed(levels):          # inner -> outer
            if merged and s == merged[-1][0] * merged[-1][1]:
                bi, si = merged.pop()
                merged.append((b * bi, si))
            else:
                merged.append((b, s))
        merged.reverse()
        if not merged:
            merged = [(1, 1)]
        return AffinePattern(bounds=tuple(b for b, _ in merged),
                             strides=tuple(s for _, s in merged),
                             base=self.base)

    def burst_length(self) -> int:
        """Elements per maximal contiguous run of the address stream — what
        one hardware burst can move without re-issuing an address."""
        c = self.canonical()
        return c.bounds[-1] if c.strides[-1] == 1 else 1

    def num_bursts(self) -> int:
        return -(-self.num_elements // self.burst_length())

    def contiguity(self) -> float:
        """Fraction of address-stream steps that are stride-1 continuations:
        1.0 = one fully contiguous run, 0.0 = element-wise scatter."""
        n = self.num_elements
        if n <= 1:
            return 1.0
        return (n - self.num_bursts()) / (n - 1)

    # -- the N_C multi-channel lane split (Table II) -------------------------
    def split(self, channels: int) -> Tuple["AffinePattern", ...]:
        """Partition the stream across ``channels`` parallel lanes along the
        outermost loop: lane ``c`` walks the same nest with a shrunk outer
        extent from its own base address.  Lanes cover the address stream
        exactly (no overlap, no gap)."""
        if channels < 1:
            raise ValueError("channels must be >= 1")
        if channels == 1:
            return (self,)
        if not self.bounds or self.bounds[0] % channels:
            raise ValueError(
                f"outer extent {self.bounds[:1]} not divisible by "
                f"channels={channels}")
        lane_outer = self.bounds[0] // channels
        lane_span = lane_outer * self.strides[0]
        bounds = (lane_outer,) + self.bounds[1:]
        return tuple(
            AffinePattern(bounds=bounds, strides=self.strides,
                          base=self.base + c * lane_span)
            for c in range(channels))

    # -- composition: src⁻¹ ∘ dst -------------------------------------------
    def compose(self, dst: "AffinePattern") -> Optional["PatternPair"]:
        """Fuse two generator configs over one shared loop nest: at each step
        the pair yields (read address from ``self``, write address from
        ``dst``).  Both patterns must enumerate the same stream positions
        (equal ``num_elements``); returns None when the two loop nests have
        no common refinement (non-nesting extents)."""
        if self.num_elements != dst.num_elements:
            raise ValueError(
                f"cannot compose patterns of {self.num_elements} vs "
                f"{dst.num_elements} elements")
        cuts = sorted(_cuts(self.bounds) | _cuts(dst.bounds))
        for a, b in zip(cuts, cuts[1:]):
            if b % a:
                return None
        bounds = tuple(b // a for a, b in zip(cuts, cuts[1:]))[::-1]
        src_strides = _refined_strides(self, cuts)
        dst_strides = _refined_strides(dst, cuts)
        return PatternPair(bounds=bounds, src_strides=src_strides,
                           dst_strides=dst_strides, src_base=self.base,
                           dst_base=dst.base)


def _cuts(bounds: Sequence[int]) -> set:
    """Suffix products: the stream positions where each loop level wraps."""
    out = {1}
    acc = 1
    for b in reversed(bounds):
        acc *= b
        out.add(acc)
    return out


def _refined_strides(pat: AffinePattern, cuts: Sequence[int]) -> Tuple[int, ...]:
    """Strides of ``pat`` re-expressed over the refined nest whose level
    weights are ``cuts`` (sorted ascending, chain-divisible)."""
    spans = []                                  # (lo_weight, hi_weight, stride)
    w = 1
    for b, s in zip(reversed(pat.bounds), reversed(pat.strides)):
        spans.append((w, w * b, s))
        w *= b
    out = []
    for lo, hi in zip(cuts, cuts[1:]):          # refined level [lo, hi)
        for w0, w1, s in spans:
            if w0 <= lo and hi <= w1:
                out.append(s * (lo // w0))
                break
        else:                                   # pragma: no cover - cuts checked
            raise AssertionError(f"refined level {lo} not covered")
    return tuple(reversed(out))


@dataclasses.dataclass(frozen=True)
class PatternPair:
    """The composed ``src⁻¹∘dst`` relayout pattern: one loop nest, a read and
    a write address per step.  This is the IR the generic AGU kernel, the
    software-AGU baseline, and the link cost model all consume."""

    bounds: Tuple[int, ...]
    src_strides: Tuple[int, ...]
    dst_strides: Tuple[int, ...]
    src_base: int = 0
    dst_base: int = 0

    @property
    def dim(self) -> int:
        return len(self.bounds)

    @property
    def num_elements(self) -> int:
        return math.prod(self.bounds)

    @property
    def src(self) -> AffinePattern:
        return AffinePattern(self.bounds, self.src_strides, self.src_base)

    @property
    def dst(self) -> AffinePattern:
        return AffinePattern(self.bounds, self.dst_strides, self.dst_base)

    def burst_length(self) -> int:
        """Elements per run that is contiguous on BOTH sides — the longest
        copy a 1D burst engine can issue per computed address pair."""
        run = 1
        for b, ss, ds in zip(reversed(self.bounds),
                             reversed(self.src_strides),
                             reversed(self.dst_strides)):
            if b == 1:
                continue
            if ss == run and ds == run:
                run *= b
            else:
                break
        return run

    def num_runs(self) -> int:
        return self.num_elements // self.burst_length()

    def runs(self):
        """-> (run_length, outer_bounds, outer_src_strides, outer_dst_strides):
        the nest with the both-sides-contiguous innermost levels merged off —
        exactly what a software AGU loop iterates."""
        run = self.burst_length()
        acc = 1
        consuming = True
        levels = []
        for b, ss, ds in zip(reversed(self.bounds),
                             reversed(self.src_strides),
                             reversed(self.dst_strides)):
            if b == 1:
                continue
            if consuming and acc < run and ss == acc and ds == acc:
                acc *= b
                continue
            consuming = False
            levels.append((b, ss, ds))
        levels.reverse()
        return (run, tuple(l[0] for l in levels), tuple(l[1] for l in levels),
                tuple(l[2] for l in levels))

    def split(self, channels: int) -> Tuple["PatternPair", ...]:
        """N_C lanes over the shared nest (see :meth:`AffinePattern.split`)."""
        if channels < 1:
            raise ValueError("channels must be >= 1")
        if channels == 1:
            return (self,)
        if not self.bounds or self.bounds[0] % channels:
            raise ValueError(
                f"outer extent {self.bounds[:1]} not divisible by "
                f"channels={channels}")
        lane_outer = self.bounds[0] // channels
        bounds = (lane_outer,) + self.bounds[1:]
        return tuple(dataclasses.replace(
            self, bounds=bounds,
            src_base=self.src_base + c * lane_outer * self.src_strides[0],
            dst_base=self.dst_base + c * lane_outer * self.dst_strides[0])
            for c in range(channels))

    def gather(self, src_flat: np.ndarray, dst_size: int,
               fill=0) -> np.ndarray:
        """Reference walk (numpy): scatter ``src_flat`` through the pair into
        a flat destination of ``dst_size`` elements (stride padding = fill)."""
        out = np.full((dst_size,), fill, dtype=src_flat.dtype)
        out[self.dst.addresses()] = src_flat[self.src.addresses()]
        return out


def affine_pattern(layout: Layout, logical_shape: Sequence[int], *,
                   order: Optional[Sequence[int]] = None) -> AffinePattern:
    """Address pattern that walks a physical buffer in *logical* order.

    This is the generator config the XDMA Frontend would be programmed with
    to stream the array out in logical (row-major over ``order``) order,
    whatever the physical layout.  ``order`` permutes the logical walk nest
    (default natural order); ``order=(..., -1, -2)`` walks columns outer —
    the transposed stream a relayout-with-transpose composes against.

    Every logical dim contributes its (grid, tile) level pair (or a single
    level when untiled); strides come from the row-major physical buffer,
    stride padding included (padded elements are simply never addressed).
    """
    layout.check(logical_shape)
    rank = len(logical_shape)
    dims = layout._phys_dims(rank)
    extents = [layout._phys_extent(logical_shape, dk) for dk in dims]
    strides = [0] * len(dims)
    acc = 1
    for i in range(len(dims) - 1, -1, -1):
        strides[i] = acc
        acc *= extents[i]
    stride_of = {dk: s for dk, s in zip(dims, strides)}
    if order is None:
        order = range(rank)
    else:
        order = tuple(d % rank for d in order)
        if sorted(order) != list(range(rank)):
            raise ValueError(f"order {order} is not a permutation of dims")
    bounds, out_strides = [], []
    for d in order:
        t = layout.dim_tile(rank, d)
        n = logical_shape[d]
        if t > 1:
            bounds += [n // t, t]
            out_strides += [stride_of[(d, "grid")], stride_of[(d, "tile")]]
        else:
            bounds.append(n)
            out_strides.append(stride_of[(d, "plain")])
    return AffinePattern(bounds=tuple(bounds), strides=tuple(out_strides))


def relayout_pair(src_layout: Layout, dst_layout: Layout,
                  logical_shape: Sequence[int], *,
                  transpose: bool = False) -> Optional[PatternPair]:
    """The ``src⁻¹∘dst`` pattern of a relayout (optionally with a logical
    transpose of the last two dims): src walked in the *destination's*
    logical order, composed with the destination walk.  None when the two
    nests have no common refinement (the generic kernel then falls back)."""
    shape = tuple(logical_shape)
    if transpose:
        rank = len(shape)
        order = tuple(range(rank - 2)) + (rank - 1, rank - 2)
        out_shape = shape[:-2] + (shape[-1], shape[-2])
        src_pat = affine_pattern(src_layout, shape, order=order)
    else:
        out_shape = shape
        src_pat = affine_pattern(src_layout, shape)
    dst_pat = affine_pattern(dst_layout, out_shape)
    return src_pat.compose(dst_pat)
