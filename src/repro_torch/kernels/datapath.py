"""The plugin datapath kernels: host side of kernels 2 and 3.

* :class:`StreamedDatapath` — kernel 2, ``csrc/streamed_datapath.cu``, the
  port of the reference's ``_compile_streamed``: reader -> a chain of
  streaming plugins -> writer, a group of threads per logical row.
* :class:`BlockDatapath` — kernel 3, ``csrc/block_datapath.cu``, the port of
  ``_compile_block``: reader -> any emit-capable chain (Transpose,
  GatherScatter, Compress, Decompress, ReduceStage and the streaming
  plugins) -> writer, spread over many blocks.

Both compile the chain once into a small op or stage list whose constants
are rounded to the stream dtype as jnp's rules require (``Scale`` and
``BiasAdd`` cast their constant to the stream dtype first), so one binary
serves every chain.  On a CPU tensor each takes its plain version — the
plugins' ``__call__`` composed with the layout algebra — and on a CUDA
tensor it launches its kernel or raises; on a meta tensor the dry run
(an active ``launch.op_cost.OpCost``) takes the plain version's shapes
and counts the call as one op (:func:`repro_torch.launch.op_cost.one_op`),
and elsewhere a meta tensor raises.  Kernel 2 runs float32, bfloat16
and float16 streams, kernel 3 those and int8, uint8, int16, uint16, int32,
uint32, int64, bool, float8_e4m3fn and float8_e5m2 streams (a
:class:`StreamedDatapath` hands every other stream to kernel 3), at any
logical rank whose leading axes fold to 8 or fewer; a scale, bias or weight
is a scalar or a vector over the last logical axis.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import layouts as L
from repro_torch.core import plugins as P
from repro_torch.launch import op_cost

from . import _build, maps

__all__ = ["StreamedDatapath", "BlockDatapath", "STREAMED", "BLOCK",
           "plain", "compose", "rank2_path", "stream_path"]


# -- shared: constants of value stages ----------------------------------------
def _column_const(value: Any, n: int, dtype: torch.dtype, device,
                  floats: Optional[bool] = None
                  ) -> Tuple[float, Optional[torch.Tensor]]:
    """A scale / bias / weight constant cast to ``dtype`` (jnp's rule), as
    (scalar, None) or (0.0, vector over the last axis on ``device``) in
    kernel 3's carrier: f32 where ``floats`` (default: a float stream),
    int64 otherwise."""
    c = P.as_tensor(value).to(dtype)
    if floats is None:
        floats = dtype.is_floating_point
    wide = torch.float32 if floats else torch.int64
    if c.numel() == 1:
        return float(c.reshape(()).to(wide)), None
    if c.numel() == n and all(s == 1 for s in c.shape[:-1]):
        vec = c.reshape(n).to(wide).to(device).contiguous()
        return 0.0, vec
    raise NotImplementedError(
        f"the datapath kernels take a scalar or a vector over the last axis "
        f"({n}), not a constant of shape {tuple(c.shape)}")


def _check_input(x: torch.Tensor, shape: Sequence[int],
                 dtype: torch.dtype) -> torch.Tensor:
    """``x`` as the dense buffer the kernels read (a strided view, a slice
    of a cache say, is copied once)."""
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype:
        raise ValueError(f"compiled for {tuple(shape)} {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    return x.contiguous()


def plain(x, chain, src_layout: L.Layout, dst_layout: L.Layout):
    """The plain version of kernels 2 and 3: reader -> plugin chain ->
    writer; a Compress at the end returns a :class:`CTensor` whose values
    take the dst layout and whose mask is raw."""
    v = P.apply_chain(chain, src_layout.to_logical(x))
    if isinstance(v, P.CTensor):
        return P.CTensor(values=dst_layout.from_logical(v.values), mask=v.mask)
    return dst_layout.from_logical(v)


# -- kernel 2: the streamed datapath ------------------------------------------
_OP_CAST, _OP_SCALE, _OP_BIAS, _OP_RMSNORM = 1, 2, 3, 4
_MAX_OPS = 8
# the kernel's code paths, by their index in StreamArgs.path
STREAM_PATHS = ("rows", "generic")
_PATH_ROWS, _PATH_GENERIC = 0, 1


class _Op(ctypes.Structure):
    _fields_ = [("code", ctypes.c_int64), ("dtype", ctypes.c_int64),
                ("a", ctypes.c_double), ("vec", ctypes.c_int64)]


class _StreamArgs(ctypes.Structure):
    _fields_ = [("rows", ctypes.c_int64), ("cols", ctypes.c_int64),
                ("pcols", ctypes.c_int64), ("in_dtype", ctypes.c_int64),
                ("out_dtype", ctypes.c_int64), ("nops", ctypes.c_int64),
                ("ops", _Op * _MAX_OPS), ("src", maps.DimMap * 2),
                ("dst", maps.DimMap * 2), ("path", ctypes.c_int64)]


STREAMED = _build.register(_build.Kernel(
    "streamed_datapath", "streamed_datapath.cu", "xdma_streamed_datapath",
    [ctypes.c_void_p] * 3,
    replaces="src/repro/core/plugin_compiler.py:236"))


def stream_path(a: _StreamArgs, src_ptr: int, dst_ptr: int) -> int:
    """The path kernel 2 takes for the arguments ``a`` (an index into
    :data:`STREAM_PATHS`): ``rows`` where both sides run along the columns
    in whole 16-byte packs of the chunk width (the wider of the two sides'
    packs, as :func:`maps.run_axis` checks it over the source's columns and
    the destination's padded columns) with a column tile, if any, of a
    power of two, and the source, the destination and every constant vector
    start on a 16-byte boundary; ``generic`` otherwise.  The C entry point
    refuses ``rows`` where it does not fit."""
    size = {code: dt.itemsize for dt, code in maps.DTYPE_CODES.items()}
    c = max(16 // size[a.in_dtype], 16 // size[a.out_dtype])

    def terms(dm):
        return [(m.tile, m.sgrid, m.stile) for m in dm]

    ptrs = [src_ptr, dst_ptr] + [a.ops[k].vec for k in range(a.nops)]
    fits = (maps.run_axis(terms(a.src), (a.rows, a.cols), c) == (1, c)
            and maps.run_axis(terms(a.dst), (a.rows, a.pcols), c) == (1, c)
            and all(m.tile & (m.tile - 1) == 0 for m in (a.src[1], a.dst[1]))
            and all(p % 16 == 0 for p in ptrs))
    return _PATH_ROWS if fits else _PATH_GENERIC


class StreamedDatapath:
    """Kernel 2 compiled for one chain, layout pair and input shape/dtype.
    Each launch takes the path :func:`stream_path` picks, and
    ``STREAMED.paths`` counts it under that name.

    A chain of more than ``_MAX_OPS`` ops runs as several launches of
    ``_MAX_OPS`` ops or fewer, joined by row-major buffers in the stream
    dtype of the point between them: every op rounds to that dtype, so the
    buffers lose nothing.  A stream the kernel does not run (an integer,
    bool or float8 input, or a Cast to such a dtype) runs on kernel 3, which
    moves their words and does their arithmetic."""

    def __init__(self, chain: Sequence[P.Plugin], src_layout: L.Layout,
                 dst_layout: L.Layout, in_shape: Sequence[int],
                 in_dtype: torch.dtype):
        self.chain = tuple(chain)
        self.src_layout, self.dst_layout = src_layout, dst_layout
        self.in_shape, self.in_dtype = tuple(in_shape), in_dtype
        self.logical = src_layout.logical_shape(self.in_shape)
        if len(self.logical) != 2:
            raise ValueError("the streamed datapath runs rank-2 logical data")
        self.out_dtype = P.chain_out_dtype(self.chain, in_dtype)
        self._prepared: Dict[Any, Tuple[_StreamArgs, List[torch.Tensor]]] = {}
        ops = [p for p in self.chain if not isinstance(p, P.Identity)]
        dtypes = [P.chain_out_dtype(ops[:k], in_dtype)
                  for k in range(len(ops) + 1)]
        self._block: Optional[BlockDatapath] = None
        self._parts: Optional[List[StreamedDatapath]] = None
        if not all(d in maps.DTYPE_CODES for d in dtypes):
            self._block = BlockDatapath(self.chain, src_layout, dst_layout,
                                        in_shape, in_dtype)
        elif len(ops) > _MAX_OPS:
            self._parts = []
            layout, shape = src_layout, self.in_shape
            for k in range(0, len(ops), _MAX_OPS):
                last = k + _MAX_OPS >= len(ops)
                self._parts.append(StreamedDatapath(
                    ops[k:k + _MAX_OPS], layout,
                    dst_layout if last else L.MN, shape, dtypes[k]))
                layout, shape = L.MN, self.logical

    def _prepare(self, device) -> Tuple[_StreamArgs, List[torch.Tensor]]:
        m, n = self.logical
        a = _StreamArgs()
        keep: List[torch.Tensor] = []
        a.rows, a.cols = m, n
        a.pcols = n + self.dst_layout.dim_pad(2, 1)
        a.in_dtype = maps.dtype_code(self.in_dtype)
        a.out_dtype = maps.dtype_code(self.out_dtype)
        dtype, k = self.in_dtype, 0
        for p in self.chain:
            if isinstance(p, P.Identity):
                continue
            if k == _MAX_OPS:
                raise NotImplementedError(f"at most {_MAX_OPS} streamed ops")
            op = a.ops[k]
            if isinstance(p, P.Cast):
                dtype = p.dtype
                op.code, op.a, op.vec = _OP_CAST, 0.0, 0
            elif isinstance(p, (P.Scale, P.BiasAdd, P.RMSNormPlugin)):
                if isinstance(p, P.RMSNormPlugin):
                    op.code, op.a, vec = _OP_RMSNORM, float(p.eps), None
                    if p.weight is not None:
                        _, vec = _column_const(p.weight, n, torch.float32,
                                               device)
                else:
                    value = p.alpha if isinstance(p, P.Scale) else p.bias
                    op.code = _OP_SCALE if isinstance(p, P.Scale) else _OP_BIAS
                    op.a, vec = _column_const(value, n, dtype, device)
                op.vec = 0 if vec is None else vec.data_ptr()
                if vec is not None:
                    keep.append(vec)
            else:
                raise ValueError(f"{p.name!r} is not a streaming plugin")
            op.dtype = maps.dtype_code(dtype)
            k += 1
        a.nops = k
        for d, mp in enumerate(maps.dim_maps(self.src_layout, (m, n))):
            a.src[d] = maps.DimMap(*mp)
        for d, mp in enumerate(maps.dim_maps(self.dst_layout, (m, n))):
            a.dst[d] = maps.DimMap(*mp)
        return a, keep

    @op_cost.one_op
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if op_cost.plain_on(x):
            return plain(x, self.chain, self.src_layout, self.dst_layout)
        if x.device.type != "cuda":
            raise NotImplementedError(f"no datapath kernel for {x.device}")
        return self.launch(x)

    def launch(self, x: torch.Tensor) -> torch.Tensor:
        """Launch kernel 2 on ``x``'s device and stream."""
        x = _check_input(x, self.in_shape, self.in_dtype)
        if self._block is not None:
            return self._block.launch(x)
        if self._parts is not None:
            for part in self._parts:
                x = part.launch(x)
            return x
        key = (x.device.type, x.device.index)
        prepared = self._prepared.get(key)
        if prepared is None:
            prepared = self._prepared[key] = self._prepare(x.device)
        args, _ = prepared
        out = torch.empty(self.dst_layout.physical_shape(self.logical),
                          dtype=self.out_dtype, device=x.device)
        args.path = stream_path(args, x.data_ptr(), out.data_ptr())
        STREAMED(ctypes.addressof(args), x.data_ptr(), out.data_ptr(),
                 path=STREAM_PATHS[args.path])
        return out


# -- kernel 3: the block datapath ---------------------------------------------
_XR, _XS, _XP = 8, 8, 16
(_ST_CAST, _ST_SCALE, _ST_BIAS, _ST_RMSNORM, _ST_TRANSPOSE, _ST_GATHER,
 _ST_COMPRESS, _ST_DECOMPRESS, _ST_REDUCE_SUM, _ST_REDUCE_MAX) = range(1, 11)
_MODE_OUT, _MODE_STAT, _MODE_MASK = 0, 1, 2
# the rank-2 path: OUT through f32, STAT, MASK, REDUCE, OUT copying words
_MODE_OUT2, _MODE_STAT2, _MODE_MASK2, _MODE_REDUCE2, _MODE_COPY2 = range(3, 8)
_VALUE_CODES = (_ST_SCALE, _ST_BIAS, _ST_RMSNORM, _ST_DECOMPRESS)
_REDUCE_STRIP = 64          # csrc SW: columns per reduce block
_REDUCE_BLOCKS = 512        # reduce blocks to aim for: about 4 an SM of an H100
_PER_THREAD = 4             # csrc PER_THREAD: generic OUT elements a thread
_INDEX32 = 2 ** 31          # the generic path's 32-bit instance: sizes below
_TILE = 32                  # csrc TT: the tiled OUT pass's tile edge


class _Stage(ctypes.Structure):
    _fields_ = [("code", ctypes.c_int64), ("dtype", ctypes.c_int64),
                ("where", ctypes.c_int64), ("keepdims", ctypes.c_int64),
                ("block_rows", ctypes.c_int64), ("a", ctypes.c_double),
                ("vec", ctypes.c_int64), ("aux", ctypes.c_int64),
                ("rows", ctypes.c_int64), ("cols", ctypes.c_int64),
                ("out_rows", ctypes.c_int64), ("inner", ctypes.c_int64),
                ("ext_in", ctypes.c_int64), ("ext_out", ctypes.c_int64),
                ("nb", ctypes.c_int64)]


class _BlockArgs(ctypes.Structure):
    _fields_ = [("nstages", ctypes.c_int64), ("st", _Stage * _XS),
                ("in_dtype", ctypes.c_int64), ("nlead", ctypes.c_int64),
                ("lext", ctypes.c_int64 * (_XR - 2)),
                ("src", maps.DimMap * _XR), ("upto", ctypes.c_int64),
                ("out_dtype", ctypes.c_int64), ("nphys", ctypes.c_int64),
                ("pext", ctypes.c_int64 * _XP), ("plim", ctypes.c_int64 * _XP),
                ("pslot", ctypes.c_int64 * _XP), ("pw", ctypes.c_int64 * _XP),
                ("total", ctypes.c_int64), ("reduce_at", ctypes.c_int64),
                ("carrier", ctypes.c_int64), ("index32", ctypes.c_int64),
                ("per_thread", ctypes.c_int64), ("nwalk", ctypes.c_int64),
                ("walk", ctypes.c_int64 * _XS), ("nvalue", ctypes.c_int64),
                ("value", ctypes.c_int64 * _XS), ("tiled", ctypes.c_int64)]


class _Stage2(ctypes.Structure):
    _fields_ = [("code", ctypes.c_int64), ("dtype", ctypes.c_int64),
                ("swap", ctypes.c_int64), ("block_rows", ctypes.c_int64),
                ("a", ctypes.c_double), ("vec", ctypes.c_int64),
                ("aux", ctypes.c_int64), ("aux_step", ctypes.c_int64)]


class _Rank2Args(ctypes.Structure):
    _fields_ = [("t", maps.Tile2), ("nstages", ctypes.c_int64),
                ("st", _Stage2 * _XS), ("dtype", ctypes.c_int64),
                ("fill_bits", ctypes.c_int64), ("op", ctypes.c_int64),
                ("eps", ctypes.c_double), ("block_rows", ctypes.c_int64),
                ("out", ctypes.c_int64), ("splits", ctypes.c_int64),
                ("partial", ctypes.c_int64), ("counter", ctypes.c_int64),
                ("nlead", ctypes.c_int64), ("batch", ctypes.c_int64),
                ("lead", maps.Lead * (_XR - 2))]


BLOCK = _build.register(_build.Kernel(
    "block_datapath", "block_datapath.cu", "xdma_block_datapath",
    [ctypes.c_void_p] * 3 + [ctypes.c_int64],
    replaces="src/repro/core/plugin_compiler.py:182"))


@dataclasses.dataclass
class _St:
    """One compiled stage of kernel 3 (host side)."""

    code: int
    dtype: torch.dtype              # stream dtype after the stage
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...] = ()
    axis: int = 0
    keepdims: int = 1
    block_rows: int = 0
    a: float = 0.0
    vec: Optional[torch.Tensor] = None
    index: Optional[torch.Tensor] = None   # GATHER indices
    mask_of: int = -1                      # DECOMPRESS: its COMPRESS stage
    floats: bool = True                    # its values travel as f32

    @property
    def is_reduce(self) -> bool:
        return self.code in (_ST_REDUCE_SUM, _ST_REDUCE_MAX)

    @property
    def changes_value(self) -> bool:
        return self.code in (_ST_CAST,) + _VALUE_CODES

    @property
    def reads_coordinate(self) -> bool:
        return self.code in (_ST_RMSNORM, _ST_DECOMPRESS) or (
            self.code in (_ST_SCALE, _ST_BIAS) and self.vec is not None)


def _compose_index(f: Optional[torch.Tensor], index: torch.Tensor,
                   code: int) -> torch.Tensor:
    """A gather's indices after the composed map ``f`` of the later index
    stages (None: identity): entries < 0 are fill codes, the later gather's
    code kept where both failed."""
    g = index if f is None else index[f.clamp(min=0)]
    g = torch.where(g < 0, torch.full_like(g, code), g)
    return g if f is None else torch.where(f < 0, f, g)


@dataclasses.dataclass
class _Composed:
    """Stages [0, k) of a segment folded into a pass at their end point:
    ``axes[a]`` is the source logical axis that tile axis ``a`` (the pass's
    rows, then its columns) indexes, ``index[a]`` its composed gather
    indices (None: identity), ``swaps[s]`` whether stage s reads the pass
    coordinate (r, c) as (c, r), and ``lead[d]`` the composed gather indices
    of leading axis ``d``, which every stage leaves in place."""

    axes: Tuple[int, int]
    index: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]
    swaps: Tuple[int, ...]
    lead: Tuple[Optional[torch.Tensor], ...]


def compose(seg: Sequence["_St"], k: int, rank: Optional[int] = None
            ) -> _Composed:
    """Walk stages [0, k) back from the pass at their end: a Transpose swaps
    the tile axes, a gather composes into its axis's index vector (a tile
    axis's or a leading axis's) with the fill code -(s + 1) of stage s.
    ``rank`` is the pass's logical rank (default: the segment's)."""
    if rank is None:
        rank = len(seg[0].in_shape) if seg else 2
    axes, index = [rank - 2, rank - 1], [None, None]
    lead: List[Optional[torch.Tensor]] = [None] * (rank - 2)
    swaps = [0] * k
    for s in range(k - 1, -1, -1):
        st = seg[s]
        swaps[s] = int(axes[0] == rank - 1)
        if st.code == _ST_TRANSPOSE:
            axes.reverse()
        elif st.code == _ST_GATHER and st.axis < rank - 2:
            lead[st.axis] = _compose_index(lead[st.axis], st.index, -(s + 1))
        elif st.code == _ST_GATHER:
            a = axes.index(st.axis)
            index[a] = _compose_index(index[a], st.index, -(s + 1))
    return _Composed(tuple(axes), tuple(index), tuple(swaps), tuple(lead))


def rank2_path(seg: Sequence["_St"], src_rank: int, src_dtype: torch.dtype,
               dst_layout: Optional[L.Layout] = None) -> bool:
    """Whether kernel 3's rank-2 path takes a launch segment: logical rank
    2 to 8, every stage leaving the leading axes ``[0, rank - 2)`` in place
    (a gather of a leading axis composes into that axis's index vector; a
    final ReduceStage may drop its rows), one stream dtype, a ReduceStage
    only last, and no gather after a stage that reads its coordinate (the
    stage's coordinate is then the pass's, swapped or not); on a stream
    other than float32, bfloat16 and float16, only stages that move words
    (its copy).  With ``dst_layout``, a destination that pads a leading
    axis goes to the generic path."""
    if not 2 <= src_rank <= _XR:
        return False
    for i, st in enumerate(seg):
        drops_rows = i == len(seg) - 1 and st.is_reduce and not st.keepdims
        if (len(st.in_shape) != src_rank or st.dtype != src_dtype
                or len(st.out_shape) != src_rank - drops_rows):
            return False
    if src_dtype not in maps.DTYPE_CODES and any(
            st.code not in (_ST_CAST, _ST_TRANSPOSE, _ST_GATHER) for st in seg):
        return False
    if any(st.is_reduce for st in seg[:-1]):
        return False
    coordinate = False
    for st in seg:
        if st.code == _ST_GATHER and coordinate:
            return False
        coordinate = coordinate or st.reads_coordinate
    if dst_layout is not None:
        out_rank = len(seg[-1].out_shape) if seg else src_rank
        if any(dst_layout.dim_pad(out_rank, d) for d in range(src_rank - 2)):
            return False
    return True


class BlockDatapath:
    """Kernel 3 compiled for one chain, layout pair and input shape/dtype.

    Launches, in order, for each launch segment (a chain with more than one
    ReduceStage is cut before each later one, joined by a row-major
    intermediate): a statistics pass per RMSNorm, a mask pass per Compress,
    then the output pass.  Each segment takes the rank-2 path where
    :func:`rank2_path` allows it, else the generic path; ``BLOCK.paths``
    counts the launches of each.  A chain is also cut where its values
    change carrier, so that a launch carries them in one type: f32 for a
    float stream (float8 included) and int64 for an integer one; a bool
    stream stays in the carrier of the stream it came from (a Cast from a
    float keeps f32, where ``x != 0`` is the cast).  ``GatherScatter``
    follows ``jnp.take``: negative indices count from the end, and an index
    outside ``[-n, n)`` yields the words of ``plugins.FILL_BITS`` (NaN, an
    integer's min, or max if unsigned, True).

    A logical rank above 8 runs folded (:func:`fold_axes`): its adjacent
    leading axes that both layouts keep contiguous and untiled and that no
    stage names become one, and an inner program of rank 8 or less runs on
    the same buffers reshaped."""

    def __init__(self, chain: Sequence[P.Plugin], src_layout: L.Layout,
                 dst_layout: L.Layout, in_shape: Sequence[int],
                 in_dtype: torch.dtype):
        self.chain = tuple(chain)
        self.src_layout, self.dst_layout = src_layout, dst_layout
        self.in_shape, self.in_dtype = tuple(in_shape), in_dtype
        self.logical = src_layout.logical_shape(self.in_shape)
        self._prepared: Dict[Any, List[_St]] = {}
        self._composed: Dict[Any, _Composed] = {}
        self._inner: Optional[BlockDatapath] = None
        if len(self.logical) > _XR:
            groups = fold_axes(self.chain, src_layout, dst_layout,
                               self.logical)
            if len(groups) <= _XR:
                self._inner = BlockDatapath(
                    _folded_chain(self.chain, self.logical, groups),
                    src_layout, dst_layout,
                    src_layout.physical_shape(_fold(self.logical, groups)),
                    in_dtype)

    # -- compile --------------------------------------------------------------
    def _compile(self, device) -> List[_St]:
        """The stage list (of the folded program for a rank above 8)."""
        if self._inner is not None:
            return self._inner._compile(device)
        shape, dtype = tuple(self.logical), self.in_dtype
        floats = _float_carried(dtype, False)
        stages: List[_St] = []
        compressed = -1                       # stage index of a pending Compress
        for p in self.chain:
            if isinstance(p, P.Identity):
                continue
            if compressed >= 0 and not isinstance(p, P.Decompress):
                raise ValueError(f"{p.name!r} cannot follow a Compress; only "
                                 "Decompress takes a CTensor")
            st = _St(code=0, dtype=dtype, in_shape=shape, floats=floats)
            n = shape[-1]
            if isinstance(p, P.Cast):
                st.code, st.dtype = _ST_CAST, p.dtype
                st.floats = _float_carried(p.dtype, floats)
            elif isinstance(p, (P.Scale, P.BiasAdd)):
                st.code = _ST_SCALE if isinstance(p, P.Scale) else _ST_BIAS
                value = p.alpha if isinstance(p, P.Scale) else p.bias
                st.a, st.vec = _column_const(value, n, dtype, device, floats)
            elif isinstance(p, P.RMSNormPlugin):
                st.code, st.a = _ST_RMSNORM, float(p.eps)
                if p.weight is not None:
                    _, st.vec = _column_const(p.weight, n, torch.float32,
                                              device)
            elif isinstance(p, P.Transpose):
                st.code = _ST_TRANSPOSE
            elif isinstance(p, P.GatherScatter):
                st.code, st.axis = _ST_GATHER, p.axis % len(shape)
                st.index = P.take_indices(p.indices, shape[st.axis],
                                          device=device).contiguous()
            elif isinstance(p, P.Compress):
                if shape[-2] % p.block_rows:
                    raise ValueError(f"logical rows {shape[-2]} not divisible "
                                     f"by block_rows={p.block_rows}")
                st.code, st.block_rows = _ST_COMPRESS, p.block_rows
                compressed = len(stages)
            elif isinstance(p, P.Decompress):
                if compressed < 0:
                    raise ValueError("Decompress needs a CTensor: put a "
                                     "Compress before it")
                st.code = _ST_DECOMPRESS
                st.block_rows = stages[compressed].block_rows
                st.mask_of, compressed = compressed, -1
            elif isinstance(p, P.ReduceStage):
                st.code = _ST_REDUCE_SUM if p.op == "sum" else _ST_REDUCE_MAX
                st.keepdims = int(p.keepdims)
                if p.op == "sum":           # jnp.sum widens narrow integers
                    st.dtype = P._sum_dtype(dtype)
                    st.floats = _float_carried(st.dtype, floats)
            else:
                raise ValueError(f"{p.name!r} has no block-datapath stage")
            shape = st.out_shape = tuple(p.out_logical_shape(shape))
            dtype, floats = st.dtype, st.floats
            if not 2 <= len(shape) <= _XR or len(st.in_shape) > _XR:
                raise NotImplementedError(
                    f"the block kernel runs logical ranks 2..{_XR}, and this "
                    f"chain's leading axes do not fold to that "
                    f"({len(self.logical)} axes in: a stage names an axis, "
                    f"or a layout tiles, pads or permutes it)")
            stages.append(st)
        maps.dtype_code(self.in_dtype, True)  # raises on a dtype the kernel
        for st in stages:                     # does not run
            maps.dtype_code(st.dtype, True)
        return stages

    def _segments(self, stages: List[_St]) -> List[Tuple[int, int]]:
        """Stage ranges of the launch segments: at most one ReduceStage and
        at most ``_XS`` stages each, and one carrier: a stage whose values
        change carrier starts a segment.  A stage that makes a bool or
        float8 value in the f32 carrier ends its segment: the store rounds
        it (the kernel's stages round to f32 / bf16 / f16 only), and a
        float8 sum runs in the output pass alone, in the reference's
        order."""
        segs, lo, has_reduce = [], 0, False
        for s, st in enumerate(stages):
            prev = stages[s - 1] if s > lo else None
            if prev is not None and (st.floats != prev.floats
                                     or _rounded_by_store(prev)) \
                    or (st.is_reduce and has_reduce) or s - lo == _XS:
                segs.append((lo, s))
                lo, has_reduce = s, False
            has_reduce = has_reduce or st.is_reduce
        segs.append((lo, len(stages)))
        return segs

    # -- launch ---------------------------------------------------------------
    def _args(self, stages: List[_St], lo: int, hi: int,
              src_layout: L.Layout, src_logical: Tuple[int, ...],
              src_dtype: torch.dtype, aux: Dict[int, torch.Tensor]
              ) -> _BlockArgs:
        a = _BlockArgs()
        a.nstages = hi - lo
        a.reduce_at = -1
        for k, st in enumerate(stages[lo:hi]):
            c = a.st[k]
            c.code, c.dtype = st.code, maps.dtype_code(st.dtype, True)
            c.keepdims, c.block_rows, c.a = st.keepdims, st.block_rows, st.a
            c.vec = 0 if st.vec is None else st.vec.data_ptr()
            buf = st.index if st.index is not None else aux.get(
                st.mask_of if st.mask_of >= 0 else lo + k)
            c.aux = 0 if buf is None else buf.data_ptr()
            rank = len(st.in_shape)
            c.rows, c.cols = st.in_shape[-2:]
            c.out_rows = st.out_shape[-2] if len(st.out_shape) > 1 else 1
            if st.code == _ST_GATHER and st.axis >= rank - 2:
                c.where = 1 + st.axis - (rank - 2)     # 1 rows, 2 columns
            elif st.code == _ST_GATHER:
                c.where = 0                            # a leading axis
                c.inner = math.prod(st.in_shape[st.axis + 1:rank - 2])
                c.ext_in = st.in_shape[st.axis]
                c.ext_out = st.out_shape[st.axis]
            if st.code == _ST_DECOMPRESS:
                c.nb = st.in_shape[-2] // st.block_rows
            if st.is_reduce:
                a.reduce_at = k
        # the stages a walk back visits (the index stages), and those that
        # change a value
        seg = stages[lo:hi]
        walk = [k for k, st in enumerate(seg)
                if st.code in (_ST_TRANSPOSE, _ST_GATHER)]
        value = [k for k, st in enumerate(seg) if st.changes_value]
        a.nwalk, a.nvalue = len(walk), len(value)
        for i, k in enumerate(walk):
            a.walk[i] = k
        for i, k in enumerate(value):
            a.value[i] = k
        a.in_dtype = maps.dtype_code(src_dtype, True)
        a.carrier = int(not (stages[hi - 1].floats if hi > lo
                             else _float_carried(src_dtype, False)))
        a.nlead = len(src_logical) - 2
        for d, e in enumerate(src_logical[:-2]):
            a.lext[d] = e
        for d, mp in enumerate(maps.dim_maps(src_layout, src_logical)):
            a.src[d] = maps.DimMap(*mp)
        return a

    @staticmethod
    def _dst_dims(a: _BlockArgs, dst_layout: L.Layout,
                  shape: Tuple[int, ...]) -> None:
        """The OUT pass's destination, one physical dim at a time (post
        perm): its extent, the index from which it lies in stride padding,
        the coordinate it adds to (0 the leading axes, linear, 1 the rows,
        2 the columns) and its weight there."""
        r = len(shape)
        phys = maps.physical_dims(dst_layout, shape)
        a.nphys = len(phys)
        for k, (e, d, w) in enumerate(phys):
            t = dst_layout.dim_tile(r, d)
            a.pext[k] = e
            a.plim[k] = shape[d] if t == 1 else (
                shape[d] // t if w == t else e)        # a grid dim, a tile dim
            a.pslot[k] = max(0, d - (r - 3))
            a.pw[k] = w * (math.prod(shape[d + 1:r - 2]) if d < r - 2 else 1)

    @staticmethod
    def _tiled(a: _BlockArgs) -> bool:
        """Whether the generic OUT pass stages through a shared tile: where
        the source runs across the destination's rows.  A 32-bit launch
        (the kernel has no 64-bit tiled instance); no ReduceStage; the
        index stages an odd number of transposes and nothing else; the
        destination's last two physical dims its rows and columns, a tile
        wide each, the outer of them unit-weight; the source axis those
        rows read (the other tile axis, after the swap) of unit stride."""
        last = a.nphys - 1
        walk = [a.st[a.walk[w]].code for w in range(a.nwalk)]
        if (not a.index32 or a.reduce_at >= 0 or last < 1
                or len(walk) % 2 == 0
                or any(code != _ST_TRANSPOSE for code in walk)):
            return False
        rows = a.pslot[last - 1]
        if ({rows, a.pslot[last]} != {1, 2} or a.pw[last - 1] != 1
                or min(a.pext[last - 1], a.pext[last]) < _TILE):
            return False
        m = a.src[a.nlead + 2 - rows]
        return (m.sgrid if m.tile == 1 else m.stile) == 1

    def _launch_segment(self, stages, lo, hi, x, src_layout, dst_layout,
                        out_dtype, aux) -> torch.Tensor:
        seg = stages[lo:hi]
        passes = []                         # (segment stage, mode, rows)
        for k, st in enumerate(seg):
            if st.code == _ST_RMSNORM:
                rows = math.prod(st.in_shape[:-1])
                aux[lo + k] = torch.empty(rows, dtype=torch.float32,
                                          device=x.device)
                passes.append((k, _MODE_STAT, rows))
            elif st.code == _ST_COMPRESS:
                blocks = st.in_shape[:-2] + (st.in_shape[-2] // st.block_rows,)
                aux[lo + k] = torch.empty(blocks, dtype=torch.bool,
                                          device=x.device)
                passes.append((k, _MODE_MASK, math.prod(blocks)))
        src_logical = src_layout.logical_shape(tuple(x.shape))
        shape = seg[-1].out_shape if seg else src_logical
        out = torch.empty(dst_layout.physical_shape(shape), dtype=out_dtype,
                          device=x.device)
        a = self._args(stages, lo, hi, src_layout, src_logical, x.dtype, aux)
        sizes = [x.numel(), out.numel()] + [
            math.prod(t) for st in seg for t in (st.in_shape, st.out_shape)]
        a.index32 = int(max(sizes) < _INDEX32)
        for k, mode, rows in passes:
            a.upto, a.total = k, rows
            BLOCK(ctypes.addressof(a), x.data_ptr(), None, mode,
                  path="generic")
        a.upto = hi - lo
        a.out_dtype = maps.dtype_code(out_dtype, True)
        self._dst_dims(a, dst_layout, shape)
        a.total = out.numel()
        # elements a thread, stored as one pack: they must not cross the
        # innermost physical run, and a whole pack needs an aligned address
        a.tiled = int(self._tiled(a))
        run = a.pext[a.nphys - 1]
        a.per_thread = 1 if a.reduce_at >= 0 or a.tiled else next(
            e for e in (_PER_THREAD, 2, 1) if run % e == 0 and (
                e < _PER_THREAD
                or out.data_ptr() % (e * out.element_size()) == 0))
        BLOCK(ctypes.addressof(a), x.data_ptr(), out.data_ptr(), _MODE_OUT,
              path="generic")
        return out

    # -- the rank-2 path ------------------------------------------------------
    def _rank2_args(self, stages, lo, hi, k, x, src_layout, aux, extent,
                    dst_layout=None, out_shape=None) -> _Rank2Args:
        """Rank-2 arguments of a pass over ``extent`` (its leading axes a
        batch of its last two) at point ``k`` of segment [lo, hi): the
        composed source map of stages [0, k) and, with a ``dst_layout``,
        the destination's maps of ``out_shape``, whose rows a final
        ReduceStage may have dropped."""
        seg = stages[lo:hi]
        rank = len(extent)
        key = (x.device.type, x.device.index, lo, hi, k)
        comp = self._composed.get(key)
        if comp is None:
            comp = self._composed[key] = compose(seg, k, rank)
        src_maps = maps.dim_maps(src_layout,
                                 src_layout.logical_shape(tuple(x.shape)))
        none = (1, 0, 0)
        if dst_layout is None:
            pads, dst_maps, lead_dst = (0, 0), (none, none), [none] * rank
        else:
            r = len(out_shape)
            dm = maps.dim_maps(dst_layout, out_shape)
            pads = (dst_layout.dim_pad(r, r - 2) if r == rank else 0,
                    dst_layout.dim_pad(r, r - 1))
            dst_maps = dm[-2:] if r == rank else (none, dm[-1])
            lead_dst = dm
        a = _Rank2Args()
        a.t = maps.tile2(extent[-2:], pads, [src_maps[ax] for ax in comp.axes],
                         comp.index, dst_maps, 16 // x.element_size())
        a.nlead, a.batch = rank - 2, math.prod(extent[:-2])
        for d in range(rank - 2):
            ld = a.lead[d]
            ld.extent = extent[d]
            ld.src.map = maps.DimMap(*src_maps[d])
            ld.src.idx = 0 if comp.lead[d] is None else comp.lead[d].data_ptr()
            ld.dst = maps.DimMap(*lead_dst[d])
        a.nstages = k
        for s, st in enumerate(seg[:k]):
            c = a.st[s]
            c.code, c.dtype, c.swap = (st.code, maps.dtype_code(st.dtype, True),
                                       comp.swaps[s])
            c.block_rows, c.a = st.block_rows, st.a
            c.vec = 0 if st.vec is None else st.vec.data_ptr()
            buf = aux.get(st.mask_of if st.mask_of >= 0 else lo + s)
            c.aux = 0 if buf is None else buf.data_ptr()
            # bytes of its per-row buffer a leading index: f32 inverse RMS
            # per row, a uint8 mask entry per row block
            c.aux_step = (4 * st.in_shape[-2] if st.code == _ST_RMSNORM else
                          st.in_shape[-2] // st.block_rows
                          if st.code == _ST_DECOMPRESS else 0)
        a.dtype = maps.dtype_code(x.dtype, True)
        a.fill_bits = P.fill_word(x.dtype)
        return a

    def _launch_rank2(self, stages, lo, hi, x, src_layout, dst_layout,
                      aux) -> torch.Tensor:
        seg = stages[lo:hi]
        dev = x.device
        for k, st in enumerate(seg):
            if st.code not in (_ST_RMSNORM, _ST_COMPRESS):
                continue
            a = self._rank2_args(stages, lo, hi, k, x, src_layout, aux,
                                 st.in_shape)
            if st.code == _ST_RMSNORM:
                buf = torch.empty(math.prod(st.in_shape[:-1]),
                                  dtype=torch.float32, device=dev)
                a.eps, mode = st.a, _MODE_STAT2
            else:
                buf = torch.empty(st.in_shape[:-2] + (
                    st.in_shape[-2] // st.block_rows,), dtype=torch.bool,
                    device=dev)
                a.block_rows, mode = st.block_rows, _MODE_MASK2
            aux[lo + k] = buf
            a.out = buf.data_ptr()
            maps.fit_to(a.t, x, None, a.lead[:a.nlead])
            BLOCK(ctypes.addressof(a), x.data_ptr(), None, mode, path="rank2")
        shape = seg[-1].out_shape if seg else tuple(
            src_layout.logical_shape(tuple(x.shape)))
        out = torch.empty(dst_layout.physical_shape(shape), dtype=x.dtype,
                          device=dev)
        keep = []
        if seg and seg[-1].is_reduce:
            st = seg[-1]
            a = self._rank2_args(stages, lo, hi, len(seg) - 1, x, src_layout,
                                 aux, st.in_shape, dst_layout, shape)
            r = len(shape)
            a.t.prows = (1 + dst_layout.dim_pad(r, r - 2)) if st.keepdims \
                else 1
            a.t.pcols = shape[-1] + dst_layout.dim_pad(r, r - 1)
            m, n = st.in_shape[-2:]
            strips = -(-a.t.pcols // _REDUCE_STRIP)
            a.op = st.code
            a.splits = max(1, min(-(-m // 128), -(-_REDUCE_BLOCKS // (
                strips * a.batch))))
            if a.splits > 1:
                keep = [torch.empty(a.batch * a.splits * n,
                                    dtype=torch.float32, device=dev),
                        torch.zeros(a.batch * strips, dtype=torch.int32,
                                    device=dev)]
                a.partial, a.counter = (t.data_ptr() for t in keep)
            mode = _MODE_REDUCE2
        else:
            a = self._rank2_args(stages, lo, hi, len(seg), x, src_layout, aux,
                                 shape, dst_layout, shape)
            copy = not any(st.code in _VALUE_CODES for st in seg)
            mode = _MODE_COPY2 if copy else _MODE_OUT2
        maps.fit_to(a.t, x, out, a.lead[:a.nlead])
        BLOCK(ctypes.addressof(a), x.data_ptr(), out.data_ptr(), mode,
              path="rank2")
        return out

    @op_cost.one_op
    def __call__(self, x: torch.Tensor):
        if op_cost.plain_on(x):
            return plain(x, self.chain, self.src_layout, self.dst_layout)
        if x.device.type != "cuda":
            raise NotImplementedError(f"no datapath kernel for {x.device}")
        return self.launch(x)

    def launch(self, x: torch.Tensor):
        """Launch kernel 3's passes on ``x``'s device and stream."""
        x = _check_input(x, self.in_shape, self.in_dtype)
        if self._inner is not None:
            return self._unfold(self._inner.launch(
                x.reshape(self._inner.in_shape)))
        key = (x.device.type, x.device.index)
        stages = self._prepared.get(key)
        if stages is None:
            stages = self._prepared[key] = self._compile(x.device)
        aux: Dict[int, torch.Tensor] = {}
        segs = self._segments(stages)
        v, src_layout = x, self.src_layout
        for i, (lo, hi) in enumerate(segs):
            final = i == len(segs) - 1
            dst_layout = self.dst_layout if final else L.MN
            rank = len(stages[lo].in_shape) if hi > lo else len(self.logical)
            if rank2_path(stages[lo:hi], rank, v.dtype, dst_layout):
                v = self._launch_rank2(stages, lo, hi, v, src_layout,
                                       dst_layout, aux)
            else:
                out_dtype = stages[hi - 1].dtype if hi > lo else self.in_dtype
                v = self._launch_segment(stages, lo, hi, v, src_layout,
                                         dst_layout, out_dtype, aux)
            src_layout = L.MN
        compress = [s for s, st in enumerate(stages)
                    if st.code == _ST_COMPRESS]
        if compress and not any(st.mask_of == compress[-1] for st in stages):
            return P.CTensor(values=v, mask=aux[compress[-1]])
        return v

    def _unfold(self, v):
        """The folded program's output in this program's shapes."""
        out = P.chain_out_shape(self.chain, self.logical)
        if isinstance(v, P.CTensor):
            return P.CTensor(
                values=self._unfold(v.values),
                mask=v.mask.reshape(tuple(out[:-2]) + v.mask.shape[-1:]))
        return v.reshape(self.dst_layout.physical_shape(out))


def _rounded_by_store(st: _St) -> bool:
    """Whether kernel 3 leaves ``st``'s value to the store to round: a bool
    or float8 made in the f32 carrier by a value stage or a sum."""
    return (st.floats and st.dtype in (torch.bool,) + P._FLOAT8
            and (st.changes_value or st.code == _ST_REDUCE_SUM))


# -- logical ranks above 8: leading axes folded -------------------------------
def _float_carried(dtype: torch.dtype, floats: bool) -> bool:
    """Whether kernel 3 carries a ``dtype`` stream as f32 (else int64); a
    bool stream stays in ``floats``, its source stream's carrier."""
    return floats if dtype == torch.bool else dtype.is_floating_point


def _layout_reach(layout: L.Layout, rank: int) -> int:
    """The first logical axis of a rank-``rank`` array that ``layout``
    tiles, pads or permutes (its physical dims are its logical axes in
    order, each plain, before that axis)."""
    k = layout.tile_rank
    reach = rank - k
    if layout.pad is not None:
        reach = min(reach, rank - len(layout.pad))
    if layout.perm is not None and len(layout.perm) > 2 * k:
        reach = min(reach, rank + k - len(layout.perm))
    return reach


def _leading(chain: Sequence[P.Plugin], logical: Sequence[int]) -> int:
    """The axes ``[0, n)`` that are leading at every stage of the chain (a
    ReduceStage without keepdims drops the rows: the axis before them
    becomes the rows after it); they keep their numbers throughout."""
    shape, lead = tuple(logical), len(logical) - 2
    for p in chain:
        shape = tuple(p.out_logical_shape(shape))
        lead = min(lead, len(shape) - 2)
    return lead


def fold_axes(chain: Sequence[P.Plugin], src_layout: L.Layout,
              dst_layout: L.Layout, logical: Sequence[int]
              ) -> List[List[int]]:
    """The logical axes of a chain's input grouped for folding, in order:
    adjacent leading axes join a group where both are leading at every
    stage, no stage names either (a gather's axis; a Transpose's and a
    ReduceStage's are the last two) and both layouts keep both plain,
    unpadded and in order.  A group of several axes is one axis of their
    extents' product, their row-major index: a layout maps it as it maps
    the pair, so the buffers keep their bytes."""
    rank, shape, named = len(logical), tuple(logical), set()
    for p in chain:
        if isinstance(p, P.GatherScatter):
            named.add(p.axis % len(shape))
        shape = tuple(p.out_logical_shape(shape))
    keep = min(_leading(chain, logical), _layout_reach(src_layout, rank),
               _layout_reach(dst_layout, len(shape)))

    def plain(d):
        return (d < keep and d not in named
                and not src_layout.dim_pad(rank, d)
                and not dst_layout.dim_pad(len(shape), d))

    groups: List[List[int]] = []
    for d in range(rank):
        if groups and plain(d) and plain(groups[-1][-1]):
            groups[-1].append(d)
        else:
            groups.append([d])
    return groups


def _fold(shape: Sequence[int], groups: Sequence[Sequence[int]]
          ) -> Tuple[int, ...]:
    return tuple(math.prod(shape[d] for d in g) for g in groups)


def _folded_chain(chain: Sequence[P.Plugin], logical: Sequence[int],
                  groups: Sequence[Sequence[int]]) -> Tuple[P.Plugin, ...]:
    """The chain on the folded axes: a gather of a leading axis names its
    group, any other axis counts from the end."""
    group_of = {g[0]: i for i, g in enumerate(groups) if len(g) == 1}
    lead = _leading(chain, logical)
    out, shape = [], tuple(logical)
    for p in chain:
        if isinstance(p, P.GatherScatter):
            a = p.axis % len(shape)
            axis = group_of[a] if a < lead else a - len(shape)
            p = dataclasses.replace(p, axis=axis)
        out.append(p)
        shape = tuple(p.out_logical_shape(shape))
    return tuple(out)
