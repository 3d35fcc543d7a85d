"""XDMA Plugins: on-the-fly data manipulation during transfers (PyTorch port).

The twin of ``repro.core.plugins``.  A :class:`Plugin` is a pure function
on the *logical* stream; the engine composes the chain between the reader
(physical->logical) and the writer (logical->physical).  The ``__call__`` of
every plugin here is plain PyTorch and follows the reference's jnp dtype
rules; composed with :meth:`Layout.to_logical` / :meth:`Layout.from_logical`
they are the plain versions the hand-written datapath kernels
(:mod:`repro_torch.kernels.datapath`) are held to.

The compiler contract is the reference's: ``emit`` marks a plugin the
datapath kernels can run (here it is the same function as ``__call__``),
``streaming`` marks a row-local, shape-preserving plugin, and
``emit_consts`` lists the arrays a kernel stage reads.  Array fields
(weights, indices, biases) may be numpy arrays or tensors on any device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .layouts import torch_dtype

__all__ = [
    "Plugin", "Identity", "Transpose", "Cast", "Scale", "BiasAdd",
    "RMSNormPlugin", "Quantize", "Dequantize", "QTensor", "apply_chain",
    "chain_out_shape", "chain_out_dtype",
    "GatherScatter", "Compress", "Decompress", "CTensor", "ReduceStage",
    "register_plugin", "plugin_by_name", "registered_plugins", "as_tensor",
]


# the dtypes torch computes only in part: float8 arithmetic runs in f32,
# uint16 / uint32 arithmetic in int64, each result rounded (float8) or
# wrapped (unsigned) back to the stream dtype, as jnp's result is
_FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)
_UNSIGNED_WIDE = {torch.uint16: 0xFFFF, torch.uint32: 0xFFFFFFFF}


def to_float8(v: torch.Tensor, dtype: torch.dtype,
              cast: bool = False) -> torch.Tensor:
    """``v`` rounded to float8 ``dtype`` as the reference rounds it: to
    nearest even; past float8_e4m3fn's range (above 464) its NaN, from
    float8_e5m2's (61440 on) an infinity, each with the value's sign.  A NaN
    keeps its sign in float8_e4m3fn (0x7F); in float8_e5m2 it is 0x7E with
    its sign where a Cast made it (``cast``: XLA's conversion), else 0x7F
    (XLA's float8_e5m2 arithmetic).  torch's own conversion past the range
    differs between versions (saturating or not), so only in-range values
    are left to it."""
    v = v.to(torch.float32)
    e4 = dtype == torch.float8_e4m3fn
    top, over = (448.0, 464.0) if e4 else (57344.0, 61440.0)
    bits = v.clamp(-top, top).to(dtype).view(torch.uint8)
    sign = torch.signbit(v).to(torch.uint8) * 128
    past = v.abs() > over if e4 else v.abs() >= over
    bits = torch.where(past, sign + (0x7F if e4 else 0x7C), bits)
    nan = sign + 0x7F if e4 else (
        sign + 0x7E if cast else torch.full_like(sign, 0x7F))
    return torch.where(v.isnan(), nan, bits).view(dtype)


def computed(x: torch.Tensor, fn: Callable) -> torch.Tensor:
    """``fn(x)`` in ``x``'s dtype, evaluated in f32 for a float8 stream and
    in int64 (wrapped to the width) for a uint16 / uint32 one: the plain
    versions on the streams torch has few kernels for."""
    if x.dtype in _FLOAT8:
        return to_float8(fn(x.to(torch.float32)), x.dtype)
    if x.dtype in _UNSIGNED_WIDE:
        return (fn(x.to(torch.int64)) & _UNSIGNED_WIDE[x.dtype]).to(x.dtype)
    return fn(x)


def as_tensor(a: Any, *, device=None, dtype=None) -> torch.Tensor:
    """A plugin constant (number, numpy array or tensor) as a tensor; a
    numpy bfloat16 array (``ml_dtypes``) crosses through its uint16 view."""
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
        if a.dtype.name == "bfloat16":
            a = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            a = torch.from_numpy(a)
    return torch.as_tensor(a, device=device, dtype=dtype)


@dataclasses.dataclass
class QTensor:
    """int8 payload + per-row scales travelling together through the tunnel."""

    values: torch.Tensor   # int8
    scales: torch.Tensor   # f32, shape = values.shape[:-1] + (1,)

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype


class Plugin:
    """Base: a pure transform on the logical stream.

    * ``emit`` — the form a datapath kernel runs; ``None`` marks the plugin
      non-fusible and the compiler falls back to the plain composition.
    * ``streaming`` — row-local on the logical (..., M, N) stream and
      shape-preserving, so the streamed kernel may run it a row at a time.
    * ``changes_rank`` / ``pytree_payload`` — as in the reference.
    """

    name: str = "plugin"
    emit: Optional[Callable] = None     # subclasses define a method to opt in
    streaming: bool = False
    changes_rank: bool = False
    pytree_payload: bool = False

    def __call__(self, x: Any) -> Any:  # pragma: no cover - interface
        raise NotImplementedError

    def emit_consts(self) -> Tuple[Any, ...]:
        """Arrays the ``emit`` stage needs as extra kernel operands."""
        return ()

    @property
    def supports_emit(self) -> bool:
        return callable(self.emit)

    def out_logical_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(shape)

    def out_dtype(self, dtype):
        return dtype

    def __repr__(self):
        return self.name


# -- the plugin registry -----------------------------------------------------
_REGISTRY: Dict[str, type] = {}


def register_plugin(cls: type) -> type:
    """Class decorator: register ``cls`` under its ``name`` attribute."""
    name = cls.name
    if not isinstance(name, str) or not name:
        raise ValueError(f"plugin {cls!r} needs a non-empty string name")
    existing = _REGISTRY.get(name)
    if existing is not None and existing is not cls:
        raise ValueError(f"plugin name {name!r} already registered to {existing!r}")
    _REGISTRY[name] = cls
    return cls


def plugin_by_name(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown plugin {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def registered_plugins() -> Dict[str, type]:
    """Snapshot of the registry (name -> class)."""
    return dict(_REGISTRY)


@register_plugin
class Identity(Plugin):
    name = "identity"
    streaming = True

    def __call__(self, x):
        return x

    emit = __call__


@register_plugin
class Transpose(Plugin):
    """Logical transpose of the trailing (M, N) dims — the paper's Load workload."""

    name = "transpose"

    def __call__(self, x):
        return torch.swapaxes(x, -1, -2)

    emit = __call__

    def out_logical_shape(self, shape):
        return tuple(shape[:-2]) + (shape[-1], shape[-2])


@register_plugin
@dataclasses.dataclass(frozen=True)
class Cast(Plugin):
    dtype: Any = torch.bfloat16
    name: str = "cast"
    streaming = True

    def __post_init__(self):
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))

    def __call__(self, x):
        if self.dtype in _FLOAT8 and x.dtype != self.dtype:
            return to_float8(x, self.dtype, cast=True)
        return x.to(self.dtype)

    emit = __call__

    def out_dtype(self, dtype):
        return self.dtype


@register_plugin
@dataclasses.dataclass(frozen=True)
class Scale(Plugin):
    """``x * alpha``, the constant cast to the stream dtype first (jnp's rule)."""

    alpha: Any = 1.0
    name: str = "scale"
    streaming = True

    def __call__(self, x):
        c = as_tensor(self.alpha, dtype=x.dtype, device=x.device)
        return computed(x, lambda v: v * c.to(v.dtype))

    emit = __call__


@register_plugin
@dataclasses.dataclass(frozen=True)
class BiasAdd(Plugin):
    """``x + bias``, the constant cast to the stream dtype first (jnp's rule)."""

    bias: Any = 0.0
    name: str = "bias_add"
    streaming = True

    def __call__(self, x):
        c = as_tensor(self.bias, dtype=x.dtype, device=x.device)
        return computed(x, lambda v: v + c.to(v.dtype))

    emit = __call__


@register_plugin
@dataclasses.dataclass(frozen=True)
class RMSNormPlugin(Plugin):
    """RMSNorm over the last logical dim, on-stream (paper §III-C Prefill).

    ``weight`` optional learned gain; applied in f32 and cast back.
    Row-local (the norm only reads its own row), hence ``streaming``.
    """

    eps: float = 1e-6
    weight: Any = None
    name: str = "rmsnorm"
    streaming = True

    def __call__(self, x):
        dtype = x.dtype
        xf = x.to(torch.float32)
        rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + self.eps)
        y = xf * rms
        if self.weight is not None:
            y = y * as_tensor(self.weight, device=x.device).to(torch.float32)
        return y.to(dtype)

    emit = __call__

    def emit_consts(self):
        return () if self.weight is None else (self.weight,)


@register_plugin
@dataclasses.dataclass(frozen=True)
class Quantize(Plugin):
    """Symmetric per-row int8 quantization on the wire (compression plugin)."""

    name: str = "quantize_int8"
    pytree_payload = True               # emits a QTensor

    def __call__(self, x) -> QTensor:
        xf = x.to(torch.float32)
        amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
        # amax * f32(1 / 127), not amax / 127: XLA compiles the reference's
        # division by the constant into this multiply under jit, and PyTorch
        # on CUDA rewrites the division into it too, so every device agrees
        scale = torch.where(amax > 0, amax * (1 / 127), torch.ones_like(amax))
        q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
        return QTensor(values=q, scales=scale)

    def out_dtype(self, dtype):
        return torch.int8


@register_plugin
@dataclasses.dataclass(frozen=True)
class Dequantize(Plugin):
    dtype: Any = torch.float32
    name: str = "dequantize_int8"

    def __post_init__(self):
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))

    def __call__(self, x: QTensor):
        return (x.values.to(torch.float32) * x.scales).to(self.dtype)

    def out_dtype(self, dtype):
        return self.dtype


# -- compiler-era plugins -----------------------------------------------------
@dataclasses.dataclass
class CTensor:
    """Block-compressed payload: dense carrier + per-block occupancy mask.

    ``mask`` has one bool per ``block_rows`` logical rows and marks blocks
    that carry any nonzero; ``wire_nbytes`` is what the link would move.
    """

    values: torch.Tensor
    mask: torch.Tensor    # bool, shape = values.shape[:-2] + (M // block_rows,)

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype

    def occupancy(self) -> torch.Tensor:
        """Fraction of row blocks that carry data (1.0 = dense)."""
        return self.mask.to(torch.float32).mean()

    def wire_nbytes(self) -> int:
        """Bytes on the link after zero-skipping (needs the logical carrier)."""
        m = self.values.shape[-2]
        blocks = self.mask.shape[-1]
        if blocks == 0 or m % blocks:
            raise ValueError(
                f"carrier rows {m} don't split into {blocks} mask blocks — "
                "wire_nbytes needs the logical (pre-writer) payload")
        block_bytes = (m // blocks) * self.values.shape[-1] * \
            self.values.element_size()
        occupied = int(self.mask.sum())
        lead = math.prod(self.values.shape[:-2])
        return occupied * block_bytes + lead * blocks  # 1 byte/mask bit (padded)


# jnp.take's fill word for an index out of range: NaN for a float (float8's
# as the reference's take writes it, 0x7F in both formats), the minimum of a
# signed integer, the maximum of an unsigned one, True
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
FILL_BITS = {torch.float32: 0x7FC00000, torch.bfloat16: 0x7FC0,
             torch.float16: 0x7E00,
             torch.float8_e4m3fn: 0x7F, torch.float8_e5m2: 0x7F,
             torch.bool: 1, torch.int8: -0x80, torch.uint8: 0xFF,
             torch.int16: -0x8000, torch.uint16: 0xFFFF,
             torch.int32: -0x80000000, torch.uint32: 0xFFFFFFFF,
             torch.int64: -2 ** 63}


def fill_word(dtype: torch.dtype) -> int:
    """:data:`FILL_BITS` of ``dtype`` as a signed integer of its width."""
    bits, width = FILL_BITS[dtype], 8 * dtype.itemsize
    bits &= (1 << width) - 1
    return bits - (1 << width) if bits >> (width - 1) else bits


def take_indices(indices: Any, n: int, device=None) -> torch.Tensor:
    """``jnp.take`` index semantics as int64: negatives count from the end,
    anything outside ``[-n, n)`` becomes -1 (its rows read as fill)."""
    idx = as_tensor(indices, device=device).to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx < 0) | (idx >= n), torch.full_like(idx, -1), idx)


@register_plugin
@dataclasses.dataclass(frozen=True)
class GatherScatter(Plugin):
    """Index-driven reorder of logical rows — the im2col / MoE-permute case.

    Follows ``jnp.take``: negative indices count from the end, and an index
    outside ``[-n, n)`` yields NaN for floats, the most negative value for
    signed and the largest for unsigned ints, and True for bools (the words
    of :data:`FILL_BITS`)."""

    indices: Any = None
    axis: int = -2
    name: str = "gather_scatter"

    def __post_init__(self):
        if self.indices is None:
            raise ValueError("GatherScatter needs an index array")

    def __call__(self, x):
        axis = self.axis % x.ndim
        idx = take_indices(self.indices, x.shape[axis], device=x.device)
        # the out-of-range rows filled with no test on the host: no sync on
        # the card, and the shapes of a meta tensor suffice
        shape = [1] * x.ndim
        shape[axis] = -1
        fail = (idx < 0).reshape(shape)
        if x.dtype.is_floating_point and x.dtype not in _FLOAT8:
            # on the values, so that autograd passes through
            out = torch.index_select(x, axis, idx.clamp(min=0))
            return out.masked_fill(fail, float("nan"))
        # on the words of the signed integer of the dtype's width, which
        # torch gathers and fills for every dtype
        words = x.view(_SIGNED[x.element_size()])
        out = torch.index_select(words, axis, idx.clamp(min=0))
        return out.masked_fill(fail, fill_word(x.dtype)).view(x.dtype)

    emit = __call__

    def emit_consts(self):
        return (self.indices,)

    def out_logical_shape(self, shape):
        axis = self.axis % len(shape)
        n = int(np.shape(self.indices)[0])
        return tuple(shape[:axis]) + (n,) + tuple(shape[axis + 1:])


@register_plugin
@dataclasses.dataclass(frozen=True)
class Compress(Plugin):
    """Block-sparse zero-skipping (the paper's compressed-tunnel case).

    Exact: ``Decompress(Compress(x)) == x`` bitwise (zero blocks are zero).
    """

    block_rows: int = 8
    name: str = "compress_blocksparse"
    pytree_payload = True               # emits a CTensor

    def __call__(self, x) -> CTensor:
        m = x.shape[-2]
        if m % self.block_rows:
            raise ValueError(f"logical rows {m} not divisible by "
                             f"block_rows={self.block_rows}")
        blocks = x.reshape(tuple(x.shape[:-2]) + (m // self.block_rows,
                                                  self.block_rows, x.shape[-1]))
        mask = (blocks != 0).any(dim=-1).any(dim=-1)
        return CTensor(values=x, mask=mask)

    emit = __call__


@register_plugin
@dataclasses.dataclass(frozen=True)
class Decompress(Plugin):
    """Inverse of :class:`Compress`: multiply by the repeated mask."""

    name: str = "decompress_blocksparse"

    def __call__(self, x: CTensor):
        v, mask = x.values, x.mask
        m = v.shape[-2]
        block_rows = m // mask.shape[-1]
        keep = torch.repeat_interleave(mask, block_rows, dim=-1)[..., :, None]
        return computed(v, lambda t: t * keep.to(t.dtype))

    emit = __call__


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """``jnp.sum``'s result dtype: floats keep theirs (half precision
    accumulates in f32), bools and narrow ints widen to 32 bits, unsigned
    ones to uint32."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    if dtype in (torch.uint8, torch.uint16, torch.uint32):
        return torch.uint32
    if dtype == torch.int64:
        return dtype
    return torch.int32


SUM_WINDOW = 32


def sum_levels(n: int) -> List[Tuple[int, int]]:
    """The reference's order of a float8 sum over ``n`` rows, which rounds
    to float8 after every addition, so that the order is the result: XLA's
    CPU compiler rewrites a reduction over 32 rows or more into windows of
    32 (the rows padded evenly at both ends with zeros, each window summed
    in order from zero), then reduces the window sums the same way, until
    fewer than 32 remain, summed in order.  ``[(rows, low padding), ...]``
    of each windowed level."""
    levels = []
    while n >= SUM_WINDOW:
        k = -(-n // SUM_WINDOW)
        levels.append((n, (k * SUM_WINDOW - n) // 2))
        n = k
    return levels


def _float8_sum(x: torch.Tensor, keepdims: bool) -> torch.Tensor:
    """``jnp.sum`` of a float8 stream over its rows in the reference's order
    (:func:`sum_levels`), each addition rounded to float8."""
    v = x.to(torch.float32).movedim(-2, 0)

    def in_order(rows):                     # (n, ...) -> (...)
        acc = torch.zeros_like(rows[0])
        for r in rows:
            acc = to_float8(acc + r, x.dtype).to(torch.float32)
        return acc

    for n, low in sum_levels(v.shape[0]):
        k = -(-n // SUM_WINDOW)
        pad = v.new_zeros((k * SUM_WINDOW - n,) + tuple(v.shape[1:]))
        v = torch.cat([pad[:low], v, pad[low:]])
        v = in_order(v.reshape((k, SUM_WINDOW) + tuple(v.shape[1:]))
                     .movedim(1, 0))
    out = to_float8(in_order(v), x.dtype)
    return out.unsqueeze(-2) if keepdims else out


@register_plugin
@dataclasses.dataclass(frozen=True)
class ReduceStage(Plugin):
    """On-the-fly reduction over the logical rows (reduce-endpoint stage).

    ``op`` is ``sum`` or ``max``; with ``keepdims`` (default) the rank is
    preserved — (..., M, N) -> (..., 1, N).
    """

    op: str = "sum"
    keepdims: bool = True
    name: str = "reduce_stage"

    def __post_init__(self):
        if self.op not in ("sum", "max"):
            raise ValueError(f"ReduceStage op must be sum|max, got {self.op!r}")

    @property
    def changes_rank(self):
        return not self.keepdims

    def __call__(self, x):
        if self.op == "max":
            return computed(x, lambda v: torch.amax(v, dim=-2,
                                                    keepdim=self.keepdims))
        out = _sum_dtype(x.dtype)
        if out == torch.uint32:             # wraps modulo 2^32
            s = torch.sum(x.to(torch.int64), dim=-2, keepdim=self.keepdims)
            return (s & 0xFFFFFFFF).to(out)
        if x.dtype in _FLOAT8:
            return _float8_sum(x, self.keepdims)
        return torch.sum(x, dim=-2, keepdim=self.keepdims, dtype=out)

    emit = __call__

    def out_logical_shape(self, shape):
        if self.keepdims:
            return tuple(shape[:-2]) + (1, shape[-1])
        return tuple(shape[:-2]) + (shape[-1],)


def apply_chain(plugins: Sequence[Plugin], x: Any) -> Any:
    """Cascade plugins (paper: 'one or more plugins can be cascaded')."""
    for p in plugins:
        x = p(x)
    return x


def chain_out_shape(plugins: Sequence[Plugin], shape: Tuple[int, ...]) -> Tuple[int, ...]:
    for p in plugins:
        new = tuple(p.out_logical_shape(tuple(shape)))
        if len(new) != len(shape) and not p.changes_rank:
            raise ValueError(
                f"plugin {p.name!r} changed logical rank {len(shape)} -> "
                f"{len(new)} without declaring it; set changes_rank=True on "
                f"the plugin (or fix its out_logical_shape) so descriptors "
                f"fail at CFG time instead of deep in the lowered program")
        shape = new
    return tuple(shape)


def chain_out_dtype(plugins: Sequence[Plugin], dtype):
    """Dtype after a cascade — the descriptor's compile-time dtype contract."""
    dtype = torch_dtype(dtype)
    for p in plugins:
        dtype = p.out_dtype(dtype)
    return dtype
