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
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

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
        return x * as_tensor(self.alpha, dtype=x.dtype, device=x.device)

    emit = __call__


@register_plugin
@dataclasses.dataclass(frozen=True)
class BiasAdd(Plugin):
    """``x + bias``, the constant cast to the stream dtype first (jnp's rule)."""

    bias: Any = 0.0
    name: str = "bias_add"
    streaming = True

    def __call__(self, x):
        return x + as_tensor(self.bias, dtype=x.dtype, device=x.device)

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
    signed and the largest for unsigned ints."""

    indices: Any = None
    axis: int = -2
    name: str = "gather_scatter"

    def __post_init__(self):
        if self.indices is None:
            raise ValueError("GatherScatter needs an index array")

    def __call__(self, x):
        axis = self.axis % x.ndim
        idx = take_indices(self.indices, x.shape[axis], device=x.device)
        out = torch.index_select(x, axis, idx.clamp(min=0))
        # the out-of-range rows filled with no test on the host: no sync on
        # the card, and the shapes of a meta tensor suffice
        if x.dtype.is_floating_point:
            fill = float("nan")
        else:
            info = torch.iinfo(x.dtype)
            fill = info.min if x.dtype.is_signed else info.max
        shape = [1] * x.ndim
        shape[axis] = -1
        return out.masked_fill((idx < 0).reshape(shape), fill)

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
        keep = torch.repeat_interleave(mask, block_rows, dim=-1).to(v.dtype)
        return v * keep[..., :, None]

    emit = __call__


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """``jnp.sum``'s result dtype: floats keep theirs (half precision
    accumulates in f32), bools and narrow ints widen to 32 bits."""
    if dtype.is_floating_point or dtype.is_complex:
        return dtype
    if dtype in (torch.uint8, torch.uint16, torch.uint32):
        return torch.uint32
    if dtype == torch.int64:
        return dtype
    return torch.int32


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
            return torch.amax(x, dim=-2, keepdim=self.keepdims)
        return torch.sum(x, dim=-2, keepdim=self.keepdims,
                         dtype=_sum_dtype(x.dtype))

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
