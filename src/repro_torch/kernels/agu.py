"""The generic XDMA Frontend kernel: ONE pattern-driven relayout (PyTorch port).

The twin of ``repro.kernels.agu``.  :func:`plan_relayout` is the reference's
planner verbatim: it decides whether a layout pair lowers through the
generic kernel (``kind`` ``"kernel"`` or ``"identity"``) or falls back, with
the reference's reasons (``rank:``, ``nest-incompatible``, ``row-pad``,
``pad-transpose``, ``granule:``), and it keeps the TPU plan's ``grid`` and
``block`` so that plans and :func:`agu_stats` agree with the reference.

:meth:`AGUPlan.run` launches kernel 1, ``csrc/agu_relayout.cu``, a
hand-written CUDA relayout whose grid is its own (64 x 64 tiles of the
destination, 16-byte accesses where the layouts' runs allow); its launches
are counted by path, ``"direct"`` (both sides run along one axis) or
``"staged"`` (through shared memory).  :func:`relayout_plain` is its plain
PyTorch version: the layout algebra composed, which the CPU takes (and the
dry run on meta while it counts, the call one op: ``launch.op_cost``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import layouts as L
from repro_torch.launch import op_cost
from repro_torch.runtime import telemetry as _tm

from . import _build, maps

__all__ = ["plan_relayout", "AGUPlan", "agu_relayout", "agu_stats",
           "clear_agu_stats", "record_fallback", "record_plan", "eff_d_buf",
           "relayout_kernel", "relayout_plain", "relayout_args", "RELAYOUT"]


def eff_d_buf(extent: int, d_buf: int) -> int:
    """Largest burst depth <= d_buf that divides the streaming extent."""
    d = max(1, min(d_buf, extent))
    while extent % d:
        d -= 1
    return d


# -- AGU coverage accounting (one event per plan, mirrors cfg_stats) ---------
# Counters live in telemetry.bank("agu"); this module keeps only the view.
_BANK = _tm.bank("agu")


def agu_stats() -> Dict[str, Any]:
    """How relayout requests lowered: through the generic AGU kernel, as the
    identity stream, or via the plain fallback (with per-reason detail)."""
    return {"kernel": _BANK.get("kernel"), "identity": _BANK.get("identity"),
            "fallback": _BANK.get("fallback"),
            "reasons": _BANK.with_prefix("reason:")}


def clear_agu_stats() -> None:
    _BANK.clear()


def _record(kind: str, reason: str = "") -> None:
    _BANK.inc(kind)
    if kind == "fallback":
        _BANK.inc(f"reason:{reason or 'unknown'}")


def record_fallback(reason: str) -> None:
    """Callers outside the planner (e.g. the engine routing a plugin chain
    off the kernel path) record their fallbacks here."""
    _record("fallback", reason)


def record_plan(plan: "AGUPlan") -> None:
    """Tally a planned lowering (kernel or identity) in :func:`agu_stats`."""
    _record(plan.kind)


# -- kernel 1 ----------------------------------------------------------------
class _RelayoutArgs(ctypes.Structure):
    _fields_ = [("t", maps.Tile2), ("elem_bytes", ctypes.c_int64)]


RELAYOUT = _build.register(_build.Kernel(
    "agu_relayout", "agu_relayout.cu", "xdma_agu_relayout",
    [ctypes.c_void_p] * 3, replaces="src/repro/kernels/agu.py:168"))


def relayout_plain(x: torch.Tensor, src_layout: L.Layout,
                   dst_layout: L.Layout, transpose: bool = False
                   ) -> torch.Tensor:
    """Kernel 1's plain version: reader, optional swap, writer."""
    v = src_layout.to_logical(x)
    if transpose:
        v = torch.swapaxes(v, -1, -2)
    return dst_layout.from_logical(v)


def relayout_args(src_layout: L.Layout, dst_layout: L.Layout,
                  logical_shape, transpose: bool, elem_bytes: int
                  ) -> _RelayoutArgs:
    """Kernel 1's arguments for a relayout of a (m, n) logical array."""
    m, n = logical_shape
    out_logical = (n, m) if transpose else (m, n)
    src_maps = maps.dim_maps(src_layout, (m, n))
    a = _RelayoutArgs()
    a.t = maps.tile2(out_logical, (dst_layout.dim_pad(2, 0),
                                   dst_layout.dim_pad(2, 1)),
                     src_maps[::-1] if transpose else src_maps, (None, None),
                     maps.dim_maps(dst_layout, out_logical), 16 // elem_bytes)
    a.elem_bytes = elem_bytes
    return a


def _relayout_cuda(x: torch.Tensor, src_layout: L.Layout,
                   dst_layout: L.Layout, transpose: bool) -> torch.Tensor:
    x = x.contiguous()      # a strided view is copied once
    if x.element_size() not in (1, 2, 4, 8):
        raise NotImplementedError(
            f"agu_relayout copies 1/2/4/8-byte words, not {x.dtype}")
    m, n = src_layout.logical_shape(tuple(x.shape))
    out_logical = (n, m) if transpose else (m, n)
    out = torch.empty(dst_layout.physical_shape(out_logical), dtype=x.dtype,
                      device=x.device)
    a = relayout_args(src_layout, dst_layout, (m, n), transpose,
                      x.element_size())
    t = maps.fit_to(a.t, x, out)
    direct = t.load_axis == t.store_axis and t.vs == t.vd
    RELAYOUT(ctypes.addressof(a), x.data_ptr(), out.data_ptr(),
             path="direct" if direct else "staged")
    return out


@op_cost.one_op
def relayout_kernel(x: torch.Tensor, src_layout: L.Layout,
                    dst_layout: L.Layout, transpose: bool = False
                    ) -> torch.Tensor:
    """Kernel 1 on a CUDA tensor; its plain version on a CPU tensor (and
    on a meta one while the dry run counts, for its shape)."""
    if x.device.type == "cuda":
        return _relayout_cuda(x, src_layout, dst_layout, transpose)
    if op_cost.plain_on(x):
        return relayout_plain(x, src_layout, dst_layout, transpose)
    raise NotImplementedError(f"no relayout kernel for device {x.device}")


# -- planning ----------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AGUPlan:
    """One planned lowering of a relayout through the generic kernel.

    ``grid`` and ``block`` are the reference's TPU geometry, kept for plan
    parity; the CUDA kernel tiles the destination its own way."""

    kind: str                               # "identity" | "kernel"
    src_layout: L.Layout
    dst_layout: L.Layout
    logical_shape: Tuple[int, ...]
    transpose: bool
    grid: Tuple[int, ...] = ()
    block: Tuple[int, int] = (0, 0)         # logical (rows, cols) per step
    pair: Optional[L.PatternPair] = None    # the composed src⁻¹∘dst pattern

    @property
    def out_logical(self) -> Tuple[int, ...]:
        m, n = self.logical_shape
        return (n, m) if self.transpose else (m, n)

    def run(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "identity":
            return x
        return relayout_kernel(x, self.src_layout, self.dst_layout,
                               self.transpose)


def _grow(base: int, extent: int, cap: int = 128) -> int:
    """Largest multiple of ``base`` dividing ``extent``, <= max(base, cap)."""
    best = base
    f = 2
    while base * f <= max(base, cap):
        if extent % (base * f) == 0:
            best = base * f
        f += 1
    return best


def plan_relayout(src_layout: L.Layout, dst_layout: L.Layout,
                  logical_shape, *, transpose: bool = False,
                  d_buf: int = 9):
    """-> (AGUPlan, '') or (None, fallback_reason).

    Pure planning — no launches, no stats.  Use :func:`agu_relayout` (or
    ``repro_torch.kernels.ops.relayout``) for the recorded, executing entry
    point.
    """
    shape = tuple(int(s) for s in logical_shape)
    if len(shape) != 2:
        return None, f"rank:{len(shape)}"
    src_layout.check(shape)
    m, n = shape
    structure = lambda l: (l.tile, l.perm, l.pad)
    if not transpose and structure(src_layout) == structure(dst_layout):
        return AGUPlan(kind="identity", src_layout=src_layout,
                       dst_layout=dst_layout, logical_shape=shape,
                       transpose=False), ""
    pair = L.relayout_pair(src_layout, dst_layout, shape, transpose=transpose)
    if pair is None:
        return None, "nest-incompatible"
    if src_layout.dim_pad(2, 0) or dst_layout.dim_pad(2, 0):
        return None, "row-pad"
    st0, st1 = src_layout.dim_tile(2, 0), src_layout.dim_tile(2, 1)
    dt0, dt1 = dst_layout.dim_tile(2, 0), dst_layout.dim_tile(2, 1)
    if transpose:
        if src_layout.is_padded or dst_layout.is_padded:
            return None, "pad-transpose"
        br = math.lcm(st0, dt1)
        bc = math.lcm(st1, dt0)
        if m % br or n % bc:
            return None, f"granule:{br}x{bc}"
        br = _grow(br, m)
        bc = _grow(bc, n)
        bc *= eff_d_buf(n // bc, d_buf)
        grid = (m // br, n // bc)
    else:
        gr = math.lcm(st0, dt0)
        gc = math.lcm(st1, dt1)
        if m % gr or n % gc:
            return None, f"granule:{gr}x{gc}"
        # untiled/permuted pairs have degenerate (1, 1) granules; grow them
        # toward one (8 x 128) slab so the grid stays coarse.  Tiled
        # granules (>= one tile) keep their legacy geometry.
        gr = _grow(gr, m, cap=8)
        gc = _grow(gc, n, cap=128)
        if src_layout.dim_pad(2, 1) or dst_layout.dim_pad(2, 1):
            # padded column strides: the block spans the whole (padded) row;
            # the d_buf burst depth stacks along rows instead
            br, bc = gr * eff_d_buf(m // gr, d_buf), n
        else:
            br, bc = gr, gc * eff_d_buf(n // gc, d_buf)
        grid = (m // br, n // bc)
    return AGUPlan(kind="kernel", src_layout=src_layout,
                   dst_layout=dst_layout, logical_shape=shape,
                   transpose=transpose, grid=grid, block=(br, bc),
                   pair=pair), ""


def agu_relayout(x: torch.Tensor, *, src_layout: L.Layout,
                 dst_layout: L.Layout, transpose: bool = False,
                 d_buf: int = 9) -> torch.Tensor:
    """Force the generic AGU kernel; raises when the pair has no plan."""
    logical = src_layout.logical_shape(tuple(x.shape))
    plan, reason = plan_relayout(src_layout, dst_layout, logical,
                                 transpose=transpose, d_buf=d_buf)
    if plan is None:
        raise ValueError(
            f"no AGU kernel plan for {src_layout.name}->{dst_layout.name}"
            f"{' transposed' if transpose else ''} on {logical} ({reason})")
    record_plan(plan)
    return plan.run(x)
