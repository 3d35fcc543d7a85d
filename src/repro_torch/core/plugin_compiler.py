"""The XDMA plugin compiler: lower a descriptor's datapath into one
hand-written kernel per endpoint side (PyTorch port).

The twin of ``repro.core.plugin_compiler``.  Paper Fig. 2(c) puts the
plugin hosts *inside* the reader -> writer datapath; this module compiles
``reader -> pre-chain -> post-chain -> writer`` (a local movement) or
``reader -> pre-chain`` / ``post-chain -> writer`` (the two sides of a
remote movement) into one kernel program each, from one of two templates:

* **streamed** (kernel 2, :class:`~repro_torch.kernels.datapath.StreamedDatapath`)
  — every plugin is row-local and shape-preserving (``streaming=True``) and
  the geometry allows row bursts: one pass over the logical rows;
* **block** (kernel 3, :class:`~repro_torch.kernels.datapath.BlockDatapath`)
  — anything else that still has ``emit`` everywhere (transpose,
  gather/scatter, compress, reduce, row padding, rank != 2).

The policy and its accounting are the reference's: a chain with a plugin
that has no ``emit`` falls back to the plain composition, an empty chain
keeps the plain relayout, and :func:`cfg_stats` counts fused vs fallback
CFG phases with their reasons.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.runtime import telemetry as _tm

from . import layouts as L
from . import plugins as P
from .descriptor import XDMADescriptor

__all__ = ["can_fuse", "compile_local", "compile_side", "maybe_compile_local",
           "maybe_compile_side", "cfg_stats", "clear_stats"]


# -- fusion accounting (one event per CFG phase, not per Data phase) ---------
_BANK = _tm.bank("plugin_compiler")


def cfg_stats() -> Dict[str, Any]:
    """Fused vs fallback CFG-phase counts, with per-reason fallback detail."""
    return {"fused": _BANK.get("fused"), "fallback": _BANK.get("fallback"),
            "reasons": _BANK.with_prefix("reason:")}


def clear_stats() -> None:
    _BANK.clear()


def _record(fused: bool, reason: str = "") -> None:
    if fused:
        _BANK.inc("fused")
    else:
        _BANK.inc("fallback")
        _BANK.inc(f"reason:{reason or 'unknown'}")


# -- fusibility --------------------------------------------------------------
def _chain_fusible(chain: Sequence[P.Plugin]) -> Optional[str]:
    """None when every plugin has an emit hook, else the fallback reason."""
    for p in chain:
        if not p.supports_emit:
            return f"no-emit:{p.name}"
    return None


def can_fuse(desc: XDMADescriptor) -> Tuple[bool, str]:
    """Whether the *local* datapath of ``desc`` compiles to one kernel.

    This is the ``backend='auto'`` policy: plugin-carrying local movements
    with a fully emit-capable chain fuse; empty chains keep the plain
    relayout (nothing to fuse into the datapath); anything else falls back.
    """
    if desc.movement != "local":
        return False, f"movement:{desc.movement}"
    chain = desc.pre + desc.post
    if not chain:
        return False, "empty-chain"
    reason = _chain_fusible(chain)
    if reason is not None:
        return False, reason
    return True, "fusible"


# -- kernel construction -----------------------------------------------------
def _burst_rows(chain, src_layout, dst_layout, m: int, d_buf: int) -> Optional[int]:
    """Rows per streamed burst, or None when the geometry forces the block
    template.  Base granularity is the lcm of the two layouts' row-tile
    factors; ``d_buf`` bursts stack on top of it exactly as in the AGU
    relayout plan.  Row-stride padding cannot be row-slabbed (the padding
    rows sit at the end of the buffer), so it falls to the block template."""
    from repro_torch.kernels.agu import eff_d_buf
    if src_layout.dim_pad(2, 0) or dst_layout.dim_pad(2, 0):
        return None
    base = math.lcm(src_layout.dim_tile(2, 0), dst_layout.dim_tile(2, 0))
    if m % base:
        return None
    return base * eff_d_buf(m // base, d_buf)


def _compile_streamed(chain, src_layout, dst_layout, in_shape, in_dtype,
                      d_buf):
    """Kernel 2 for all-streaming chains, or None when the geometry forces
    the block template."""
    from repro_torch.kernels.datapath import StreamedDatapath
    logical = src_layout.logical_shape(tuple(in_shape))
    if len(logical) != 2:
        return None
    if _burst_rows(chain, src_layout, dst_layout, logical[0], d_buf) is None:
        return None
    return StreamedDatapath(chain, src_layout, dst_layout, in_shape, in_dtype)


def _compile_block(chain, src_layout, dst_layout, in_shape, in_dtype):
    """Kernel 3: any emit-capable chain."""
    from repro_torch.kernels.datapath import BlockDatapath
    return BlockDatapath(chain, src_layout, dst_layout, in_shape, in_dtype)


def _compile_for_aval(chain, src_layout, dst_layout, d_buf, in_shape,
                      in_dtype):
    streaming = all(p.streaming for p in chain)
    if streaming and len(in_shape) >= 2:
        fn = _compile_streamed(chain, src_layout, dst_layout, in_shape,
                               in_dtype, d_buf)
        if fn is not None:
            return fn
    return _compile_block(chain, src_layout, dst_layout, in_shape, in_dtype)


def _specializing(chain, src_layout, dst_layout, d_buf, validate):
    """Descriptor-level callable: specializes one kernel program per input
    shape and dtype (the reference's per-aval specialization)."""
    kernels: Dict[Tuple, Callable] = {}

    def run(x: torch.Tensor):
        key = (tuple(x.shape), x.dtype)
        fn = kernels.get(key)
        if fn is None:
            validate(tuple(x.shape))
            fn = _compile_for_aval(chain, src_layout, dst_layout, d_buf,
                                   tuple(x.shape), x.dtype)
            kernels[key] = fn
        return fn(x)

    run.kernels = kernels               # (shape, dtype) -> kernel program
    return run


# -- public entry points -----------------------------------------------------
def compile_local(desc: XDMADescriptor) -> Callable:
    """The full local datapath as one kernel program; raises when not
    fusible.  The returned callable specializes (and memoizes) one program
    per input shape/dtype."""
    if desc.movement != "local":
        raise ValueError(f"compile_local only lowers local movements, "
                         f"got {desc.movement!r}")
    chain = desc.pre + desc.post
    reason = _chain_fusible(chain)
    if reason is not None:
        raise ValueError(f"descriptor is not fusible ({reason}); "
                         "use the fused backend instead")

    def validate(shape):
        desc.validate(desc.src.layout.logical_shape(shape))

    return _specializing(chain, desc.src.layout, desc.dst.layout, desc.d_buf,
                         validate)


def maybe_compile_local(desc: XDMADescriptor, *,
                        tally: bool = True) -> Optional[Callable]:
    """``backend='auto'`` policy + stats: the compiled datapath, or None to
    signal the plain-composition fallback.  ``tally=False`` leaves
    ``cfg_stats`` alone (a queue's ``run``, one program in the reference,
    which no CFG phase of the plugin compiler counts)."""
    ok, reason = can_fuse(desc)
    if tally:
        _record(ok, reason)
    if not ok:
        return None
    return compile_local(desc)


def compile_side(layout: L.Layout, chain: Sequence[P.Plugin], *, side: str,
                 d_buf: int = 9) -> Callable:
    """One endpoint side of a remote movement as one kernel program.

    ``side='src'``: reader + pre-chain (physical src buffer -> link
    payload); ``side='dst'``: post-chain + writer (link payload -> physical
    dst buffer).  The identity layout stands in for the link end."""
    chain = tuple(chain)
    reason = _chain_fusible(chain)
    if reason is not None:
        raise ValueError(f"side is not fusible ({reason})")
    if side == "src":
        src_layout, dst_layout = layout, L.MN
    elif side == "dst":
        src_layout, dst_layout = L.MN, layout
    else:
        raise ValueError(f"side must be 'src' or 'dst', got {side!r}")
    return _specializing(chain, src_layout, dst_layout, d_buf,
                         lambda shape: None)


def maybe_compile_side(layout: L.Layout, chain: Sequence[P.Plugin], *,
                       side: str, d_buf: int = 9) -> Optional[Callable]:
    """Side-fusion policy for remote movements: fuse a non-empty, fully
    emit-capable chain whose payload stays a plain tensor (QTensor /
    CTensor payloads split the stream across the collective), else None.
    A side with no plugins is not a fallback: there is no chain to fuse."""
    chain = tuple(chain)
    if not chain:
        return None
    reason = _chain_fusible(chain)
    if reason is None:
        for p in chain:
            if p.pytree_payload:
                reason = f"pytree-payload:{p.name}"
                break
    _record(reason is None, reason or "")
    if reason is not None:
        return None
    return compile_side(layout, chain, side=side, d_buf=d_buf)
