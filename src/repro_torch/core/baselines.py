"""The paper's comparison setups (Fig. 4 ①②③), on the port.

The twin of ``repro.core.baselines``.  Each setup computes what
``xdma_copy`` computes, bit for bit, the way a system without the XDMA
Frontend would move it:

① 2D software control loop + 1D DMA (iDMA-style): the core computes every
   address; the DMA moves only *contiguous* runs.  :func:`sw_agu_loop` is a
   host loop that decodes each run index of the descriptor's ``src⁻¹∘dst``
   pattern pair into its (read, write) addresses and issues one contiguous
   copy per run — on the card, one device copy per run.  For transposing
   movements a run is one element.

② 2D software control loop + 2D DMA (Gemmini-style): the loop issues one
   ``(tm, tn)`` strided block copy per block (:func:`sw_loop_2d_dma`), read
   in place from the source buffer's strides.

③ 1D DMA burst copy + a dedicated layout-transformation accelerator: a
   full-bandwidth copy into an intermediate buffer, then a separate
   transform pass whose output is materialized before the writer
   (:func:`copy_then_transform`).

④⑤⑥ XDMA(d_buf) is ``engine.xdma_copy_pallas`` / kernel 1.
"""
from __future__ import annotations

import math

import torch

from . import engine
from . import layouts as L
from . import plugins as P
from .descriptor import XDMADescriptor

__all__ = [
    "sw_agu_loop",
    "sw_loop_1d_dma",
    "sw_loop_2d_dma",
    "copy_then_transform",
]


def _transpose_only(desc: XDMADescriptor, what: str) -> bool:
    if desc.plugins and not (len(desc.plugins) == 1
                             and isinstance(desc.plugins[0], P.Transpose)):
        raise ValueError(f"{what} supports copy/transpose only")
    return bool(desc.plugins)


def sw_agu_loop(x: torch.Tensor, desc: XDMADescriptor) -> torch.Tensor:
    """Software address generation over the composed affine pattern, for
    any layout pair the pattern algebra composes.

    The pattern pair's loop nest is walked run by run: each iteration the
    host decodes the run index into the pair's digits, computes the (read,
    write) address pair from the bases and strides, and issues one
    contiguous copy of ``run`` elements between the flat buffers.
    """
    transpose = _transpose_only(desc, "software AGU baseline")
    logical_in = desc.src_layout.logical_shape(tuple(x.shape))
    pair = L.relayout_pair(desc.src_layout, desc.dst_layout, logical_in,
                           transpose=transpose)
    if pair is None:
        raise ValueError(
            f"{desc.src_layout.name}->{desc.dst_layout.name}: no common "
            "loop-nest refinement; the software AGU has no pattern to walk")
    out_logical = (logical_in[:-2] + (logical_in[-1], logical_in[-2])
                   if transpose else tuple(logical_in))
    run, bounds, src_strides, dst_strides = pair.runs()
    run = int(run)
    n_runs = math.prod(bounds)
    suffix = []
    acc = 1
    for b in reversed(bounds):
        suffix.append(acc)
        acc *= b
    suffix.reverse()
    digits = [(int(b), int(sp), int(ss), int(ds)) for b, sp, ss, ds
              in zip(bounds, suffix, src_strides, dst_strides)]

    src_flat = x.reshape(-1)
    dst_phys = desc.dst_layout.physical_shape(out_logical)
    size = math.prod(dst_phys)
    # positions no run writes (stride padding) stay zero, as the reference's
    dst_flat = (torch.empty if n_runs * run == size else torch.zeros)(
        size, dtype=x.dtype, device=x.device)
    src_base, dst_base = int(pair.src_base), int(pair.dst_base)
    for r in range(n_runs):
        sa, da = src_base, dst_base
        for b, sp, ss, ds in digits:
            digit = (r // sp) % b
            sa += digit * ss
            da += digit * ds
        dst_flat[da:da + run].copy_(src_flat[sa:sa + run])
    return dst_flat.reshape(dst_phys)


def sw_loop_1d_dma(x: torch.Tensor, desc: XDMADescriptor) -> torch.Tensor:
    """Setup ①: software loop + 1D DMA, contiguous runs only — the runs of
    :func:`sw_agu_loop`."""
    return sw_agu_loop(x, desc)


def _split_view(x: torch.Tensor, layout: L.Layout) -> torch.Tensor:
    """The source's logical (M, N) as a 4-D view ``(M/sm, sm, N/sn, sn)``
    over its own strides (sm, sn = its tile, or 1 untiled), with no copy;
    the strided block reads of the 2D DMA slice it."""
    if layout.tile is None:
        logical = layout.to_logical(x)            # MN / NM / MNP: a view
        return logical.unsqueeze(1).unsqueeze(3)
    if len(layout.tile) != 2 or layout.pad is not None or x.ndim != 4:
        raise ValueError(f"software 2D-DMA baseline: no strided view of "
                         f"{layout.name} over a rank-{x.ndim} buffer")
    if layout.perm is not None:    # undo the trailing-dim order, as to_logical
        off = x.ndim - len(layout.perm)
        x = x.permute(tuple(range(off))
                      + tuple(off + i for i in L._argsort(layout.perm)))
    return x.permute(0, 2, 1, 3)


def _axis_slices(start: int, extent: int, tile: int):
    """(grid slice, in-tile slice) selecting ``extent`` logical indices from
    ``start`` on one split axis."""
    if extent % tile == 0 and start % tile == 0:
        return (slice(start // tile, (start + extent) // tile), slice(None))
    if tile % extent == 0 and start % extent == 0:
        g, o = divmod(start, tile)
        return (slice(g, g + 1), slice(o, o + extent))
    raise ValueError(f"software 2D-DMA baseline: a block of {extent} from "
                     f"{start} does not map onto tiles of {tile}")


def _block(view: torch.Tensor, r0: int, rows: int, c0: int,
           cols: int) -> torch.Tensor:
    """Logical block [r0, r0+rows) x [c0, c0+cols) of a split view, as a
    4-D strided view."""
    sm, sn = view.shape[1], view.shape[3]
    rg, ri = _axis_slices(r0, rows, sm)
    cg, ci = _axis_slices(c0, cols, sn)
    return view[rg, ri, cg, ci]


def sw_loop_2d_dma(x: torch.Tensor, desc: XDMADescriptor) -> torch.Tensor:
    """Setup ②: one (tm, tn) strided block per software-issued descriptor.

    The block is the tiled side's tile (MN x MN moves 8-row blocks); each is
    read through the source buffer's strides and written to its slot of the
    destination, one copy a block.
    """
    transpose = _transpose_only(desc, "software 2D-DMA baseline")
    logical_in = desc.src_layout.logical_shape(tuple(x.shape))
    m, n = logical_in[-2:]
    out_logical = (n, m) if transpose else (m, n)
    tiled = desc.dst_layout if desc.dst_layout.is_tiled else desc.src_layout
    tm, tn = tiled.tile if tiled.is_tiled else (min(8, out_logical[0]),
                                                out_logical[1])
    om, on = out_logical
    gm, gn = om // tm, on // tn
    src = _split_view(x, desc.src_layout)
    if desc.dst_layout.is_tiled:
        dst = torch.empty((gm, gn, tm, tn), dtype=x.dtype, device=x.device)
        slot = lambda bi, bj: dst[bi, bj]                      # noqa: E731
    else:
        dst = torch.empty(out_logical, dtype=x.dtype, device=x.device)
        slot = lambda bi, bj: dst[bi * tm:(bi + 1) * tm,       # noqa: E731
                                  bj * tn:(bj + 1) * tn]
    for r in range(gm * gn):
        bi, bj = r // gn, r % gn
        if transpose:
            blk = _block(src, bj * tn, tn, bi * tm, tm).permute(2, 3, 0, 1)
        else:
            blk = _block(src, bi * tm, tm, bj * tn, tn)
        slot(bi, bj).view(blk.shape).copy_(blk)
    if desc.dst_layout.is_tiled:
        return dst.reshape(desc.dst_layout.physical_shape(out_logical))
    return dst


def copy_then_transform(x: torch.Tensor, desc: XDMADescriptor) -> torch.Tensor:
    """Setup ③: burst copy to an intermediate, then a separate transform pass.

    The intermediate is a real read + write pass over the buffer
    (``clone``), and the transform's output is materialized (``contiguous``)
    before the writer: the doubled traffic the paper attributes to this
    design."""
    intermediate = x.clone()
    logical = engine.reader(intermediate, desc.src_layout)
    logical = P.apply_chain(desc.plugins, logical)
    logical = logical.contiguous()                 # accelerator output buffer
    return engine.writer(logical, desc.dst_layout)
