"""Kernel 5: symmetric int8 quantize-on-stream into the int8 tile layout (the
twin of ``repro.kernels.quant``).

The wire-format producer for compressed collectives: rows are scaled to int8
while being tiled to ``MNM32N128``, with per-row f32 scales alongside.  On a
CUDA tensor :func:`quantize_tiled` launches ``csrc/quantize_tiled.cu``; on a
CPU tensor it takes the plain version (on a meta tensor too while the dry
run counts: one op to ``launch.op_cost``).  Values and scales equal the
reference's bit for bit: the scale is ``amax * f32(1 / 127)``, which is what
XLA makes of the reference's ``amax / 127.0``, then an IEEE ``x / scale``
rounded half to even.  Non-finite rows keep that promise: the row max
propagates NaN as ``jnp.max`` does, so a row holding a NaN gets scale 1.0
(``amax > 0`` is false) and a row holding an inf gets scale inf; a NaN
quotient (a NaN element, inf / inf) stores 0, as the reference's conversion
does.

Shapes follow the reference: the columns must be a whole number of tiles,
and rows past ``(m // tm) * tm`` get no values.  Their scales are left
unwritten by the reference (NaN where its interpreter runs it); the port
writes NaN there.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.launch import op_cost

from . import _build, maps, ref

__all__ = ["quantize_tiled", "quantize_tiled_plain", "quant_args", "QUANT"]

QUANT = _build.register(_build.Kernel(
    "quantize_tiled", "quantize_tiled.cu", "xdma_quantize_tiled",
    [ctypes.c_void_p] * 4, replaces="src/repro/kernels/quant.py:34"))


class _QuantArgs(ctypes.Structure):
    _fields_ = [("rows", ctypes.c_int64), ("cols", ctypes.c_int64),
                ("tm", ctypes.c_int64), ("tn", ctypes.c_int64),
                ("dtype", ctypes.c_int64)]


def _scales(m: int, rows: int, device) -> torch.Tensor:
    scales = torch.empty((m, 1), dtype=torch.float32, device=device)
    scales[rows:] = float("nan")
    return scales


def quantize_tiled_plain(x: torch.Tensor, tile_shape=(32, 128)):
    """The plain version: :func:`.ref.quantize_tiled_ref` on the rows the
    reference's grid covers, NaN scales past them."""
    tile_shape = tuple(int(t) for t in tile_shape)
    rows = maps.tiled_rows(x, tile_shape, "quantize_tiled")
    values, s = ref.quantize_tiled_ref(x[:rows], tile_shape)
    scales = _scales(x.shape[0], rows, x.device)
    scales[:rows] = s
    return values, scales


def quant_args(x: torch.Tensor, tile_shape: Tuple[int, int]) -> _QuantArgs:
    """Kernel 5's arguments for ``x`` (m, n) into ``tile_shape`` tiles."""
    a = _QuantArgs()
    a.rows = maps.tiled_rows(x, tile_shape, "quantize_tiled")
    a.cols = x.shape[1]
    a.tm, a.tn = tile_shape
    a.dtype = maps.dtype_code(x.dtype)
    return a


def _launch(x, tile_shape):
    x = x.contiguous()      # a strided view is copied once
    a = quant_args(x, tile_shape)
    tm, tn = tile_shape
    values = torch.empty((a.rows // tm, a.cols // tn, tm, tn),
                         dtype=torch.int8, device=x.device)
    scales = _scales(x.shape[0], a.rows, x.device)
    QUANT(ctypes.addressof(a), x.data_ptr(), values.data_ptr(),
          scales.data_ptr())
    return values, scales


@op_cost.one_op
def quantize_tiled(x: torch.Tensor, tile_shape=(32, 128), *, d_buf: int = 9):
    """Per-row symmetric int8 of ``x`` (m, n): ``(values, scales)`` with
    values int8 ``(m // tm, n // tn, tm, tn)`` and scales f32 ``(m, 1)``.

    ``d_buf`` is the reference's TPU burst depth; it picks only the
    reference's grid and never the result."""
    tile_shape = tuple(int(t) for t in tile_shape)
    if op_cost.plain_on(x):
        return quantize_tiled_plain(x, tile_shape)
    if x.device.type != "cuda":
        raise NotImplementedError(f"no quantize_tiled kernel for {x.device}")
    return _launch(x, tile_shape)
