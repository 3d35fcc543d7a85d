"""Helpers the port's parity tests (``tests/test_torch_*.py``) share.

The same numpy inputs go through the JAX reference and the PyTorch port;
arrays cross as numpy, bf16 as its ``uint16`` view (torch does not take
``ml_dtypes`` arrays).  A descriptor of the reference crosses as a plain
spec (:func:`spec_of`) that ``repro_torch.core.descriptor.from_spec`` reads.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.plugin_compiler as ref_pc
import repro.kernels.agu as ref_agu
import repro.runtime.telemetry as ref_tm
from repro.core import plugins as RP
from repro.core import xdma as ref_xdma

import repro_torch.core.api as port_api
import repro_torch.core.plugin_compiler as port_pc
import repro_torch.kernels.agu as port_agu
import repro_torch.runtime.telemetry as port_tm


def _reset_all():
    ref_xdma.clear_cache()
    ref_agu.clear_agu_stats()
    ref_pc.clear_stats()
    ref_tm.reset()
    port_api.clear_cache()
    port_agu.clear_agu_stats()
    port_pc.clear_stats()
    port_tm.reset()


@pytest.fixture(scope="module", autouse=True)
def reset_global_state():
    """After the module, leave the reference's (and the port's) global state
    as a fresh process has it: the CFG cache, agu_stats, cfg_stats and the
    telemetry banks.  Other test files in the same worker count on it."""
    yield
    _reset_all()


def bits(a) -> np.ndarray:
    """An array's raw bits as an unsigned-int numpy array (bitwise compare)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bool:
            return a.numpy().view(np.uint8)
        size = a.element_size()
        as_int = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                  8: torch.int64}[size]
        a = a.contiguous().view(as_int).numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


def to_torch(a) -> torch.Tensor:
    """numpy / jax array -> CPU tensor, bf16 through its uint16 view."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_f32(a) -> np.ndarray:
    """A float tensor / array as float32 numpy (for tolerance compares)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().to(torch.float32).numpy()
    return np.asarray(a).astype(np.float32)


def _array_spec(a):
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return {"array": a.view(np.uint16), "dtype": "bfloat16"}
    return {"array": a, "dtype": a.dtype.name}


def _field_spec(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, type) or isinstance(v, np.dtype):
        return {"dtype": np.dtype(v).name}
    if hasattr(v, "dtype") and hasattr(v, "shape"):
        return _array_spec(v)
    return v


def plugin_spec(p):
    if dataclasses.is_dataclass(p):
        fields = {f.name: _field_spec(getattr(p, f.name))
                  for f in dataclasses.fields(p) if f.name != "name"}
    else:
        fields = {}
    return {"name": p.name, "fields": fields}


def layout_spec(layout):
    return {"name": layout.name, "tile": layout.tile, "perm": layout.perm,
            "pad": layout.pad}


def endpoint_spec(ep):
    spec = {"kind": ep.kind, "layout": layout_spec(ep.layout)}
    for k in ("axis", "perm", "split_axis", "concat_axis", "axis_size"):
        spec[k] = getattr(ep, k)
    return spec


def spec_of(desc):
    """A reference descriptor as the plain spec ``from_spec`` reads."""
    return {"src": endpoint_spec(desc.src), "dst": endpoint_spec(desc.dst),
            "pre": [plugin_spec(p) for p in desc.pre],
            "post": [plugin_spec(p) for p in desc.post],
            "d_buf": desc.d_buf, "channels": desc.channels,
            "backend": desc.backend}


def port_desc(desc):
    from repro_torch.core.descriptor import from_spec
    return from_spec(spec_of(desc))


def assert_same_payload(got, want, *, context="", **tol):
    """Port output (tensor / CTensor / QTensor) vs reference output: bitwise
    when no tolerance is given, else allclose in f32 with equal dtype names
    and shapes (masks and int payloads always bitwise)."""
    if isinstance(want, (RP.CTensor,)):
        np.testing.assert_array_equal(bits(got.mask), bits(want.mask),
                                      err_msg=context)
        got, want = got.values, want.values
    if isinstance(want, (RP.QTensor,)):
        np.testing.assert_array_equal(bits(got.values), bits(want.values),
                                      err_msg=context)
        got, want = got.scales, want.scales
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (context, tuple(got.shape),
                                            want.shape)
    assert str(got.dtype).replace("torch.", "") == want.dtype.name, (
        context, got.dtype, want.dtype)
    if not tol:
        np.testing.assert_array_equal(bits(got), bits(want), err_msg=context)
    else:
        np.testing.assert_allclose(to_f32(got), to_f32(want), err_msg=context,
                                   **tol)
