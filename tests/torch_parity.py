"""Helpers the port's parity tests (``tests/test_torch_*.py``) share.

The same numpy inputs go through the JAX reference and the PyTorch port;
arrays cross as numpy, bf16 as its ``uint16`` view (torch does not take
``ml_dtypes`` arrays).  A descriptor of the reference crosses as a plain
spec (:func:`spec_of`) that ``repro_torch.core.descriptor.from_spec`` reads.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.autotune as ref_at
import repro.core.descriptor as ref_descriptor
import repro.core.plugin_compiler as ref_pc
import repro.kernels.agu as ref_agu
import repro.runtime.scheduler as ref_sched
import repro.runtime.telemetry as ref_tm
import repro.serving.transfer as ref_transfer
from repro.core import plugins as RP
from repro.core import xdma as ref_xdma

import repro_torch.core.api as port_api


def _reset_all():
    """Both packages' global state as a fresh process has it: the CFG cache
    and its siblings (the autotune memos, the scheduler's round cache), the
    page-geometry and KV-plane descriptor memos (their first calls count an
    autotune search), agu_stats, cfg_stats and every telemetry bank
    (cfg_cache, agu, plugin_compiler, autotune, links, queues, rings,
    multicast); the port's through ``reset_process_state``."""
    ref_xdma.clear_cache()
    ref_at.clear_cache()
    ref_sched._ROUND_CACHE.clear()
    ref_descriptor.page_layout.cache_clear()
    ref_descriptor.page_descriptor.cache_clear()
    ref_transfer.kv_plane_descs.cache_clear()
    ref_agu.clear_agu_stats()
    ref_pc.clear_stats()
    ref_tm.reset()
    port_api.reset_process_state()


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
    """numpy / jax array -> CPU tensor, bf16 through its uint16 view and
    float8 through its uint8 view (torch does not take ``ml_dtypes``)."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype.name in ("float8_e4m3fn", "float8_e5m2"):
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            getattr(torch, a.dtype.name))
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


# -- the rank-2 tiled copy's index arithmetic, emulated ------------------------
def _term(term, i):
    """``xdma::term_off`` over an index array: offsets, or fill codes < 0."""
    m = term.map
    if term.idx:
        vec = np.ctypeslib.as_array(
            (ctypes.c_int64 * (int(i.max()) + 1)).from_address(term.idx))
        j = vec[i]
        off = (np.maximum(j, 0) // m.tile) * m.sgrid + \
            (np.maximum(j, 0) % m.tile) * m.stile
        return np.where(j < 0, j, off)
    return (i // m.tile) * m.sgrid + (i % m.tile) * m.stile


def _check_packs(off, axis, width, whole, live):
    """Every access of ``width`` positions along ``axis`` that starts at a
    multiple of ``width`` lies wholly inside or outside ``whole`` and, where
    ``live``, is consecutive and ``width``-aligned in memory, as a 16-byte
    pack of the kernel must be."""
    if width == 1:
        return
    o, w, v = (np.moveaxis(a, axis, -1) for a in (off, whole, live))
    assert o.shape[-1] % width == 0, (o.shape, width)
    o, w, v = (a.reshape(a.shape[:-1] + (-1, width)) for a in (o, w, v))
    assert (w.all(-1) | ~w.any(-1)).all(), "a pack straddles the extent"
    v = v.all(-1)
    assert (o[..., 0][v] % width == 0).all(), "a pack is not aligned"
    assert (np.diff(o, axis=-1)[v] == 1).all(), \
        "a pack is not consecutive in memory"


def emulate_tile2(t, src_flat, out_size, value=None, fill=None, *, out=None,
                  src_base=0, dst_base=0, lead_code=0, written=None):
    """``xdma::tile2_run`` (csrc/xdma_common.cuh) over flat numpy buffers:
    every position of the destination's padded space is written once, the
    logical ones from ``value(src_flat[offsets], r, c)`` (default: the words
    unchanged) or ``fill(codes, r, c)`` where a gather's index failed, the
    stride padding with zeros.  The access widths the host chose (``vs``,
    ``vd``) are checked against the offsets they would move as packs.

    Kernel 3's batched pass runs it once a leading index: both sides
    offset by ``src_base`` / ``dst_base``, a failed leading-axis gather's
    ``lead_code`` merged into each element's (the more negative stands),
    into the whole destination ``out``, counting writes in ``written``."""
    r, c = np.broadcast_arrays(np.arange(t.prows)[:, None],
                               np.arange(t.pcols)[None, :])
    inside = (r < t.rows) & (c < t.cols)
    sr = _term(t.src_r, np.minimum(r, t.rows - 1))
    sc = _term(t.src_c, np.minimum(c, t.cols - 1))
    so = np.where((sr < 0) | (sc < 0), np.minimum(sr, sc), sr + sc + src_base)
    if lead_code < 0:
        so = np.minimum(np.where(so < 0, so, 0), lead_code)
    ok = inside & (so >= 0)
    _check_packs(so, t.load_axis, t.vs, inside, ok)
    dm = lambda m, i: (i // m.tile) * m.sgrid + (i % m.tile) * m.stile
    do = dst_base + dm(t.dst_r, r) + dm(t.dst_c, c)
    everywhere = np.ones_like(inside)
    _check_packs(do, t.store_axis, t.vd, everywhere, everywhere)
    assert np.unique(do).size == do.size, "a destination word written twice"
    if written is not None:
        np.add.at(written, do.ravel(), 1)
    if out is None:
        out = np.zeros(out_size, dtype=src_flat.dtype)
    out[do[~inside]] = 0
    vals = src_flat[so[ok]]
    out[do[ok]] = vals if value is None else value(vals, r[ok], c[ok])
    bad = inside & (so < 0)
    if bad.any():
        out[do[bad]] = fill(so[bad], r[bad], c[bad])
    return out


# -- one scenario on both packages ----------------------------------------------
class Side:
    """One package under a common spelling, so a scenario written once runs
    on the reference (``"ref"``) and on the port (``"port"``).  ``rand``
    draws the reference's seeded input; the port gets the same values."""

    def __init__(self, name):
        self.name = name
        if name == "ref":
            import jax.numpy as jnp
            import repro.core as C
            import repro.runtime as R
            self.dtypes = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                           "int8": jnp.int8, "float16": jnp.float16}
            self.asarray = jnp.asarray
        else:
            import repro_torch.core as C
            import repro_torch.runtime as R
            self.dtypes = {"float32": torch.float32,
                           "bfloat16": torch.bfloat16, "int8": torch.int8,
                           "float16": torch.float16}
            self.asarray = to_torch
        self.C, self.R = C, R
        self.xdma = C.xdma
        self.autotune = C.autotune
        import importlib
        pkg = "repro" if name == "ref" else "repro_torch"
        for mod in ("topology", "ring", "simulator", "scheduler", "trace",
                    "telemetry", "chrometrace"):
            setattr(self, mod, importlib.import_module(f"{pkg}.runtime.{mod}"))
        self.L = importlib.import_module(f"{pkg}.core.layouts")
        self.descriptor = importlib.import_module(f"{pkg}.core.descriptor")

    def rand(self, shape, seed=0, dtype="float32"):
        import jax.numpy as jnp
        a = jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                        {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                         "float16": jnp.float16}[dtype])
        return a if self.name == "ref" else to_torch(a)


SIDES = ("ref", "port")


def on_both(scenario, *args, values_tol=None, **kw):
    """Run ``scenario(side, ...)`` on the reference and on the port, each
    from a fresh state, and hold the port's result equal to the
    reference's: everything it returns through :func:`norm` (reports,
    completion times, counters: exact), except under ``"values"``, a list
    of outputs held by :func:`assert_same_payload` (bitwise, or within
    ``values_tol`` for float chains).  Returns the two raw results."""
    out = {}
    for name in SIDES:
        _reset_all()
        out[name] = scenario(Side(name), *args, **kw)
    _reset_all()
    ref, port = out["ref"], out["port"]
    if isinstance(ref, dict):
        rv, pv = ref.get("values", ()), port.get("values", ())
        assert len(rv) == len(pv)
        for i, (got, want) in enumerate(zip(pv, rv)):
            assert_same_payload(got, want, context=f"values[{i}]",
                                **(values_tol or {}))
        strip = lambda d: {k: v for k, v in d.items() if k != "values"}
        got, want = norm(strip(port)), norm(strip(ref))
    else:
        got, want = norm(port), norm(ref)
    assert got == want, first_difference(got, want)
    return ref, port


def first_difference(got, want, path="result"):
    """Where two :func:`norm` structures first differ, for the message."""
    if type(got) is not type(want):
        return f"{path}: {type(got).__name__} vs {type(want).__name__}"
    if isinstance(got, dict):
        if set(got) != set(want):
            return f"{path}: keys {sorted(set(got) ^ set(want), key=repr)}"
        for k in got:
            if got[k] != want[k]:
                return first_difference(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(got, (list, tuple)):
        if len(got) != len(want):
            return f"{path}: length {len(got)} vs {len(want)}"
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                return first_difference(g, w, f"{path}[{i}]")
    return f"{path}: port {got!r:.300} vs reference {want!r:.300}"


def dtype_name(d):
    """A dtype of either package (or a name) as the reference spells it."""
    if isinstance(d, str):
        return d
    if isinstance(d, torch.dtype):
        return str(d).replace("torch.", "")
    return np.dtype(d).name


def norm(v):
    """A structure of either package as plain comparable data: arrays and
    tensors by dtype, shape and bits; dataclasses by class name and fields
    (a descriptor by its summary and layouts); dtypes by name."""
    import jax
    from repro.core.descriptor import XDMADescriptor as RD
    from repro_torch.core.descriptor import XDMADescriptor as PD
    from repro_torch.core import plugins as PP
    if isinstance(v, (RD, PD)):
        return ("desc", v.summary(), v.src.layout.name, v.dst.layout.name,
                tuple(sorted(n for n, _ in (v.dst.dsts or ()))))
    if isinstance(v, (RP.QTensor, PP.QTensor)):
        return ("QTensor", norm(v.values), norm(v.scales))
    if isinstance(v, (RP.CTensor, PP.CTensor)):
        return ("CTensor", norm(v.values), norm(v.mask))
    if isinstance(v, (torch.Tensor, jax.Array, np.ndarray)):
        return ("array", dtype_name(v.dtype), tuple(v.shape),
                bits(v).tobytes())
    if isinstance(v, (torch.dtype, np.dtype)):
        return ("dtype", dtype_name(v))
    if isinstance(v, type) and not dataclasses.is_dataclass(v):
        return ("dtype", np.dtype(v).name)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple(
            (f.name, norm(getattr(v, f.name))) for f in dataclasses.fields(v))
    if isinstance(v, dict):
        return {k: norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(norm(x) for x in v)
    return v


BANKS = ("links", "queues", "rings", "multicast", "autotune", "cfg_cache")


def sched_record(S, sched):
    """What a scheduler run leaves for comparison: its replayed report,
    completion queue, per-resource dispatch order, per-task rounds,
    per-link bytes, the incremental makespan and the counter banks."""
    rep = sched.report()
    per_link = {}
    for t in sched.sim_tasks():
        if t.resource in sched.topology:
            per_link[t.resource] = per_link.get(t.resource, 0) + t.nbytes
    return {"report": rep, "completions": list(sched.completions),
            "dispatched": dict(sched._dispatched),
            "rounds": {tid: t.round for tid, t in sched._tasks.items()},
            "sim_tasks": sched.sim_tasks(), "per_link": per_link,
            "makespan": sched.makespan(),
            "banks": {d: S.telemetry.bank(d).as_dict() for d in BANKS}}
