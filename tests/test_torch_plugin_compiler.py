"""Parity of the port's plugin datapath (kernels 2 and 3) with the reference's.

* The policy (``can_fuse``, ``_burst_rows``, the template chosen) and
  ``cfg_stats`` equal the reference's.
* Streamed and block chains agree with the reference within
  ``tests/oracle.py``'s chain tolerances, and bitwise where the chain only
  moves data (transposes, gathers, masks).
* The kernels' host code (op and stage lists, constants, layout maps,
  scratch buffers, launch order) runs against emulators of the CUDA code's
  index and value arithmetic, reading and writing the same CPU memory the
  kernel would on the card.
"""
import pytest

pytest.importorskip("torch")

import ctypes  # noqa: E402
import dataclasses  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import oracle as O  # noqa: E402
import test_differential as TD  # noqa: E402
from repro import core as RC  # noqa: E402
from repro.core import plugin_compiler as rpc  # noqa: E402
from repro.core import plugins as RP  # noqa: E402
from repro.core import xdma as rx  # noqa: E402
from repro_torch.core import layouts as PL  # noqa: E402
from repro_torch.core import plugin_compiler as ppc  # noqa: E402
from repro_torch.core import plugins as PP  # noqa: E402
from repro_torch.core import xdma as px  # noqa: E402
from repro_torch.kernels import _build, datapath as DP  # noqa: E402
import torch_parity as P2  # noqa: E402
from torch_parity import (assert_same_payload, bits, port_desc,  # noqa: E402,F401
                          reset_global_state, to_f32, to_torch)


def _x(shape, seed=0, zero_rows=0, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if zero_rows:
        x[..., :zero_rows, :] = 0.0
    return x.astype(dtype)


def _perm(n, seed=1):
    return np.random.default_rng(seed).permutation(n)


# (src, dst, chain builder, logical shape, input dtype); the builder takes the
# plugin module and the logical shape, so one spelling serves both packages
def _bf16(M):
    return jnp.bfloat16 if M is RP else torch.bfloat16


def _arr(M, a):
    """An array constant for the reference (numpy) or the port (tensor)."""
    return a if M is RP else to_torch(a)


STREAMED_CASES = {
    "rmsnorm_store": ("MN", "MNM16N128",
                      lambda M, s: (M.RMSNormPlugin(),), (64, 256), np.float32),
    "rmsnorm_weight_bf16": ("MN", "MNM16N128", lambda M, s: (M.RMSNormPlugin(
        weight=_arr(M, np.linspace(-2, 2, s[-1]).astype(jnp.bfloat16))),), (64, 256),
        jnp.bfloat16),
    "cast_scale_bias": ("MN", "MNM16N128", lambda M, s: (
        M.Cast(_bf16(M)), M.Scale(1.5), M.BiasAdd(0.25)), (64, 256),
        np.float32),
    "scale_bias_vectors": ("MNM8N128", "MNP64", lambda M, s: (
        M.Scale(_arr(M, np.linspace(0.5, 2.0, s[-1]).astype(np.float32))),
        M.BiasAdd(_arr(M, np.linspace(-1, 1, s[-1]).astype(np.float32)))),
        (64, 256),
        np.float32),
    "identity_nm": ("NM", "MNM8N128", lambda M, s: (M.Identity(),), (64, 256),
                    np.float32),
    "cast_f16_rmsnorm": ("MN", "MN", lambda M, s: (
        M.Cast(jnp.float16 if M is RP else torch.float16),
        M.RMSNormPlugin(eps=1e-5)), (32, 384), np.float32),
}

BLOCK_CASES = {
    "load_transpose": ("MNM16N128", "MN", lambda M, s: (M.Transpose(),),
                       (64, 256), jnp.bfloat16),
    "gather_rows": ("MN", "MN", lambda M, s: (M.GatherScatter(
        indices=_perm(s[0])),), (64, 256), jnp.bfloat16),
    "gather_fill": ("MN", "MN", lambda M, s: (M.GatherScatter(
        indices=np.r_[_perm(s[0] - 1), s[0] + 5]),), (64, 256), np.float32),
    "gather_cols_neg": ("MN", "MNM8N128", lambda M, s: (M.GatherScatter(
        indices=np.arange(-1, -s[-1] - 1, -1), axis=-1),), (64, 256),
        np.float32),
    "compress": ("MN", "MNM8N128", lambda M, s: (M.Compress(block_rows=8),),
                 (64, 256), np.float32),
    "compress_roundtrip": ("MN", "MN", lambda M, s: (
        M.Compress(block_rows=8), M.Decompress()), (64, 256), jnp.bfloat16),
    "reduce_sum": ("MN", "MN", lambda M, s: (M.ReduceStage("sum"),),
                   (64, 256), np.float32),
    "reduce_max_bf16": ("MNM16N128", "MN", lambda M, s: (
        M.ReduceStage("max"),), (64, 256), jnp.bfloat16),
    "rmsnorm_rowpad": ("MN", "rowpad", lambda M, s: (M.RMSNormPlugin(),),
                       (64, 256), np.float32),
    "rank3_rmsnorm": ("MN", "KV4M8N128", lambda M, s: (
        M.RMSNormPlugin(), M.Scale(2.0)), (8, 32, 256), np.float32),
    "transpose_rmsnorm_sum": ("NMM8N128", "MNP64", lambda M, s: (
        M.Transpose(), M.RMSNormPlugin(), M.ReduceStage("sum")),
        (128, 256), np.float32),
    "max_transpose_sum": ("MN", "MN", lambda M, s: (
        M.ReduceStage("max"), M.Transpose(), M.ReduceStage("sum")),
        (64, 256), np.float32),
    "hypothesis_case": ("MN", "MN", lambda M, s: (
        M.Cast(_bf16(M)), M.Scale(1.5), M.ReduceStage("sum")), (128, 128),
        np.float32),
}


def _layouts(name):
    if name == "rowpad":
        return (RC.Layout(None, "rowpad", pad=(8, 0)),
                PL.Layout(None, "rowpad", pad=(8, 0)))
    if name == "leadpad":               # pads the leading axis of a rank 3
        return (RC.Layout(None, "leadpad", pad=(2, 0, 0)),
                PL.Layout(None, "leadpad", pad=(2, 0, 0)))
    return RC.by_name(name), PL.by_name(name)


def _case(cases, name, backend="auto", d_buf=9):
    src, dst, chain, shape, dtype = cases[name]
    (rs, ps), (rd, pd) = _layouts(src), _layouts(dst)
    ref = RC.XDMADescriptor(src=RC.Endpoint.local(rs), dst=RC.Endpoint.local(rd),
                            pre=chain(RP, shape), d_buf=d_buf, backend=backend)
    zero = 8 if "compress" in name else 0
    x = _x(shape, seed=3, zero_rows=zero, dtype=dtype)
    xin = np.asarray(rs.from_logical(jnp.asarray(x)))
    return ref, port_desc(ref), xin


def _tol(desc, dtype):
    half = np.dtype(dtype).itemsize < 4
    return dict(rtol=2e-2, atol=1e-2) if half else O.chain_tolerance(desc)


def _exact(name):
    return not any(k in name for k in ("rmsnorm", "sum", "scale", "cast",
                                       "hypothesis"))


# -- policy parity -------------------------------------------------------------
@pytest.mark.parametrize("chain", [(), ("rmsnorm",), ("quantize",),
                                   ("transpose", "quantize"),
                                   ("gather", "reduce")])
def test_can_fuse_matches_reference(chain):
    def build(M):
        made = {"rmsnorm": M.RMSNormPlugin(), "quantize": M.Quantize(),
                "transpose": M.Transpose(), "reduce": M.ReduceStage(),
                "gather": M.GatherScatter(indices=np.arange(8))}
        return tuple(made[c] for c in chain)
    ref = RC.describe("MN", "MN", *build(RP))
    assert ppc.can_fuse(port_desc(ref)) == rpc.can_fuse(ref)


@pytest.mark.parametrize("src,dst", [("MN", "MNM8N128"), ("MNM16N128", "MN"),
                                     ("MNM8N128", "MNM32N128"),
                                     ("MNP64", "MN")])
@pytest.mark.parametrize("m,d_buf", [(128, 9), (96, 3), (256, 1), (24, 5)])
def test_burst_rows_match_reference(src, dst, m, d_buf):
    want = rpc._burst_rows((), RC.by_name(src), RC.by_name(dst), m, d_buf)
    got = ppc._burst_rows((), PL.by_name(src), PL.by_name(dst), m, d_buf)
    assert got == want


@pytest.mark.parametrize("name", sorted(STREAMED_CASES) + sorted(BLOCK_CASES))
def test_template_choice(name):
    cases = STREAMED_CASES if name in STREAMED_CASES else BLOCK_CASES
    _, desc, xin = _case(cases, name)
    fn = ppc.compile_local(desc)
    fn(to_torch(xin))
    (prog,) = fn.kernels.values()
    want = DP.StreamedDatapath if cases is STREAMED_CASES else DP.BlockDatapath
    assert type(prog) is want


# -- value parity vs the reference ----------------------------------------------
@pytest.mark.parametrize("backend", ["auto", "compiled"])
@pytest.mark.parametrize("name", sorted(STREAMED_CASES) + sorted(BLOCK_CASES))
def test_chain_matches_reference(name, backend):
    cases = STREAMED_CASES if name in STREAMED_CASES else BLOCK_CASES
    ref, desc, xin = _case(cases, name, backend=backend)
    if name == "scale_bias_vectors":
        # the reference's Pallas kernels refuse vector constants (their
        # kernel bodies capture them); its fused composition is the same
        # function
        ref = dataclasses.replace(ref, backend="fused")
    want = rx.transfer(jnp.asarray(xin), ref)
    got = px.transfer(to_torch(xin), desc)
    tol = _tol(ref, xin.dtype)
    if name == "hypothesis_case":
        # the reference's bf16 row sum is one bf16 ulp off the oracle's
        # (ROADMAP.md §3); the port agrees with the oracle
        tol = dict(rtol=2 ** -6, atol=0.125)
    if _exact(name):
        assert_same_payload(got, want, context=name)
    else:
        assert_same_payload(got, want, context=name, **tol)


@pytest.mark.parametrize("name", sorted(STREAMED_CASES) + sorted(
    set(BLOCK_CASES) - {"gather_fill"}))          # the oracle has no fill
def test_chain_matches_oracle(name):
    cases = STREAMED_CASES if name in STREAMED_CASES else BLOCK_CASES
    ref, desc, xin = _case(cases, name)
    want = O.oracle_transfer(xin, ref)
    got = px.transfer(to_torch(xin), desc)
    if isinstance(want, O.OCTensor):
        np.testing.assert_array_equal(bits(got.mask), bits(want.mask))
        got, want = got.values, want.values
    tol = _tol(ref, xin.dtype)
    if name == "hypothesis_case":
        # bf16 sums of 128 rows: the oracle and the port both accumulate in
        # f32; one bf16 ulp of the result is 2^-8 relative
        tol = dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(to_f32(got), np.asarray(want, np.float32),
                               **tol)


def test_hypothesis_case_against_reference_and_oracle():
    """The example Hypothesis stored against the reference (local MN->MN,
    cast_bf16 -> scale -> reduce_sum, 128x128, d_buf=1): the reference sums
    bf16 rows differently from the oracle; the port accumulates in f32 and
    rounds once, which is what the oracle does."""
    case = TD.DescCase(kind="local", m=128, n=128, src="MN", dst="MN",
                       segments=("cast_bf16", "scale"), terminal="reduce_sum",
                       split=0, d_buf=1, seed=0)
    x, ref = case.build()
    desc = port_desc(ref)
    xin = np.asarray(x)
    got = to_f32(px.transfer(to_torch(xin), desc))
    want_ref = np.asarray(rx.transfer(x, ref), np.float32)
    want_oracle = np.asarray(O.oracle_transfer(xin, ref), np.float32)
    port_vs_oracle = np.abs(got - want_oracle).max()
    ref_vs_oracle = np.abs(want_ref - want_oracle).max()
    # one bf16 ulp of a sum near 16..32 is 0.125
    assert port_vs_oracle <= ref_vs_oracle
    np.testing.assert_allclose(got, want_oracle, rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(got, want_ref, rtol=2 ** -6, atol=0.125)


_jit_quantize = jax.jit(lambda v: RP.Quantize()(v))


def _assert_quantize_bitwise(x, ref, desc, got, tol, context):
    """A chain ending in Quantize: the int8 values and f32 scales are bitwise
    the reference's jitted Quantize (what its "auto" and "fused" backends
    run) of the stream that reaches it, and that stream is the reference's
    within the chain tolerance.  The stream itself is not bitwise: under jit
    XLA contracts a Scale followed by a BiasAdd into one fused multiply-add,
    which the port (and the oracle) round twice."""
    assert isinstance(ref.plugins[-1], RP.Quantize), context
    head = dataclasses.replace(ref, plugins=(), pre=(),
                               post=tuple(ref.plugins[:-1]), backend="fused")
    stream = PP.apply_chain(desc.plugins[:-1],
                            desc.src_layout.to_logical(to_torch(np.asarray(x))))
    want_stream = RC.xdma_copy_jit(x, dataclasses.replace(
        head, dst=RC.Endpoint.local(RC.MN)))
    np.testing.assert_allclose(to_f32(stream), to_f32(want_stream),
                               err_msg=context, **tol)
    crossed = stream.numpy() if stream.dtype != torch.bfloat16 else \
        stream.view(torch.int16).numpy().view(jnp.bfloat16)
    want = _jit_quantize(jnp.asarray(crossed))
    np.testing.assert_array_equal(
        bits(got.values), bits(ref.dst_layout.from_logical(want.values)),
        err_msg=context)
    np.testing.assert_array_equal(bits(got.scales), bits(want.scales),
                                  err_msg=context)


@pytest.mark.parametrize("i", range(10))
def test_seeded_local_sweep_matches_reference(i):
    rng = np.random.default_rng(1000 + i)
    case = TD.make_case(rng, kind="local")
    x, ref = case.build()
    desc = port_desc(ref)
    want = rx.transfer(x, ref)
    got = px.transfer(to_torch(np.asarray(x)), desc)
    tol = O.chain_tolerance(ref)
    if any(isinstance(p, RP.ReduceStage) and p.op == "sum" for p in ref.pre):
        tol = dict(rtol=2e-2, atol=2e-2) if tol["rtol"] > 1e-4 else \
            dict(rtol=1e-4, atol=1e-4)
    if isinstance(want, RP.QTensor):
        _assert_quantize_bitwise(x, ref, desc, got, tol, repr(case))
        return
    assert_same_payload(got, want, context=repr(case), **tol)


def test_cfg_stats_match_reference_after_the_same_sequence():
    rpc.clear_stats()
    ppc.clear_stats()
    names = sorted(set(STREAMED_CASES) - {"scale_bias_vectors"})
    for name in names + sorted(BLOCK_CASES):
        cases = STREAMED_CASES if name in STREAMED_CASES else BLOCK_CASES
        ref, desc, xin = _case(cases, name)
        rx.transfer(jnp.asarray(xin), ref)
        px.transfer(to_torch(xin), desc)
    for ref in (RC.describe("MN", "MNM8N128"),
                RC.describe("MN", "MN", RP.Quantize())):
        xin = jnp.asarray(_x((64, 256)))
        rx.transfer(xin, ref)
        px.transfer(to_torch(np.asarray(xin)), port_desc(ref))
    assert ppc.cfg_stats() == rpc.cfg_stats()
    assert ppc.cfg_stats()["reasons"] == {"empty-chain": 1,
                                          "no-emit:quantize_int8": 1}


def test_compile_local_refuses_a_non_fusible_chain():
    desc = port_desc(RC.describe("MN", "MN", RP.Quantize()))
    with pytest.raises(ValueError, match="no-emit:quantize_int8"):
        ppc.compile_local(desc)


def test_decompress_without_compress_raises():
    prog = DP.BlockDatapath((PP.Decompress(),), PL.MN, PL.MN, (16, 32),
                            torch.float32)
    with pytest.raises(ValueError, match="Decompress"):
        prog._compile("cpu")


# The chains the reference's ``compiled`` backend runs that kernels 2 and 3
# once refused (ROADMAP §3, fault 1): integer streams, more than 8 streamed
# ops, logical rank above 4.  Integer outputs are held bitwise, float ones
# within the oracle's chain tolerance.
FAULT1_CASES = {
    "gather_int8": ("MN", "MN", lambda M: (
        M.GatherScatter(indices=_perm(64, 3)),), (64, 128), np.int8),
    "transpose_int32": ("MN", "MNM8N128", lambda M: (M.Transpose(),),
                        (128, 256), np.int32),
    "nine_scales": ("MN", "MNM8N128", lambda M: tuple(
        M.Scale(1.0 + k / 64) for k in range(9)), (64, 256), np.float32),
    "scale_rank5": ("MN", "MN", lambda M: (M.Scale(2.5),),
                    (2, 2, 2, 8, 128), np.float32),
    # integer arithmetic follows jnp's promotion: the constant cast to the
    # stream dtype, int8 wrapping, jnp.sum widening int8 to int32
    "int_arith_sum": ("MN", "MN", lambda M: (
        M.Scale(3), M.BiasAdd(-7), M.ReduceStage("sum")), (64, 128), np.int8),
    "int_to_float_cast": ("MN", "MNM8N128", lambda M: (
        M.Transpose(), M.Cast(jnp.float32 if M is RP else torch.float32),
        M.Scale(0.5)), (128, 256), np.int32),
}


def _fault1(name):
    src, dst, chain, shape, dtype = FAULT1_CASES[name]
    rng = np.random.default_rng(21)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, shape, endpoint=True).astype(dtype)
    else:
        x = rng.standard_normal(shape).astype(dtype)
    ref = RC.describe(src, dst, *chain(RP), backend="compiled")
    return ref, port_desc(ref), x


@pytest.mark.parametrize("name", sorted(FAULT1_CASES))
def test_fault1_cases_match_reference_compiled(name):
    ref, desc, xin = _fault1(name)
    want = rx.transfer(jnp.asarray(xin), ref)
    got = px.transfer(to_torch(xin), desc)
    if np.issubdtype(np.asarray(want).dtype, np.integer):
        assert_same_payload(got, want, context=name)
    else:
        assert_same_payload(got, want, context=name, **_tol(ref, xin.dtype))


@pytest.mark.parametrize("name", sorted(FAULT1_CASES))
def test_fault1_cases_compile_for_the_kernels(name):
    """The kernels' host code takes every case: the program the port
    compiles for it prepares its launches (stage lists, segments, paths)."""
    _, desc, xin = _fault1(name)
    fn = ppc.compile_local(desc)
    fn(to_torch(xin))
    (prog,) = fn.kernels.values()
    block = prog if isinstance(prog, DP.BlockDatapath) else prog._block
    if block is None:                       # kernel 2, in parts of <= 8 ops
        parts = prog._parts or [prog]
        assert sum(len(p.chain) for p in parts) == len(desc.plugins)
        assert all(len(p.chain) <= DP._MAX_OPS for p in parts)
        for p in parts:
            p._prepare("cpu")
        return
    stages = block._compile("cpu")
    for lo, hi in block._segments(stages):
        floats = {st.dtype.is_floating_point for st in stages[lo:hi]}
        assert len(floats) <= 1, "a launch carries one kind of value"


def test_kernels_refuse_integer_streams(monkeypatch):
    """The kernels refuse no stream the reference's datapath takes: the
    int8 gather and a bool transpose are bitwise the reference's
    ``compiled`` backend, each on kernel 3's rank-2 path (a word copy, here
    emulated over the arguments the host prepares).  float64, of which the
    reference has no stream (JAX runs with x64 off), is still refused, and
    the refusal says so."""
    ref, desc, xin = _fault1("gather_int8")
    want = rx.transfer(jnp.asarray(xin), ref)
    got = px.transfer(to_torch(xin), desc)
    np.testing.assert_array_equal(bits(got), bits(want))
    prog = DP.BlockDatapath(desc.plugins, PL.MN, PL.MN, xin.shape, torch.int8)
    stages = prog._compile("cpu")
    assert [DP.rank2_path(stages[lo:hi], 2, torch.int8)
            for lo, hi in prog._segments(stages)] == [True]
    xb = np.random.default_rng(5).random((16, 32)) < 0.5
    ref = RC.describe("MN", "MN", RP.Transpose(), backend="compiled")
    want = rx.transfer(jnp.asarray(xb), ref)
    assert_same_payload(px.transfer(to_torch(xb), port_desc(ref)), want)
    emu = _Emulated(_emulate_block)
    monkeypatch.setattr(DP, "BLOCK", emu)
    prog = DP.BlockDatapath((PP.Transpose(),), PL.MN, PL.MN, (16, 32),
                            torch.bool)
    assert_same_payload(prog.launch(to_torch(xb)), want)
    assert emu.paths == {"rank2": 1}
    prog = DP.BlockDatapath((PP.Transpose(),), PL.MN, PL.MN, (16, 32),
                            torch.float64)
    with pytest.raises(NotImplementedError, match="no float64 stream"):
        prog._compile("cpu")


def test_gather_follows_jnp_take_out_of_range():
    idx = np.array([3, -1, 9, -12])
    x = _x((8, 16))
    want = np.asarray(RP.GatherScatter(indices=idx)(jnp.asarray(x)))
    got = PP.GatherScatter(indices=idx)(to_torch(x))
    np.testing.assert_array_equal(bits(got), bits(want))


# -- kernel emulators: the CUDA arithmetic over the same memory ----------------
_F32, _BF16, _F16 = 0, 1, 2
_CODE_DTYPE = {code: dt for dt, code in {**DP.maps.DTYPE_CODES,
                                         **DP.maps.INT_CODES}.items()}
_SIZE = {code: dt.itemsize for code, dt in _CODE_DTYPE.items()}
_BOOL = DP.maps.INT_CODES[torch.bool]
_FLOAT8 = {DP.maps.INT_CODES[torch.float8_e4m3fn]: ml_dtypes.float8_e4m3fn,
           DP.maps.INT_CODES[torch.float8_e5m2]: ml_dtypes.float8_e5m2}
# the integer codes' (bits, signed)
_INT_RANGE = {DP.maps.INT_CODES[dt]: (8 * dt.itemsize, dt.is_signed)
              for dt in DP.maps.INT_CODES
              if not dt.is_floating_point and dt != torch.bool}


def _round(v, dt):
    """``round_c`` in the f32 carrier."""
    v = np.float32(v)
    if dt == _BF16:
        b = np.array([v], np.float32).view(np.uint32)
        b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
            & np.uint32(0xFFFF0000)
        return b.view(np.float32)[0]
    if dt == _F16:
        return np.float32(np.float16(v))
    if dt in _FLOAT8:
        return np.float32(np.array(v).astype(_FLOAT8[dt]))
    if dt == _BOOL:
        return np.float32(1.0 if v != 0 else 0.0)
    return v


def _wrap(v, dt):
    """``wrap_to``: an int64 carrier value in the width of dtype code
    ``dt``."""
    if dt == _BOOL:
        return int(v != 0)
    width, signed = _INT_RANGE[dt]
    v = int(v) % (1 << width)
    return v - (1 << width) if signed and v >> (width - 1) else v


def _at(ctype, addr):
    return ctype.from_address(int(addr))


def _load(addr, i, dt, ints=False):
    """``from_raw``: element ``i`` of dtype code ``dt`` at ``addr`` in the
    f32 carrier, or with ``ints`` the int64 one (a float toward zero)."""
    n = _SIZE[dt]
    word = int.from_bytes(ctypes.string_at(int(addr) + n * i, n), "little")
    if dt == _F32:
        f = np.array([word], np.uint32).view(np.float32)[0]
    elif dt == _BF16:
        f = np.array([word << 16], np.uint32).view(np.float32)[0]
    elif dt == _F16:
        f = np.float32(np.array([word], np.uint16).view(np.float16)[0])
    elif dt in _FLOAT8:
        f = np.float32(np.array([word], np.uint8).view(_FLOAT8[dt])[0])
    else:
        width, signed = _INT_RANGE.get(dt, (8, False))     # bool: 0 or 1
        v = word - (1 << width) if signed and word >> (width - 1) else word
        return v if ints else np.float32(v)
    if not ints:
        return np.float32(f)
    return -2 ** 63 if not abs(f) < 2.0 ** 63 else int(np.trunc(f))


def _made_by_cast(a):
    """``put_narrow``'s ``cast``: the launch's last stage is a Cast."""
    return a.nstages > 0 and a.st[a.nstages - 1].code == DP._ST_CAST


def _store_all(addr, values, dt, cast=False):
    """``store_group`` of every element: f32 carrier values rounded to dtype
    code ``dt`` (a float8 as ``plugins.to_float8`` rounds it, a Cast's NaN
    with ``cast``), or int64 ones already in its range."""
    values = np.asarray(values)
    target = _CODE_DTYPE[dt]
    if values.dtype == np.int64:
        t = torch.from_numpy(values.copy()).to(target)
    else:
        f = torch.from_numpy(np.asarray(values, np.float32))
        t = PP.to_float8(f, target, cast) if dt in _FLOAT8 else f.to(target)
    t = t.contiguous()
    ctypes.memmove(addr, t.data_ptr(), t.numel() * t.element_size())


def _f32_at(addr, i):
    return np.float32(_at(ctypes.c_float, addr + 4 * i).value)


def _dim_off(m, i):
    return (i // m.tile) * m.sgrid + (i % m.tile) * m.stile


class _Emulated:
    """Stands in for a Kernel: emulates the launch, counts it (and its path,
    as ``Kernel.paths`` does)."""

    def __init__(self, fn):
        self.fn, self.launches, self.name = fn, 0, "emulated"
        self.paths = {}

    def __call__(self, *args, path=None):
        self.fn(*args)
        self.launches += 1
        if path is not None:
            self.paths[path] = self.paths.get(path, 0) + 1


class _BlockEmu:
    """csrc/block_datapath.cu's generic path, one element at a time: a
    coordinate is [the leading axes' linear index, the row, the column],
    walked back through the host's list of index stages to a source offset
    (or a gather's fill); the host's list of value stages then runs
    forward, a stage that reads its coordinate walking the output's back
    through the index stages after it."""

    def __init__(self, a, src):
        self.a, self.src = a, src
        self.ints = a.carrier == 1          # the int64 carrier, else f32

    def rnd(self, v, dt):
        """``round_c``: the f32 carrier leaves a bool or float8 value to
        the store (the host ends the launch at its stage)."""
        if self.ints:
            return _wrap(v, dt)
        return v if dt == _BOOL or dt in _FLOAT8 else _round(v, dt)

    def konst(self, st, j):
        if self.ints:
            return (_at(ctypes.c_int64, st.vec + 8 * j).value if st.vec
                    else int(st.a))
        return _f32_at(st.vec, j) if st.vec else np.float32(st.a)

    def fill(self, dt):
        """``fill_of``: jnp.take's fill in the carrier."""
        if not self.ints:
            return np.float32(np.nan)
        return _load(ctypes.addressof(ctypes.c_int64(
            PP.fill_word(_CODE_DTYPE[dt]))), 0, dt, True)

    def walk_back(self, lo, hi, c):
        for s in reversed([self.a.walk[w] for w in range(self.a.nwalk)]):
            if not lo <= s < hi:
                continue
            st = self.a.st[s]
            if st.code == DP._ST_TRANSPOSE:
                c[1], c[2] = c[2], c[1]
                continue
            assert st.code == DP._ST_GATHER
            if st.where == 0:
                mid, low = divmod(c[0], st.inner)
                high, q = divmod(mid, st.ext_out)
                j = _at(ctypes.c_int64, st.aux + 8 * q).value
                if j < 0:
                    return s
                c[0] = (high * st.ext_in + j) * st.inner + low
            else:
                j = _at(ctypes.c_int64, st.aux + 8 * c[st.where]).value
                if j < 0:
                    return s
                c[st.where] = j
        return -1

    def apply(self, st, v, c):
        if st.code == DP._ST_CAST:
            return self.rnd(v, st.dtype)
        if st.code == DP._ST_SCALE:
            return self.rnd(v * self.konst(st, c[2]), st.dtype)
        if st.code == DP._ST_BIAS:
            return self.rnd(v + self.konst(st, c[2]), st.dtype)
        if st.code == DP._ST_RMSNORM:       # in f32
            y = np.float32(np.float32(v)
                           * _f32_at(st.aux, c[0] * st.rows + c[1]))
            if st.vec:
                y = np.float32(y * _f32_at(st.vec, c[2]))
            if self.ints:
                y = -2 ** 63 if not abs(y) < 2.0 ** 63 else int(np.trunc(y))
            return self.rnd(y, st.dtype)
        assert st.code == DP._ST_DECOMPRESS
        m = c[0] * st.nb + c[1] // st.block_rows
        keep = _at(ctypes.c_uint8, st.aux + m).value != 0
        one = int(keep) if self.ints else np.float32(1.0 if keep else 0.0)
        return self.rnd(v * one, st.dtype)

    def apply_forward(self, lo, hi, c, fill, v):
        """The value stages of [lo, hi) after the fill stage, in order."""
        for s in [self.a.value[w] for w in range(self.a.nvalue)]:
            dt = self.a.st[s].dtype
            assert self.ints or not (dt == _BOOL or dt in _FLOAT8) \
                or s == self.a.nstages - 1, "a narrow value before the store"
            if lo <= s < hi and s > fill:
                cs = list(c)
                assert self.walk_back(s + 1, hi, cs) < 0
                v = self.apply(self.a.st[s], v, cs)
        return v

    def src_offset(self, c):
        a, n = self.a, self.a.nlead
        off = _dim_off(a.src[n], c[1]) + _dim_off(a.src[n + 1], c[2])
        rem = c[0]
        for d in range(n - 1, -1, -1):
            rem, i = divmod(rem, a.lext[d])
            off += _dim_off(a.src[d], i)
        assert not a.index32 or off < DP._INDEX32
        return off

    def eval_plain(self, k, c):
        cw = list(c)
        fill = self.walk_back(0, k, cw)
        if fill >= 0:
            v = self.fill(self.a.st[fill].dtype)
        else:
            v = _load(self.src, self.src_offset(cw), self.a.in_dtype,
                      self.ints)
        return self.apply_forward(0, k, c, fill, v)

    def eval(self, k, c):
        R = self.a.reduce_at
        if R < 0 or R >= k:
            return self.eval_plain(k, c)
        cw = list(c)
        fill = self.walk_back(R + 1, k, cw)
        if fill >= 0:
            v = self.fill(self.a.st[fill].dtype)
        else:
            st = self.a.st[R]
            lead = cw[0] if st.keepdims else cw[0] * st.out_rows + cw[1]
            row = lambda r: self.eval_plain(R, [lead, r, cw[2]])  # noqa: E731
            total = st.code == DP._ST_REDUCE_SUM
            if self.ints:
                xs = [row(r) for r in range(st.rows)]
                acc = sum(xs) if total else max(xs, default=-2 ** 63)
            elif total and st.dtype in _FLOAT8:
                acc = _ordered_sum(st.rows, st.dtype, row)
            else:
                acc = np.float32(0.0 if total else -np.inf)
                for r in range(st.rows):
                    x = row(r)
                    if total:
                        acc = np.float32(acc + x)
                    elif not (acc != acc or x <= acc):
                        acc = x
            v = self.rnd(acc, st.dtype)
        return self.apply_forward(R + 1, k, c, fill, v)


def _ordered_sum(n, dt, row):
    """``ordered_sum``: a float8 sum in the reference's order, one thread
    walking the rows and closing each window of 32 as its last row passes
    (each addition rounded to float8)."""
    ext, low, m = [], [], n
    while m >= 32:
        k = -(-m // 32)
        ext.append(m)
        low.append((k * 32 - m) // 2)
        m = k
    acc = [np.float32(0.0)] * (len(ext) + 1)
    for i in range(n):
        acc[0] = _round(acc[0] + row(i), dt)
        e = i
        for j in range(len(ext)):
            w = e + low[j]
            if e != ext[j] - 1 and w % 32 != 31:
                break
            acc[j + 1] = _round(acc[j + 1] + acc[j], dt)
            acc[j] = np.float32(0.0)
            e = w // 32
    return acc[-1]


# -- kernel 3's rank-2 path, vectorized over the pass's space ------------------
_NP = {_F32: np.float32, _BF16: np.uint16, _F16: np.float16}


def _round_arr(v, dt):
    v = np.asarray(v, np.float32)
    if dt == _BF16:
        b = v.view(np.uint32)
        b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
            & np.uint32(0xFFFF0000)
        return np.where(np.isnan(v), v, b.view(np.float32))
    if dt == _F16:
        return v.astype(np.float16).astype(np.float32)
    return v


def _floats(addr, n, dt):
    """``n`` elements of dtype code ``dt`` at ``addr`` as float32."""
    if n == 0:
        return np.zeros(0, np.float32)
    raw = np.ctypeslib.as_array((ctypes.c_uint8 * (n * _SIZE[dt]))
                                .from_address(int(addr))).view(_NP[dt])
    if dt == _BF16:
        return (raw.astype(np.uint32) << np.uint32(16)).view(np.float32)
    return raw.astype(np.float32)


def _vec(addr, idx):
    return _floats(addr, int(np.max(idx)) + 1, _F32)[idx]


def _apply2(st, v, r, c):
    """``apply_item`` of csrc/block_datapath.cu on arrays."""
    i, j = (c, r) if st.swap else (r, c)
    if st.code == DP._ST_CAST:
        return _round_arr(v, st.dtype)
    if st.code in (DP._ST_SCALE, DP._ST_BIAS):
        k = _vec(st.vec, j) if st.vec else np.float32(st.a)
        y = v * k if st.code == DP._ST_SCALE else v + k
        return _round_arr(y, st.dtype)
    if st.code == DP._ST_RMSNORM:
        y = (v * _vec(st.aux, i)).astype(np.float32)
        if st.vec:
            y = (y * _vec(st.vec, j)).astype(np.float32)
        return _round_arr(y, st.dtype)
    if st.code == DP._ST_DECOMPRESS:
        b = i // st.block_rows
        mask = np.ctypeslib.as_array((ctypes.c_uint8 * (int(b.max()) + 1))
                                     .from_address(st.aux))[b]
        return _round_arr(v * np.where(mask != 0, np.float32(1),
                                       np.float32(0)), st.dtype)
    return v


def _run2(stages, v, start, r, c):
    """The Values policy: stages [start, len(stages)) per element, in
    order."""
    v = np.asarray(v, np.float32).copy()
    for s, st in enumerate(stages):
        on = start <= s
        if on.any():
            v[on] = _apply2(st, v[on], r[on], c[on])
    return v


def _lead_at(a, b):
    """``lead_at``: leading index b's flat index, source and destination
    offsets (the source's 0 where a gather failed) and fill code."""
    flat, so, do, code = b, 0, 0, 0
    for d in range(a.nlead - 1, -1, -1):
        ld = a.lead[d]
        b, i = divmod(b, ld.extent)
        o = int(P2._term(ld.src, np.array([i]))[0])
        if o < 0:
            code = min(code, o)
        else:
            so += o
        do += _dim_off(ld.dst, i)
    return flat, (0 if code < 0 else so), do, code


def _stages_at(a, flat):
    """``stages_to_shared``: the pass's stages, each per-row buffer offset
    to leading index ``flat``."""
    out = []
    for s in range(a.nstages):
        st = DP._Stage2.from_buffer_copy(a.st[s])
        st.aux += flat * st.aux_step
        out.append(st)
    return out


def _pass_offsets(t, src_base=0, lead_code=0):
    r, c = np.broadcast_arrays(np.arange(t.rows)[:, None],
                               np.arange(t.cols)[None, :])
    sr, sc = P2._term(t.src_r, r), P2._term(t.src_c, c)
    so = np.where((sr < 0) | (sc < 0), np.minimum(sr, sc), sr + sc + src_base)
    if lead_code < 0:
        so = np.minimum(np.where(so < 0, so, 0), lead_code)
    return r, c, so


def _pass_values(a, stages, src, src_base, lead_code):
    """Every value of one leading index's (rows, cols) pass space."""
    t = a.t
    r, c, so = _pass_offsets(t, src_base, lead_code)
    if t.load_axis == 1 and t.vs > 1:
        inside = np.ones(r.shape, bool)
        P2._check_packs(so, 1, t.vs, inside, so >= 0)
    ok = so >= 0
    x = _floats(src, int(so.max()) + 1 if ok.any() else 0, a.dtype)
    v = np.full(r.shape, np.nan, np.float32)
    v[ok] = x[so[ok]]
    start = np.where(ok, 0, -so)
    return _run2(stages, v, start, r, c).reshape(r.shape)


_WORD = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _src_top(a, leads):
    """Source elements the batched pass reaches."""
    tops = [0]
    for _, so, _, code in leads:
        r, c, off = _pass_offsets(a.t, so, code)
        if (off >= 0).any():
            tops.append(int(off.max()) + 1)
    return max(tops)


def _emulate_rank2(args_addr, src, dst, mode):
    a = DP._Rank2Args.from_address(args_addr)
    t = a.t
    dm = lambda m, i: (i // m.tile) * m.sgrid + (i % m.tile) * m.stile
    leads = [_lead_at(a, b) for b in range(a.batch)]
    span = int(dm(t.dst_r, np.arange(t.prows)).max()
               + dm(t.dst_c, np.arange(t.pcols)).max()) + 1
    top = max(do for _, _, do, _ in leads) + span
    written = np.zeros(top, np.int64)
    if mode in (DP._MODE_COPY2, DP._MODE_OUT2):
        n = _SIZE[a.dtype]
        word = _WORD[n]
        raw = np.ctypeslib.as_array((ctypes.c_uint8 * (_src_top(a, leads) * n))
                                    .from_address(src)).view(word)
        if mode == DP._MODE_COPY2:
            out = np.zeros(top, word)
            fill = word(a.fill_bits & ((1 << 8 * n) - 1))
            for flat, so, do, code in leads:
                P2.emulate_tile2(t, raw, top, fill=lambda code, r, c: fill,
                                 out=out, src_base=so, dst_base=do,
                                 lead_code=code, written=written)
            ctypes.memmove(dst, out.ctypes.data, out.nbytes)
        else:
            x = _floats(raw.ctypes.data, raw.size, a.dtype)
            out = np.zeros(top, np.float32)
            for flat, so, do, code in leads:
                st = _stages_at(a, flat)
                P2.emulate_tile2(
                    t, x, top,
                    value=lambda v, r, c: _run2(st, v, np.zeros_like(r), r, c),
                    fill=lambda code, r, c: _run2(
                        st, np.full(r.shape, np.nan, np.float32), -code, r, c),
                    out=out, src_base=so, dst_base=do, lead_code=code,
                    written=written)
            _store_all(dst, out, a.dtype)
        assert (written == 1).all(), "a destination word not written once"
        return
    vals = np.zeros(top, np.float32)
    for flat, so, do, code in leads:
        v = _pass_values(a, _stages_at(a, flat), src, so, code)
        if mode == DP._MODE_STAT2:
            ss = (v * v).astype(np.float32).sum(-1, dtype=np.float32)
            inv = (np.float32(1) / np.sqrt(
                ss / np.float32(t.cols) + np.float32(a.eps))).astype(np.float32)
            ctypes.memmove(a.out + 4 * flat * t.rows, inv.ctypes.data,
                           inv.nbytes)
        elif mode == DP._MODE_MASK2:
            nb = t.rows // a.block_rows
            any_ = (v != 0).reshape(-1, a.block_rows * t.cols).any(-1)
            hit = any_.astype(np.uint8)
            ctypes.memmove(a.out + flat * nb, hit.ctypes.data, hit.nbytes)
        else:                                   # REDUCE
            assert a.splits >= 1 and a.op in (DP._ST_REDUCE_SUM,
                                              DP._ST_REDUCE_MAX)
            if a.op == DP._ST_REDUCE_SUM:
                red = v.sum(0, dtype=np.float32)
            else:
                red = np.where(np.isnan(v).any(0), np.float32(np.nan),
                               v.max(0))
            rows, cols = np.broadcast_arrays(np.arange(t.prows)[:, None],
                                             np.arange(t.pcols)[None, :])
            at = do + dm(t.dst_r, rows) + dm(t.dst_c, cols)
            np.add.at(written, at.ravel(), 1)
            vals[at] = 0
            vals[do + dm(t.dst_r, 0) + dm(t.dst_c, np.arange(t.cols))] = \
                _round_arr(red, a.dtype)
    if mode == DP._MODE_REDUCE2:
        assert (written == 1).all(), "a destination word not written once"
        _store_all(dst, vals, a.dtype)


def _decode_dims(a, q, top):
    """``decode_dims``: the coordinate physical dims [0, top] add at index
    q, and whether one of them lies in stride padding."""
    base, pad = [0, 0, 0], False
    for kk in range(top, -1, -1):
        q, i = divmod(q, a.pext[kk])
        pad |= i >= a.plim[kk]
        base[a.pslot[kk]] += i * a.pw[kk]
    return base, pad


def _emulate_tiled(a, emu, dst):
    """``out_tiled_kernel``: tile t of the dst's last two physical dims, each
    element evaluated at its coordinate and written once."""
    last, T = a.nphys - 1, DP._TILE
    assert a.index32 and a.reduce_at < 0 and a.per_thread == 1 and last >= 1
    ec, er = a.pext[last], a.pext[last - 1]
    tc = (ec + T - 1) // T
    per = (er + T - 1) // T * tc
    assert a.total % (er * ec) == 0
    vals = np.zeros(a.total, np.int64 if emu.ints else np.float32)
    written = np.zeros(a.total, np.int64)
    for t in range(a.total // (er * ec) * per):
        q, rest = divmod(t, per)
        ti, tj = divmod(rest, tc)
        base, pad = _decode_dims(a, q, last - 2)
        for r in range(ti * T, min(ti * T + T, er)):
            for j in range(tj * T, min(tj * T + T, ec)):
                p = q * er * ec + r * ec + j
                assert not a.index32 or p < DP._INDEX32
                written[p] += 1
                if pad or r >= a.plim[last - 1] or j >= a.plim[last]:
                    continue
                c = list(base)
                c[a.pslot[last - 1]] += r * a.pw[last - 1]
                c[a.pslot[last]] += j * a.pw[last]
                vals[p] = emu.eval(a.upto, c)
    assert (written == 1).all(), "a destination element not written once"
    _store_all(dst, vals, a.out_dtype, _made_by_cast(a))


def _emulate_block(args_addr, src, dst, mode):
    if mode >= DP._MODE_OUT2:
        return _emulate_rank2(args_addr, src, dst, mode)
    a = DP._BlockArgs.from_address(args_addr)
    emu = _BlockEmu(a, src)
    k = a.upto
    if mode == DP._MODE_OUT and a.tiled:
        return _emulate_tiled(a, emu, dst)
    if mode == DP._MODE_OUT:
        E, last = a.per_thread, a.nphys - 1
        assert a.total % E == 0 and (a.reduce_at < 0 or E == 1)
        assert a.pext[last] % E == 0
        assert E <= DP._PER_THREAD
        if E == DP._PER_THREAD:
            assert dst % (E * _SIZE[a.out_dtype]) == 0, "an unaligned pack"
        vals = np.zeros(a.total, np.int64 if emu.ints else np.float32)
        for g in range(a.total // E):
            p0 = g * E
            assert not a.index32 or p0 + E <= DP._INDEX32
            q, inner = divmod(p0, a.pext[last])
            base, pad = _decode_dims(a, q, last - 1)
            for e in range(E):
                i = inner + e
                if pad or i >= a.plim[last]:
                    continue
                c = list(base)
                c[a.pslot[last]] += i * a.pw[last]
                vals[p0 + e] = emu.eval(k, c)
        _store_all(dst, vals, a.out_dtype, _made_by_cast(a))
        return
    st = a.st[k]
    R = a.reduce_at      # the kernel's eval sums no float8 in order
    assert not (0 <= R < k and a.st[R].code == DP._ST_REDUCE_SUM
                and a.st[R].dtype in _FLOAT8), "a float8 sum before a pass"
    if mode == DP._MODE_STAT:
        for row in range(a.total):
            lead, i = divmod(row, st.rows)
            ss = np.float32(0.0)
            for j in range(st.cols):
                v = np.float32(emu.eval(k, [lead, i, j]))
                ss = np.float32(ss + v * v)
            inv = np.float32(1.0) / np.sqrt(np.float32(
                ss / np.float32(st.cols) + np.float32(st.a)))
            _at(ctypes.c_float, st.aux + 4 * row).value = inv
        return
    nb = st.rows // st.block_rows
    for e in range(a.total):
        lead, blk = divmod(e, nb)
        hit = 0
        for t in range(st.block_rows * st.cols):
            r, j = divmod(t, st.cols)
            if emu.eval(k, [lead, blk * st.block_rows + r, j]) != 0:
                hit = 1
                break
        _at(ctypes.c_uint8, st.aux + e).value = hit


_EMU_SHAPES = {(64, 256): (16, 128), (32, 384): (16, 128),
               (128, 256): (32, 128), (8, 32, 256): (4, 8, 128),
               (128, 128): (32, 128)}


def _emulation_input(cases, name):
    src, dst, chain, shape, dtype = cases[name]
    shape = _EMU_SHAPES[shape]
    (_, ps), (_, pd) = _layouts(src), _layouts(dst)
    x = _x(shape, seed=9, zero_rows=8 if "compress" in name else 0,
           dtype=dtype)
    return ps.from_logical(to_torch(x)), chain(PP, shape), ps, pd


# -- kernel 2: csrc/streamed_datapath.cu over its own arguments ----------------
def _csrc_const(source, name):
    """A ``constexpr`` of a CUDA source: the emulators follow the kernel's."""
    text = (_build.CSRC / source).read_text()
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", text).group(1))


_CACHE_BYTES, _THREADS, _STAGE_FLOATS = (
    _csrc_const("streamed_datapath.cu", n)
    for n in ("CACHE_BYTES", "THREADS", "STAGE_FLOATS"))
_ITEMSIZE = {code: dt.itemsize for dt, code in DP.maps.DTYPE_CODES.items()}


def _fma_sums(vals):
    """``ss = fma(v, v, ss)`` along each row of ``vals`` (one thread's values
    in order; zeros past its last leave its sum as it is)."""
    ss = np.zeros(vals.shape[0], np.float32)
    for s in range(vals.shape[1]):
        v = vals[:, s].astype(np.float64)
        ss = (v * v + ss.astype(np.float64)).astype(np.float32)
    return ss


def _warp_sums(v):
    """The xor-shuffle tree over the 32 lanes of each row of ``v``."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(np.float32)
    return v


def _group_sum(ss):
    """``xdma::group_reduce<G>`` of the per-thread sums ``ss`` (G of them)."""
    w = _warp_sums(ss.reshape(-1, 32))[:, 0]
    r = w[0]
    for x in w[1:]:
        r = np.float32(r + x)
    return r


def _block_sum(ss):
    """``xdma::block_sum`` of the per-thread sums of a block."""
    s = np.zeros(32, np.float32)
    w = _warp_sums(ss.reshape(-1, 32))[:, 0]
    s[:w.size] = w
    return _warp_sums(s)[0]


def _stream_ops(a, v, cols, inv, upto):
    """``run_ops``: ops [0, upto) of the list on the values ``v`` of columns
    ``cols``; RMSNorm k scales by ``inv[k]``."""
    for k in range(upto):
        op = a.ops[k]
        if op.code != DP._OP_CAST:
            c = _vec(op.vec, cols) if op.vec else np.float32(op.a)
            if op.code == DP._OP_SCALE:
                v = v * c
            elif op.code == DP._OP_BIAS:
                v = v + c
            else:
                v = v * inv[k]
                if op.vec:
                    v = v * c
        v = _round_arr(np.asarray(v, np.float32), op.dtype)
    return v


def _rows_geometry(a):
    """``launch_rows``: columns a chunk (the wider side's 16-byte pack),
    chunks a thread caches, threads a row."""
    c = max(16 // _ITEMSIZE[a.in_dtype], 16 // _ITEMSIZE[a.out_dtype])
    cache = _CACHE_BYTES // (c * _ITEMSIZE[a.in_dtype])
    tpr = next((t for t in (32, 64, 128) if a.cols // c <= t * cache), 256)
    return c, cache, tpr


def _consecutive_packs(off, c, base, size):
    """Each row of ``off`` (a chunk's c offsets) is consecutive in memory and
    starts on a 16-byte boundary, as the chunk's packs must."""
    assert (np.diff(off, axis=-1) == 1).all(), "a chunk is not consecutive"
    assert ((base + off[:, 0] * size) % 16 == 0).all(), "a pack is unaligned"


class _StreamedEmu:
    """Kernel 2 on the path its arguments name, over the launch's memory: the
    offsets each path computes (the rows path a row offset once a row and a
    column offset once a chunk, the generic path a map per element), the
    order of each RMSNorm's sum (per thread, then the group's or the block's
    tree), and in ``reads`` the source elements read: once where the rows
    path's registers or the generic path's shared memory hold the row, else
    once for each RMSNorm and once for the store."""

    def __init__(self):
        self.reads = 0

    def __call__(self, args_addr, src, dst):
        a = DP._StreamArgs.from_address(args_addr)
        norms = [k for k in range(a.nops) if a.ops[k].code == DP._OP_RMSNORM]
        m, n, pn = a.rows, a.cols, a.pcols
        top = _dim_off(a.src[0], m - 1) + _dim_off(a.src[1], n - 1) + 1
        x_all = _floats(src, top, a.in_dtype)
        out = np.zeros(m * pn, np.float32)
        written = np.zeros(m * pn, np.int64)
        rows = a.path == DP._PATH_ROWS
        if rows:
            c, cache, tpr = _rows_geometry(a)
            assert n % c == 0 and pn % c == 0, "launch_rows refuses this"
            assert all(a.ops[k].vec % 16 == 0 for k in range(a.nops))
            q = np.arange(n // c)
            cached = min(q.size, tpr * cache)
            per_row = cached * c + (q.size - cached) * c * (len(norms) + 1)
        else:
            assert a.path == DP._PATH_GENERIC
            staged = n <= _STAGE_FLOATS
            per_row = n * (1 if staged else len(norms) + 1)
        cols = np.arange(n)
        e = np.arange(c) if rows else None
        for i in range(m):
            if rows:
                soff = (_dim_off(a.src[0], i) + _dim_off(a.src[1], q * c)
                        )[:, None] + e
                assert (soff.ravel() == _dim_off(a.src[0], i)
                        + _dim_off(a.src[1], cols)).all()
                _consecutive_packs(soff, c, src, _ITEMSIZE[a.in_dtype])
                soff = soff.ravel()
            else:
                soff = _dim_off(a.src[0], i) + _dim_off(a.src[1], cols)
            x = x_all[soff]
            self.reads += per_row
            threads = tpr if rows else _THREADS
            inv = {}
            for k in norms:
                v = _stream_ops(a, x, cols, inv, k)
                # thread t's values in order: its chunks t + tpr * mm (rows)
                # or its columns t + 256 * mm (generic)
                unit = c if rows else 1
                per = -(-(n // unit) // threads)
                pad = np.zeros(per * threads * unit, np.float32)
                pad[:n] = v
                vals = pad.reshape(per, threads, unit).transpose(1, 0, 2)
                ss = _fma_sums(vals.reshape(threads, per * unit))
                ss = _group_sum(ss) if rows else _block_sum(ss)
                inv[k] = np.float32(1.0) / np.sqrt(np.float32(
                    ss / np.float32(n) + np.float32(a.ops[k].a)))
            v = _stream_ops(a, x, cols, inv, a.nops)
            if rows:
                qp = np.arange(pn // c)
                doff = (_dim_off(a.dst[0], i) + _dim_off(a.dst[1], qp * c)
                        )[:, None] + e
                _consecutive_packs(doff, c, dst, _ITEMSIZE[a.out_dtype])
                doff = doff.ravel()
            else:
                doff = _dim_off(a.dst[0], i) + _dim_off(a.dst[1],
                                                        np.arange(pn))
            out[doff[:n]] = v
            written[doff] += 1
        assert (written == 1).all(), "a destination element written twice"
        _store_all(dst, out, a.out_dtype)


# kernel 2's path for each STREAMED_CASES entry at its emulation shape
STREAMED_PATHS = {"cast_f16_rmsnorm": "rows", "cast_scale_bias": "rows",
                  "identity_nm": "generic", "rmsnorm_store": "rows",
                  "rmsnorm_weight_bf16": "rows",
                  "scale_bias_vectors": "rows"}

# more cases of kernel 2 alone: (src, dst, chain, logical shape, dtype, path,
# reads): each source element read "once" (the row fits the registers or
# shared memory), "all" of the row again for each RMSNorm (the generic path
# past shared memory), or the "part" the registers do not hold (rows path)
STREAMED_EMU_CASES = {
    "reread_two_rmsnorms": ("MN", "MN", lambda s: (
        PP.RMSNormPlugin(), PP.Scale(torch.linspace(0.5, 2, s[-1])),
        PP.RMSNormPlugin(weight=torch.linspace(-1, 1, s[-1]))),
        (2, 12800), torch.float32, "rows", "part"),
    "two_rmsnorms_bf16": ("MN", "MNM8N128", lambda s: (
        PP.RMSNormPlugin(eps=1e-5), PP.BiasAdd(0.5), PP.RMSNormPlugin(
            weight=torch.linspace(-2, 2, s[-1]).to(torch.bfloat16))),
        (16, 256), torch.bfloat16, "rows", "once"),
    "cast_rmsnorm_warp_groups": ("MN", "MNM16N128", lambda s: (
        PP.Cast(torch.bfloat16), PP.RMSNormPlugin()), (16, 2048),
        torch.float32, "rows", "once"),
    "ragged_width": ("MN", "MN", lambda s: (PP.RMSNormPlugin(),), (8, 130),
                     torch.float32, "generic", "once"),
    "mnp64_dst": ("MN", "MNP64", lambda s: (PP.RMSNormPlugin(
        weight=torch.linspace(-2, 2, s[-1])), PP.Scale(0.5)), (16, 256),
        torch.bfloat16, "rows", "once"),
    "mnm8n8_f16": ("MNM8N8", "MNM32N128", lambda s: (
        PP.Scale(torch.linspace(0.5, 2, s[-1])), PP.Cast(torch.float32)),
        (32, 256), torch.float16, "rows", "once"),
    "generic_reread_two_rmsnorms": ("NM", "MN", lambda s: (
        PP.RMSNormPlugin(), PP.Cast(torch.bfloat16), PP.RMSNormPlugin()),
        (2, 12800), torch.float32, "generic", "all"),
    "wide_rows": ("MN", "MNM8N128", lambda s: (PP.RMSNormPlugin(),),
                  (64, 65536), torch.float32, "rows", "part"),
    "wide_generic": ("NM", "MNM8N128", lambda s: (PP.RMSNormPlugin(),),
                     (64, 65536), torch.float32, "generic", "all"),
}


@pytest.mark.parametrize("name", sorted(STREAMED_CASES) +
                         sorted(STREAMED_EMU_CASES))
def test_streamed_kernel_host_code_under_emulation(name, monkeypatch):
    if name in STREAMED_CASES:
        x, plugins, ps, pd = _emulation_input(STREAMED_CASES, name)
        path, reads = STREAMED_PATHS[name], "once"
    else:
        src, dst, chain, shape, dtype, path, reads = STREAMED_EMU_CASES[name]
        ps, pd = PL.by_name(src), PL.by_name(dst)
        x = ps.from_logical(torch.from_numpy(_x(shape, seed=9)).to(dtype))
        plugins = chain(shape)
    emu = _StreamedEmu()
    launched = _Emulated(emu)
    monkeypatch.setattr(DP, "STREAMED", launched)
    prog = DP.StreamedDatapath(plugins, ps, pd, tuple(x.shape), x.dtype)
    got = prog.launch(x)
    want = DP.plain(x, plugins, ps, pd)
    m, n = prog.logical
    again = m * n * sum(isinstance(p, PP.RMSNormPlugin) for p in plugins)
    assert launched.launches == 1 and launched.paths == {path: 1}
    if reads == "once":
        assert emu.reads == m * n
    elif reads == "all":
        assert emu.reads == m * n + again
    else:
        assert m * n < emu.reads < m * n + again
    assert got.dtype == want.dtype and got.shape == want.shape
    if not any(isinstance(p, PP.RMSNormPlugin) for p in plugins):
        np.testing.assert_array_equal(bits(got), bits(want))
    else:
        tol = dict(rtol=2e-2, atol=1e-2) if prog.out_dtype.itemsize < 4 or \
            x.dtype.itemsize < 4 or any(isinstance(p, PP.Cast)
                                        for p in plugins) \
            else dict(rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(to_f32(got), to_f32(want), **tol)


# layouts whose logical rows run along the columns in 16-byte packs: each
# tile of NMM8N128 is row-major, so its columns run 128 elements at a time
# though its grid of tiles is column-major
COLUMN_RUNNING = ("MN", "MNM8N128", "MNM16N128", "MNM32N128", "MNM8N8",
                  "MNP64", "NMM8N128")


def _picked(src, dst, dtype, shape=(32, 256), chain=None, x=None):
    ps, pd = PL.by_name(src), PL.by_name(dst)
    chain = (PP.RMSNormPlugin(),) if chain is None else chain
    prog = DP.StreamedDatapath(chain, ps, pd, ps.physical_shape(shape), dtype)
    a, _ = prog._prepare("cpu")
    x = torch.empty(ps.physical_shape(shape), dtype=dtype) if x is None else x
    out = torch.empty(pd.physical_shape(shape), dtype=prog.out_dtype)
    return DP.STREAM_PATHS[DP.stream_path(a, x.data_ptr(), out.data_ptr())]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_streamed_path_choice(dtype):
    """``rows`` for every pair of column-running layouts; ``generic`` where
    a side runs along the rows (NM), for a width that is not a whole number
    of chunks, and for a source or a constant vector off a 16-byte
    boundary."""
    for src in COLUMN_RUNNING:
        for dst in COLUMN_RUNNING:
            assert _picked(src, dst, dtype) == "rows", (src, dst)
        assert _picked("NM", src, dtype) == "generic", src
        assert _picked(src, "NM", dtype) == "generic", src
    assert _picked("MN", "MN", dtype, shape=(32, 250)) == "generic"
    # a cast to a 2-byte stream: 8-column chunks, so 260 columns do not fit
    half = torch.bfloat16 if dtype != torch.bfloat16 else torch.float16
    want = "rows" if dtype == torch.float32 else "generic"
    assert _picked("MN", "MN", dtype, shape=(32, 260)) == want
    assert _picked("MN", "MN", dtype, shape=(32, 260),
                   chain=(PP.Cast(half),)) == "generic"
    off = torch.empty(32 * 256 + 1, dtype=dtype)[1:].view(32, 256)
    assert _picked("MN", "MN", dtype, x=off) == "generic"
    weight = torch.linspace(0.5, 2, 257)[1:]          # off by 4 bytes
    assert _picked("MN", "MN", dtype, chain=(
        PP.RMSNormPlugin(weight=weight),)) == "generic"


@pytest.mark.parametrize("src,path", [("MN", "rows"), ("NM", "generic")])
def test_streamed_prepares_rows_wider_than_shared_memory(src, path):
    """A 64 x 65,536 f32 RMSNorm transfer: the row (256 KiB) fits neither
    the registers nor shared memory; the kernel re-reads it, so the host
    prepares its arguments as for any width."""
    ps = PL.by_name(src)
    prog = DP.StreamedDatapath((PP.RMSNormPlugin(),), ps, PL.MNM8N128,
                               ps.physical_shape((64, 65536)), torch.float32)
    a, _ = prog._prepare("cpu")
    assert (a.rows, a.cols, a.pcols, a.nops) == (64, 65536, 65536, 1)
    assert _picked(src, "MNM8N128", torch.float32, shape=(64, 65536)) == path


# launches of each kernel-3 path per block case
BLOCK_PATHS = {
    "compress": {"rank2": 2}, "compress_roundtrip": {"rank2": 2},
    "gather_cols_neg": {"rank2": 1}, "gather_fill": {"rank2": 1},
    "gather_rows": {"rank2": 1}, "load_transpose": {"rank2": 1},
    "reduce_max_bf16": {"rank2": 1}, "reduce_sum": {"rank2": 1},
    "rmsnorm_rowpad": {"rank2": 2}, "transpose_rmsnorm_sum": {"rank2": 2},
    # logical rank 3: its leading axis a batch of the rank-2 pass, tiled by
    # the KV4M8N128 destination
    "rank3_rmsnorm": {"rank2": 2},
    # a cast between dtypes; a segment whose ReduceStage is not last ([max,
    # transpose]) before one that is ([sum])
    "hypothesis_case": {"generic": 1},
    "max_transpose_sum": {"generic": 1, "rank2": 1},
}


@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_block_kernel_host_code_under_emulation(name, monkeypatch):
    x, plugins, ps, pd = _emulation_input(BLOCK_CASES, name)
    emu = _Emulated(_emulate_block)
    monkeypatch.setattr(DP, "BLOCK", emu)
    prog = DP.BlockDatapath(plugins, ps, pd, tuple(x.shape), x.dtype)
    got = prog.launch(x)
    want = DP.plain(x, plugins, ps, pd)
    passes = sum(isinstance(p, (PP.RMSNormPlugin, PP.Compress))
                 for p in plugins)
    segments = max(1, sum(isinstance(p, PP.ReduceStage) for p in plugins))
    assert emu.launches == passes + segments
    assert emu.paths == BLOCK_PATHS[name]
    if isinstance(want, PP.CTensor):
        np.testing.assert_array_equal(bits(got.mask), bits(want.mask))
        got, want = got.values, want.values
    assert got.dtype == want.dtype and got.shape == want.shape
    if _exact(name):
        np.testing.assert_array_equal(bits(got), bits(want))
    else:
        np.testing.assert_allclose(to_f32(got), to_f32(want),
                                   rtol=2e-2, atol=1e-2)


def test_block_segments_cut_before_a_second_reduce():
    chain = (PP.ReduceStage("max"), PP.Transpose(), PP.ReduceStage("sum"),
             PP.Scale(2.0), PP.ReduceStage("sum"))
    prog = DP.BlockDatapath(chain, PL.MN, PL.MN, (16, 32), torch.float32)
    stages = prog._compile("cpu")
    assert prog._segments(stages) == [(0, 2), (2, 4), (4, 5)]


# -- kernel 3's path choice and composed index map ------------------------------
def _idx(values):
    return np.asarray(values, np.int64)


# (src, dst, chain, logical shape, dtype, paths, bitwise)
PATH_CASES = {
    "transpose_then_gather": ("MNM8N128", "MN", lambda: (
        PP.Transpose(), PP.GatherScatter(indices=_perm(256, 4))), (32, 256),
        torch.bfloat16, {"rank2": 1}, True),
    "two_gathers_one_axis": ("MN", "MNM8N128", lambda: (
        PP.GatherScatter(indices=_perm(64, 5)),
        PP.GatherScatter(indices=_perm(64, 6))), (64, 256), torch.float32,
        {"rank2": 1}, True),
    "gather_out_of_range_bf16": ("MN", "MN", lambda: (PP.GatherScatter(
        indices=_idx([3, -1, 40, -41, 0] + list(range(5, 32)))),),
        (32, 128), torch.bfloat16, {"rank2": 1}, True),
    "two_gathers_out_of_range": ("MN", "MN", lambda: (
        PP.GatherScatter(indices=_idx([1, 99] + list(range(2, 32)))),
        PP.GatherScatter(indices=_idx([1, 0, 77] + list(range(3, 128))),
                         axis=-1),
        PP.GatherScatter(indices=_idx([0, 1, -50] + list(range(3, 32))))),
        (32, 128), torch.float32, {"rank2": 1}, True),
    "scale_then_gather_fill": ("MN", "MNP64", lambda: (
        PP.Scale(2.0), PP.GatherScatter(indices=_idx(
            list(range(31)) + [64]))), (32, 128), torch.float32,
        {"rank2": 1}, True),
    "gather_transpose_vector_scale": ("MN", "MN", lambda: (
        PP.GatherScatter(indices=_perm(128, 7), axis=-1), PP.Transpose(),
        PP.Scale(torch.linspace(0.5, 2, 32))), (32, 128), torch.float32,
        {"rank2": 1}, True),
    "cast_same_dtype": ("NM", "MNM8N128", lambda: (
        PP.Cast(torch.float32), PP.Transpose()), (128, 64), torch.float32,
        {"rank2": 1}, True),
    "cast_between_dtypes": ("MN", "MN", lambda: (
        PP.Cast(torch.bfloat16), PP.Transpose()), (32, 128), torch.float32,
        {"generic": 1}, True),
    "gather_after_vector_scale": ("MN", "MN", lambda: (
        PP.Scale(torch.linspace(0.5, 2, 128)),
        PP.GatherScatter(indices=_perm(32, 8))), (32, 128), torch.float32,
        {"generic": 1}, True),
    "stage_after_reduce": ("MN", "MN", lambda: (
        PP.ReduceStage("max"), PP.Scale(2.0)), (32, 128), torch.float32,
        {"generic": 1}, True),
    "rank3_transpose": ("MN", "MN", lambda: (PP.Transpose(),), (4, 16, 128),
                        torch.float32, {"rank2": 1}, True),
    "decompress_after_transpose": ("MN", "MN", lambda: (
        PP.Transpose(), PP.Compress(block_rows=8), PP.Decompress()),
        (128, 32), torch.bfloat16, {"rank2": 2}, True),
    # logical ranks 3-5 as a batch of the rank-2 pass: the KV tunnel's
    # (1, S, D) transpose, the checkpoint's stacked leaves through the
    # Compress wire, an RMSNorm at rank 4, a gather of a leading axis (one
    # index out of range: its slice is the NaN fill), a final ReduceStage
    # keeping or dropping its rows (a sum over 384 rows in three splits a
    # leading index), a destination that tiles the leading axis, and a
    # source off a 16-byte boundary
    "tunnel_transpose": ("MN", "MN", lambda: (PP.Transpose(),), (1, 64, 128),
                         torch.bfloat16, {"rank2": 1}, True),
    "stacked_compress_roundtrip": ("MN", "MN", lambda: (
        PP.Compress(block_rows=8), PP.Decompress()), (3, 64, 128),
        torch.float32, {"rank2": 2}, True),
    "rmsnorm_rank4": ("MN", "MNP64", lambda: (
        PP.Transpose(), PP.RMSNormPlugin(weight=torch.linspace(-1, 2, 32))),
        (2, 3, 32, 128), torch.float32, {"rank2": 2}, False),
    "lead_gather_out_of_range": ("MN", "MNM16N128", lambda: (
        PP.Transpose(), PP.GatherScatter(indices=_idx([2, 0, 7, -1, 3]),
                                         axis=0)),
        (4, 128, 16), torch.bfloat16, {"rank2": 1}, True),
    "rank3_reduce_max_keepdims": ("MNM8N128", "MNP64", lambda: (
        PP.Transpose(), PP.ReduceStage("max", keepdims=True)), (3, 32, 128),
        torch.float32, {"rank2": 1}, True),
    "rank3_reduce_sum_drops_rows": ("MN", "MN", lambda: (
        PP.ReduceStage("sum", keepdims=False),), (3, 384, 128),
        torch.float32, {"rank2": 1}, False),
    "kv4_destination": ("MN", "KV4M8N128", lambda: (
        PP.GatherScatter(indices=_perm(16, 9), axis=-2),
        PP.Scale(torch.linspace(0.5, 2, 128))), (8, 16, 128), torch.float32,
        {"rank2": 1}, True),
    "unaligned_base_rank3": ("MN", "MN", lambda: (PP.Scale(2.0),),
                             (2, 16, 128), torch.float32, {"rank2": 1}, True),
    # the destination pads a leading axis: the generic path
    "padded_leading_axis": ("MN", "leadpad", lambda: (PP.Scale(2.0),),
                            (3, 16, 128), torch.float32, {"generic": 1}, True),
}


@pytest.mark.parametrize("name", sorted(PATH_CASES))
def test_block_path_choice_under_emulation(name, monkeypatch):
    """Which chains take the rank-2 path, and that both paths' arguments
    reproduce the plain version (bitwise: index stages, NaN fills, masks)."""
    src, dst, chain, shape, dtype, paths, bitwise = PATH_CASES[name]
    ps, pd = _layouts(src)[1], _layouts(dst)[1]
    x = torch.from_numpy(_x(shape, seed=11, zero_rows=8)).to(dtype)
    x = ps.from_logical(x)
    if "unaligned" in name:             # one element past a 16-byte boundary
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)
        assert x.data_ptr() % 16 and x.is_contiguous()
    plugins = chain()
    emu = _Emulated(_emulate_block)
    monkeypatch.setattr(DP, "BLOCK", emu)
    prog = DP.BlockDatapath(plugins, ps, pd, tuple(x.shape), x.dtype)
    got = prog.launch(x)
    want = DP.plain(x, plugins, ps, pd)
    assert emu.paths == paths
    if isinstance(want, PP.CTensor):
        np.testing.assert_array_equal(bits(got.mask), bits(want.mask))
        got, want = got.values, want.values
    assert got.dtype == want.dtype and got.shape == want.shape
    if bitwise:
        np.testing.assert_array_equal(bits(got), bits(want))
    else:       # f32 value chains: tests/oracle.py's f32 chain tolerance
        np.testing.assert_allclose(to_f32(got), to_f32(want), rtol=1e-5,
                                   atol=1e-5)


# the generic OUT pass staged through a shared tile where the source runs
# across the destination's rows: (src, dst, chain, logical shape, dtype,
# tiled, bitwise)
TILED_CASES = {
    "cast_transpose_rank3": ("MN", "MN", lambda: (
        PP.Cast(torch.bfloat16), PP.Transpose()), (2, 40, 72), torch.float32,
        True, True),
    "transpose_cast_rmsnorm_padded": ("MN", "MNP64", lambda: (
        PP.Transpose(), PP.Cast(torch.bfloat16),
        PP.RMSNormPlugin(weight=torch.linspace(-1, 2, 48))), (48, 96),
        torch.float32, True, False),
    "cast_transpose_vector_scale": ("MNM8N128", "MN", lambda: (
        PP.Cast(torch.float16), PP.Transpose(),
        PP.Scale(torch.linspace(0.5, 2, 64)), PP.Transpose(),
        PP.Transpose()), (64, 256), torch.float32, True, True),
    # the source's run reaches the dst's columns: no tile
    "two_transposes": ("MN", "MN", lambda: (
        PP.Cast(torch.bfloat16), PP.Transpose(), PP.Transpose()), (40, 72),
        torch.float32, False, True),
    "column_major_source": ("NM", "MN", lambda: (
        PP.Cast(torch.bfloat16), PP.Transpose()), (40, 72), torch.float32,
        False, True),
    # the dst's rows narrower than a tile, or a gather among the index stages
    "narrow_rows": ("MN", "MN", lambda: (
        PP.Cast(torch.bfloat16), PP.Transpose()), (40, 16), torch.float32,
        False, True),
    "gather_and_transpose": ("MN", "MN", lambda: (
        PP.Cast(torch.bfloat16), PP.GatherScatter(indices=_perm(40, 3)),
        PP.Transpose()), (40, 72), torch.float32, False, True),
}


@pytest.mark.parametrize("name", sorted(TILED_CASES))
def test_block_generic_tiled_pass_under_emulation(name, monkeypatch):
    """Which generic OUT passes stage through the shared tile
    (``BlockDatapath._tiled``), and that the tiled walk over the
    destination writes each element once and reproduces the plain
    version."""
    src, dst, chain, shape, dtype, tiled, bitwise = TILED_CASES[name]
    ps, pd = _layouts(src)[1], _layouts(dst)[1]
    x = ps.from_logical(torch.from_numpy(_x(shape, seed=13)).to(dtype))
    plugins = chain()
    seen = []

    def record(args, src_ptr, dst_ptr, mode):
        if mode == DP._MODE_OUT:
            seen.append(DP._BlockArgs.from_address(args).tiled)
        _emulate_block(args, src_ptr, dst_ptr, mode)

    emu = _Emulated(record)
    monkeypatch.setattr(DP, "BLOCK", emu)
    prog = DP.BlockDatapath(plugins, ps, pd, tuple(x.shape), x.dtype)
    got = prog.launch(x)
    want = DP.plain(x, plugins, ps, pd)
    assert set(emu.paths) == {"generic"} and seen == [int(tiled)]
    assert got.dtype == want.dtype and got.shape == want.shape
    if bitwise:
        np.testing.assert_array_equal(bits(got), bits(want))
    else:       # bf16 after an f32 row sum: tests/oracle.py's bf16 tolerance
        np.testing.assert_allclose(to_f32(got), to_f32(want), rtol=2e-2,
                                   atol=1e-2)


def test_block_generic_tiled_pass_is_32_bit_only(monkeypatch):
    """A launch on the 64-bit index instances takes the untiled output pass
    (the kernel has no 64-bit tiled instance), with the same result."""
    monkeypatch.setattr(DP, "_INDEX32", 0)
    src, dst, chain, shape, dtype, _, _ = TILED_CASES["cast_transpose_rank3"]
    ps, pd = _layouts(src)[1], _layouts(dst)[1]
    x = ps.from_logical(torch.from_numpy(_x(shape, seed=13)).to(dtype))
    seen = []

    def record(args, src_ptr, dst_ptr, mode):
        a = DP._BlockArgs.from_address(args)
        seen.append((a.index32, a.tiled))
        _emulate_block(args, src_ptr, dst_ptr, mode)

    monkeypatch.setattr(DP, "BLOCK", _Emulated(record))
    prog = DP.BlockDatapath(chain(), ps, pd, tuple(x.shape), x.dtype)
    got = prog.launch(x)
    assert seen == [(0, 0)]
    np.testing.assert_array_equal(bits(got), bits(DP.plain(x, chain(), ps,
                                                           pd)))


# the batched rank-2 path against the reference's compiled backend:
# (src, dst, the chain from a plugin module, logical shape, dtype)
BATCHED_REF_CASES = {
    "tunnel_transpose": ("MN", "MN", lambda M: (M.Transpose(),),
                         (1, 64, 128), jnp.bfloat16),
    "stacked_compress_roundtrip": ("MN", "MN", lambda M: (
        M.Compress(block_rows=8), M.Decompress()), (3, 64, 128), np.float32),
}


@pytest.mark.parametrize("name", sorted(BATCHED_REF_CASES))
def test_batched_rank2_chains_match_reference_compiled(name, monkeypatch):
    """The KV tunnel's transpose and the checkpoint's stacked wire: the
    port's plain version and its kernel (emulated over the arguments the
    host prepares, on the rank-2 path) bitwise the reference's ``compiled``
    backend."""
    src, dst, chain, shape, dtype = BATCHED_REF_CASES[name]
    xin = _x(shape, seed=21, zero_rows=8, dtype=dtype)
    ref = RC.describe(src, dst, *chain(RP), backend="compiled")
    desc = port_desc(ref)
    want = rx.transfer(jnp.asarray(xin), ref)
    assert_same_payload(px.transfer(to_torch(xin), desc), want, context=name)
    emu = _Emulated(_emulate_block)
    monkeypatch.setattr(DP, "BLOCK", emu)
    x = to_torch(xin)
    prog = DP.BlockDatapath(desc.plugins, desc.src.layout, desc.dst.layout,
                            tuple(x.shape), x.dtype)
    assert_same_payload(prog.launch(x), want, context=name)
    assert set(emu.paths) == {"rank2"}


def _stages(chain, shape, dtype=torch.float32):
    prog = DP.BlockDatapath(chain, PL.MN, PL.MN, shape, dtype)
    return prog._compile("cpu")


def test_composed_map_transpose_then_gather():
    """Transpose, then a gather of the transposed rows: the pass's row axis
    indexes the source's columns through the gather's indices."""
    idx = _perm(96, 3)
    seg = _stages((PP.Transpose(), PP.GatherScatter(indices=idx)), (16, 96))
    comp = DP.compose(seg, len(seg))
    assert comp.axes == (1, 0) and comp.index[1] is None
    np.testing.assert_array_equal(comp.index[0].numpy(), idx)
    assert comp.swaps == (0, 0)


def test_composed_map_two_gathers_on_one_axis():
    a, b = _perm(32, 1), _perm(32, 2)
    seg = _stages((PP.GatherScatter(indices=a), PP.GatherScatter(indices=b)),
                  (32, 64))
    comp = DP.compose(seg, 2)
    assert comp.axes == (0, 1) and comp.index[1] is None
    np.testing.assert_array_equal(comp.index[0].numpy(), a[b])


def test_composed_map_out_of_range_fills():
    """An index outside [-n, n) composes into the fill code -(g + 1) of its
    gather g; where two gathers fail, the later one's code stands."""
    first = _idx([1, 40, 2, 3] + list(range(4, 32)))       # 40 fails
    second = _idx([1, 0, -33, 2] + list(range(4, 32)))     # -33 fails
    seg = _stages((PP.GatherScatter(indices=first), PP.Scale(2.0),
                   PP.GatherScatter(indices=second)), (32, 64))
    comp = DP.compose(seg, 3)
    got = comp.index[0].numpy()
    assert got[0] == -1          # second[0] = 1 -> first[1] = 40 fails at 0
    assert got[1] == 1           # second[1] = 0 -> first[0] = 1
    assert got[2] == -3          # second[2] = -33 fails at stage 2
    assert got[3] == 2           # second[3] = 2 -> first[2] = 2
    assert DP.rank2_path(seg, 2, torch.float32)


def test_composed_map_swap_parity_of_value_stages():
    """A value stage reads its coordinate swapped under an odd number of
    later transposes."""
    seg = _stages((PP.Scale(torch.linspace(1, 2, 64)), PP.Transpose(),
                   PP.BiasAdd(torch.linspace(1, 2, 32)), PP.Transpose(),
                   PP.Scale(3.0)), (32, 64))
    comp = DP.compose(seg, len(seg))
    assert comp.axes == (0, 1)
    assert (comp.swaps[0], comp.swaps[2], comp.swaps[4]) == (0, 1, 0)
