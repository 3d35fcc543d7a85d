"""The streams the reference's datapath takes beyond float32, bfloat16,
float16 and the signed integers: bool, uint8, uint16, uint32,
float8_e4m3fn and float8_e5m2, and logical ranks 9 and 10.

Each case runs one seeded input through the reference's
``repro.core.api.transfer`` with ``backend="compiled"`` and through the
port's with ``compiled``, ``auto`` and ``fused`` (on the CPU: the plain
versions), and holds them bitwise, dtype and shape included.  Kernel 3's
host code then runs each case against the emulator of its CUDA arithmetic
(``test_torch_plugin_compiler.py``): the stage lists, carriers, segments,
paths and the folded leading axes of a rank above 8, bitwise the same.

The rule for casts: XLA's conversion of a negative float to an unsigned
integer is implementation-defined, so such a cast's input stays inside the
range: a float into an unsigned integer is drawn in [0, max), and within it
every value is held bitwise.  Into float8 the port rounds as the reference's
XLA does past the range too (``plugins.to_float8``: float8_e4m3fn's NaN
above 464, float8_e5m2's infinity from 61440, a NaN's sign kept), and
``test_float8_edges_match_reference`` holds those values bitwise.
"""
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_plugin_compiler as TPC  # noqa: E402
from repro import core as RC  # noqa: E402
from repro.core import plugins as RP  # noqa: E402
from repro.core import xdma as rx  # noqa: E402
from repro_torch.core import plugin_compiler as ppc  # noqa: E402
from repro_torch.core import plugins as PP  # noqa: E402
from repro_torch.core import xdma as px  # noqa: E402
from repro_torch.kernels import datapath as DP  # noqa: E402
from torch_parity import (assert_same_payload, port_desc,  # noqa: E402,F401
                          reset_global_state, to_torch)

DTYPES = ("bool", "uint8", "uint16", "uint32", "float8_e4m3fn",
          "float8_e5m2")
SHAPE = (48, 128)          # 48 rows: a float8 sum in two padded windows
BACKENDS = ("compiled", "auto", "fused")


def _draw(rng, dtype, shape):
    """A seeded array of ``dtype`` (a name or numpy dtype)."""
    dt = jnp.dtype(dtype)
    if dt == np.bool_:
        return rng.random(shape) < 0.5
    if dt.name.startswith("float8"):
        return (4 * rng.standard_normal(shape)).astype(np.float32).astype(dt)
    if np.issubdtype(dt, np.unsignedinteger):
        return rng.integers(0, np.iinfo(dt).max, shape, endpoint=True,
                            dtype=np.uint64).astype(dt)
    if np.issubdtype(dt, np.integer):
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, shape, endpoint=True).astype(dt)
    return rng.standard_normal(shape).astype(dt)


def _into(rng, dtype, shape):
    """f32 inputs of a Cast into ``dtype``, inside its range (the module's
    rule): zeros among them for bool."""
    dt = jnp.dtype(dtype)
    if np.issubdtype(dt, np.unsignedinteger):
        top = min(float(np.iinfo(dt).max), 2.0 ** 31)
        return rng.uniform(0, top, shape).astype(np.float32)
    x = (4 * rng.standard_normal(shape)).astype(np.float32)
    x[::3] = 0
    return x


def _cast_to(M, dtype):
    return jnp.dtype(dtype) if M is RP else getattr(torch, jnp.dtype(
        dtype).name)


def _scale(dtype):
    return 1.5 if jnp.dtype(dtype).name.startswith("float8") else 3


# (src, dst, chain from a plugin module and the dtype, input from a
# generator and the dtype); the fill index 60 lies past the 48 rows
CHAINS = {
    "transpose": ("MN", "MN", lambda M, d: (M.Transpose(),), None),
    "gather_fill": ("MN", "MN", lambda M, d: (M.GatherScatter(
        indices=np.r_[np.arange(47, -1, -2), 60, -49, -1]),), None),
    "reduce_sum": ("MN", "MN", lambda M, d: (M.ReduceStage("sum"),), None),
    "reduce_max": ("MN", "MN", lambda M, d: (M.ReduceStage("max"),), None),
    "compress_roundtrip": ("MN", "MN", lambda M, d: (
        M.Compress(block_rows=8), M.Decompress()), "zero_blocks"),
    "cast_to_f32": ("MN", "MN", lambda M, d: (
        M.Cast(_cast_to(M, "float32")),), None),
    "cast_from_f32": ("MN", "MN", lambda M, d: (M.Cast(_cast_to(M, d)),),
                      "f32"),
    "scale": ("MN", "MN", lambda M, d: (M.Scale(_scale(d)),), None),
    "tiled_store": ("MN", "MNM8N128", lambda M, d: (), None),
}


def _input(name, dtype, seed=0):
    rng = np.random.default_rng(seed)
    how = CHAINS[name][3]
    if how == "f32":
        return _into(rng, dtype, SHAPE)
    x = _draw(rng, dtype, SHAPE)
    if how == "zero_blocks":            # two of the six row blocks are zero
        x[8:16] = 0
        x[32:40] = 0
    return x


def _run(x, src, dst, chain):
    """The reference's ``compiled`` result and the port's under each
    backend."""
    ref = RC.describe(src, dst, *chain(RP), backend="compiled")
    want = rx.transfer(jnp.asarray(x), ref)
    got = {b: px.transfer(to_torch(x), port_desc(RC.describe(
        src, dst, *chain(RP), backend=b))) for b in BACKENDS}
    return want, got


def _emulated(x, src, dst, plugins, monkeypatch):
    """Kernel 3 over the host's arguments for ``plugins``, emulated."""
    emu = TPC._Emulated(TPC._emulate_block)
    monkeypatch.setattr(DP, "BLOCK", emu)
    ps, pd = TPC._layouts(src)[1], TPC._layouts(dst)[1]
    t = ps.from_logical(to_torch(x))
    prog = DP.BlockDatapath(plugins, ps, pd, tuple(t.shape), t.dtype)
    return prog.launch(t), emu, prog


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_stream_matches_reference_compiled(name, dtype):
    src, dst, chain, _ = CHAINS[name]
    x = _input(name, dtype)
    want, got = _run(x, src, dst, lambda M: chain(M, dtype))
    for backend, g in got.items():
        assert_same_payload(g, want, context=f"{name} {dtype} {backend}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(set(CHAINS) - {"tiled_store"}))
def test_stream_kernel_host_code_under_emulation(name, dtype, monkeypatch):
    """Kernel 3 (emulated) on each case, bitwise the reference's
    ``compiled`` result; a launch carries its values in one carrier, and a
    stream that only moves words takes the rank-2 path."""
    src, dst, chain, _ = CHAINS[name]
    x = _input(name, dtype)
    want = rx.transfer(jnp.asarray(x), RC.describe(
        src, dst, *chain(RP, dtype), backend="compiled"))
    got, emu, prog = _emulated(x, src, dst, chain(PP, dtype), monkeypatch)
    assert_same_payload(got, want, context=f"{name} {dtype}")
    stages = prog._compile("cpu")
    for lo, hi in prog._segments(stages):
        assert len({st.floats for st in stages[lo:hi]}) == 1
    if name in ("transpose", "gather_fill"):
        assert emu.paths == {"rank2": 1}


@pytest.mark.parametrize("dtype", DTYPES)
def test_streams_route_to_kernel3(dtype):
    """A streaming chain over a stream kernel 2 does not run (float8 is a
    floating-point dtype to torch) compiles to kernel 3."""
    desc = port_desc(RC.describe("MN", "MN", RP.Scale(_scale(dtype)),
                                 backend="compiled"))
    fn = ppc.compile_local(desc)
    x = _draw(np.random.default_rng(1), dtype, SHAPE)
    fn(to_torch(x))
    (prog,) = fn.kernels.values()
    assert isinstance(prog, DP.StreamedDatapath) and prog._block is not None


def test_bool_stream_after_a_float_cast_keeps_the_f32_carrier(monkeypatch):
    """A Cast from f32 to bool is x != 0 in the f32 carrier (NaN is True),
    made by the store: the Cast and the Scale after it each end their
    launch, and the bool sum after them, an int32, runs in the int64
    carrier; emulated, bitwise the reference."""
    chain = lambda M, b: (M.Cast(b), M.Scale(2.0),  # noqa: E731
                          M.ReduceStage("sum"))
    x = _into(np.random.default_rng(4), "float32", (16, 32))
    x[1, ::5] = np.nan
    want = rx.transfer(jnp.asarray(x), RC.describe(
        "MN", "MN", *chain(RP, jnp.bool_), backend="compiled"))
    got, emu, prog = _emulated(x, "MN", "MN", chain(PP, torch.bool),
                               monkeypatch)
    assert_same_payload(got, want)
    stages = prog._compile("cpu")
    assert [st.floats for st in stages] == [True, True, False]
    assert prog._segments(stages) == [(0, 1), (1, 2), (2, 3)]


@pytest.mark.parametrize("dtype", ("float8_e4m3fn", "float8_e5m2"))
def test_a_float8_sum_ends_its_launch(dtype, monkeypatch):
    """A float8 sum runs in the output pass only, where it sums in the
    reference's order: the Scale after it (whose float8 result the store
    rounds) and the Compress (whose mask pass would otherwise sum it again
    per element) start launches of their own, bitwise the reference."""
    chain = lambda M: (M.ReduceStage("sum"), M.Scale(0.5),  # noqa: E731
                       M.Compress(block_rows=1))
    x = _draw(np.random.default_rng(3), dtype, SHAPE)
    want = rx.transfer(jnp.asarray(x), RC.describe(
        "MN", "MN", *chain(RP), backend="compiled"))
    got, emu, prog = _emulated(x, "MN", "MN", chain(PP), monkeypatch)
    assert prog._segments(prog._compile("cpu")) == [(0, 1), (1, 2), (2, 3)]
    assert_same_payload(got, want, context=dtype)


# -- logical ranks above 8 ---------------------------------------------------
RANK9 = (2, 1, 2, 1, 2, 1, 2, 8, 16)
RANK10 = (2, 1, 2, 1, 2, 1, 2, 1, 8, 16)
# (chain, logical shape, dtype, the folded rank kernel 3 runs)
RANK_CASES = {
    "transpose_rank9": (lambda M: (M.Transpose(),), RANK9, np.float32, 3),
    "scale_rank9": (lambda M: (M.Scale(2.5),), RANK9, np.float32, 3),
    "lead_gather_rank9": (lambda M: (M.GatherScatter(
        indices=np.array([1, 0, 5]), axis=0),), RANK9, np.float32, 4),
    "reduce_sum_rank9": (lambda M: (M.ReduceStage("sum"),), RANK9,
                         np.int32, 3),
    "transpose_rank10": (lambda M: (M.Transpose(),), RANK10, np.float32, 3),
    "scale_rank10": (lambda M: (M.Scale(2.5),), RANK10, np.float32, 3),
    "lead_gather_rank10": (lambda M: (M.GatherScatter(
        indices=np.array([1, -1, 2, 0]), axis=2),), RANK10, np.float32, 5),
    "reduce_max_rank10": (lambda M: (M.ReduceStage("max", keepdims=False),),
                          RANK10, np.float32, 4),
}


@pytest.mark.parametrize("name", sorted(RANK_CASES))
def test_rank_above_8_matches_reference_compiled(name):
    chain, shape, dtype, _ = RANK_CASES[name]
    x = _draw(np.random.default_rng(7), dtype, shape)
    want, got = _run(x, "MN", "MN", chain)
    for backend, g in got.items():
        assert_same_payload(g, want, context=f"{name} {backend}")


@pytest.mark.parametrize("name", sorted(RANK_CASES))
def test_rank_above_8_folds_for_kernel3(name, monkeypatch):
    """The folded program's arguments, emulated, give the reference's
    result; its launches count under ``BLOCK.paths`` as any other's."""
    chain, shape, dtype, rank = RANK_CASES[name]
    x = _draw(np.random.default_rng(7), dtype, shape)
    want = rx.transfer(jnp.asarray(x), RC.describe(
        "MN", "MN", *chain(RP), backend="compiled"))
    got, emu, prog = _emulated(x, "MN", "MN", chain(PP), monkeypatch)
    assert_same_payload(got, want, context=name)
    assert len(prog._inner.logical) == rank
    assert sum(emu.paths.values()) >= 1


def test_rank9_folds_into_a_tiled_destination(monkeypatch):
    """A destination that tiles the last two axes leaves the leading ones
    plain: they fold, and the tiled store is bitwise the reference's."""
    x = _draw(np.random.default_rng(8), np.float32, (2, 1, 2, 1, 2, 1, 2,
                                                     16, 128))
    want = rx.transfer(jnp.asarray(x), RC.describe(
        "MN", "MNM8N128", RP.Scale(2.5), backend="compiled"))
    got, emu, prog = _emulated(x, "MN", "MNM8N128", (PP.Scale(2.5),),
                               monkeypatch)
    assert_same_payload(got, want)
    assert len(prog._inner.logical) == 3 and emu.paths == {"rank2": 1}


def test_rank9_that_does_not_fold_is_refused():
    """Gathers of the leading axes 0, 2, 4 and 6 name every other one, so no
    two adjacent axes fold and 9 stay: the port's plain version matches the
    reference's result, and kernel 3's host code refuses the chain."""
    def chain(M):
        return tuple(M.GatherScatter(indices=np.array([1, 0]), axis=a)
                     for a in (0, 2, 4, 6))
    x = _draw(np.random.default_rng(9), np.float32, RANK9)
    want, got = _run(x, "MN", "MN", chain)
    for backend, g in got.items():
        assert_same_payload(g, want, context=backend)
    assert len(DP.fold_axes(chain(PP), TPC.PL.MN, TPC.PL.MN, RANK9)) == 9
    prog = DP.BlockDatapath(chain(PP), TPC.PL.MN, TPC.PL.MN, RANK9,
                            torch.float32)
    with pytest.raises(NotImplementedError, match="do not fold"):
        prog._compile("cpu")


def test_float8_sum_follows_the_reference_order():
    """A float8 sum rounds after every addition: over 1100 rows the
    reference sums windows of 32 (padded evenly), then windows of those;
    the plain version and the kernel's serial walk (emulated) follow it."""
    rng = np.random.default_rng(3)
    for dt in ("float8_e4m3fn", "float8_e5m2"):
        x = _draw(rng, dt, (1100, 8))
        want = rx.transfer(jnp.asarray(x), RC.describe(
            "MN", "MN", RP.ReduceStage("sum"), backend="compiled"))
        assert_same_payload(PP.ReduceStage("sum")(to_torch(x)), want)
        vals = to_torch(x).to(torch.float32).numpy()
        code = DP.maps.INT_CODES[getattr(torch, dt)]
        col = [TPC._ordered_sum(1100, code, lambda r, j=j: vals[r, j])
               for j in range(8)]
        np.testing.assert_array_equal(
            np.asarray(col, np.float32).astype(np.dtype(want.dtype)).view(
                np.uint8), np.asarray(want).reshape(8).view(np.uint8))


# f32 values at float8's edges: the saturation band of float8_e4m3fn (448 <
# |v| <= 464 rounds to 448), past it (its NaN), float8_e5m2's largest finite
# value and its infinity from 61440, the infinities, NaN of both signs (-NaN
# as x86 makes it, 0xFFC00000) and subnormals (a tie to even among them)
EDGES = np.concatenate([np.array(
    [448, -448, 449, 464, -464, 465, -465, 479, 480, 57344, 61439, 61440,
     -61440, 1e9, np.inf, -np.inf, np.nan, 2.0 ** -9, 2.0 ** -10,
     3 * 2.0 ** -10, 2.0 ** -17, 3 * 2.0 ** -18, -2.0 ** -16], np.float32),
    np.array([0xFFC00000], np.uint32).view(np.float32)])


@pytest.mark.parametrize("dtype", ("float8_e4m3fn", "float8_e5m2"))
@pytest.mark.parametrize("op", ("cast", "scale"))
def test_float8_edges_match_reference(op, dtype, monkeypatch):
    """Cast f32 -> float8 of the edge values, and a Scale of 1.5 on the
    float8 stream they round to (whose products cross the range again):
    the port under every backend and kernel 3 (emulated) are bitwise the
    reference's ``compiled`` result, NaN bytes included (a Cast's NaN is
    0x7E with its sign in float8_e5m2, its arithmetic's 0x7F)."""
    rng = np.random.default_rng(11)
    x = np.concatenate([EDGES, (4 * rng.standard_normal(
        32 - EDGES.size)).astype(np.float32)]).reshape(2, 16)
    if op == "cast":
        chain = lambda M: (M.Cast(_cast_to(M, dtype)),)  # noqa: E731
    else:
        x = np.asarray(x.astype(jnp.dtype(dtype)))
        chain = lambda M: (M.Scale(1.5),)  # noqa: E731
    want, got = _run(x, "MN", "MN", chain)
    for backend, g in got.items():
        assert_same_payload(g, want, context=f"{op} {dtype} {backend}")
    got, emu, _ = _emulated(x, "MN", "MN", chain(PP), monkeypatch)
    assert_same_payload(got, want, context=f"{op} {dtype} emulated")
    assert emu.paths == {"generic": 1}
