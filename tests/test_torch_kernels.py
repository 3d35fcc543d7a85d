"""Parity of the port's fused kernels 4 and 5 with the reference's.

``rmsnorm_relayout`` (kernel 4) and ``quantize_tiled`` (kernel 5): the same
numpy inputs go through the reference's Pallas kernels (interpret mode, as
``tests/test_kernels.py`` runs them) and through the port on the CPU, which
takes the plain versions.  RMSNorm is compared within tolerance (f32: the
reference test's rtol/atol 1e-5; bf16: one bf16 ulp, rtol 2e-2 / atol
1e-2), int8 values and scales bitwise.  The kernels' own arguments are
checked by an emulation of their store arithmetic; the kernels themselves by
the ``cuda`` tests on a GPU.
"""
import pytest

pytest.importorskip("torch")

import os  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.fused_rmsnorm_relayout import rmsnorm_relayout as r_norm  # noqa: E402
from repro.kernels.quant import quantize_tiled as r_quant  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_rmsnorm_relayout as pnorm  # noqa: E402
from repro_torch.kernels import ops as pops  # noqa: E402
from repro_torch.kernels import quant as pquant  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402
from torch_parity import bits, reset_global_state, to_f32, to_torch  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DTYPES = {"float32": np.float32, "bfloat16": jnp.bfloat16}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=1e-2)}


def _x(shape, dtype="float32", seed=0, scale=1.0):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    return x.astype(DTYPES[dtype])


# -- kernel 4: rmsnorm_relayout -----------------------------------------------
@pytest.mark.parametrize("m,n,tile", [(64, 256, (16, 128)),
                                      (32, 128, (8, 128)),
                                      (96, 384, (32, 128))])
@pytest.mark.parametrize("weight", [False, True])
@pytest.mark.parametrize("d_buf", [1, 3, 9])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_relayout_matches_reference(m, n, tile, weight, d_buf, dtype):
    x = _x((m, n), dtype, seed=17)
    w = _x((n,), dtype, seed=19) if weight else None
    want = r_norm(jnp.asarray(x), None if w is None else jnp.asarray(w), tile,
                  d_buf=d_buf)
    got = pops.rmsnorm_relayout(to_torch(x), None if w is None else
                                to_torch(w), tile, d_buf=d_buf)
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).replace("torch.", "") == want.dtype.name
    np.testing.assert_allclose(to_f32(got), to_f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_relayout_ref_twin(dtype):
    x, w = _x((64, 256), dtype, seed=3), _x((256,), dtype, seed=4)
    for weight in (None, w):
        want = rref.rmsnorm_relayout_ref(
            jnp.asarray(x), None if weight is None else jnp.asarray(weight),
            (16, 128))
        got = pref.rmsnorm_relayout_ref(
            to_torch(x), None if weight is None else to_torch(weight),
            (16, 128))
        np.testing.assert_allclose(to_f32(got), to_f32(want), **TOL[dtype])


@pytest.mark.parametrize("m", [24, 40])
def test_rmsnorm_relayout_drops_rows_past_the_last_row_tile(m):
    """The reference's grid covers m // tm row tiles; the rest is dropped."""
    x = _x((m, 256), seed=5)
    want = r_norm(jnp.asarray(x), None, (16, 128))
    got = pops.rmsnorm_relayout(to_torch(x), None, (16, 128))
    assert tuple(got.shape) == tuple(want.shape) == (m // 16, 2, 16, 128)
    np.testing.assert_allclose(to_f32(got), to_f32(want), **TOL["float32"])


def test_rmsnorm_relayout_refuses_partial_column_tiles():
    x = _x((32, 200), seed=6)
    with pytest.raises(TypeError, match="reshape"):
        r_norm(jnp.asarray(x), None, (16, 128))
    with pytest.raises(ValueError, match="whole number"):
        pops.rmsnorm_relayout(to_torch(x), None, (16, 128))


def _tiled_offsets(rows, cols, tm, tn):
    """Kernel 4's and 5's store arithmetic: the flat offset of (row, col)."""
    r = np.arange(rows)[:, None]
    j = np.arange(cols)[None, :]
    return (r // tm) * cols * tm + (r % tm) * tn + (j // tn) * tm * tn + j % tn


@pytest.mark.parametrize("m,n,tile,dtype", [
    (64, 256, (16, 128), "bfloat16"), (40, 384, (8, 128), "float32"),
    (48, 96, (16, 24), "float32")])
def test_rmsnorm_relayout_kernel_args_emulated(m, n, tile, dtype):
    """The kernel's arguments drive its store into the reference's tiles."""
    x, w = _x((m, n), dtype, seed=8), _x((n,), "float32", seed=9)
    a = pnorm.norm_args(to_torch(x), to_torch(w), tile, 1e-6)
    assert (a.rows, a.cols, a.tm, a.tn) == ((m // tile[0]) * tile[0], n,
                                            *tile)
    assert (a.dtype, a.w_dtype) == ({"float32": 0, "bfloat16": 1}[dtype], 0)
    xf = x[:a.rows].astype(np.float32)
    y = xf / np.sqrt((xf * xf).mean(-1, keepdims=True) + 1e-6) * w
    out = np.full(a.rows * a.cols, np.nan, np.float32)
    out[_tiled_offsets(a.rows, a.cols, a.tm, a.tn)] = y
    want = r_norm(jnp.asarray(x), jnp.asarray(w), tile)
    np.testing.assert_allclose(out.reshape(want.shape), to_f32(want),
                               **TOL[dtype])


# -- kernel 5: quantize_tiled -------------------------------------------------
def _qx(m, n, dtype, seed):
    """Rows of mixed magnitude, an all-zero row, and a row of exact .5 ties
    (amax 127, so the scale is 1.0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)) * rng.uniform(0.01, 100, (m, 1))
    x[1] = 0.0
    ties = np.array([127.0, 2.5, -0.5, 1.5, -2.5, 0.5, -1.5, 3.5, -126.5])
    x[2] = np.resize(ties, n)
    return x.astype(DTYPES[dtype])


TIES_Q = np.array([127, 2, 0, 2, -2, 0, -2, 4, -126], np.int8)


@pytest.mark.parametrize("m,n", [(64, 256), (32, 384), (96, 256)])
@pytest.mark.parametrize("d_buf", [1, 5])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_tiled_matches_reference(m, n, d_buf, dtype):
    x = _qx(m, n, dtype, seed=23)
    v, s = r_quant(jnp.asarray(x), (32, 128), d_buf=d_buf)
    vr, sr = _jit_quant_ref(jnp.asarray(x), (32, 128))
    pv, ps = pops.quantize_tiled(to_torch(x), (32, 128), d_buf=d_buf)
    assert pv.dtype == torch.int8 and ps.dtype == torch.float32
    assert tuple(pv.shape) == v.shape and tuple(ps.shape) == s.shape
    # bitwise against the reference's kernel and its jitted oracle; XLA
    # compiles amax / 127.0 into amax * f32(1 / 127) in both
    np.testing.assert_array_equal(bits(pv), bits(v))
    np.testing.assert_array_equal(bits(ps), bits(s))
    np.testing.assert_array_equal(bits(pv), bits(vr))
    np.testing.assert_array_equal(bits(ps), bits(sr))
    logical = pref.untile_ref(pv).numpy()
    assert ps[1].item() == 1.0 and not logical[1].any()
    assert ps[2].item() == 1.0
    np.testing.assert_array_equal(logical[2], np.resize(TIES_Q, n))


_jit_quant_ref = jax.jit(rref.quantize_tiled_ref, static_argnums=1)


def test_quantize_tiled_ref_twin_bitwise():
    for dtype in sorted(DTYPES):
        x = _qx(64, 256, dtype, seed=29)
        vr, sr = _jit_quant_ref(jnp.asarray(x), (32, 128))
        pv, ps = pref.quantize_tiled_ref(to_torch(x), (32, 128))
        np.testing.assert_array_equal(bits(pv), bits(vr))
        np.testing.assert_array_equal(bits(ps), bits(sr))
        # run op by op, the oracle divides: its scales are within one ulp
        _, se = rref.quantize_tiled_ref(jnp.asarray(x), (32, 128))
        np.testing.assert_array_max_ulp(ps.numpy(), np.asarray(se), maxulp=1)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_tiled_non_finite_rows_match_reference(dtype):
    """A row holding a NaN gets scale 1.0 (its amax is NaN, and NaN > 0 is
    false), its NaN element 0 and the rest round(x); a row holding +inf or
    -inf gets scale inf and all zeros (inf / inf is NaN, which converts to
    0).  The plain version against the reference's kernel in interpret
    mode."""
    x = _qx(32, 256, "float32", seed=41)
    x[3, 5], x[4, 7], x[5, 9] = np.nan, np.inf, -np.inf
    x = x.astype(DTYPES[dtype])
    v, s = r_quant(jnp.asarray(x), (32, 128), d_buf=1)
    pv, ps = pref.quantize_tiled_ref(to_torch(x), (32, 128))
    np.testing.assert_array_equal(bits(pv), bits(v))
    np.testing.assert_array_equal(bits(ps), bits(s))
    assert ps[3:6, 0].tolist() == [1.0, float("inf"), float("inf")]
    logical = pref.untile_ref(pv).numpy()
    xf = to_f32(to_torch(x))
    assert logical[3, 5] == 0 and not logical[4:6].any()
    want3 = np.clip(np.round(np.delete(xf[3], 5)), -127, 127)
    np.testing.assert_array_equal(np.delete(logical[3], 5), want3)
    qv, qs = pops.quantize_tiled(to_torch(x), (32, 128))
    np.testing.assert_array_equal(bits(qv), bits(v))
    np.testing.assert_array_equal(bits(qs), bits(s))


def test_quantize_tiled_scales_past_the_last_row_tile_are_nan():
    """The reference writes no scale past (m // tm) * tm rows (its
    interpreter leaves NaN); the port writes NaN there."""
    x = _qx(40, 256, "float32", seed=31)
    v, s = r_quant(jnp.asarray(x))
    pv, ps = pops.quantize_tiled(to_torch(x))
    np.testing.assert_array_equal(bits(pv), bits(v))
    np.testing.assert_array_equal(bits(ps[:32]), bits(np.asarray(s)[:32]))
    assert np.isnan(np.asarray(s)[32:]).all() and torch.isnan(ps[32:]).all()


def test_quantize_tiled_refuses_partial_column_tiles():
    x = _x((64, 200), seed=6)
    with pytest.raises(TypeError, match="reshape"):
        r_quant(jnp.asarray(x))
    with pytest.raises(ValueError, match="whole number"):
        pops.quantize_tiled(to_torch(x))


def test_quantize_tiled_kernel_args_emulated():
    x = _qx(96, 384, "bfloat16", seed=37)
    a = pquant.quant_args(to_torch(x), (32, 128))
    assert (a.rows, a.cols, a.tm, a.tn, a.dtype) == (96, 384, 32, 128, 1)
    pv, _ = pquant.quantize_tiled_plain(to_torch(x))
    logical = pref.untile_ref(pv).numpy()
    out = np.zeros(a.rows * a.cols, np.int8)
    out[_tiled_offsets(a.rows, a.cols, a.tm, a.tn)] = logical
    v, _ = r_quant(jnp.asarray(x))
    np.testing.assert_array_equal(out.reshape(v.shape), np.asarray(v))


# -- the ops layer and the kernel registry ------------------------------------
def test_ops_exports_match_reference():
    assert sorted(pops.__all__) == sorted(rops.__all__)
    assert pops.rmsnorm_relayout is pnorm.rmsnorm_relayout
    assert pops.quantize_tiled is pquant.quantize_tiled


def test_every_kernel_names_a_pallas_call_of_the_reference():
    """Each registered kernel's ``replaces`` is the file:line of a
    ``pl.pallas_call`` in the reference, and together they cover all six."""
    sites = set()
    for k in _build.KERNELS:
        path, line = k.replaces.split(":")
        with open(f"{ROOT}/{path}") as f:
            text = f.read().splitlines()[int(line) - 1]
        assert "pallas_call(" in text, (k.name, k.replaces, text)
        assert (_build.CSRC / k.source).exists()
        sites.add(k.replaces)
    assert len(sites) == len(_build.KERNELS) == 6


def test_build_log_is_read_back_for_a_library_built_earlier(monkeypatch,
                                                           tmp_path):
    """A library found built does not start nvcc, and its build log (kept
    beside it) is what ``BUILD_LOG`` holds for it."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    src = "flash_attention.cu"
    lib = _build._target(src)
    lib.write_bytes(b"")
    lib.with_suffix(".log").write_text("ptxas info    : Used 99 registers")
    assert _build.build_all([src]) == [lib]
    assert _build.BUILD_LOG == {src: "ptxas info    : Used 99 registers"}


@pytest.mark.parametrize("fn,args", [
    (pops.rmsnorm_relayout, (None, (16, 128))),
    (pops.quantize_tiled, ((32, 128),))])
def test_wrappers_launch_or_raise_off_the_cpu(fn, args):
    x = torch.empty(64, 256, device="meta")
    with pytest.raises(NotImplementedError, match=re.escape("meta")):
        fn(x, *args)
