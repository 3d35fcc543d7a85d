"""Parity of the port's Fig. 4 software baselines
(``repro_torch.core.baselines``) with the reference's and with the port's
own ``xdma_copy``.

Every setup is an element permutation of the same bytes, so every
comparison is bitwise: ① the software AGU loop (one contiguous copy per run
of the ``src⁻¹∘dst`` pattern pair), ② the 2D DMA loop (one strided block
per descriptor), ③ copy-then-transform.  The cases of
``tests/test_plugins.py:62,74`` run on the port, then every pair of the
canonical layouts, and the reference's refusals.
"""
import pytest

pytest.importorskip("torch")

import itertools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import core as C  # noqa: E402
import repro_torch.core as PC  # noqa: E402
from repro_torch.core import baselines as PB  # noqa: E402
from torch_parity import bits, reset_global_state, to_torch  # noqa: E402,F401

SETUPS = ("sw_loop_1d_dma", "sw_agu_loop", "sw_loop_2d_dma",
          "copy_then_transform")
CANONICAL = ["MN", "NM", "MNP64", "MNM8N128", "MNM16N128", "MNM32N128",
             "MNM8N8", "NMM8N128"]


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(src, dst, transpose, x_logical, setups=SETUPS, engine=True):
    """Each setup on both packages, held bitwise to the reference's output
    and to the port's xdma_copy (``engine=None``: where the reference's
    output is its engine's); returns the port's outputs."""
    plug = lambda M: [M.Transpose()] if transpose else []     # noqa: E731
    rd = C.describe(src, dst, *plug(C))
    pd = PC.describe(src, dst, *plug(PC))
    xin = C.by_name(src).from_logical(jnp.asarray(x_logical))
    xt = to_torch(np.asarray(xin))
    want = PC.xdma_copy(xt, pd)
    np.testing.assert_array_equal(bits(want), bits(C.xdma_copy(xin, rd)))
    outs = {}
    for name in setups:
        got = getattr(PB, name)(xt, pd)
        ref = getattr(C.baselines, name)(xin, rd)
        assert tuple(got.shape) == tuple(ref.shape), name
        np.testing.assert_array_equal(bits(got), bits(ref), err_msg=name)
        same = (tuple(ref.shape) == tuple(want.shape)
                and (bits(ref) == bits(want)).all())
        assert same or engine is None and name == "sw_loop_2d_dma", name
        if engine or same:
            assert tuple(got.shape) == tuple(want.shape), name
            np.testing.assert_array_equal(bits(got), bits(want), err_msg=name)
        outs[name] = got
    return outs


@pytest.mark.parametrize("src,dst", [("MN", "MNM16N128"), ("MNM16N128", "MN"),
                                     ("MN", "MNM8N128"),
                                     ("MNM8N128", "MNM16N128")])
def test_baselines_match_engine(src, dst):
    _both(src, dst, False, rand((64, 256), 3))


def test_baselines_match_engine_transpose():
    _both("MNM16N128", "MNM16N128", True, rand((256, 256), 4))


def test_sw_agu_loop_transposing_pair_runs_one_element_at_a_time():
    """MN -> NM moves each element on its own (runs of one), with and
    without a Transpose on the stream."""
    x = rand((64, 256), 5)
    pair = PC.relayout_pair(PC.MN, PC.NM, (64, 256))
    assert pair.runs()[0] == 1
    _both("MN", "NM", False, x, ("sw_agu_loop",))
    _both("MN", "NM", True, rand((128, 128), 6), ("sw_agu_loop",))


@pytest.mark.parametrize("src,dst,transpose", [
    (s, d, False) for s, d in itertools.product(CANONICAL, CANONICAL)] + [
    (s, s, True) for s in CANONICAL])
def test_every_canonical_pair(src, dst, transpose):
    """Where the reference's setup computes what its engine does, so does
    the port's; where it does not (its block loop returns the logical
    matrix for an untiled destination other than MN, and reshapes the
    block grid of NMM8N128 as row-major), the port returns the reference's
    bytes all the same."""
    x = rand((256, 256) if transpose else (64, 256), 7)
    try:
        C.baselines.sw_loop_2d_dma(
            C.by_name(src).from_logical(jnp.asarray(x)),
            C.describe(src, dst, *([C.Transpose()] if transpose else [])))
        setups = ("sw_agu_loop", "sw_loop_2d_dma", "copy_then_transform")
    except (ValueError, TypeError):
        # the reference's block loop cannot walk this pair; the port refuses
        # it too (below), and the other setups still run
        setups = ("sw_agu_loop", "copy_then_transform")
        pd = PC.describe(src, dst, *([PC.Transpose()] if transpose else []))
        with pytest.raises((ValueError, TypeError)):
            PB.sw_loop_2d_dma(to_torch(np.asarray(C.by_name(src).from_logical(
                jnp.asarray(x)))), pd)
    _both(src, dst, transpose, x, setups, engine=None)


def test_baselines_refuse_other_chains():
    x = to_torch(rand((64, 256), 8))
    d = PC.describe("MN", "MNM8N128", PC.Scale(2.0))
    rd = C.describe("MN", "MNM8N128", C.Scale(2.0))
    for name in ("sw_agu_loop", "sw_loop_1d_dma", "sw_loop_2d_dma"):
        with pytest.raises(ValueError, match="copy/transpose only") as got:
            getattr(PB, name)(x, d)
        with pytest.raises(ValueError) as want:
            getattr(C.baselines, name)(jnp.asarray(x.numpy()), rd)
        assert str(got.value) == str(want.value)


def test_sw_agu_loop_refuses_a_pair_with_no_common_refinement():
    src, dst = C.tiled_layout(8, 48), C.tiled_layout(8, 32)
    x = rand((96, 96), 9)
    xin = src.from_logical(jnp.asarray(x))
    assert C.relayout_pair(src, dst, (96, 96)) is None
    with pytest.raises(ValueError) as want:
        C.baselines.sw_agu_loop(xin, C.describe(src, dst))
    psrc, pdst = PC.tiled_layout(8, 48), PC.tiled_layout(8, 32)
    with pytest.raises(ValueError, match="no common") as got:
        PB.sw_agu_loop(to_torch(np.asarray(xin)), PC.describe(psrc, pdst))
    assert str(got.value) == str(want.value)
