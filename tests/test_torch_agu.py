"""Parity of the port's AGU relayout (kernel 1) with the reference's.

The plan (kind, grid, block, fallback reason) must equal the reference's;
relayouts are element permutations, so results are compared bitwise in
f32, bf16 and int8.  On the CPU the relayout runs its plain version; the
kernel's own arguments are checked by an emulation of its index arithmetic,
and the kernel itself by the ``cuda`` tests on a GPU.
"""
import pytest

pytest.importorskip("torch")

import re  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import oracle as O  # noqa: E402
from repro.core import layouts as RL  # noqa: E402
from repro.kernels import agu as ragu  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402
from repro.kernels import relayout as rrk  # noqa: E402
from repro_torch.core import layouts as PL  # noqa: E402
from repro_torch.kernels import agu as pagu  # noqa: E402
from repro_torch.kernels import ops as pops  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402
from repro_torch.kernels import relayout as prk  # noqa: E402
from torch_parity import (bits, emulate_tile2,  # noqa: E402,F401
                          reset_global_state, to_torch)

CANONICAL_PAIRS = [
    ("MN", "MNM8N128", False), ("MN", "MNM16N128", False),
    ("MN", "MNM32N128", False), ("MNM8N128", "MN", False),
    ("MNM16N128", "MN", False), ("MNM32N128", "MN", False),
    ("MNM8N128", "MNM8N128", True), ("MNM16N128", "MNM16N128", True),
    ("MNM32N128", "MNM32N128", True), ("MN", "MN", True),
    ("MNM8N128", "MNM16N128", False),
    ("MN", "NM", False), ("NM", "MNM8N128", False),
    ("MN", "MNP64", False), ("MNP64", "MNM16N128", False),
    ("NMM8N128", "MN", False),
]
DTYPES = {"float32": np.float32, "bfloat16": jnp.bfloat16, "int8": np.int8}


def _x(shape, dtype="float32", seed=0):
    x = np.random.default_rng(seed).standard_normal(shape) * 20
    return x.astype(DTYPES[dtype])


def _plan_key(plan, reason):
    if plan is None:
        return (None, reason)
    return (plan.kind, plan.grid, plan.block, plan.out_logical, reason)


@pytest.mark.parametrize("shape", [(256, 256), (128, 384), (4096, 4096)])
@pytest.mark.parametrize("d_buf", [1, 3, 9])
def test_plans_match_reference_on_canonical_pairs(shape, d_buf):
    for src, dst, t in CANONICAL_PAIRS:
        want = ragu.plan_relayout(RL.by_name(src), RL.by_name(dst), shape,
                                  transpose=t, d_buf=d_buf)
        got = pagu.plan_relayout(PL.by_name(src), PL.by_name(dst), shape,
                                 transpose=t, d_buf=d_buf)
        assert _plan_key(*got) == _plan_key(*want), (src, dst, t)
        assert got[0].kind == "kernel"


@pytest.mark.parametrize("src,dst,shape,transpose", [
    ("MN", "MNM8N128", (2, 16, 256), False),              # rank:3
    ("t6", "t4", (24, 256), False),                       # nest-incompatible
    ("MNP64", "MNM8N128", (128, 256), True),              # pad-transpose
    ("rowpad", "MN", (32, 256), False),                   # row-pad
    ("MNM8N128", "MNM16N128", (24, 256), False),          # granule
    ("MNM8N128", "MNM8N128", (64, 256), False),           # identity
])
def test_fallback_reasons_match_reference(src, dst, shape, transpose):
    extra = {"t6": ((6, 128), None), "t4": ((4, 128), None),
             "rowpad": (None, (8, 0))}

    def lay(mod, name):
        if name in extra:
            tile, pad = extra[name]
            return mod.Layout(tile, name, pad=pad)
        return mod.by_name(name)

    try:
        want = _plan_key(*ragu.plan_relayout(lay(RL, src), lay(RL, dst),
                                             shape, transpose=transpose))
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            pagu.plan_relayout(lay(PL, src), lay(PL, dst), shape,
                               transpose=transpose)
        return
    got = _plan_key(*pagu.plan_relayout(lay(PL, src), lay(PL, dst), shape,
                                        transpose=transpose))
    assert got == want


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("src,dst,transpose", CANONICAL_PAIRS)
def test_relayout_bitwise_vs_reference(src, dst, transpose, dtype):
    x = _x((128, 256), dtype, seed=3)
    xin = np.asarray(RL.by_name(src).from_logical(jnp.asarray(x)))
    want = rops.relayout(jnp.asarray(xin), src_layout=RL.by_name(src),
                         dst_layout=RL.by_name(dst), transpose=transpose)
    got = pops.relayout(to_torch(xin), src_layout=PL.by_name(src),
                        dst_layout=PL.by_name(dst), transpose=transpose)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_agu_stats_match_reference_after_the_canonical_sweep():
    ragu.clear_agu_stats()
    pagu.clear_agu_stats()
    x = _x((256, 256), seed=5)
    t6 = (RL.Layout((6, 128), "t6"), RL.Layout((4, 128), "t4"))
    p6 = (PL.Layout((6, 128), "t6"), PL.Layout((4, 128), "t4"))
    for src, dst, t in CANONICAL_PAIRS + [("MNM8N128", "MNM8N128", False)]:
        xin = np.asarray(RL.by_name(src).from_logical(jnp.asarray(x)))
        rops.relayout(jnp.asarray(xin), src_layout=RL.by_name(src),
                      dst_layout=RL.by_name(dst), transpose=t)
        pops.relayout(to_torch(xin), src_layout=PL.by_name(src),
                      dst_layout=PL.by_name(dst), transpose=t)
    x24 = _x((24, 256), seed=6)
    rin = t6[0].from_logical(jnp.asarray(x24))
    want = rops.relayout(rin, src_layout=t6[0], dst_layout=t6[1])
    got = pops.relayout(to_torch(np.asarray(rin)), src_layout=p6[0],
                        dst_layout=p6[1])
    np.testing.assert_array_equal(bits(got), bits(want))
    assert pagu.agu_stats() == ragu.agu_stats()
    assert pagu.agu_stats()["kernel"] == len(CANONICAL_PAIRS)
    assert pagu.agu_stats()["reasons"] == {"nest-incompatible": 1}


@pytest.mark.parametrize("m,n,tile", [(16, 128, (8, 128)), (64, 256, (16, 128)),
                                      (96, 384, (32, 128))])
def test_tile_untile_wrappers_bitwise(m, n, tile):
    x = _x((m, n), seed=7)
    want = np.asarray(rrk.tile(jnp.asarray(x), tile, d_buf=3))
    got = prk.tile(to_torch(x), tile, d_buf=3)
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(pref.tile_ref(to_torch(x), tile)),
                                  bits(rref.tile_ref(jnp.asarray(x), tile)))
    np.testing.assert_array_equal(bits(prk.untile(got, d_buf=3)), bits(x))


@pytest.mark.parametrize("m,n,tile", [(256, 256, (16, 128)), (128, 256, (8, 128))])
def test_tiled_transpose_and_mn_transpose_wrappers(m, n, tile):
    t = np.asarray(rref.tile_ref(jnp.asarray(_x((m, n), seed=11)), tile))
    want = rrk.tiled_transpose(jnp.asarray(t), d_buf=5)
    got = prk.tiled_transpose(to_torch(t), d_buf=5)
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(pref.tiled_transpose_ref(to_torch(t))),
                                  bits(want))
    x = _x((m, n), seed=13)
    np.testing.assert_array_equal(bits(prk.mn_transpose(to_torch(x))),
                                  bits(x.T))
    np.testing.assert_array_equal(bits(pref.mn_transpose_ref(to_torch(x))),
                                  bits(x.T))
    blk = prk.tile_block(to_torch(x), *tile)
    np.testing.assert_array_equal(bits(prk.untile_block(blk)), bits(x))


def test_agu_relayout_raises_without_a_plan():
    x = torch.zeros(2, 16, 256)
    with pytest.raises(ValueError, match="rank:3"):
        pagu.agu_relayout(x, src_layout=PL.MN, dst_layout=PL.MNM8N128)


def test_identity_plan_returns_its_input():
    x = torch.zeros(64, 256)
    plan, _ = pagu.plan_relayout(PL.MN, PL.MN, (64, 256))
    assert plan.kind == "identity" and plan.run(x) is x


# -- kernel 1's arguments, emulated ------------------------------------------
def _emulate_relayout(x_flat, a, out_size):
    """The CUDA kernel's index arithmetic (``xdma::tile2_run`` with the Copy
    policy): every position of the dst's padded logical space reads (or
    zero-fills) and writes once, and every 16-byte pack the host chose is
    whole, consecutive and aligned."""
    assert a.t.vs in (1, 16 // a.elem_bytes) and a.t.vd in (1, 16 // a.elem_bytes)
    return emulate_tile2(a.t, x_flat, out_size)


@pytest.mark.parametrize("elem_bytes", [1, 2, 4, 8])
@pytest.mark.parametrize("src,dst,transpose", CANONICAL_PAIRS + [
    ("MNM32N128", "NMM8N128", False), ("NM", "MN", True),
    ("MNM8N8", "MNP64", False)])
def test_kernel_arguments_reproduce_the_relayout(src, dst, transpose,
                                                 elem_bytes):
    sl, dl = PL.by_name(src), PL.by_name(dst)
    shape = (128, 384)
    x = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)
    xin = sl.from_logical(x)
    a = pagu.relayout_args(sl, dl, shape, transpose, elem_bytes)
    want = pagu.relayout_plain(xin, sl, dl, transpose)
    got = _emulate_relayout(xin.reshape(-1).numpy(), a, want.numel())
    np.testing.assert_array_equal(got, want.reshape(-1).numpy())
    assert a.t.load_axis in (0, 1) and a.t.store_axis in (0, 1)


# (src, dst, transpose, shape, elem_bytes) -> (load axis, vs, store axis, vd)
ACCESS_CASES = {
    ("MN", "MNM8N128", False, (4096, 4096), 4): (1, 4, 1, 4),
    ("MNM16N128", "MN", True, (8192, 3072), 2): (0, 8, 1, 8),
    ("MN", "NM", False, (256, 384), 4): (1, 4, 0, 4),
    ("MN", "MNP64", False, (128, 384), 1): (1, 16, 1, 16),
    # extents that are not a whole number of packs: word copies on that side
    ("MN", "MN", True, (37, 100), 4): (0, 4, 1, 1),
    ("MN", "NM", False, (36, 102), 2): (1, 1, 0, 1),
    ("NM", "MNP64", False, (40, 20), 8): (0, 2, 1, 2),
    ("MN", "MNP64", False, (40, 100), 4): (1, 4, 1, 4),
    ("MN", "MNP64", False, (40, 102), 4): (1, 1, 1, 1),
}


@pytest.mark.parametrize("case", sorted(ACCESS_CASES))
def test_kernel_access_widths_and_ragged_shapes(case):
    """The host's choice of each side's run axis and access width, on shapes
    that are not a whole number of 64 x 64 tiles or of 16-byte packs."""
    src, dst, transpose, shape, elem_bytes = case
    sl, dl = PL.by_name(src), PL.by_name(dst)
    a = pagu.relayout_args(sl, dl, shape, transpose, elem_bytes)
    assert (a.t.load_axis, a.t.vs, a.t.store_axis, a.t.vd) == \
        ACCESS_CASES[case]
    x = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)
    xin = sl.from_logical(x)
    want = pagu.relayout_plain(xin, sl, dl, transpose)
    got = _emulate_relayout(xin.reshape(-1).numpy(), a, want.numel())
    np.testing.assert_array_equal(got, want.reshape(-1).numpy())


def test_relayout_oracle_agrees_with_the_port():
    x = _x((128, 256), seed=17)
    for src, dst, t in CANONICAL_PAIRS:
        xin = np.asarray(RL.by_name(src).from_logical(jnp.asarray(x)))
        want = O.relayout_oracle(xin, RL.by_name(src), RL.by_name(dst),
                                 transpose=t)
        got = pagu.relayout_plain(to_torch(xin), PL.by_name(src),
                                  PL.by_name(dst), t)
        np.testing.assert_array_equal(bits(got), bits(want))
