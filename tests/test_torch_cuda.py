"""The port's hand-written CUDA kernels on the card, held against their plain
PyTorch versions (which the CPU runs).

Every test here is marked ``cuda`` and skips without a GPU.  The module
imports neither JAX nor the reference, so it runs on a machine that has only
PyTorch and the CUDA toolkit::

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro_torch.core as PC  # noqa: E402
from repro_torch.core import plugin_compiler as ppc  # noqa: E402
from repro_torch.core import xdma as px  # noqa: E402
from repro_torch.kernels import agu as pagu  # noqa: E402
from repro_torch.kernels import datapath as DP  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import fused_rmsnorm_relayout as FN  # noqa: E402
from repro_torch.kernels import ops as pops  # noqa: E402
from repro_torch.kernels import quant as FQ  # noqa: E402

pytestmark = pytest.mark.cuda

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

ROWPAD = PC.Layout(None, "rowpad", pad=(8, 0))

# (src, dst, chain, logical shape, dtype, bitwise)
CHAINS = {
    "rmsnorm_store": ("MN", "MNM16N128", lambda s: (PC.RMSNormPlugin(
        weight=torch.linspace(-2, 2, s[-1]).to(torch.bfloat16)),),
        (256, 384), torch.bfloat16, False),
    "cast_scale_bias": ("MN", "MNP64", lambda s: (
        PC.Cast(torch.bfloat16), PC.Scale(1.5), PC.BiasAdd(0.25)),
        (128, 256), torch.float32, True),
    "vector_constants": ("NM", "MNM8N128", lambda s: (
        PC.Scale(torch.linspace(0.5, 2, s[-1])),
        PC.BiasAdd(torch.linspace(-1, 1, s[-1]))), (128, 256), torch.float32,
        True),
    "f16_rmsnorm": ("MN", "MN", lambda s: (
        PC.Cast(torch.float16), PC.RMSNormPlugin(eps=1e-5)), (64, 384),
        torch.float32, False),
    "load_transpose": ("MNM16N128", "MN", lambda s: (PC.Transpose(),),
                       (256, 384), torch.bfloat16, True),
    "gather_fill": ("MN", "MNM8N128", lambda s: (PC.GatherScatter(
        indices=np.r_[np.random.default_rng(1).permutation(s[0] - 1),
                      -1, s[0] + 3][1:]),), (128, 256), torch.float32, True),
    "gather_cols": ("MN", "MN", lambda s: (PC.GatherScatter(
        indices=np.arange(s[-1] - 1, -1, -1), axis=-1),), (64, 256),
        torch.bfloat16, True),
    "compress": ("MN", "MNM16N128", lambda s: (PC.Compress(block_rows=8),),
                 (256, 256), torch.bfloat16, True),
    "compress_roundtrip": ("MN", "MN", lambda s: (
        PC.Compress(block_rows=8), PC.Decompress()), (256, 256),
        torch.float32, True),
    "reduce_sum": ("MN", "MN", lambda s: (PC.ReduceStage("sum"),),
                   (512, 256), torch.float32, False),
    "reduce_max": ("MNM16N128", "MN", lambda s: (PC.ReduceStage("max"),),
                   (512, 256), torch.bfloat16, True),
    "rowpad_rmsnorm": ("MN", ROWPAD, lambda s: (PC.RMSNormPlugin(),),
                       (64, 256), torch.float32, False),
    "rank3": ("MN", "KV4M8N128", lambda s: (PC.RMSNormPlugin(),
                                            PC.Scale(2.0)),
              (8, 32, 256), torch.float32, False),
    "transpose_rmsnorm_sum": ("NMM8N128", "MNP64", lambda s: (
        PC.Transpose(), PC.RMSNormPlugin(), PC.ReduceStage("sum")),
        (128, 256), torch.float32, False),
    "two_reduces": ("MN", "MN", lambda s: (
        PC.ReduceStage("max"), PC.Transpose(), PC.ReduceStage("sum")),
        (64, 256), torch.float32, False),
    # the chains kernels 2 and 3 once refused (ROADMAP §3, fault 1)
    "gather_int8": ("MN", "MN", lambda s: (PC.GatherScatter(
        indices=np.random.default_rng(3).permutation(s[0])),), (64, 128),
        torch.int8, True),
    "gather_fill_int32": ("MN", "MNM8N128", lambda s: (PC.GatherScatter(
        indices=np.r_[np.arange(s[0] - 2), -1, s[0] + 3]),), (128, 256),
        torch.int32, True),
    "transpose_int32": ("MN", "MNM8N128", lambda s: (PC.Transpose(),),
                        (128, 256), torch.int32, True),
    "nine_scales": ("MN", "MNM8N128", lambda s: tuple(
        PC.Scale(1.0 + k / 64) for k in range(9)), (64, 256), torch.float32,
        False),
    "scale_rank5": ("MN", "MN", lambda s: (PC.Scale(2.5),), (2, 2, 2, 8, 128),
                    torch.float32, False),
    "int_arith_sum": ("MN", "MN", lambda s: (
        PC.Scale(3), PC.BiasAdd(-7), PC.ReduceStage("sum")), (64, 128),
        torch.int8, True),
    "int_to_float_cast": ("MN", "MNM8N128", lambda s: (
        PC.Transpose(), PC.Cast(torch.float32), PC.Scale(0.5)), (128, 256),
        torch.int32, True),
    "compress_int16": ("MN", "MN", lambda s: (
        PC.Compress(block_rows=8), PC.Decompress()), (256, 256), torch.int16,
        True),
    "int64_rank3": ("MN", "MN", lambda s: (
        PC.Transpose(), PC.GatherScatter(indices=np.arange(s[0])[::-1],
                                         axis=0)), (4, 32, 128), torch.int64,
        True),
}


@pytest.fixture(autouse=True)
def _needs_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand-written kernels)")


def _logical(shape, dtype, seed=0, zero_blocks=False):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) * 4
    if zero_blocks:
        keep = torch.rand(shape[-2] // 8, generator=gen) < 0.5
        x = x * keep.repeat_interleave(8)[:, None]
    return x.to(dtype)


def _layout(name):
    return name if isinstance(name, PC.Layout) else PC.by_name(name)


def _equal_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.float64])
def test_relayout_kernel_bitwise_vs_plain(dtype):
    x = _logical((256, 384), torch.float32, seed=2).to(dtype).cuda()
    before = pagu.RELAYOUT.launches
    for src, dst, t in CANONICAL_PAIRS:
        sl, dl = PC.by_name(src), PC.by_name(dst)
        xin = sl.from_logical(x)
        got = pagu.relayout_kernel(xin, sl, dl, t)
        assert _equal_bits(got, pagu.relayout_plain(xin, sl, dl, t)), \
            (src, dst, t)
    torch.cuda.synchronize()
    assert pagu.RELAYOUT.launches == before + len(CANONICAL_PAIRS)


# untiled pairs, which take any shape: (src, dst, transpose)
RAGGED_PAIRS = [("MN", "MN", True), ("MN", "NM", False), ("NM", "MN", True),
                ("MN", "MNP64", False), ("NM", "MNP64", False),
                ("MNP64", "NM", False)]
RAGGED_SHAPES = [(37, 100), (65, 131), (130, 66), (3, 1000)]


def _misaligned(x):
    """``x`` copied to a buffer whose base is one element past a 16-byte
    boundary, so no access of the kernel may be a 16-byte pack there."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_relayout_kernel_ragged_shapes_bitwise(dtype, shape, misaligned):
    """Extents that are not a whole number of 64 x 64 tiles or of 16-byte
    packs, and a source or destination base off 16-byte alignment."""
    x = _logical(shape, torch.float32, seed=3).to(dtype).cuda()
    for src, dst, t in RAGGED_PAIRS:
        sl, dl = PC.by_name(src), PC.by_name(dst)
        xin = sl.from_logical(x)
        if misaligned:
            xin = _misaligned(xin)
        got = pagu.relayout_kernel(xin, sl, dl, t)
        assert _equal_bits(got, pagu.relayout_plain(xin, sl, dl, t)), \
            (src, dst, t)


def _block_fn(sl, dl, chain):
    return ppc.compile_local(PC.XDMADescriptor(
        src=PC.Endpoint(layout=sl), dst=PC.Endpoint(layout=dl), pre=chain))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_rank2_path_bitwise_on_canonical_pairs(dtype):
    """Kernel 3's rank-2 path on the 16 canonical pairs: a Transpose where
    the pair transposes, else a row gather with one index out of range (the
    NaN fill); every launch counted on the rank-2 path."""
    x = _logical((256, 384), dtype, seed=4)
    for src, dst, t in CANONICAL_PAIRS:
        sl, dl = PC.by_name(src), PC.by_name(dst)
        idx = np.r_[np.random.default_rng(2).permutation(255), 300]
        chain = (PC.Transpose(),) if t else (PC.GatherScatter(indices=idx),)
        fn = _block_fn(sl, dl, chain)
        xin = sl.from_logical(x)
        want = fn(xin)
        before = dict(DP.BLOCK.paths)
        got = fn(xin.cuda())
        torch.cuda.synchronize()
        assert DP.BLOCK.paths.get("rank2", 0) == before.get("rank2", 0) + 1
        assert DP.BLOCK.paths.get("generic", 0) == before.get("generic", 0)
        assert _equal_bits(got.cpu(), want), (src, dst, t)


# (chain, bitwise) on ragged shapes through the rank-2 path
RANK2_CHAINS = {
    "transpose": (lambda s: (PC.Transpose(),), True),
    "gather_fill": (lambda s: (PC.GatherScatter(indices=np.r_[
        np.arange(s[0] - 1, 0, -1), s[0] + 7]),), True),
    "gather_cols_transpose": (lambda s: (PC.GatherScatter(
        indices=np.arange(s[1] - 1, -1, -1), axis=-1), PC.Transpose()), True),
    "transpose_scale_vec": (lambda s: (PC.Transpose(), PC.Scale(
        torch.linspace(0.5, 2, s[0]))), True),
    "reduce_max": (lambda s: (PC.ReduceStage("max"),), True),
    "reduce_sum": (lambda s: (PC.ReduceStage("sum"),), False),
    "transpose_rmsnorm": (lambda s: (PC.Transpose(), PC.RMSNormPlugin()),
                          False),
}


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(RANK2_CHAINS))
def test_block_rank2_path_ragged_vs_plain(name, dtype, shape, misaligned):
    chain, bitwise = RANK2_CHAINS[name]
    x = _logical(shape, dtype, seed=6)
    for src, dst in (("MN", "MN"), ("NM", "MNP64")):
        sl, dl = PC.by_name(src), PC.by_name(dst)
        fn = _block_fn(sl, dl, chain(shape))
        xin = sl.from_logical(x)
        want = fn(xin)
        xc = _misaligned(xin.cuda()) if misaligned else xin.cuda()
        before = DP.BLOCK.paths.get("rank2", 0)
        got = fn(xc)
        torch.cuda.synchronize()
        assert DP.BLOCK.paths.get("rank2", 0) > before
        got = got.cpu()
        if bitwise:
            assert _equal_bits(got, want), (src, dst)
        else:
            assert got.dtype == want.dtype and got.shape == want.shape
            tol = (dict(rtol=2e-2, atol=1e-2) if got.element_size() < 4
                   else dict(rtol=1e-4, atol=1e-4))
            torch.testing.assert_close(got.float(), want.float(), **tol)


def test_relayout_kernel_keeps_nan_payloads_and_negative_zero():
    bits = torch.tensor([0x7FC00001, 0x7F800001, 0x80000000, 0xFFC12345],
                        dtype=torch.int64).to(torch.int32)
    x = bits.repeat(64 * 128 // 4).view(torch.float32).reshape(64, 128)
    got = pagu.relayout_kernel(x.cuda(), PC.MN, PC.MN, True).cpu()
    assert torch.equal(got.view(torch.int32), x.T.contiguous().view(torch.int32))


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_datapath_kernels_vs_plain(name):
    src, dst, chain, shape, dtype, bitwise = CHAINS[name]
    sl, dl = _layout(src), _layout(dst)
    x = sl.from_logical(_logical(shape, dtype, seed=5,
                                 zero_blocks="compress" in name))
    desc = PC.XDMADescriptor(src=PC.Endpoint(layout=sl),
                             dst=PC.Endpoint(layout=dl), pre=chain(shape))
    fn = ppc.compile_local(desc)
    want = fn(x)                                  # plain version, CPU
    counts = (DP.STREAMED.launches, DP.BLOCK.launches)
    got = fn(x.cuda())
    torch.cuda.synchronize()
    assert (DP.STREAMED.launches, DP.BLOCK.launches) != counts
    if isinstance(want, PC.CTensor):
        assert torch.equal(got.mask.cpu(), want.mask)
        got, want = got.values, want.values
    got = got.cpu()
    if bitwise:
        assert _equal_bits(got, want)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        tol = (dict(rtol=2e-2, atol=1e-2) if got.element_size() < 4
               else dict(rtol=1e-4, atol=1e-4))
        torch.testing.assert_close(got.float(), want.float(), **tol)


# -- kernel 2's two paths ------------------------------------------------------
# layouts whose logical rows run along the columns in 16-byte packs (each
# NMM8N128 tile is row-major): every pair of them takes the rows path
ROW_LAYOUTS = ("MN", "MNM8N128", "MNM16N128", "MNM32N128", "MNM8N8", "MNP64",
               "NMM8N128")

# the chains of tests/test_torch_plugin_compiler.py's STREAMED_CASES
STREAMED_CHAINS = {
    "rmsnorm_store": lambda s: (PC.RMSNormPlugin(),),
    "rmsnorm_weight_bf16": lambda s: (PC.RMSNormPlugin(
        weight=torch.linspace(-2, 2, s[-1]).to(torch.bfloat16)),),
    "cast_scale_bias": lambda s: (PC.Cast(torch.bfloat16), PC.Scale(1.5),
                                  PC.BiasAdd(0.25)),
    "scale_bias_vectors": lambda s: (PC.Scale(torch.linspace(0.5, 2, s[-1])),
                                     PC.BiasAdd(torch.linspace(-1, 1, s[-1]))),
    "identity": lambda s: (PC.Identity(),),
    "cast_f16_rmsnorm": lambda s: (PC.Cast(torch.float16),
                                   PC.RMSNormPlugin(eps=1e-5)),
}


def _streamed_vs_plain(src, dst, chain, x, path, misaligned=False):
    """Kernel 2 on the logical ``x`` moved from ``src`` to ``dst``: the launch
    counted on ``path``, and the result held against the plain version on
    the CPU (bitwise without an RMSNorm, else within the chain tolerance)."""
    sl, dl = _layout(src), _layout(dst)
    xin = sl.from_logical(x)
    prog = DP.StreamedDatapath(chain, sl, dl, tuple(xin.shape), xin.dtype)
    want = prog(xin)
    xc = _misaligned(xin.cuda()) if misaligned else xin.cuda()
    before = dict(DP.STREAMED.paths)
    got = prog(xc)
    torch.cuda.synchronize()
    for p in DP.STREAM_PATHS:
        assert DP.STREAMED.paths.get(p, 0) == before.get(p, 0) + (p == path), \
            (src, dst, path, DP.STREAMED.paths)
    got = got.cpu()
    if not any(isinstance(p, PC.RMSNormPlugin) for p in chain):
        assert _equal_bits(got, want), (src, dst)
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    half = x.element_size() < 4 or any(
        isinstance(p, PC.Cast) and p.dtype.itemsize < 4 for p in chain)
    tol = (dict(rtol=2e-2, atol=1e-2) if half
           else dict(rtol=2e-5, atol=1e-5))
    torch.testing.assert_close(got.float(), want.float(), **tol,
                               msg=lambda m: f"{src}->{dst}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(STREAMED_CHAINS))
def test_streamed_rows_path_layout_pairs(name, dtype):
    shape = (64, 256)
    x = _logical(shape, dtype, seed=8)
    chain = STREAMED_CHAINS[name](shape)
    for src in ROW_LAYOUTS:
        for dst in ROW_LAYOUTS:
            _streamed_vs_plain(src, dst, chain, x, "rows")


# (src, dst, logical shape): rows that are not a whole number of blocks,
# widths that are not a power of two (gemma3-27B's d_model among them) or
# not a whole number of warps' chunks, and a bf16 row wider than one
# block's registers (re-read)
RAGGED_STREAMS = [("MN", "MNP64", (37, 256)), ("MN", "MN", (33, 136)),
                  ("MN", "MNM16N128", (32, 5376)), ("MNP64", "MN", (5, 1000)),
                  ("MN", "MNM8N128", (8, 24832))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("src,dst,shape", RAGGED_STREAMS)
def test_streamed_rows_path_ragged(src, dst, shape, dtype):
    x = _logical(shape, dtype, seed=10)
    for name in ("rmsnorm_weight_bf16", "cast_scale_bias", "cast_f16_rmsnorm"):
        _streamed_vs_plain(src, dst, STREAMED_CHAINS[name](shape), x, "rows")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_streamed_generic_path_vs_plain(dtype):
    """The generic path: a side that runs along the rows, a width that is
    not a whole number of chunks, and a view one element off a 16-byte
    boundary."""
    for name, chain in sorted(STREAMED_CHAINS.items()):
        for src, dst, shape, off in (("NM", "MNM8N128", (64, 256), False),
                                     ("MNM16N128", "NM", (32, 384), False),
                                     ("MN", "MNP64", (24, 250), False),
                                     ("MN", "MNM16N128", (64, 256), True)):
            x = _logical(shape, dtype, seed=11)
            _streamed_vs_plain(src, dst, chain(shape), x, "generic", off)


@pytest.mark.parametrize("src,path", [("MN", "rows"), ("NM", "generic")])
def test_streamed_row_wider_than_shared_memory(src, path):
    """A 64 x 65,536 f32 RMSNorm transfer (a 256 KiB row): the rows path
    re-reads what its registers do not hold, the generic path what its
    shared memory does not."""
    x = _logical((64, 65536), torch.float32, seed=12)
    _streamed_vs_plain(src, "MNM8N128", (PC.RMSNormPlugin(),), x, path)


@pytest.mark.parametrize("backend", ["auto", "fused", "pallas", "compiled"])
def test_transfer_on_cuda_matches_cpu(backend):
    descs = [PC.describe("MN", "MNM16N128", backend=backend),
             PC.describe("MNM8N128", "MN", PC.Transpose(), backend=backend),
             PC.describe("MN", "MNM8N128", PC.Scale(2.0), backend=backend),
             PC.describe("MN", "MN", PC.Compress(8), PC.Decompress(),
                         backend=backend)]
    x = _logical((128, 256), torch.float32, seed=7, zero_blocks=True)
    for desc in descs:
        xin = desc.src.layout.from_logical(x)
        got = px.transfer(xin.cuda(), desc)
        assert got.is_cuda
        assert _equal_bits(got.cpu(), px.transfer(xin, desc)), desc.summary()


def test_queue_on_cuda_matches_the_transfers_in_turn():
    w = torch.linspace(0.5, 1.5, 256).to(torch.bfloat16).cuda()
    store = PC.describe("MN", "MNM16N128", PC.RMSNormPlugin(weight=w))
    load = PC.describe("MNM16N128", "MN", PC.Transpose(), backend="compiled")
    x = _logical((128, 256), torch.bfloat16, seed=9).cuda()
    want = px.transfer(px.transfer(x, store), load)
    assert _equal_bits(px.XDMAQueue([store, load]).run(x), want)


# -- kernels 4-6: the fused kernel layer --------------------------------------
NORM_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.bfloat16: dict(rtol=2e-2, atol=1e-2)}


# (m, n, tile): 16-byte packs with one warp a row and with 128 threads a row,
# rows past the last row tile, tiles that are not a whole number of bf16
# packs (one element an access), and a row longer than the registers hold
@pytest.mark.parametrize("m,n,tile", [(256, 3072, (16, 128)),
                                      (40, 384, (8, 128)),
                                      (48, 120, (16, 40)),
                                      (32, 20480, (8, 128))])
@pytest.mark.parametrize("weight", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_relayout_kernel_vs_plain(m, n, tile, weight, dtype):
    x = _logical((m, n), dtype, seed=11)
    w = None if weight is None else _logical((n,), weight, seed=12)
    want = FN.rmsnorm_relayout_plain(x, w, tile)
    before = FN.NORM.launches
    got = pops.rmsnorm_relayout(x.cuda(), None if w is None else w.cuda(),
                                tile)
    torch.cuda.synchronize()
    assert FN.NORM.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               **NORM_TOL[dtype])


def _quant_input(m, n, dtype, seed):
    x = _logical((m, n), torch.float32, seed=seed)
    x = x * torch.linspace(0.01, 30, m)[:, None]
    x[1] = 0.0
    ties = torch.tensor([127.0, 2.5, -0.5, 1.5, -2.5, 0.5, -1.5, 3.5])
    x[2] = ties.repeat(-(-n // 8))[:n]
    return x.to(dtype)


@pytest.mark.parametrize("m,n,tile", [(96, 8192, (32, 128)),
                                      (64, 256, (32, 128)),
                                      (40, 384, (32, 128)),
                                      (64, 120, (32, 40)),
                                      (64, 40960, (32, 128))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_tiled_kernel_bitwise_vs_plain(m, n, tile, dtype):
    x = _quant_input(m, n, dtype, seed=13)
    want_v, want_s = FQ.quantize_tiled_plain(x, tile)
    before = FQ.QUANT.launches
    got_v, got_s = pops.quantize_tiled(x.cuda(), tile)
    torch.cuda.synchronize()
    assert FQ.QUANT.launches == before + 1
    assert _equal_bits(got_v.cpu(), want_v)
    assert _equal_bits(got_s.cpu(), want_s)
    assert got_s[1].item() == 1.0 and got_s[2].item() == 1.0


@pytest.mark.parametrize("tile", [(32, 128), (32, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_tiled_kernel_non_finite_rows_bitwise(tile, dtype):
    """A NaN row: scale 1.0, its NaN element 0; an inf or -inf row: scale
    inf, all values 0 — values and scales bitwise the plain version's (16-byte
    packs with (32, 128), one element an access with (32, 40))."""
    n = 4 * tile[1]
    x = _quant_input(64, n, torch.float32, seed=17)
    x[3, 5], x[4, 7], x[5, 9] = float("nan"), float("inf"), float("-inf")
    x[6, :] = float("nan")
    x = x.to(dtype)
    want_v, want_s = FQ.quantize_tiled_plain(x, tile)
    got_v, got_s = pops.quantize_tiled(x.cuda(), tile)
    torch.cuda.synchronize()
    assert _equal_bits(got_v.cpu(), want_v)
    assert _equal_bits(got_s.cpu(), want_s)
    assert got_s[3:7, 0].tolist() == [1.0, float("inf"), float("inf"), 1.0]
    logical = got_v.cpu().permute(0, 2, 1, 3).reshape(64, n)
    assert logical[3, 5] == 0 and not logical[4:7].any()


# (B, Sq, Sk, H, KV, hd, causal, window, dtype)
FLASH_CASES = {
    "causal_ragged": (2, 96, 96, 1, 1, 16, True, None, torch.float32),
    "window": (1, 200, 200, 1, 1, 64, True, 70, torch.float32),
    "full_bf16": (2, 128, 128, 1, 1, 128, False, None, torch.bfloat16),
    "sq_gt_sk": (1, 100, 40, 1, 1, 32, True, None, torch.float32),
    "no_live_key": (1, 130, 40, 1, 1, 32, False, 8, torch.float32),
    "gqa_window_bf16": (1, 256, 256, 8, 2, 128, True, 64, torch.bfloat16),
    "gqa_f16": (2, 64, 64, 4, 4, 64, True, None, torch.float16),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_attention_kernel_vs_plain(name):
    B, Sq, Sk, H, KV, hd, causal, window, dtype = FLASH_CASES[name]
    q = _logical((B * Sq * H, hd), dtype, seed=21).reshape(B, Sq, H, hd)
    k = _logical((B * Sk * KV, hd), dtype, seed=22).reshape(B, Sk, KV, hd)
    v = _logical((B * Sk * KV, hd), dtype, seed=23).reshape(B, Sk, KV, hd)
    q, k = q / 4, k / 4
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    before = FA.FLASH.launches
    path = "fma" if dtype == torch.float32 else "mma"
    before_path = FA.FLASH.paths.get(path, 0)
    if H == 1:
        fold = lambda t: t[:, :, 0]                       # noqa: E731
        want = FA.flash_attention_plain(fold(q), fold(k), fold(v),
                                        causal=causal, window=window)
        got = FA.flash_attention(fold(q).cuda(), fold(k).cuda(),
                                 fold(v).cuda(), causal=causal, window=window)
    else:
        want = FA.flash_attention_gqa_plain(q, k, v, causal=causal,
                                            window=window)
        got = FA.flash_attention_gqa(q.cuda(), k.cuda(), v.cuda(),
                                     causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.FLASH.launches == before + 1
    assert FA.FLASH.paths[path] == before_path + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.cpu().float(), want.float(), **tol)


def _flash_half_vs_plain(q, k, v, causal, window):
    """One launch of kernel 6 on its tensor-core path, held within 2e-2 of
    the plain version."""
    before = FA.FLASH.paths.get("mma", 0)
    want = FA.flash_attention_gqa_plain(q.cpu(), k.cpu(), v.cpu(),
                                        causal=causal, window=window)
    got = FA.flash_attention_gqa(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.FLASH.paths["mma"] == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("hd", [8, 24, 80, 100, 192, 256, 320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_attention_any_head_dim_vs_plain(dtype, hd):
    """A head dim between the kernel's instance widths runs on the next
    larger one (columns past hd zero, scale hd^-0.5 of the true hd); from
    129 to 256 every dtype takes the FMA path, above 256 the chunked path.
    GQA with a causal window."""
    B, S, H, KV = 1, 150, 4, 2
    q, k, v = (_logical((B * S * n, hd), torch.float32, seed=40 + i)
               .reshape(B, S, n, hd) / (4 if i < 2 else 1)
               for i, n in enumerate((H, KV, KV)))
    path = ("chunked" if hd > 256 else
            "fma" if dtype == torch.float32 or hd > 128 else "mma")
    before = FA.FLASH.paths.get(path, 0)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    want = FA.flash_attention_gqa_plain(q, k, v, causal=True, window=64)
    got = FA.flash_attention_gqa(q.cuda(), k.cuda(), v.cuda(), causal=True,
                                 window=64)
    torch.cuda.synchronize()
    assert FA.FLASH.paths[path] == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32
           else dict(rtol=2e-2, atol=2e-2))
    torch.testing.assert_close(got.cpu().float(), want.float(), **tol)


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float16, torch.bfloat16)])
def test_flash_attention_mixed_dtypes_vs_plain(q_dtype, kv_dtype):
    """q, k and v cast up to their promoted dtype before the launch; the
    result in q's dtype."""
    q = _logical((2 * 96, 64), torch.float32, seed=45).reshape(2, 96, 64) / 4
    k = _logical((2 * 96, 64), torch.float32, seed=46).reshape(2, 96, 64) / 4
    v = _logical((2 * 96, 64), torch.float32, seed=47).reshape(2, 96, 64)
    q, k, v = q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype)
    want = FA.flash_attention_plain(q, k, v, causal=True)
    got = FA.flash_attention(q.cuda(), k.cuda(), v.cuda(), causal=True)
    torch.cuda.synchronize()
    assert got.dtype == q_dtype and got.shape == want.shape
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2e-2,
                               atol=2e-2)


# (B, Sq, Sk, H, KV, causal, window): each edge of the mma path
FLASH_HALF_CASES = {
    "ragged_sk": (2, 200, 150, 1, 1, True, None),
    "sq_gt_sk": (1, 100, 40, 1, 1, True, None),
    "no_live_key": (1, 130, 40, 1, 1, False, 8),
    "window_not_causal": (1, 200, 200, 1, 1, False, 70),
    "gqa_causal_window": (1, 256, 256, 4, 2, True, 64),
    "full": (2, 128, 96, 1, 1, False, None),
}


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(FLASH_HALF_CASES))
def test_flash_attention_mma_path_edges(name, dtype, hd):
    """Ragged Sk, Sq > Sk, rows with no live key (the reference averages
    every V row), a window without causal, GQA with a window, and no mask,
    at every head dim, in bf16 and f16."""
    B, Sq, Sk, H, KV, causal, window = FLASH_HALF_CASES[name]
    q = _logical((B * Sq * H, hd), torch.float32, seed=31).reshape(B, Sq, H, hd)
    k = _logical((B * Sk * KV, hd), torch.float32, seed=32).reshape(B, Sk, KV, hd)
    v = _logical((B * Sk * KV, hd), torch.float32, seed=33).reshape(B, Sk, KV, hd)
    q, k = q / 4, k / 4
    _flash_half_vs_plain(*(t.to(dtype).cuda() for t in (q, k, v)), causal,
                         window)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("aligned", [True, False])
def test_flash_attention_mma_path_strided_gqa_views(aligned, dtype, hd):
    """q, k and v are strided, non-contiguous views of one packed (B, S,
    H + 2 KV, hd) buffer, read in place; unaligned, the buffer starts one
    element past a 16-byte boundary and the kernel moves single elements."""
    B, S, H, KV = 2, 160, 6, 2
    n = B * S * (H + 2 * KV) * hd
    flat = torch.empty(n + 1, dtype=dtype, device="cuda")
    flat = flat[:n] if aligned else flat[1:]
    qkv = flat.view(B, S, H + 2 * KV, hd)
    qkv.copy_(_logical((n // hd, hd), torch.float32, seed=34).reshape(
        qkv.shape) / 2)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert not q.is_contiguous() and not k.is_contiguous()
    args = FA.flash_args(q, k, v, torch.empty_like(q), causal=True,
                         window=48)
    assert args.vec == int(aligned)
    _flash_half_vs_plain(q, k, v, True, 48)


# -- the distributed Controller and the Fig. 4 baselines on the card ------------
def test_scheduler_on_the_card_bitwise_vs_serial_transfer():
    """A task graph through ``DistributedScheduler`` on CUDA tensors —
    batched rounds over two links, a chain, a future-fed auto task, a
    multicast — launches kernels 1-3 and equals serial ``xdma.transfer`` of
    the same resolved descriptors bitwise; the incremental makespan equals
    the replay's."""
    from repro_torch.kernels import _build
    from repro_torch.runtime import DistributedScheduler, Topology
    x = _logical((256, 384), torch.bfloat16, seed=40).cuda()
    w = torch.linspace(-2, 2, 384).to(torch.bfloat16).cuda()
    store = PC.describe("MN", "MNM16N128", PC.RMSNormPlugin(weight=w))
    load = PC.describe("MNM16N128", "MN", PC.Transpose(), backend="compiled")
    tile = PC.describe("MN", "MNM8N128", backend="pallas")
    x32 = _logical((256, 384), torch.float32, seed=41).cuda()
    sched = DistributedScheduler(Topology.host_device(devices=4))
    _build.reset_launches()
    f1 = sched.submit(x, store, link="h2d0", tenant="a")
    f2 = sched.submit(f1, load, link="h2d0", tenant="a")
    f3 = PC.XDMAQueue([store, load]).submit_to(sched, x, link="h2d1",
                                               tenant="b")
    f4 = sched.submit(x32, tile, link="h2d2")
    f5 = sched.submit(f4, PC.describe("MNM8N128", "auto"), link="d2h2",
                      deps=(f2,))
    mc = sched.submit_multicast(x32, PC.describe(
        PC.Endpoint.local(PC.MN), PC.Endpoint.multicast(
            (("dev1", "MNM8N128"), ("dev2", "MNM8N128")))), src="host")
    sched.flush()
    torch.cuda.synchronize()
    assert pagu.RELAYOUT.launches > 0 and DP.STREAMED.launches > 0 \
        and DP.BLOCK.launches > 0
    s2 = px.transfer(px.transfer(x, store), load)
    s4 = px.transfer(x32, tile)
    d5 = sched._tasks[f5.task_id].desc
    assert not d5.has_auto
    for got, want in ((f1.result(), px.transfer(x, store)), (f2.result(), s2),
                      (f3.result(), s2), (f4.result(), s4),
                      (f5.result(), px.transfer(s4, d5))):
        assert got.is_cuda and _equal_bits(got, want)
    for d in ("dev1", "dev2"):
        assert _equal_bits(mc.result_at(d), px.transfer(
            x32, PC.describe("MN", "MNM8N128")))
    assert sched.makespan() == sched.report().makespan


@pytest.mark.parametrize("src,dst,transpose", [
    ("MN", "MNM8N128", False), ("MNM8N128", "MN", False),
    ("MN", "MNM16N128", False), ("MNM16N128", "MNM16N128", True),
    ("MNM8N128", "MNM16N128", False), ("MN", "NM", False)])
def test_baselines_on_the_card_bitwise_vs_kernel1(src, dst, transpose):
    """The four Fig. 4 setups on CUDA tensors equal kernel 1 bitwise."""
    from repro_torch.core import baselines as PB
    x = _logical((256, 256) if transpose else (128, 256), torch.float32,
                 seed=42).cuda()
    sl = PC.by_name(src)
    xin = sl.from_logical(x)
    desc = PC.describe(src, dst, *([PC.Transpose()] if transpose else []),
                       backend="pallas")
    before = pagu.RELAYOUT.launches
    want = px.transfer(xin, desc)
    torch.cuda.synchronize()
    assert pagu.RELAYOUT.launches == before + 1
    setups = ["sw_loop_1d_dma", "sw_agu_loop", "copy_then_transform"]
    if dst != "NM":          # the block loop returns NM as its logical matrix
        setups.append("sw_loop_2d_dma")
    for name in setups:
        got = getattr(PB, name)(xin, desc)
        assert got.is_cuda and _equal_bits(got, want), name


# -- remote movements and the movement-plane consumers on the card --------------
def test_remote_sides_launch_their_kernels_on_a_size_one_axis():
    """On a size-1 axis the collectives move nothing, so each remote
    descriptor is its two endpoint sides: kernel 2 for a Cast -> Scale post
    side, kernel 3 for a transposing src side, bitwise the CPU run."""
    from repro_torch import sharding as S
    E = PC.Endpoint
    x = _logical((64, 256), torch.float32, seed=3)
    descs = [(PC.describe(E.local(PC.MN), E.peer("x", [(0, 0)]),
                          post=(PC.Cast(torch.bfloat16), PC.Scale(0.5))),
              DP.STREAMED),
             (PC.describe(E.local(PC.MN), E.peer("x", [(0, 0)], PC.MNM8N8),
                          pre=(PC.Transpose(),)), DP.BLOCK),
             (PC.describe(E.local(PC.MN), E.all_to_all("x", 0, 1),
                          pre=(PC.Quantize(),),
                          post=(PC.Dequantize(torch.float32),)), None)]
    with S.local_axis("x"):
        for desc, kernel in descs:
            before = kernel.launches if kernel is not None else 0
            got = px.transfer(x.cuda(), desc)
            torch.cuda.synchronize()
            if kernel is not None:
                assert kernel.launches == before + 1, desc.summary()
            assert got.is_cuda and _equal_bits(got.cpu(), px.transfer(x, desc))
        g = _logical((3, 1000), torch.float32, seed=4)
        got = PC.compressed_psum(g.cuda(), "x", 1)
        assert _equal_bits(got.cpu(), PC.compressed_psum(g, "x", 1))


def test_a_gloo_world_on_one_card_matches_the_cpu_world(tmp_path):
    """Two ranks on the card(s): over gloo on one card (NCCL needs a card a
    rank), over NCCL on two.  Every output bitwise the CPU world's, the side
    kernels launched, the host hop counted in the wire bank under gloo and
    absent under NCCL."""
    import torch_remote_cases as RC
    from repro_torch import sharding as S
    from repro_torch.kernels import _build
    _build.build_all()                   # the ranks load the built libraries
    card = S.run_spmd(RC.card_body, (2,), ("x",), args=("cuda",),
                      device="cuda", workdir=str(tmp_path / "card"))
    cpu = S.run_spmd(RC.card_body, (2,), ("x",), args=("cpu",),
                     device="cpu", workdir=str(tmp_path / "cpu"))
    for a, b in zip(card, cpu):
        assert a["backend"] == S.pick_backend(2, "cuda")[0]
        for k in ("cast_scale", "transpose", "a2a_codec", "reduce_codec"):
            assert _equal_bits(a[k], b[k]), k
        assert a["launches"]["streamed_datapath"] >= 1
        assert a["launches"]["block_datapath"] >= 1
        if a["backend"] == "gloo":
            assert a["wire"]["host_hop_bytes"] > 0
        else:
            assert "host_hop_bytes" not in a["wire"]
        assert "host_hop_bytes" not in b["wire"]


def test_consumers_land_on_the_card(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import SyntheticLM, stage_batch
    from repro_torch.runtime import DistributedScheduler, Topology
    from repro_torch.serving import PagedKVPool, transfer as T
    kv = _logical((1, 256, 8, 128), torch.bfloat16, seed=5).cuda()
    tiled = T.kv_prefill_store(kv)
    back = T.kv_load_transposed(tiled)
    assert back.is_cuda and _equal_bits(
        back.cpu(), T.kv_load_transposed(T.kv_prefill_store(kv.cpu())))
    pool = PagedKVPool(4, 32)
    sched = DistributedScheduler(Topology.host_device(2))
    pool.bind(sched)
    mat = kv.reshape(256, 1024)[:32]
    pid = pool.alloc(1024, "bfloat16")
    pool.store(pid, mat)
    sched.flush(); pool.commit()
    pool.evict(pid)
    sched.flush(); pool.commit()
    pool.restore(pid)
    sched.flush(); pool.commit()
    f = pool.load(pid)
    sched.flush()
    assert f.result().is_cuda and _equal_bits(f.result(), mat)
    t = {"w": _logical((64, 128), torch.bfloat16, seed=6).cuda(),
         "step": torch.tensor(3)}
    m = CheckpointManager(str(tmp_path), stage_layout="auto")
    m.save(1, t, blocking=False)
    on_card = m.restore(1, t)
    assert on_card["w"].is_cuda and _equal_bits(on_card["w"], t["w"])
    on_cpu = m.restore(1, t, device="cpu")
    assert _equal_bits(on_cpu["w"], t["w"].cpu())
    ds = SyntheticLM(vocab=64, seq_len=8, global_batch=2, family="vlm",
                     d_model=16)
    staged = stage_batch(ds.batch_at(0), torch.bfloat16)
    assert all(v.is_cuda for v in staged.values())
    assert _equal_bits(staged["embeds"].cpu(), stage_batch(
        ds.batch_at(0), torch.bfloat16, device="cpu")["embeds"])


@pytest.mark.parametrize("src,dst", [("MN", "MNM16N128"), ("MNM16N128", "MN"),
                                     ("MNM16N128", "MNM16N128"),
                                     ("MN", "NM")])
def test_empty_chain_relayouts_take_kernel1_on_the_card(src, dst):
    """An empty chain under backend "auto" (page stores and loads, the
    checkpoint's at-rest layouts, multicast hops) runs on kernel 1 on the
    card, bitwise the plain composition the CPU runs; agu_stats keeps
    counting only the "pallas" backend."""
    x = _logical((64, 1024), torch.bfloat16, seed=7)
    xin = _layout(src).from_logical(x)
    desc = PC.describe(src, dst)
    stats = pagu.agu_stats()
    before = pagu.RELAYOUT.launches
    got = px.transfer(xin.cuda(), desc)
    torch.cuda.synchronize()
    identity = src == dst
    assert pagu.RELAYOUT.launches == before + (0 if identity else 1)
    assert pagu.agu_stats() == stats
    assert got.is_cuda and _equal_bits(got.cpu(), px.transfer(xin, desc))


# -- the MoE layer and the continuous-batching server -------------------------
def test_moe_layer_on_the_card_matches_the_cpu():
    """The qwen3-moe smoke layer in f32 (TF32 off): the same expert ids and
    kept slots on the card as on the CPU (the top-k and the dispatch sort
    fix their orders), the output within 1e-5 of max|y|."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.layers import moe as PM
    from repro_torch.layers._init import Init

    cfg = dataclasses.replace(configs.smoke_config("qwen3_moe_30b_a3b"),
                              dtype=torch.float32)
    p = PM.init_moe(Init(torch.Generator().manual_seed(0), "cpu"), cfg)
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pc = {k: v.cuda() for k, v in p.items()}
        got, got_aux = PM.moe_apply(cfg, pc, x.cuda())
        g_card = PM._route(cfg, pc["router"],
                           x.cuda().reshape(-1, cfg.d_model))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    want, want_aux = PM.moe_apply(cfg, p, x)
    g_cpu = PM._route(cfg, p["router"], x.reshape(-1, cfg.d_model))
    assert torch.equal(g_card[1].cpu(), g_cpu[1])
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * scale
    assert abs(float(got_aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))


def test_continuous_engine_on_the_card_matches_the_cpu():
    """Three requests through a 7-page pool (forced preemption): the card's
    tokens, steps and pool counters are the CPU's; page stores and loads
    launched kernel 1, evictions and restores kernel 3."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import lm
    from repro_torch.serving import (ContinuousBatchingEngine, PagedKVPool,
                                     uniform_stream)

    cfg = dataclasses.replace(configs.smoke_config("qwen3_1p7b"),
                              dtype=torch.float32)
    params = lm.init_params(cfg, 0, device="cpu")
    reqs = uniform_stream(cfg, 3, 0.0, prompt_len=8, max_new=4)

    def serve(device, p):
        return ContinuousBatchingEngine(
            cfg, p, max_len=24, max_batch=3, cache_dtype=torch.float32,
            pool=PagedKVPool(7, 32), device=device).serve(reqs)

    want = serve("cpu", params)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.reset_launches()
    try:
        got = serve("cuda", _to_card(params))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.synchronize()
    assert got.preemptions == want.preemptions > 0
    assert (got.steps, got.pool_stats) == (want.steps, want.pool_stats)
    for rid, toks in want.tokens.items():
        np.testing.assert_array_equal(got.tokens[rid], toks)
    assert pagu.RELAYOUT.launches > 0
    assert DP.BLOCK.launches > 0


def _to_card(tree):
    from repro_torch import _pytree
    return _pytree.tree_map_with_path(lambda p, t: t.cuda(), tree)
