"""The dry run's bytes counter (``repro_torch.launch.op_cost``, the twin of
``repro.launch.hlo_cost``) against programs whose bytes are counted by
hand: the twins of ``tests/test_hlo_cost.py``'s cases, each to the byte.

An op bills its tensor operands read and its outputs written; a view bills
nothing; an in-place write into a slice bills the slice; loops run eagerly,
so each trip is counted as it runs.  A storage is held from the op that
allocates it until its last view dies, the step's arguments from the start.
A kernel's wrapper (and a collective) is one op, on meta and on the CPU
alike, whatever its plain version runs inside.
"""
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch import sharding as S  # noqa: E402
from repro_torch.core import describe, xdma  # noqa: E402
from repro_torch.core import layouts as L  # noqa: E402
from repro_torch.core import plugins as P  # noqa: E402
from repro_torch.kernels import agu, flash_attention as FA  # noqa: E402
from repro_torch.kernels import fused_rmsnorm_relayout as FR  # noqa: E402
from repro_torch.kernels import quant  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.op_cost import OpCost  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401

F32 = 4


def _count(fn, *arguments):
    """``(flops, memory)`` of one call of ``fn`` through the dry
    run's own counter (``dryrun.count_step``)."""
    flops, _, _, mem = DR.count_step(DR.Step(fn, arguments))
    return flops, mem


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_single_matmul_flops_and_bytes(device):
    """(64, 128) @ (128, 32) f32: 2 m k n FLOPs; both operands read once,
    the product written once; held: the operands, then the product."""
    a = torch.zeros(64, 128, device=device)
    b = torch.zeros(128, 32, device=device)
    flops, mem = _count(lambda: a @ b, a, b)
    assert flops == 2 * 64 * 128 * 32
    args, prod = (64 * 128 + 128 * 32) * F32, 64 * 32 * F32
    assert mem == {"op_bytes": args + prod, "argument": args,
                   "output": prod, "temp": prod, "peak": args + prod}


@pytest.mark.parametrize("trips", [1, 4, 10])
def test_a_loop_bills_every_trip(trips):
    """x = x @ a, ``trips`` times, (32, 32) f32: every trip reads two
    matrices and writes one (no trip count to read, each trip is counted
    as it runs); the previous product dies as the next is made, so at most
    two products are held."""
    a = torch.zeros(32, 32, device="meta")
    x0 = torch.zeros(32, 32, device="meta")

    def loop():
        x = x0
        for _ in range(trips):
            x = x @ a
        return x
    flops, mem = _count(loop, x0, a)
    m = 32 * 32 * F32
    assert flops == trips * 2 * 32 ** 3
    assert mem["op_bytes"] == trips * 3 * m
    assert mem["argument"] == 2 * m and mem["output"] == m
    assert mem["peak"] == 2 * m + min(trips, 2) * m


@pytest.mark.parametrize("write", ["copy_", "index_put_", "index_copy_"])
def test_a_slice_write_in_a_loop_bills_the_slice_not_the_buffer(write):
    """A cache-update loop: 32 trips writing row i of a (256, 1024, 4) f32
    buffer (4 MiB) bill each trip's 16 KiB update, made and read, and the
    16 KiB slice written (``copy_`` into a view, ``index_put_`` and
    ``index_copy_`` through an index), never the buffer: far below the
    32 x 4 MiB a whole-buffer write would cost.  The buffer is never
    copied, so nothing but one update is held beyond the arguments."""
    buf = torch.zeros(256, 1024, 4, device="meta")
    idx = [torch.zeros(1, dtype=torch.int64, device="meta")
           for _ in range(32)]
    row = 1024 * 4 * F32

    def fill():
        for i in range(32):
            upd = torch.full((1, 1024, 4), float(i), device="meta")
            if write == "copy_":
                buf[i] = upd[0]
            elif write == "index_put_":
                buf.index_put_((idx[i],), upd)
            else:
                buf.index_copy_(0, idx[i], upd)
        return buf
    _, mem = _count(fill, buf, idx)
    index = 0 if write == "copy_" else 8
    # made (written), read, and its slice written; the index read
    assert mem["op_bytes"] == 32 * (3 * row + index)
    assert mem["op_bytes"] < 3e7 < 32 * buf.numel() * F32
    assert mem["argument"] == 256 * row + 32 * 8
    assert mem["output"] == 256 * row
    assert mem["temp"] == 2 * row          # the old update and the new


@pytest.mark.parametrize("n", [1 << 10, 1 << 20, 1 << 21])
def test_bytes_scale_with_the_data(n):
    """v * 2 on n f32: n read and n written (8 MiB at 2^20), the product
    held beside the argument."""
    x = torch.zeros(n, device="meta")
    _, mem = _count(lambda: x * 2.0, x)
    assert mem == {"op_bytes": 8 * n, "argument": 4 * n, "output": 4 * n,
                   "temp": 4 * n, "peak": 8 * n}


def test_views_cost_nothing():
    """view, t, slice, select, expand, permute, reshape of a contiguous
    tensor, detach, unsqueeze_ and as_strided move no byte and hold none
    beyond the argument they view."""
    x = torch.zeros(1 << 16, device="meta")

    def views():
        v = x.view(256, 256).t()[2:].expand(3, 254, 256)
        w = x.reshape(-1, 2).permute(1, 0)[0].detach()
        u = x[:4096].view(64, 64)
        u.unsqueeze_(0)
        return v, w, u, x.as_strided((16, 16), (1, 16))
    _, mem = _count(views, x)
    nbytes = (1 << 16) * F32
    assert mem == {"op_bytes": 0, "argument": nbytes, "output": nbytes,
                   "temp": 0, "peak": nbytes}


def test_a_storage_is_freed_when_its_last_view_dies():
    """A storage is held by identity: its views keep it, each counted
    once, and it is freed when the last of them dies; the peak stays."""
    with OpCost() as cost:
        a = torch.empty(1000, device="meta")
        assert cost.live == 4000
        v, w = a[10:], a.view(10, 100)
        assert cost.live == 4000
        del a
        assert cost.live == 4000
        del v
        assert cost.live == 4000
        del w
        assert cost.live == 0
        b = torch.empty(250, device="meta")
        assert cost.live == 1000
    mem = cost.result(b)
    assert (mem["peak"], mem["output"], mem["temp"]) == (4000, 1000, 4000)


def _kernel_calls(dev):
    """``{name: (call, arguments, bytes moved, output bytes)}`` for each
    kernel wrapper, on ``dev``."""
    x = torch.zeros(64, 256, device=dev)
    w = torch.ones(256, device=dev)
    q = torch.zeros(1, 128, 4, 64, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16, device=dev)
    v = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16, device=dev)
    t = describe("MN", "MN", P.Transpose())
    xb = 64 * 256 * F32
    return {
        "relayout": (lambda: agu.relayout_kernel(x, L.MN, L.MNM8N128),
                     (x,), 2 * xb, xb),
        "block_datapath": (lambda: xdma.transfer(x, t), (x,), 2 * xb, xb),
        "rmsnorm_relayout": (lambda: FR.rmsnorm_relayout(x, w, (16, 128)),
                             (x, w), 2 * xb + 256 * F32, xb),
        # int8 values and an f32 scale a row
        "quantize_tiled": (lambda: quant.quantize_tiled(x), (x,),
                           xb + 64 * 256 + 64 * F32, 64 * 256 + 64 * F32),
        "flash_attention_gqa": (lambda: FA.flash_attention_gqa(q, k, v),
                                (q, k, v), 2 * q.numel() * 2
                                + 2 * k.numel() * 2, q.numel() * 2)}


@pytest.mark.parametrize("name", ["relayout", "block_datapath",
                                  "rmsnorm_relayout", "quantize_tiled",
                                  "flash_attention_gqa"])
def test_a_kernel_wrapper_counts_once_on_meta(name):
    """Each hand-written kernel's wrapper on meta (where it runs its plain
    version for the shapes) is one op: its operands read and its outputs
    written, held as outputs, none of the plain version's intermediates;
    the same numbers as the CPU run of the same call."""
    got = {}
    for dev in ("meta", "cpu"):
        fn, arguments, moved, out = _kernel_calls(dev)[name]
        with OpCost(arguments) as cost:
            y = fn()
        got[dev] = (cost.result(y), dict(cost.by_op))
        mem, by_op = got[dev]
        assert mem["op_bytes"] == moved, (dev, mem, by_op)
        assert len(by_op) == 1, by_op
        assert mem["output"] == mem["temp"] == out, (dev, mem)
        assert mem["peak"] == mem["argument"] + out
    assert got["meta"] == got["cpu"]


def test_a_collective_on_the_meta_mesh_is_one_op():
    """An all-gather of a (4, 6) f32 block over a model axis of 16: the
    block read, the (64, 6) result written and held, as on a real axis."""
    with S.meta_mesh((2, 16), ("data", "model"), rank=3):
        x = torch.zeros(4, 6, device="meta")
        with OpCost((x,)) as cost:
            y = S.all_gather(x, "model", 0)
        mem = cost.result(y)
    assert dict(cost.by_op) == {"_all_gather": (24 + 384) * F32}
    assert mem["peak"] == (24 + 384) * F32 and mem["output"] == 384 * F32
