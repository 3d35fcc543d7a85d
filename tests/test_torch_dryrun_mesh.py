"""The dry run on the production mesh counts what a real rank's step does.

``repro_torch.launch.dryrun.run_cell`` plays one rank of a mesh on meta
tensors inside ``sharding.meta_mesh``, whose collectives count and move
nothing.  Here one (2, 2) ("data", "model") gloo world on the CPU
(``tests/torch_remote_cases.py::dry_body``) runs the same cells for real
(a dense and an MoE smoke config, trained and decoded, and the dense one
on a context-parallel decode), and every rank's FLOP count
(``FlopCounterMode``), collective ledger (the ``collectives`` and MoE
``wire`` banks' growth over the step, key by key), state bytes, and the
bytes its ops move and hold (``op_cost``: bytes moved, argument, output,
temp and peak) equal ``run_cell(..., mesh=, rank=)``'s for that rank.

Below it: the meta mesh's own rules (a collective on a tensor that is not
on meta raises; shapes and counts as a real axis gives them), the MoE
dispatch bitwise the reference's after its scatter-adds of a fixed size
(dropped rows into the sentinel row, ``-0.0`` made ``+0.0`` as the
reference's add makes it), and the records of two production cells.
"""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_remote_cases as RC  # noqa: E402
from repro import configs as RCF  # noqa: E402
from repro.layers import moe as RMOE  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.layers import moe as PMOE  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return S.run_spmd(RC.dry_body, *RC.DRY_WORLD, device="cpu",
                      workdir=str(tmp_path_factory.mktemp("dry_world")))


@pytest.mark.parametrize("cell", range(len(RC.DRY_CELLS)),
                         ids=[f"{a}-{s[0]}" for a, s in RC.DRY_CELLS])
def test_the_meta_rank_counts_what_the_real_rank_does(world, cell):
    """Every rank of the real (2, 2) world against ``run_cell`` on meta for
    that rank: the same FLOPs, the same collective ledger key by key (calls
    and bytes by op and axis), the same MoE plane ledger, the same state
    bytes, the same bytes moved by the ops and the same argument, output
    and peak bytes (meta's counted as the CPU's real tensors are); and the
    record's derived fields are read from them."""
    arch, shape = RC.DRY_CELLS[cell]
    shape = ShapeConfig(*shape)
    mesh = M.MeshSpec(*RC.DRY_WORLD)
    for r, rank in enumerate(world):
        got = rank[cell]
        rec = DR.run_cell(configs.smoke_config(arch), shape, mesh=mesh,
                          rank=r)
        assert rec["flops_per_device"] == got["flops"] > 0, r
        assert rec["collectives"] == got["collectives"], r
        # the plane's ledger also counts calls by backend: meta here, gloo
        # in the world
        assert rec["wire"] == {k.replace("backend:gloo", "backend:meta"): v
                               for k, v in got["wire"].items()}, r
        assert rec["state_bytes_per_device"] == got["state_bytes"], r
        mem = got["memory"]
        assert rec["op_bytes_per_device"] == mem["op_bytes"] > \
            got["state_bytes"], (r, rec["op_bytes_per_device"], mem)
        assert rec["bytes_per_device"] == {
            "state": got["state_bytes"],
            **{k: mem[k] for k in ("argument", "output", "temp", "peak")}
        }, (r, rec["bytes_per_device"], mem)
        assert mem["peak"] >= mem["argument"] > 0, r
        assert rec["roofline_s"]["memory"] == \
            mem["op_bytes"] / DR.H100_HBM_BYTES_PER_S
        by_op, by_axis = DR.collective_bytes(got["collectives"], got["wire"])
        assert rec["collective_bytes_per_device"] == by_op
        assert rec["collective_bytes_by_axis"] == by_axis
        assert rec["roofline_s"]["collective"] == \
            sum(by_op.values()) / DR.H100_NVLINK_BYTES_PER_S
    if shape.name == "long":
        assert rec["axes"]["seq"] == "data"
        assert any(k.endswith(":data") for k in world[0][cell]["collectives"])
    if "moe" in arch:
        assert world[0][cell]["wire"].get("calls:all_to_all", 0) > 0


def test_a_collective_on_the_meta_mesh_counts_and_moves_nothing():
    """Shapes as the real collectives give them, the ledger counted as a
    real axis counts it, and a tensor that is not on meta refused."""
    with S.meta_mesh((2, 16, 16), ("pod", "data", "model"), rank=37) as m:
        assert m.backend == "meta" and m.world_size == 512
        pair = S.axis_over(("pod", "data"))
        assert (pair.name, pair.size, pair.index) == (("pod", "data"), 32, 2)
        assert S.mesh_axis(("data", "model")).index == 37
        assert S.axis_index("model") == 5
        x = torch.empty(4, 6, device="meta")
        before = S.collective_stats()
        assert S.all_gather(x, ("pod", "data"), 1).shape == (4, 192)
        y = S.gather_along(x.requires_grad_(), "model", 0)
        assert y.shape == (64, 6)
        y.sum().backward()                    # a reduce-scatter back
        assert x.grad.shape == (4, 6)
        assert S.all_reduce(x, "model", "max").shape == (4, 6)
        grown = {k: v - before.get(k, 0)
                 for k, v in S.collective_stats().items()
                 if v != before.get(k, 0)}
        assert grown == {"calls:all_gather:pod+data": 1,
                         "bytes:all_gather:pod+data": 96,
                         "calls:all_gather:model": 1,
                         "bytes:all_gather:model": 96,
                         "calls:reduce_scatter:model": 1,
                         "bytes:reduce_scatter:model": 64 * 6 * 4,
                         "calls:all_reduce_max:model": 1,
                         "bytes:all_reduce_max:model": 96}
        with pytest.raises(RuntimeError, match="meta mesh"):
            S.all_reduce(torch.ones(3), "model")
    assert S.registered_axes() == {}


def test_shards_take_a_batch_over_two_axes_and_a_seq_axis():
    """Neither the batch over ("pod", "data") nor a context-parallel
    ``seq`` axis is refused: ``Shards.data`` is the pair, ``dp`` its size,
    and the mesh names the ``seq`` axis."""
    cfg = configs.smoke_config("qwen3_1p7b")
    with S.meta_mesh((2, 2, 2), ("pod", "data", "model"), rank=5):
        sh = lm.shards_of(cfg.with_axes(S.Axes(batch=("pod", "data"),
                                               model="model")))
        assert sh.data == ("pod", "data") and sh.dp == 4
        assert sh.mesh == M.MeshSpec((2, 2, 2), ("pod", "data", "model"))
        sh = lm.shards_of(cfg.with_axes(S.Axes(batch=(), model="model",
                                               seq="data")), serving=True)
        assert sh.data is None and sh.dp == 1
        assert sh.mesh == M.MeshSpec((2, 2), ("data", "model"))


def _moe_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    T = 24
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    x[::5] = -0.0                        # whole rows of -0.0
    router = rng.standard_normal((cfg.d_model, cfg.n_experts)).astype(
        np.float32) * 0.3
    return x, router


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mixtral_8x7b"])
@pytest.mark.parametrize("factor", [0.5, 4.0])
def test_moe_dispatch_is_bitwise_the_references(arch, factor):
    """Routing, then dispatch at a capacity that drops rows (0.5) and at
    one that drops none: the expert ids equal the reference's and the aux
    loss (its expert counts now a scatter-add) within 1e-6 relative (the
    router's product and softmax round apart); fed the reference's gates
    and ids, the dispatch buffer is bitwise the reference's (a kept row of
    -0.0 is +0.0 there, as the reference's scatter-add leaves it), and so
    are the slots, the kept mask and the order."""
    pc = dataclasses.replace(configs.smoke_config(arch),
                             capacity_factor=factor)
    rc = dataclasses.replace(RCF.smoke_config(arch), capacity_factor=factor)
    x, router = _moe_inputs(pc, 7)
    _, pe, paux = PMOE._route(pc, torch.from_numpy(router),
                              torch.from_numpy(x))
    rg, re_, raux = RMOE._route(rc, jnp.asarray(router), jnp.asarray(x))
    assert np.array_equal(pe.numpy(), np.asarray(re_))
    assert abs(float(paux) - float(raux)) <= 1e-6 * float(raux)
    C = PMOE._capacity(pc, x.shape[0])
    got = PMOE._dispatch(pc, torch.from_numpy(x),
                         torch.from_numpy(np.array(re_)).long(),
                         torch.from_numpy(np.array(rg)), C)
    want = RMOE._dispatch(rc, jnp.asarray(x), re_, rg, C)
    assert bool(got[2].all()) == (factor > 1)     # rows dropped at 0.5
    assert np.array_equal(_bits(got[0]), _bits(want[0]))
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    kept_zero = (x[got[4].numpy()] == 0).all(-1) & got[2].numpy()
    assert kept_zero.any()                # a kept row of -0.0 reached it
    assert (_bits(got[0]) == 0x80000000).sum() == 0


@pytest.mark.parametrize("cell", [("qwen2-0.5b", "decode_32k", True),
                                  ("gemma3-27b", "long_500k", False)])
def test_a_production_cell_is_counted_with_every_term(cell):
    """Rank 0 of the 2 x 16 x 16 mesh's ``decode_32k`` step (the batch
    over ("pod", "data"), the logits' rows gathered over the pair) and of
    the 16 x 16 mesh's ``long_500k`` decode (the cache over "data"): no
    field null, the temp and peak bytes counted (``op_cost``) and positive,
    the peak at least the arguments, the ops' bytes above the state's and
    the memory term those bytes over the HBM rate."""
    arch, shape, multi_pod = cell
    rec = DR.run_cell(arch, shape, multi_pod=multi_pod)
    assert rec["n_devices"] == (512 if multi_pod else 256)
    nulls = {k for k, v in rec.items() if v is None}
    nulls |= {k for k, v in rec["bytes_per_device"].items() if v is None}
    assert not nulls, nulls
    mem = rec["bytes_per_device"]
    assert set(mem) == {"state", "argument", "output", "temp", "peak"}
    assert mem["temp"] > 0 and mem["peak"] > 0
    assert mem["peak"] >= mem["argument"] >= mem["state"] > 0
    assert rec["op_bytes_per_device"] > rec["state_bytes_per_device"]
    assert rec["roofline_s"]["memory"] == \
        rec["op_bytes_per_device"] / DR.H100_HBM_BYTES_PER_S
    assert rec["flops_per_device"] > 0 and rec["state_bytes_per_device"] > 0
    assert set(rec["roofline_s"]) == {"compute", "memory", "collective"}
    assert all(v > 0 for v in rec["roofline_s"].values())
    assert 0 < rec["useful_flop_ratio"] <= 1.5
    if multi_pod:
        assert rec["collective_bytes_by_axis"]["all_gather:pod+data"] > 0
    else:
        assert rec["collective_bytes_by_axis"]["all_reduce_max:data"] > 0
