"""The port's side of ``tests/test_torch_remote.py``: the remote cases as one
SPMD body, run in every rank of one 8-rank gloo world on the CPU.

This module imports no JAX: every rank imports it by name (``spawn``), and
only torch and ``repro_torch`` are needed there.  The inputs are the
reference tests' seeded arrays; rank ``r`` takes row ``r`` of each, as
``shard_map`` with ``PartitionSpec('x')`` hands device ``r`` its block.
"""
import numpy as np
import torch

N = 8
RING = tuple((i, (i + 1) % N) for i in range(N))
HALF = ((0, 4), (1, 5), (2, 6), (3, 7))    # prefill ranks 0-3 -> decode 4-7


def global_inputs():
    """The reference tests' inputs (``test_remote.py``, ``test_api.py``)."""
    rng = np.random.default_rng
    return {
        "g": rng(1).standard_normal((N, 1000)).astype(np.float32),
        "x": rng(2).standard_normal((N, 16, 128)).astype(np.float32),
        "kv": rng(3).standard_normal((N, 2, 32, 4, 16)).astype(np.float32),
        "a": rng(3).standard_normal((N, 8, 4, 16)).astype(np.float32),
    }


def _raises(fn) -> bool:
    try:
        fn()
    except Exception:
        return True
    return False


def port_body(mesh):
    """Every case, in one rank: ``{case: tensor or value}``.  The tensors
    carry a leading block dim of 1, as a ``shard_map`` out spec
    ``PartitionSpec('x')`` stacks them."""
    from repro_torch import core as C
    from repro_torch import sharding as S
    from repro_torch.core import plugin_compiler, remote, xdma
    from repro_torch.core.descriptor import Endpoint
    from repro_torch.runtime import telemetry
    from repro_torch.runtime.trace import capture
    from repro_torch.serving.transfer import cross_stage_transfer

    calls = _spy_collectives()
    xdma.clear_cache()
    plugin_compiler.clear_stats()
    telemetry.reset()
    r = S.axis_index("x")
    inp = {k: torch.from_numpy(v[r:r + 1].copy())
           for k, v in global_inputs().items()}
    g, x, kv, a = inp["g"], inp["x"], inp["kv"], inp["a"]
    out = {}
    local = lambda f, v: f(v[0])[None]        # noqa: E731  (xs[0] ... [None])

    # test_remote.py
    out["compressed_psum"] = local(lambda v: C.compressed_psum(v, "x", N), g)
    red, err = C.compressed_psum_with_feedback(
        g[0].reshape(125, 8), torch.zeros(125, 8), "x", N)
    out["feedback_reduced"], out["feedback_err"] = red[None], err[None]
    out["ppermute_codec"] = C.xdma_ppermute(
        x, "x", list(RING), pre=[C.Quantize()],
        post=[C.Dequantize(torch.float32)])
    out["ppermute_plain"] = C.xdma_ppermute(x, "x", list(RING))
    out["ppermute_half"] = C.xdma_ppermute(x, "x", list(HALF))
    out["cross_stage"] = local(lambda v: cross_stage_transfer(v, "x", HALF),
                               kv)
    out["cross_stage_transposed"] = local(
        lambda v: cross_stage_transfer(v, "x", HALF, transpose=True), kv)

    # test_api.py: the descriptor spellings of the same collectives
    peer_codec = C.describe(Endpoint.local(C.MN), Endpoint.peer("x", RING),
                            pre=(C.Quantize(),),
                            post=(C.Dequantize(torch.float32),))
    out["transfer_peer_codec"] = xdma.transfer(x, peer_codec)
    q = xdma.transfer(x, C.describe(Endpoint.local(C.MN),
                                    Endpoint.peer("x", RING),
                                    pre=(C.Quantize(),)))
    out["peer_quantize_values"], out["peer_quantize_scales"] = \
        q.values, q.scales
    a2a = C.describe(Endpoint.local(C.MN), Endpoint.all_to_all("x", 0, 1))
    out["transfer_all_to_all"] = local(lambda v: xdma.transfer(v, a2a), a)
    out["all_to_all"] = local(lambda v: C.xdma_all_to_all(
        v, "x", split_axis=0, concat_axis=1), a)
    a2a_codec = C.describe(Endpoint.local(C.MN),
                           Endpoint.all_to_all("x", 0, 1),
                           pre=(C.Quantize(),),
                           post=(C.Dequantize(torch.float32),))
    out["all_to_all_codec"] = local(lambda v: xdma.transfer(v, a2a_codec), a)
    red_codec = C.describe(Endpoint.local(C.MN), Endpoint.reduce("x", N),
                           pre=(C.Quantize(),),
                           post=(C.Dequantize(torch.float32),))
    out["reduce_codec"] = local(lambda v: xdma.transfer(v, red_codec), g)
    scaled = C.describe(Endpoint.local(C.MN), Endpoint.reduce("x", N),
                        pre=(C.Scale(2.0), C.Quantize()),
                        post=(C.Dequantize(torch.float32),))
    out["reduce_scaled"] = local(lambda v: xdma.transfer(v, scaled), g)
    plain = C.describe(Endpoint.local(C.MN), Endpoint.reduce("x", N),
                       post=(C.BiasAdd(1.0),))
    out["reduce_bias"] = local(lambda v: xdma.transfer(v, plain), g)
    out["reduce_descriptor"] = local(
        lambda v: xdma.transfer(v, C.reduce_descriptor("x", N)), g)
    out["reduce_descriptor_codec"] = local(lambda v: xdma.transfer(
        v, C.reduce_descriptor("x", N, compressed=True)), g)
    orphan = C.describe(Endpoint.local(C.MN), Endpoint.reduce("x", N),
                        post=(C.Dequantize(torch.bfloat16),))
    out["orphan_dequantize_raises"] = _raises(
        lambda: xdma.transfer(g[0], orphan))

    # the endpoint sides: one kernel per side where the chain allows it
    plugin_compiler.clear_stats()
    side_cast = C.describe(Endpoint.local(C.MN), Endpoint.peer("x", RING),
                           post=(C.Cast(torch.bfloat16), C.Scale(0.5)))
    out["side_dst_cast_scale"] = local(
        lambda v: xdma.transfer(v, side_cast), x)
    side_t = C.describe(Endpoint.local(C.MN),
                        Endpoint.peer("x", RING, C.MNM8N8),
                        pre=(C.Transpose(),))
    out["side_src_transpose"] = local(lambda v: xdma.transfer(v, side_t), x)
    side_norm = C.describe(Endpoint.local(C.MNM8N128),
                           Endpoint.all_to_all("x", 0, 0),
                           pre=(C.RMSNormPlugin(),))
    out["side_src_rmsnorm_a2a"] = local(lambda v: xdma.transfer(
        C.MNM8N128.from_logical(v), side_norm), x)
    mcast = C.describe(Endpoint.local(C.MN),
                       Endpoint.multicast_axis("x", RING))
    out["multicast_axis"] = xdma.transfer(x, mcast)
    xdma.transfer(x, peer_codec)              # a cached CFG phase: no new count
    out["cfg_stats"] = plugin_compiler.cfg_stats()

    # the trace prices remote and codec wires from the descriptor
    with capture(name="remote") as tr:
        xdma.transfer(x[0], peer_codec)
        xdma.transfer(x[0], red_codec)
        xdma.transfer(x[0], C.reduce_descriptor("x", N))
    out["trace"] = [(e.endpoint, e.nbytes, e.wire_nbytes,
                     list(e.logical_shape), e.label) for e in tr.events]
    telemetry.reset("wire")
    xdma.transfer(x, peer_codec)
    out["wire"] = remote.wire_stats()
    out["collective_calls"] = calls
    return out


def _spy_collectives():
    """Record every ``torch.distributed`` collective this rank issues, with
    whether ``core/remote.py`` is on its stack (the in-plane contract: the
    movement plane issues every collective from one module)."""
    import traceback

    import torch.distributed as dist
    calls = []

    def spy(name, orig):
        def wrapped(*a, **k):
            stack = "".join(traceback.format_stack())
            calls.append((name, "core/remote.py" in stack))
            return orig(*a, **k)
        return wrapped

    for name in ("all_to_all_single", "all_reduce", "all_gather",
                 "all_gather_into_tensor", "send", "recv",
                 "batch_isend_irecv", "broadcast", "reduce_scatter_tensor"):
        setattr(dist, name, spy(name, getattr(dist, name)))
    return calls


def card_body(mesh, device):
    """A small remote round on ``device`` for the card test: a ring peer with
    a Cast -> Scale post side, a transposing src side, an all-to-all with
    the int8 codec and the reduce codec; the inputs drawn on the CPU from
    the rank's seed.  Returns the outputs and the rank's wire counters."""
    from repro_torch import core as C
    from repro_torch import sharding as S
    from repro_torch.core import remote, xdma
    from repro_torch.core.descriptor import Endpoint
    from repro_torch.kernels import _build

    n, r = mesh.world_size, S.axis_index("x")
    ring = tuple((i, (i + 1) % n) for i in range(n))
    gen = torch.Generator().manual_seed(r)
    x = torch.randn(64, 256, generator=gen).to(device)
    _build.reset_launches()
    out = {
        "cast_scale": xdma.transfer(x, C.describe(
            Endpoint.local(C.MN), Endpoint.peer("x", ring),
            post=(C.Cast(torch.bfloat16), C.Scale(0.5)))),
        "transpose": xdma.transfer(x, C.describe(
            Endpoint.local(C.MN), Endpoint.peer("x", ring),
            pre=(C.Transpose(),))),
        "a2a_codec": xdma.transfer(x, C.describe(
            Endpoint.local(C.MN), Endpoint.all_to_all("x", 0, 0),
            pre=(C.Quantize(),), post=(C.Dequantize(torch.float32),))),
        "reduce_codec": xdma.transfer(
            x, C.reduce_descriptor("x", n, compressed=True)),
    }
    if device != "cpu":
        torch.cuda.synchronize()
    out["launches"] = {k.name: k.launches for k in _build.KERNELS}
    out["wire"] = remote.wire_stats()
    out["backend"] = mesh.backend
    return out


def mesh2d_body(mesh):
    """A (2, 4) mesh over ('data', 'model'): each axis's index and size, and
    sums over one axis and over both."""
    from repro_torch import core as C
    from repro_torch import sharding as S
    v = torch.full((4,), float(mesh.rank))
    return {name: (S.axis_index(name), S.axis_size(name))
            for name in ("data", "model")} | {
        "sum_model": C.xdma_psum(v, "model"),
        "sum_data": C.xdma_psum(v, "data"),
        "sum_all": C.xdma_psum(v, ("data", "model")),
        "backend": mesh.backend}


def failing_body(mesh):
    """Rank 1 raises; the run must fail with its traceback."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return {}


# -- the MoE layer on a (2, 4) mesh over ('data', 'model') ---------------------
MOE_MESH = ((2, 4), ("data", "model"))
MOE_X_SHAPE = (2, 16, 64)                   # (B, S, d) of the qwen3-moe smoke


def moe_params(E, d, f, seed):
    """Seeded numpy MoE parameters with the reference's standard deviations
    (``repro.layers.moe.init_moe``)."""
    rng = np.random.default_rng(seed)
    nrm = lambda shape, std: (rng.standard_normal(shape) * std).astype(  # noqa: E731
        np.float32)
    return {"router": nrm((d, E), d ** -0.5),
            "w_gate": nrm((E, d, f), d ** -0.5),
            "w_up": nrm((E, d, f), d ** -0.5),
            "w_down": nrm((E, f, d), f ** -0.5)}


def moe_inputs():
    """The MoE world's inputs: the qwen3-moe smoke layer's parameters (8
    experts), those of a 6-expert variant that takes the tensor-parallel
    path on 4 model ranks, the tokens, and a (8, 4, 16) array for the ring
    all-gather (``tests/test_trace.py``'s shapes)."""
    rng = np.random.default_rng(20)
    return {"p": moe_params(8, 64, 32, 21), "p_tp": moe_params(6, 64, 32, 22),
            "x": rng.standard_normal(MOE_X_SHAPE).astype(np.float32),
            "v": rng.standard_normal((8, 4, 16)).astype(np.float32)}


def moe_configs(configs, dataclasses, Axes, f32):
    """(local cfg, mesh cfg, TP cfg, TP mesh cfg): the qwen3-moe smoke
    config in f32 at capacity factor 8, as the reference's tests set it."""
    cfg = dataclasses.replace(configs.smoke_config("qwen3_moe_30b_a3b"),
                              dtype=f32, capacity_factor=8.0)
    axes = Axes(batch=("data",), model="model", model_size=4, batch_size=2)
    cfg_tp = dataclasses.replace(cfg, n_experts=6, top_k=2, d_ff_expert=32)
    return cfg, cfg.with_axes(axes), cfg_tp, cfg_tp.with_axes(axes)


def moe_body(mesh):
    """The MoE cases in one rank of the (2, 4) world: this rank's output
    block of each (its data shard of the batch; replicated over model), the
    ring all-gather, and the EP path's ledger and collectives."""
    import dataclasses

    from repro_torch import configs
    from repro_torch import sharding as S
    from repro_torch.layers import moe as M
    from repro_torch.runtime import DistributedScheduler, Topology
    from repro_torch.runtime.trace import capture

    calls = _spy_collectives()
    inp = moe_inputs()
    p = {k: torch.from_numpy(v) for k, v in inp["p"].items()}
    p_tp = {k: torch.from_numpy(v) for k, v in inp["p_tp"].items()}
    cfg, cfg2, _, cfg_tp2 = moe_configs(configs, dataclasses, S.Axes,
                                        torch.float32)
    data, r = S.axis_index("data"), S.axis_index("model")
    x = torch.from_numpy(inp["x"][data:data + 1].copy())
    out = {}
    with capture(name="moe") as tr:
        out["ep"], out["ep_aux"] = M.moe_apply(cfg2, p, x, mesh=mesh)
    out["ep_kinds"] = tr.by_endpoint()
    out["ep_calls"] = list(calls)
    out["int8"], _ = M.moe_apply(dataclasses.replace(cfg2,
                                                     moe_wire_int8=True),
                                 p, x, mesh=mesh)
    out["nosplit"], _ = M.moe_apply(cfg2, p, x[:, :2], mesh=mesh)
    sched = DistributedScheduler(Topology.parallel(2, prefix="a2a"),
                                 name="moe")
    out["sched"], _ = M.moe_apply(cfg2, p, x, mesh=mesh, scheduler=sched)
    rep = sched.report()
    out["sched_spans"] = [(s.label, s.resource, s.start, s.end)
                          for s in rep.spans]
    tight = dataclasses.replace(cfg2, capacity_factor=1.0)
    out["tight"], _ = M.moe_apply(tight, p, x, mesh=mesh)
    out["tight_sched"], _ = M.moe_apply(
        tight, p, x, mesh=mesh,
        scheduler=DistributedScheduler(Topology.parallel(2, prefix="a2a"),
                                       name="moe2"))
    out["tp"], _ = M.moe_apply(cfg_tp2, p_tp, x, mesh=mesh)
    v = torch.from_numpy(inp["v"][:, r:r + 1].copy())
    out["ring"] = M._ring_all_gather(v, "model", 4)
    out["calls"] = list(calls)
    return out
