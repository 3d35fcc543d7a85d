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


# -- data-parallel training on a 4-rank ('dp',) world ------------------------
DP_MESH = ((4,), ("dp",))
DP_SHAPE = dict(seq=16, batch=8)          # tests/test_trace.py's DP cell


def dp_config(configs, dataclasses, f32):
    """The qwen2-0.5b smoke config in f32 (the reference's DP test)."""
    return dataclasses.replace(configs.smoke_config("qwen2_0p5b"), dtype=f32)


def dp_train_body(mesh, state_np, batch_np):
    """One rank of the DP world: the explicit DP step (plain, then the int8
    codec) from the same state on the global batch, with each step's
    ledger, the collectives it issued, the compressed trace's replays, and
    a 2-microbatch step through a scheduler."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import lm
    from repro_torch.runtime import DistributedScheduler, Topology
    from repro_torch.runtime.trace import capture
    from repro_torch.train import step as T

    calls = _spy_collectives()
    cfg = dp_config(configs, dataclasses, torch.float32)
    seq, batch = DP_SHAPE["seq"], DP_SHAPE["batch"]
    shape = ShapeConfig("t", seq, batch, "train", microbatches=1)
    state = lm.params_from_numpy(state_np, device="cpu")
    data = {k: torch.from_numpy(v) for k, v in batch_np.items()}

    def events(tr):
        return [(e.endpoint, e.nbytes, e.wire_nbytes,
                 list(e.logical_shape or ()))
                for e in tr.xdma_events()]

    out = {}
    for name, compressed in (("plain", False), ("compressed", True)):
        step = T.make_dp_train_step(cfg, shape, mesh=mesh, axis="dp",
                                    compressed=compressed)
        del calls[:]
        with capture(name=name) as tr:
            new, m = step(dict(state), dict(data))
        out[name] = {"loss": m["loss"], "grad_norm": m["grad_norm"],
                     "params": new["params"], "step": new["step"],
                     "events": events(tr), "calls": list(calls)}
        if compressed:
            out[name]["makespans"] = (
                tr.replay(Topology.ring(4)).makespan,
                tr.replay(Topology.ring(4), sw_agu=True).makespan)
    sched = DistributedScheduler(Topology.parallel(2), name="dp")
    step = T.make_dp_train_step(
        cfg, ShapeConfig("t", seq, batch, "train", microbatches=2),
        mesh=mesh, axis="dp", compressed=False, scheduler=sched)
    with capture(name="scheduled") as tr:
        new, m = step(dict(state), dict(data))
    out["scheduled"] = {"loss": m["loss"], "params": new["params"],
                        "events": events(tr),
                        "labels": sorted(s.label for s in
                                         sched.report().spans)}
    return out


# -- the sharded trainer on a (2, 2) ('data', 'model') world -----------------
TP_MESH = ((2, 2), ("data", "model"))
TP_SHAPE = dict(seq=16, batch=8, microbatches=2)
TP_LAYER_B = 4                             # the layer cases' batch


def tp_layer_configs(configs, dataclasses, f32):
    """The layer cases' smoke configs in f32, by regime on a model axis of
    2: qwen3 (H4, KV2: head-parallel, tied), the same with one KV head (the
    KV heads repeated), qwen2 (H7, KV1: sequence-parallel) and phi4-mini
    (an untied head; with a vocabulary of 255, which does not split over
    the axis)."""
    q3 = configs.smoke_config("qwen3_1p7b")
    return {"head": dataclasses.replace(q3, dtype=f32),
            "repeat": dataclasses.replace(q3, dtype=f32, n_kv_heads=1),
            "seq": dataclasses.replace(configs.smoke_config("qwen2_0p5b"),
                                       dtype=f32),
            "untied": dataclasses.replace(
                configs.smoke_config("phi4_mini_3p8b"), dtype=f32),
            "odd": dataclasses.replace(
                configs.smoke_config("phi4_mini_3p8b"), dtype=f32,
                vocab=255)}


def tp_step_config(configs, dataclasses, dtype):
    """The phi4-mini smoke config widened until FSDP's 1 << 20 rule shards
    the embedding (4096 x 256), the untied head and the FFN's matrices (2 x
    256 x 4096).  Its head keeps the logits near unit scale, so the loss
    (about 8.8) leaves an absolute 1e-5 ten f32 ulps; the tied qwen3 smoke
    config widened so starts near 170, where an ulp is 1.5e-5."""
    return dataclasses.replace(configs.smoke_config("phi4_mini_3p8b"),
                               dtype=dtype, d_model=256, d_ff=4096,
                               vocab=4096)


TP_CROSS_SK = 24                           # kv_x rows of the cross case
# the MoE layer cases on the model axis of 2: (config changes, sequence)
TP_MOE = {"ep": ({}, 16),                          # experts split, S split
          "ep_nosplit": ({}, 15),                  # S % 2: every rank routes
          "tp": ({"n_experts": 5}, 16),            # d_ff_expert split
          "replicated": ({"n_experts": 5, "d_ff_expert": 33}, 16),
          "int8": ({"moe_wire_int8": True}, 16)}   # EP with the int8 wire
TP_MOE_DAUX = 0.5                          # the aux loss's cotangent
TP_MODELS = ("jamba", "xlstm", "whisper")


def tp_slot_configs(configs, dataclasses, f32):
    """The other slots' layer cases in f32 on a model axis of 2: jamba's
    Mamba (4 SSM heads, one or two a rank; 3 heads of 32 channels, a head
    split between the ranks), xlstm's mLSTM (2 heads; 1 head of 64, split)
    and sLSTM (2 heads; 1 head, run whole on every rank), whisper's
    cross-attention in the three regimes (4 heads: head-parallel; 1 KV
    head: repeated; 3 heads: sequence-parallel)."""
    jamba = dataclasses.replace(configs.smoke_config("jamba_1p5_large_398b"),
                                dtype=f32)
    xl = dataclasses.replace(configs.smoke_config("xlstm_125m"), dtype=f32)
    one = dataclasses.replace(xl, n_heads=1, n_kv_heads=1, head_dim=64)
    cross = dataclasses.replace(configs.smoke_config("whisper_small"),
                                dtype=f32)
    return {"mamba": jamba,
            "mamba_split": dataclasses.replace(jamba, ssm_heads=3,
                                               ssm_d_inner=96),
            "mlstm": xl, "mlstm_split": one, "slstm": xl, "slstm_whole": one,
            "cross": cross,
            "cross_repeat": dataclasses.replace(cross, n_kv_heads=1),
            "cross_seq": dataclasses.replace(cross, n_heads=3, n_kv_heads=3)}


def tp_moe_config(configs, dataclasses, f32, name):
    """The qwen3-moe smoke config in f32 (8 experts of d_ff 32, top 2, the
    default capacity factor) with case ``name``'s changes."""
    return dataclasses.replace(configs.smoke_config("qwen3_moe_30b_a3b"),
                               dtype=f32, **TP_MOE[name][0])


TP_ARCH = {"jamba": "jamba_1p5_large_398b", "xlstm": "xlstm_125m",
           "whisper": "whisper_small"}
# jamba's experts (2 x 4 x 256 x 512) and Mamba w_z / w_x (2 x 256 x 2048),
# whisper's encoder and decoder FFNs (2 x 256 x 2048) reach FSDP's 1 << 20
# elements; its encoder reads 24 frames against 16 decoder tokens.  xlstm
# stays at its smoke width.
TP_WIDE = {"jamba": dict(d_model=256, ssm_d_inner=2048, d_ff_expert=512),
           "xlstm": {},
           "whisper": dict(d_model=256, d_ff=2048, encoder_seq=24)}


# jamba's f32 steps: no warmup, and an eps at which Adam's first update is
# not lr * sign(g) for a gradient within its noise of zero.  jamba's
# gradients (its Mamba's) are 1e-5 to 3e-5 of their scale off the
# reference's, single-process too (tests/test_torch_train_steps.py); at the
# default 1e-8 that flips a few elements near zero, 2 lr = 6e-4 apart.  At
# 1e-4 an element's update moves at most lr / eps = 3 times its gradient's
# error, and every element whose gradient is above 1e-4 moves by lr.
TP_JAMBA_OPT = dict(warmup_steps=0, eps=1e-4)


def tp_model_config(configs, dataclasses, dtype, name):
    """The whole-model cases' smoke configs, widened by ``TP_WIDE``."""
    return dataclasses.replace(configs.smoke_config(TP_ARCH[name]),
                               dtype=dtype, **TP_WIDE[name])


def tp_opt_config(AdamWConfig, run):
    """The f32 step's AdamW: no warmup, so each step moves every weight by
    about the learning rate (3e-4), three times the 1e-4 bound on the
    parameters; a warmup of 100 steps would move them 3e-6, and no fault in
    the gradients could show.  The bf16 run keeps the default, as the
    reference's sharded run it is held to does."""
    return AdamWConfig(warmup_steps=0) if run == "f32" else AdamWConfig()


def all_to_all_bytes():
    """This rank's all-to-all payload bytes so far: the ``collectives``
    bank's over every axis and the movement plane's ``wire`` bank's."""
    from repro_torch import sharding as S
    from repro_torch.core import remote
    return sum(v for k, v in list(S.collective_stats().items())
               + list(remote.wire_stats().items())
               if k.startswith("bytes:all_to_all"))


def tp_body(mesh, inp):
    """One rank of the (2, 2) world: each sharded layer's output, input
    gradient and weight gradients (whole: gathered over the model axis,
    summed over the data axis) — attention, MLPs, Mamba, mLSTM, sLSTM,
    cross-attention and the MoE layer's paths —, embedding plus
    vocab-parallel loss, the whole model's gradient of one microbatch (and
    of jamba's, xlstm's and whisper's), and two steps of the sharded step
    in f32 and in bf16 (and jamba's in f32) with the state they leave
    (whole)."""
    import dataclasses

    from repro_torch import _pytree, configs
    from repro_torch import sharding as S
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as M
    from repro_torch.layers import attention as A
    from repro_torch.layers import embedding as E
    from repro_torch.layers import mamba as MB
    from repro_torch.layers import mlp as F
    from repro_torch.layers import moe as MOE
    from repro_torch.layers import xlstm as X
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train import step as T

    torch.set_num_threads(1)
    shape = ShapeConfig("t", TP_SHAPE["seq"], TP_SHAPE["batch"], "train",
                        TP_SHAPE["microbatches"])
    axes = M.axes_for(mesh, shape)
    dp = S.axis_size("data")

    def tree(a):
        return lm.params_from_numpy(a, device="cpu")

    def rows(a):                            # this data rank's rows
        t = torch.from_numpy(np.ascontiguousarray(a))
        n = t.shape[0] // dp
        return t[S.axis_index("data") * n:(S.axis_index("data") + 1) * n]

    def whole_rows(t):
        return S.all_gather(t, "data", 0)

    def layer(cfg, p, fn, x_np, dy_np, extra=()):
        """``fn(cfg, local params, x)`` on this rank's rows with the model
        axis sharding ``p`` by its rules: the whole output, input gradient
        (and that of each tensor of ``extra``) and weight gradients."""
        specs = M.fit_specs(mesh, M.infer_param_specs(p, cfg.axes), p)
        local = M.shard_tree(p, specs, mesh)
        leaves = [t.requires_grad_() for t in _pytree.leaves(local)]
        local = _pytree.unflatten(local, leaves)
        x = rows(x_np).requires_grad_()
        y = fn(cfg, local, x)
        k = 1 + len(extra)
        got = torch.autograd.grad(y, [x, *extra] + leaves, rows(dy_np))
        grads = M.gather_tree(_pytree.unflatten(local, list(got[k:])),
                              specs, mesh)
        return {"y": whole_rows(y.detach()), "dx": whole_rows(got[0]),
                "dextra": [whole_rows(g) for g in got[1:k]],
                "grads": [S.all_reduce(g, "data")
                          for g in _pytree.leaves(grads)]}

    cfgs = {k: c.with_axes(axes) for k, c in tp_layer_configs(
        configs, dataclasses, torch.float32).items()}
    out = {}
    pos = inp["positions"]
    for name in ("head", "repeat", "seq"):
        cfg = cfgs[name]
        out[name] = layer(
            cfg, tree(inp["attn"][name]),
            lambda c, p, x: A.attn_apply(c, p, x, rows(pos))[0],
            inp["x"][name], inp["dy"][name])
    for name, fn in (("swiglu", F.swiglu), ("gelu", F.gelu_mlp)):
        out[name] = layer(cfgs["head"], tree(inp["mlp"][name]), fn,
                          inp["x"]["head"], inp["dy"]["head"])

    def embed_loss(cfg, p, tokens, labels):
        x = E.embed(cfg, p, tokens)
        logits = E.lm_head(cfg, p, x).to(torch.float32)
        logz, ll = T._logz_and_label_logit(logits, labels,
                                           E.vocab_axis(cfg))
        n = labels.numel() * dp
        return ((logz - ll).sum() / n
                + 1e-4 * ((logz ** 2).sum() / n))

    for name in ("head", "untied", "odd"):
        cfg = cfgs[name]
        p = tree(inp["embed"][name])
        specs = M.fit_specs(mesh, M.infer_param_specs(p, cfg.axes), p)
        local = M.shard_tree(p, specs, mesh)
        leaves = [t.requires_grad_() for t in _pytree.leaves(local)]
        local = _pytree.unflatten(local, leaves)
        loss = embed_loss(cfg, local, rows(inp["tokens"]) % cfg.vocab,
                          rows(inp["labels"]) % cfg.vocab)
        got = torch.autograd.grad(loss, leaves)
        grads = M.gather_tree(_pytree.unflatten(local, list(got)), specs,
                              mesh)
        out["embed_" + name] = {
            "loss": S.all_reduce(loss.detach(), "data"),
            "grads": [S.all_reduce(g, "data")
                      for g in _pytree.leaves(grads)]}

    # the other slots, each tree under its slot's key (the path rules read
    # it): Mamba, mLSTM, sLSTM, cross-attention over a longer kv_x
    apply = {"mamba": MB.mamba_apply, "mlstm": X.mlstm_apply,
             "slstm": X.slstm_apply}
    for name, cfg in tp_slot_configs(configs, dataclasses,
                                     torch.float32).items():
        cfg, slot = cfg.with_axes(axes), name.split("_")[0]
        if slot == "cross":
            kv = rows(inp["kv"]).requires_grad_()
            fn = (lambda c, p, x: A.attn_apply(  # noqa: E731
                c, p["cross"], x, rows(pos), causal=False, kv_x=kv,
                apply_rope=False, cross=True)[0])
            extra = [kv]
        else:
            fn = (lambda c, p, x, s=slot: apply[s](c, p[s], x)[0])  # noqa: E731
            extra = []
        out[name] = layer(cfg, tree(inp["slot"][name]), fn, inp["x"][name],
                          inp["dy"][name], extra)

    # the MoE layer's four paths and the int8 wire: (y, aux) and their
    # gradients, each data rank's aux cotangent its share
    for name in TP_MOE:
        cfg = tp_moe_config(configs, dataclasses, torch.float32,
                            name).with_axes(axes)
        c = inp["moe"][name]
        p = tree({"ffn": c["p"]})
        specs = M.fit_specs(mesh, M.infer_param_specs(p, cfg.axes), p)
        local = M.shard_tree(p, specs, mesh)
        leaves = [t.requires_grad_() for t in _pytree.leaves(local)]
        local = _pytree.unflatten(local, leaves)
        x = rows(c["x"]).requires_grad_()
        y, aux = MOE.moe_apply(cfg, local["ffn"], x, mesh=mesh)
        before = all_to_all_bytes()
        got = torch.autograd.grad(
            [y, aux], [x] + leaves,
            [rows(c["dy"]), torch.tensor(TP_MOE_DAUX / dp)])
        a2a_vjp = all_to_all_bytes() - before
        grads = M.gather_tree(_pytree.unflatten(local, list(got[1:])),
                              specs, mesh)
        out["moe_" + name] = {
            "y": whole_rows(y.detach()), "aux": aux.detach(),
            "dx": whole_rows(got[0]), "a2a_vjp": a2a_vjp,
            "grads": [S.all_reduce(g, "data")
                      for g in _pytree.leaves(grads)]}

    def sharded_cfg(dtype):
        return dataclasses.replace(
            tp_step_config(configs, dataclasses, dtype).with_axes(axes),
            fsdp=True)

    # the whole model's gradient of one microbatch (the global batch)
    cfg = sharded_cfg(torch.float32)
    specs, _ = M.state_specs(cfg, mesh)
    state = M.shard_tree(tree(inp["state"]), specs, mesh)
    out["fsdp"] = sorted(
        "/".join(map(str, (k for _, k in path)))
        for (path, _), sp in zip(
            _pytree.flatten_with_paths(state["params"]),
            M.spec_leaves(specs["params"], state["params"]))
        if "data" in sp)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in inp["batches"]]
    loss, _, grads = T._value_and_grad(
        cfg, state["params"], T._data_block(batches[0], "data"), mesh=mesh)
    out["grad_loss"] = S.all_reduce(loss, "data")
    out["grads"] = _pytree.leaves(M.gather_tree(
        _pytree.unflatten(state["params"], grads), specs["params"], mesh))

    # jamba, xlstm and whisper: one microbatch's gradient (rank 0 keeps
    # it), then jamba's sharded f32 step, 2 steps of 2 microbatches
    for name in TP_MODELS:
        cfg = dataclasses.replace(tp_model_config(
            configs, dataclasses, torch.float32, name).with_axes(axes),
            fsdp=True)
        mspecs, _ = M.state_specs(cfg, mesh)
        params = M.shard_tree(tree(inp["models"][name]["params"]),
                              mspecs["params"], mesh)
        mb = [{k: torch.from_numpy(v) for k, v in b.items()}
              for b in inp["models"][name]["batches"]]
        loss, _, grads = T._value_and_grad(
            cfg, params, T._data_block(mb[0], "data"), mesh=mesh)
        grads = _pytree.leaves(M.gather_tree(
            _pytree.unflatten(params, grads), mspecs["params"], mesh))
        out["model_" + name] = {
            "loss": S.all_reduce(loss, "data"),
            "fsdp": sorted(
                "/".join(map(str, (k for _, k in path)))
                for (path, _), sp in zip(
                    _pytree.flatten_with_paths(params),
                    M.spec_leaves(mspecs["params"], params))
                if "data" in sp),
            "grads": grads if mesh.rank == 0 else None}
        if name != "jamba":
            continue
        st = {"params": params, "opt": M.shard_tree(
            adamw_init(tree(inp["models"][name]["params"])),
            mspecs["opt"], mesh),
            "step": torch.zeros((), dtype=torch.int32)}
        step = T.make_train_step(cfg, shape, AdamWConfig(**TP_JAMBA_OPT),
                                 mesh=mesh)
        losses = []
        for b in mb:
            st, m = step(st, b)
            losses.append(float(m["loss"]))
        whole = M.gather_tree(st, mspecs, mesh)
        out["jamba_f32"] = {
            "losses": losses, "step": whole["step"],
            **({k: _pytree.leaves(v) for k, v in (
                ("params", whole["params"]), ("mu", whole["opt"]["mu"]),
                ("nu", whole["opt"]["nu"]))} if mesh.rank == 0 else {})}

    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = sharded_cfg(dtype)
        step = T.make_train_step(cfg, shape, tp_opt_config(AdamWConfig, name),
                                 mesh=mesh)
        st, losses, norms = state, [], []
        for b in batches:
            st, m = step(st, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        whole = M.gather_tree(st, specs, mesh)
        out[name] = {"losses": losses, "grad_norms": norms,
                     "params": _pytree.leaves(whole["params"]),
                     "mu": _pytree.leaves(whole["opt"]["mu"]),
                     "nu": _pytree.leaves(whole["opt"]["nu"]),
                     "step": whole["step"]}
    out["ledger"] = S.collective_stats()
    return out


# -- the sharded launcher: launch/train.py --ranks 4 --smoke -----------------
LAUNCH_ARCH = "qwen3-1.7b"
LAUNCH_KW = dict(steps=3, batch=4, seq=16, smoke=True, ckpt_every=2,
                 microbatches=1, lr=3e-4, resume=True, seed=0)


LAUNCH_MOE_ARCH = "jamba-1.5-large-398b"


def launcher_body(mesh, ckpt_dir):
    """One rank of ``launch/train.py --ranks 4 --smoke``'s world
    (``train_rank``): 3 steps with a checkpoint at step 2 (and the final
    one at 3), then the step-3 checkpoint removed and the run resumed from
    step 2; then jamba's smoke config (attention, Mamba and MoE slots) for
    2 steps.  Returns the runs' losses and final states (rank 0's)."""
    import os
    import shutil

    import torch.distributed as dist

    from repro_torch.launch import train as LT

    torch.set_num_threads(1)
    kw = dict(LAUNCH_KW, ckpt_dir=ckpt_dir)
    full = LT.train_rank(mesh, LAUNCH_ARCH, kw)
    dist.barrier()
    if mesh.rank == 0:
        shutil.copytree(os.path.join(ckpt_dir, "step_0000000003"),
                        ckpt_dir + ".final")
        shutil.rmtree(os.path.join(ckpt_dir, "step_0000000003"))
    dist.barrier()
    resumed = LT.train_rank(mesh, LAUNCH_ARCH, kw)
    jamba = LT.train_rank(mesh, LAUNCH_MOE_ARCH,
                          dict(LAUNCH_KW, steps=2, ckpt_dir=None))
    return {"full": full["history"], "resumed": resumed["history"],
            "state": full["state"], "resumed_state": resumed["state"],
            "mesh": mesh.shape, "ledger": full["ledger"],
            "jamba": jamba["history"]}


# -- sharded serving: lm.prefill / decode_step and the engines on a mesh -----
SERVE_WORLD = ((2, 2), ("data", "model"))
SERVE_MESHES = {"1x4": (1, 4), "2x2": (2, 2)}  # (1, 4) a view of the world
SERVE = dict(B=4, S=16, steps=4, max_len=32)
SERVE_RAGGED = (16, 13, 11, 16)            # each row's position, ragged
SERVE_BYTES_LEN = 256                      # the collective-bytes step's cache
SERVE_ARCHS = ("phi4_mini_3p8b", "gemma3_27b", "qwen3_1p7b", "qwen2_0p5b",
               "jamba_1p5_large_398b", "mixtral_8x7b", "qwen3_moe_30b_a3b",
               "xlstm_125m", "qwen2_vl_7b", "whisper_small")
# config changes by variant: the XDMA cache layout; xlstm with one head of
# 64 (the mLSTM state whole on every rank, the sLSTM cache a block of a
# head's channels); whisper with 3 heads (the cross cache split by frames),
# and with one KV head and 18 frames (the cross cache whole on a model axis
# of 4; the encoder's query heads divide it: the repeat regime)
SERVE_VARIANTS = {"": {}, "xdma": dict(xdma_cache=True),
                  "one_head": dict(n_heads=1, n_kv_heads=1, head_dim=64),
                  "cross_seq": dict(n_heads=3, n_kv_heads=3),
                  "cross_whole": dict(n_kv_heads=1, encoder_seq=18)}
# a max_len the model axis of 4 does not divide: the fitted spec keeps a
# sequence-split KV cache whole on every rank
SERVE_UNEVEN_LEN = 30
SERVE_ENGINE_ARCHS = ("qwen3_1p7b", "jamba_1p5_large_398b")
# the continuous engine's stream: (arrival, prompt length, new tokens)
SERVE_STREAM = ((0.0, 8, 4), (0.0, 12, 3), (0.0, 16, 4), (0.0, 4, 5),
                (0.0, 12, 4), (0.0, 8, 3))
SERVE_POOL_PAGES = 256                     # jamba's Mamba states: 28 a request
# qwen3 on a pool a rank where the stream's youngest requests are evicted
# and restored: max_len 64 (a (1, 4) rank's K block 16 slots, 2 pages), the
# pages by mesh (one more page a rank and nothing is evicted; under 12 on
# (1, 4), 8 on (2, 2), the engine runs out of pages)
SERVE_TIGHT = dict(max_len=64, pages={"1x4": 13, "2x2": 9})
# jamba's Mamba layer with 3 SSM heads of 32 channels: d_inner splits over
# either model axis, the heads over neither, so the state is whole on every
# rank and its channel blocks split heads
SERVE_MAMBA = dict(ssm_heads=3, ssm_d_inner=96)


def serve_cases():
    """``{case: (arch, variant, mesh, ragged, max_len)}``: every smoke
    config on both meshes; qwen3 and gemma3 (window 8 against 16 prompt
    tokens: the rolled write) with the XDMA cache, a ragged decode of each
    (qwen3's on the heads split, gemma3's on the sequence split; qwen3's
    (1, 4) run is the one held to the reference's own sharded run too);
    the variants; on (1, 4) a max_len of ``SERVE_UNEVEN_LEN`` for qwen3,
    gemma3 (its window's cache split, its global cache whole) and whisper
    with 18 frames (its self and cross caches whole)."""
    L = SERVE["max_len"]
    cases = {}
    for mesh in SERVE_MESHES:
        for arch in SERVE_ARCHS:
            cases[f"{arch}@{mesh}"] = (arch, "", mesh, False, L)
        cases[f"qwen3_1p7b+xdma@{mesh}"] = ("qwen3_1p7b", "xdma", mesh,
                                           mesh == "2x2", L)
        cases[f"gemma3_27b+xdma@{mesh}"] = ("gemma3_27b", "xdma", mesh,
                                           mesh == "1x4", L)
        cases[f"xlstm_125m+one_head@{mesh}"] = ("xlstm_125m", "one_head",
                                               mesh, False, L)
        cases[f"whisper_small+cross_seq@{mesh}"] = ("whisper_small",
                                                   "cross_seq", mesh, False,
                                                   L)
    U = SERVE_UNEVEN_LEN
    cases["qwen3_1p7b+uneven@1x4"] = ("qwen3_1p7b", "", "1x4", False, U)
    cases["gemma3_27b+xdma+uneven@1x4"] = ("gemma3_27b", "xdma", "1x4",
                                           True, U)
    cases["whisper_small+cross_whole@1x4"] = ("whisper_small",
                                              "cross_whole", "1x4", False, U)
    return cases


def serve_config(configs, dataclasses, f32, arch, variant):
    """``arch``'s smoke config in f32 with ``variant``'s changes.  An MoE
    config's capacity factor is ``n_experts / top_k``, so that no expert
    drops a token: the sharded MoE routes each (data block, sequence
    slice) with its own capacity, as the reference's ``shard_map`` does,
    and only with no drops is that the unsharded layer's routing."""
    cfg = dataclasses.replace(configs.smoke_config(arch), dtype=f32,
                              **SERVE_VARIANTS[variant])
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def serve_inputs(cfg, seed):
    """Seeded numpy prompts of ``cfg``'s family (embeds and 3-row
    positions for the vlm, audio frames for whisper) and the decode
    steps' tokens."""
    rng = np.random.default_rng(seed)
    B, S = SERVE["B"], SERVE["S"]
    b = {}
    if cfg.family == "vlm":
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
        pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
        b["positions"] = np.stack([pos, pos, pos])
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "audio":
        b["audio_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    steps = rng.integers(0, cfg.vocab, (SERVE["steps"], B, 1)).astype(
        np.int32)
    return b, steps


def serve_body(mesh, inp):
    """One rank of the (2, 2) world, each case on its mesh (the world's,
    or the (1, 4) view): the case's weights cut to this rank's blocks by
    the serving specs, ``lm.prefill`` of the whole prompt, the ragged
    positions set where the case is ragged, then ``lm.decode_step`` over
    the steps' tokens: every step's logits, this rank's final cache leaves
    and its fresh cache's leaf shapes.  Then one decode step's collective
    bytes against one layer's K block (qwen3), ``ServingEngine`` and
    ``ContinuousBatchingEngine`` with ``mesh=`` (qwen3, jamba), and a
    Mamba layer whose heads do not divide the axis (``SERVE_MAMBA``)
    through a prefill and the decode steps with its cache: the outputs
    (whole) and this rank's final cache.  The continuous engine runs qwen3
    once more on a pool that evicts and restores (``SERVE_TIGHT``)."""
    import dataclasses

    from repro_torch import _pytree, configs
    from repro_torch import sharding as S
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     ServingEngine, trace_stream)

    torch.set_num_threads(1)
    f32 = torch.float32
    B, max_len = SERVE["B"], SERVE["max_len"]

    def sharded(arch, variant, m):
        cfg = serve_config(configs, dataclasses, f32, arch, variant)
        cfg = cfg.with_axes(S.Axes(batch=("data",), model="model"))
        params = lm.params_from_numpy(inp["params"][(arch, variant)],
                                      device="cpu")
        specs, _ = M.serving_specs(cfg, m)
        return cfg, M.shard_tree(params, specs, m)

    def tensors(b):
        return {k: torch.from_numpy(v) for k, v in b.items()}

    out = {"cases": {}, "bytes": {}, "engines": {}, "mamba": {}}
    for name, (arch, variant, mname, ragged, L) in serve_cases().items():
        with S.view(mesh, SERVE_MESHES[mname]) as m:
            cfg, local = sharded(arch, variant, m)
            b, steps = inp["inputs"][(arch, variant)]
            cache = lm.init_cache(cfg, B, L, f32, device="cpu")
            shapes = [tuple(t.shape) for t in _pytree.leaves(cache)]
            logits, cache = lm.prefill(cfg, local, tensors(b), cache, mesh=m,
                                       max_len=L)
            got = [logits]
            if ragged:
                cache = dict(cache, pos=torch.tensor(SERVE_RAGGED,
                                                     dtype=torch.int32))
            for t in steps:
                logits, cache = lm.decode_step(cfg, local,
                                               torch.from_numpy(t), cache,
                                               mesh=m, max_len=L)
                got.append(logits)
            out["cases"][name] = {"logits": got, "shapes": shapes,
                                  "cache": _pytree.leaves(cache)}

    for mname in SERVE_MESHES:
        with S.view(mesh, SERVE_MESHES[mname]) as m:
            cfg, local = sharded("qwen3_1p7b", "", m)
            b, steps = inp["inputs"][("qwen3_1p7b", "")]
            cache = lm.init_cache(cfg, B, SERVE_BYTES_LEN, f32, device="cpu")
            _, cache = lm.prefill(cfg, local, tensors(b), cache, mesh=m)
            before = S.collective_stats()
            _, cache = lm.decode_step(cfg, local, torch.from_numpy(steps[0]),
                                      cache, mesh=m)
            after = S.collective_stats()
            k = cache["blocks"][0]["k"]
            out["bytes"][mname] = {
                "step": {key: v - before.get(key, 0)
                         for key, v in after.items()
                         if v != before.get(key, 0)},
                "layer_k_block": k[0].numel() * k.element_size()}

            for arch in SERVE_ENGINE_ARCHS:
                cfg, local = sharded(arch, "", m)
                b, _ = inp["inputs"][(arch, "")]
                eng = ServingEngine(cfg, local, max_len, cache_dtype=f32,
                                    mesh=m, device="cpu")
                toks = eng.generate(tensors(b), SERVE["steps"])
                cont = ContinuousBatchingEngine(
                    cfg, local, max_len, max_batch=4, cache_dtype=f32,
                    capacity_pages=SERVE_POOL_PAGES, mesh=m, device="cpu")
                rep = cont.serve(trace_stream(cfg, SERVE_STREAM, seed=5))
                out["engines"][f"{arch}@{mname}"] = {
                    "tokens": toks, "served": rep.tokens,
                    "steps": rep.steps, "pool": rep.pool_stats,
                    "elapsed_s": rep.elapsed_s}
            cfg, local = sharded("qwen3_1p7b", "", m)
            rep = ContinuousBatchingEngine(
                cfg, local, SERVE_TIGHT["max_len"], max_batch=4,
                cache_dtype=f32, capacity_pages=SERVE_TIGHT["pages"][mname],
                mesh=m, device="cpu").serve(
                    trace_stream(cfg, SERVE_STREAM, seed=5))
            out["engines"][f"tight@{mname}"] = {
                "served": rep.tokens, "steps": rep.steps,
                "pool": rep.pool_stats, "elapsed_s": rep.elapsed_s,
                "preemptions": rep.preemptions}
    from repro_torch.layers import mamba as MB
    for mname in SERVE_MESHES:
        with S.view(mesh, SERVE_MESHES[mname]) as m:
            cfg = dataclasses.replace(
                configs.smoke_config("jamba_1p5_large_398b"), dtype=f32,
                **SERVE_MAMBA).with_axes(S.Axes(batch=("data",),
                                                model="model"))
            specs, _ = M.serving_specs(cfg, m)
            spec = {k: sp[1:] for k, sp in specs["blocks"][1]["mamba"].items()}
            p = M.shard_tree(lm.params_from_numpy(inp["mamba"]["p"], "cpu"),
                             spec, m)
            sh = lm.shards_of(cfg, serving=True)
            cache = {k: v[0] for k, v in lm.init_cache(
                cfg, B, max_len, f32, device="cpu")["blocks"][1].items()}
            ys = []
            for x in [inp["mamba"]["x"]] + list(inp["mamba"]["steps"]):
                y, cache = MB.mamba_apply(cfg, p, sh.rows(
                    torch.from_numpy(x), B), cache=cache)
                ys.append(sh.whole_rows(y, B))
            out["mamba"][mname] = {"y": ys, "cache": cache}
    out["ledger"] = S.collective_stats()
    return out


# -- the production mesh's last regimes: tests/test_torch_mesh_regimes.py ----
REGIME_WORLD = ((2, 2, 1), ("pod", "data", "model"))
REGIME_SHAPE = dict(seq=16, batch=8, microbatches=2)
# the multi-pod prefill and decode: the batch over ("pod", "data")
REGIME_SERVE = dict(arch="qwen3_1p7b", B=4, S=12, steps=3, max_len=32)
# context-parallel decode on the (2, 2) view ("data", "model") of the same
# ranks, Axes(batch=(), model="model", seq="data"): B rows whole on every
# rank, a prompt of S, then `steps` decode steps
CP = dict(B=2, S=12, steps=3, max_len=32)
CP_RAGGED = (12, 7)                         # each row's position, ragged
CP_UNEVEN_LEN = 30                          # the pair of 4 does not divide it
CP_ENGINE = ("heads", "pair")               # also through ServingEngine
# sequence-parallel attention (3 heads on a model axis of 2) over 15 query
# rows, which the axis does not divide: each rank 8 rows, the last padded;
# self-attention, and cross-attention over 9 rows of kv_x
UNEVEN = dict(B=2, S=15, Sk=9, heads=3)


def uneven_config(configs, dataclasses, f32):
    return dataclasses.replace(configs.smoke_config("phi4_mini_3p8b"),
                               dtype=f32, n_heads=UNEVEN["heads"],
                               n_kv_heads=UNEVEN["heads"])
# case: (arch, config changes, ragged, max_len).  KV 2 on a model axis of 2:
# each rank's heads split by sequence over "data"; KV 1: the sequence over
# the pair ("data", "model"); gemma3's window of 8 against a prompt of 12:
# the rolled write, its window cache split too
CP_CASES = {
    "heads": ("qwen3_1p7b", {}, False, 32),
    "heads+xdma+ragged": ("gemma3_27b", dict(xdma_cache=True), True, 32),
    "pair": ("qwen2_0p5b", {}, False, 32),
    "pair+xdma+ragged": ("gemma3_27b", dict(xdma_cache=True, n_kv_heads=1),
                         True, 32),
    "pair+uneven": ("qwen2_0p5b", {}, False, CP_UNEVEN_LEN),
}


# continuous batching on the context-parallel cache (ROADMAP §1 item 10e),
# on the (2, 2) view with seq="data": case -> (CP_CASES entry, max_len,
# pool pages a rank).  Arrivals staggered on the simulated clock (ragged
# positions in a decode), 3 requests at a time, pages of 8 rows, each pool
# small enough that the youngest requests are evicted and restored on
# every rank: qwen3's KV sequence over "data" alone, qwen2's over the pair
# (max_len 64: a rank's block of 16 slots grows a second page), qwen2's
# max_len of 30 whole on every rank, gemma3's XDMA layouts with its rolled
# window (its window leaf paged whole every step).  (A pool under one
# request's pages and its growth runs out of pages: 6 to 8, gemma3's 14.)
CP_CB = {"heads": ("heads", 32, 10), "pair": ("pair", 64, 10),
         "pair+uneven": ("pair+uneven", CP_UNEVEN_LEN, 12),
         "gemma3": ("heads+xdma+ragged", 32, 26)}
CP_CB_STREAM = ((0.0, 12, 4), (0.0, 6, 5), (4e-6, 9, 3), (4e-6, 16, 4),
                (1.5e-5, 4, 5))
CP_CB_ENGINE = dict(max_batch=3, page_rows=8)


def regime_view(mesh):
    """The (2, 2, 1) world's ranks as a (2, 2) ("data", "model") mesh: its
    "data" the world's "pod" axis, its "model" the world's "data" axis and
    its pair the world's ("pod", "data") pair (row-major either way)."""
    from repro_torch import sharding as S
    return S.regroup(mesh, {"data": "pod", "model": "data",
                            ("data", "model"): ("pod", "data")}, (2, 2))


def cp_config(configs, dataclasses, f32, name):
    arch, kw, _, _ = CP_CASES[name]
    return dataclasses.replace(configs.smoke_config(arch), dtype=f32, **kw)


def cp_inputs(cfg, seed):
    """Seeded prompt tokens (B, S) and the decode steps' tokens."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (CP["B"], CP["S"])).astype(
        np.int32)}
    steps = rng.integers(0, cfg.vocab, (CP["steps"], CP["B"], 1)).astype(
        np.int32)
    return b, steps


def regime_body(mesh, inp):
    """One rank of the (2, 2, 1) ("pod", "data", "model") world: (1) the
    sharded f32 step, 2 steps of 2 microbatches, the batch and FSDP over
    the pair ("pod", "data"), the state it leaves (whole) and the ledger;
    (2) prefill and decode with the batch over the pair; (3) on the (2, 2)
    view, every context-parallel case: prefill, then decode, every step's
    logits, this rank's final cache leaves and their fitted specs; then
    ``ContinuousBatchingEngine(mesh=)`` on each ``CP_CB`` case: every
    request's tokens and logits, the steps, the pool's counters and the
    simulated clock."""
    import dataclasses

    from repro_torch import _pytree, configs
    from repro_torch import sharding as S
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     ServingEngine, trace_stream)
    from repro_torch.train import step as T

    torch.set_num_threads(1)
    f32 = torch.float32
    out = {}
    shape = ShapeConfig("t", REGIME_SHAPE["seq"], REGIME_SHAPE["batch"],
                        "train", REGIME_SHAPE["microbatches"])
    cfg = dataclasses.replace(
        tp_step_config(configs, dataclasses, f32).with_axes(
            M.axes_for(mesh, shape)), fsdp=True)
    specs, _ = M.state_specs(cfg, mesh)
    state = M.shard_tree(lm.params_from_numpy(inp["state"], device="cpu"),
                         specs, mesh)
    step = T.make_train_step(cfg, shape, tp_opt_config(AdamWConfig, "f32"),
                             mesh=mesh)
    losses, norms = [], []
    for b in inp["batches"]:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out["ledger"] = S.collective_stats()
    whole = M.gather_tree(state, specs, mesh)
    out["step"] = {"losses": losses, "grad_norms": norms,
                   "axes": cfg.axes.batch,
                   "fsdp": sorted({str(e) for sp in M.spec_leaves(
                       specs["params"], whole["params"]) for e in sp
                       if isinstance(e, tuple)}),
                   "params": _pytree.leaves(whole["params"]),
                   "mu": _pytree.leaves(whole["opt"]["mu"]),
                   "nu": _pytree.leaves(whole["opt"]["nu"]),
                   "step": whole["step"]}

    def serve(cfg, m, params_np, b, steps, L, ragged=None):
        sp, _ = M.serving_specs(cfg, m)
        local = M.shard_tree(lm.params_from_numpy(params_np, device="cpu"),
                             sp, m)
        cache = lm.init_cache(cfg, b["tokens"].shape[0], L, f32,
                              device="cpu")
        logits, cache = lm.prefill(
            cfg, local, {k: torch.from_numpy(v) for k, v in b.items()},
            cache, mesh=m, max_len=L)
        got = [logits]
        if ragged is not None:
            cache = dict(cache, pos=torch.tensor(ragged, dtype=torch.int32))
        for t in steps:
            logits, cache = lm.decode_step(cfg, local, torch.from_numpy(t),
                                           cache, mesh=m, max_len=L)
            got.append(logits)
        whole = lm._whole_cache(cfg, b["tokens"].shape[0], L, f32,
                                torch.device("meta"))
        fitted = M.spec_leaves(M.serving_cache_specs(cfg, whole, m), whole)
        return {"logits": got, "cache": _pytree.leaves(cache),
                "specs": fitted}

    R = REGIME_SERVE
    scfg = dataclasses.replace(
        configs.smoke_config(R["arch"]), dtype=f32).with_axes(
            S.Axes(batch=("pod", "data"), model="model"))
    b, steps = inp["pod_serve"]["inputs"]
    out["pod_serve"] = serve(scfg, mesh, inp["pod_serve"]["params"], b,
                             steps, R["max_len"])

    out["cp"], out["cp_engine"], out["uneven"] = {}, {}, {}
    with regime_view(mesh) as m:
        from repro_torch.layers import attention as A
        cfg = uneven_config(configs, dataclasses, f32).with_axes(
            S.Axes(batch=(), model="model"))
        u = inp["uneven"]
        p = lm.params_from_numpy(u["p"], device="cpu")
        specs = M.fit_specs(m, M.infer_param_specs(p, cfg.axes), p)
        local = M.shard_tree(p, specs, m)
        leaves = [t.requires_grad_() for t in _pytree.leaves(local)]
        local = _pytree.unflatten(local, leaves)
        pos = torch.from_numpy(u["pos"])
        for name in ("self", "cross"):
            x = torch.from_numpy(u["x"]).requires_grad_()
            kv = torch.from_numpy(u["kv"]).requires_grad_()
            y = A.attn_apply(cfg, local, x, pos,
                             kv_x=kv if name == "cross" else None,
                             apply_rope=name == "self")[0]
            got = torch.autograd.grad(y, [x, kv] + leaves,
                                      torch.from_numpy(u["dy"]),
                                      allow_unused=True)
            grads = M.gather_tree(_pytree.unflatten(local, list(got[2:])),
                                  specs, m)
            out["uneven"][name] = {"y": y.detach(), "dx": got[0],
                                   "dkv": got[1],
                                   "grads": _pytree.leaves(grads)}
        for name, (_, _, ragged, L) in CP_CASES.items():
            cfg = cp_config(configs, dataclasses, f32, name).with_axes(
                S.Axes(batch=(), model="model", seq="data"))
            b, steps = inp["cp"][name]["inputs"]
            out["cp"][name] = serve(cfg, m, inp["cp"][name]["params"], b,
                                    steps, L,
                                    CP_RAGGED if ragged else None)
            if name in CP_ENGINE:
                sp, _ = M.serving_specs(cfg, m)
                local = M.shard_tree(lm.params_from_numpy(
                    inp["cp"][name]["params"], device="cpu"), sp, m)
                out["cp_engine"][name] = ServingEngine(
                    cfg, local, L, cache_dtype=f32, mesh=m,
                    device="cpu").generate(
                        {k: torch.from_numpy(v) for k, v in b.items()},
                        CP["steps"])
        out["cp_cb"] = {}
        for name, (case, L, pages) in CP_CB.items():
            cfg = cp_config(configs, dataclasses, f32, case).with_axes(
                S.Axes(batch=(), model="model", seq="data"))
            sp, _ = M.serving_specs(cfg, m)
            local = M.shard_tree(lm.params_from_numpy(
                inp["cp"][case]["params"], device="cpu"), sp, m)
            rep = ContinuousBatchingEngine(
                cfg, local, L, cache_dtype=f32,
                capacity_pages=pages, mesh=m, device="cpu",
                keep_logits=True, **CP_CB_ENGINE).serve(
                    trace_stream(cfg, CP_CB_STREAM, seed=4))
            out["cp_cb"][name] = {
                "tokens": rep.tokens, "logits": rep.logits,
                "steps": rep.steps, "pool": rep.pool_stats,
                "elapsed_s": rep.elapsed_s, "preemptions": rep.preemptions}
    return out


# -- the dry run against the real step: tests/test_torch_dryrun_mesh.py ------
DRY_WORLD = ((2, 2), ("data", "model"))
# (arch, shape): a dense and an MoE smoke cell, each trained and decoded;
# the dense one also on a context-parallel decode (B 1: seq over "data")
DRY_CELLS = (("qwen3_1p7b", ("t", 16, 8, "train", 2)),
             ("qwen3_1p7b", ("d", 32, 4, "decode", 1)),
             ("qwen3_1p7b", ("long", 64, 1, "decode", 1)),
             ("qwen3_moe_30b_a3b", ("t", 16, 8, "train", 2)),
             ("qwen3_moe_30b_a3b", ("d", 32, 4, "decode", 1)))


def dry_body(mesh):
    """One rank of the (2, 2) world: each ``DRY_CELLS`` cell's real step on
    the CPU (``dryrun.cell_step`` with ``device="cpu"``), counted by
    ``dryrun.count_step``: its FLOPs, the growth of the collectives and
    wire banks, the state's bytes, and the bytes its ops moved and held
    (``op_cost``)."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DR

    torch.set_num_threads(1)
    out = []
    for arch, shape in DRY_CELLS:
        shape = ShapeConfig(*shape)
        cfg = DR.cell_config(configs.smoke_config(arch), shape, mesh)
        run, nbytes = DR.cell_step(cfg, shape, mesh, device="cpu")
        flops, coll, wire, mem = DR.count_step(run)
        out.append({"flops": flops, "collectives": coll, "wire": wire,
                    "state_bytes": nbytes, "memory": mem})
    return out
