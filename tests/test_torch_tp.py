"""The port's sharded trainer (tensor parallelism and FSDP on a ('data',
'model') process mesh) against the reference.

One (2, 2) gloo world on the CPU (``tests/torch_remote_cases.py::tp_body``)
runs every case; the reference computes each unsharded, in f32, on the same
numpy inputs and its ``init_params`` weights:

* attention in its three regimes on a model axis of 2 (head-parallel,
  the KV heads repeated, sequence-parallel), the SwiGLU and GeLU MLPs, the
  vocab-parallel embedding and head with the vocab-parallel cross-entropy:
  outputs, input gradients and every weight's gradient;
* the whole model's gradient of one microbatch, every leaf;
* the sharded f32 step, 2 steps of 2 microbatches, against the reference's
  jitted single-process ``make_train_step``: the loss within 1e-5, the
  gathered parameters and moments within 1e-4, on a config whose
  embedding and FFN matrices FSDP really shards;
* the sharded bf16 step against the reference's own sharded run (a (2, 2)
  mesh of 4 XLA CPU devices, built as ``launch/train.py:61-73`` builds
  it): the loss within 4x the reference's own gap between its sharded and
  unsharded runs, measured here.
"""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_remote_cases as RC  # noqa: E402
from conftest import run_multidevice  # noqa: E402
from repro import configs as RCF  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.layers import attention as RA  # noqa: E402
from repro.layers import embedding as RE  # noqa: E402
from repro.layers import mlp as RM  # noqa: E402
from repro.optim import adamw as ROpt  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401

SEQ, BATCH, MICRO = (RC.TP_SHAPE[k] for k in ("seq", "batch",
                                              "microbatches"))
B = RC.TP_LAYER_B


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jitter(tree, seed):
    """Every 1-D leaf (norm scales, biases) moved off its init, so that a
    bias or scale applied twice or not at all shows."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if a.ndim == 1 else a, tree)


@pytest.fixture(scope="module")
def case():
    """The inputs, and the reference's results on them."""
    cfgs = RC.tp_layer_configs(RCF, dataclasses, jnp.float32)
    rng = np.random.default_rng(7)
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    inp = {"attn": {}, "x": {}, "dy": {}, "embed": {}}
    ref = {}
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (B, SEQ)).copy()
    inp["positions"] = pos
    for i, name in enumerate(("head", "repeat", "seq")):
        cfg = cfgs[name]
        p = _np(_jitter(RA.init_attn(keys[i], cfg), i))
        x = rng.standard_normal((B, SEQ, cfg.d_model)).astype(np.float32)
        dy = rng.standard_normal((B, SEQ, cfg.d_model)).astype(np.float32)
        inp["attn"][name], inp["x"][name], inp["dy"][name] = p, x, dy
        y, vjp = jax.vjp(lambda p, x: RA.attn_apply(cfg, p, x, pos)[0], p, x)
        gp, gx = vjp(jnp.asarray(dy))
        ref[name] = {"y": y, "dx": gx, "grads": jax.tree.leaves(gp)}
    cfg = cfgs["head"]
    inp["mlp"] = {
        "swiglu": _np(RM.init_swiglu(keys[3], cfg.d_model, cfg.d_ff)),
        "gelu": _np(_jitter(RM.init_gelu_mlp(keys[4], cfg.d_model,
                                             cfg.d_ff), 4))}
    for name, fn in (("swiglu", RM.swiglu), ("gelu", RM.gelu_mlp)):
        y, vjp = jax.vjp(lambda p, x: fn(cfg, p, x), inp["mlp"][name],
                         inp["x"]["head"])
        gp, gx = vjp(jnp.asarray(inp["dy"]["head"]))
        ref[name] = {"y": y, "dx": gx, "grads": jax.tree.leaves(gp)}
    inp["tokens"] = rng.integers(0, 256, (B, SEQ)).astype(np.int32)
    inp["labels"] = rng.integers(0, 256, (B, SEQ)).astype(np.int32)

    def embed_loss(cfg, p):
        x = RE.embed(cfg, p, jnp.asarray(inp["tokens"]))
        logits = RE.lm_head(cfg, p, x).astype(jnp.float32)
        logz = jax.scipy.special.logsumexp(logits, axis=-1)
        ll = jnp.take_along_axis(logits, jnp.asarray(inp["labels"])[..., None],
                                 axis=-1)[..., 0]
        return (logz - ll).mean() + 1e-4 * (logz ** 2).mean()

    for i, name in enumerate(("head", "untied")):
        cfg = cfgs[name]
        inp["embed"][name] = p = _np(RE.init_embed(keys[5 + i], cfg))
        loss, g = jax.value_and_grad(lambda p: embed_loss(cfg, p))(p)
        ref["embed_" + name] = {"loss": float(loss),
                                "grads": jax.tree.leaves(g)}

    # the whole model: one microbatch's gradient, then 2 steps of 2
    cfg = RC.tp_step_config(RCF, dataclasses, jnp.float32)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                     seed=1)
    inp["batches"] = [ds.batch_at(i) for i in range(2)]
    state = RS.init_state(jax.random.PRNGKey(0), cfg)
    inp["state"] = _np(state)
    b0 = {k: jnp.asarray(v) for k, v in inp["batches"][0].items()}
    loss, g = jax.value_and_grad(
        lambda p: RS.loss_fn(cfg, p, b0)[0])(state["params"])
    ref["grad_loss"], ref["grads"] = float(loss), jax.tree.leaves(g)
    step = jax.jit(RS.make_train_step(
        cfg, RShape("t", SEQ, BATCH, "train", MICRO),
        RC.tp_opt_config(ROpt.AdamWConfig, "f32")))
    losses, norms = [], []
    for b in inp["batches"]:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    ref["f32"] = {"losses": losses, "grad_norms": norms,
                  "params": jax.tree.leaves(state["params"]),
                  "mu": jax.tree.leaves(state["opt"]["mu"]),
                  "nu": jax.tree.leaves(state["opt"]["nu"])}
    return inp, ref


@pytest.fixture(scope="module")
def world(case, tmp_path_factory):
    inp, _ = case
    return S.run_spmd(RC.tp_body, *RC.TP_MESH, device="cpu", args=(inp,),
                      workdir=str(tmp_path_factory.mktemp("tp_spmd")))


@pytest.fixture(scope="module")
def reference_sharded():
    """The reference's bf16 losses over the same two batches, unsharded and
    sharded on a (2, 2) mesh as its launcher shards them."""
    snippet = f"""
import contextlib, dataclasses, json
import jax, jax.numpy as jnp
from repro import configs
from repro.configs.base import ShapeConfig
from repro.data.pipeline import SyntheticLM
from repro.launch import mesh as MM
from repro.sharding import make_mesh_compat
from repro.train.step import init_state, make_train_step

cfg = dataclasses.replace(configs.smoke_config('phi4_mini_3p8b'), d_model=256,
                          d_ff=4096, vocab=4096)
shape = ShapeConfig('t', {SEQ}, {BATCH}, 'train', {MICRO})
ds = SyntheticLM(vocab=cfg.vocab, seq_len={SEQ}, global_batch={BATCH}, seed=1)
batches = [{{k: jnp.asarray(v) for k, v in ds.batch_at(i).items()}}
           for i in range(2)]

def run(cfg, mesh):
    state = init_state(jax.random.PRNGKey(0), cfg)
    step = make_train_step(cfg, shape, mesh=mesh)
    if mesh is None:
        fn, ctx = jax.jit(step), contextlib.nullcontext()
    else:
        shapes = jax.eval_shape(lambda: state)
        ns = MM.fit_specs(mesh, MM.infer_state_specs(shapes, cfg.axes), shapes)
        ns = jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s), ns,
                          is_leaf=lambda x: isinstance(
                              x, jax.sharding.PartitionSpec))
        state = jax.device_put(state, ns)
        fn = jax.jit(step, in_shardings=(ns, None), out_shardings=(ns, None))
        ctx = mesh
    losses = []
    with ctx:
        for b in batches:
            state, m = fn(state, b)
            losses.append(float(m['loss']))
    return losses

plain = run(cfg, None)
mesh = make_mesh_compat((2, 2), ('data', 'model'))
scfg = dataclasses.replace(cfg.with_axes(MM.axes_for(mesh, shape)), fsdp=True)
print(json.dumps({{'plain': plain, 'sharded': run(scfg, mesh)}}))
"""
    return json.loads(run_multidevice(snippet, n_devices=4).splitlines()[-1])


def _close(got, want, atol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(np.asarray(got, np.float64)
                       - np.asarray(want, np.float64)).max())
    assert err <= atol, f"{what}: {err} > {atol}"


def _scale(a):
    return float(np.abs(np.asarray(a)).max())


@pytest.mark.parametrize("regime", ["head", "repeat", "seq", "swiglu",
                                    "gelu"])
def test_sharded_layer_matches_the_unsharded_reference(case, world, regime):
    """Attention in each regime (qwen3 H4 KV2 head-parallel, KV1 repeated,
    qwen2 H7 KV1 sequence-parallel) and the MLPs: output, input gradient and
    every weight's gradient within 1e-5 of their scale, in every rank."""
    _, ref = case
    want = ref[regime]
    for rank in world:
        got = rank[regime]
        _close(got["y"], want["y"], 1e-5 * _scale(want["y"]), "output")
        _close(got["dx"], want["dx"], 1e-5 * _scale(want["dx"]), "dx")
        assert len(got["grads"]) == len(want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            _close(g, w, 1e-5 * _scale(w) + 1e-7, "weight gradient")


@pytest.mark.parametrize("head", ["head", "untied"])
def test_vocab_parallel_embedding_and_loss(case, world, head):
    """The embedding looked up by vocabulary block, the head's logits left
    vocab-sharded and the cross-entropy reduced over the blocks: the loss
    and the embedding's (and an untied head's) gradients."""
    _, ref = case
    want = ref["embed_" + head]
    for rank in world:
        got = rank["embed_" + head]
        assert abs(float(got["loss"]) - want["loss"]) < 1e-5 * abs(
            want["loss"])
        assert len(got["grads"]) == len(want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            _close(g, w, 1e-5 * _scale(w) + 1e-7, "embedding gradient")


def test_every_leaf_gradient_of_the_sharded_model(case, world):
    """One microbatch through the whole sharded model (FSDP at use, the
    layers tensor-parallel, the vocab-parallel loss): every parameter's
    gradient, gathered, against ``jax.value_and_grad`` of the reference's
    ``loss_fn``."""
    _, ref = case
    for rank in world:
        assert abs(float(rank["grad_loss"]) - ref["grad_loss"]) < 1e-5
        assert len(rank["grads"]) == len(ref["grads"])
        for g, w in zip(rank["grads"], ref["grads"]):
            _close(g, w, 1e-4 * _scale(w) + 1e-7, "gradient")


def test_fsdp_shards_the_embedding_and_the_ffn(world):
    """The config's embedding, head and FFN matrices reach FSDP's 1 << 20
    elements, so the data axis really shards them (the FFN's over its
    stacked layer dim, each data rank a layer)."""
    fsdp = set(world[0]["fsdp"])
    assert {"embed/embed", "embed/head", "blocks/0/ffn/w_gate",
            "blocks/0/ffn/w_up", "blocks/0/ffn/w_down"} <= fsdp


def test_sharded_f32_step_matches_the_reference_step(case, world):
    """2 steps of 2 microbatches with no warmup, so the reference moves
    every leaf by more than three times the parameters' bound: the loss
    within 1e-5, the gathered parameters and Adam moments within 1e-4 of
    the reference's jitted single-process step (``tests/test_trace.py:
    343-353``'s bounds), the gradient norm within 1e-5 relative (Adam's
    update does not see a gradient's scale; the norm does), every rank's
    gathered state the same."""
    inp, ref = case
    want = ref["f32"]
    start = jax.tree.leaves(inp["state"]["params"])
    for rank in world:
        got = rank["f32"]
        for a, b in zip(got["losses"], want["losses"]):
            assert abs(a - b) < 1e-5, (got["losses"], want["losses"])
        for a, b in zip(got["grad_norms"], want["grad_norms"]):
            assert abs(a - b) <= 1e-5 * b, (got["grad_norms"],
                                             want["grad_norms"])
        assert int(got["step"]) == 2
        for key in ("params", "mu", "nu"):
            assert len(got[key]) == len(want[key])
            for g, w in zip(got[key], want[key]):
                _close(g, w, 1e-4, key)
    for w, p0 in zip(want["params"], start):
        assert _scale(np.asarray(w) - p0) > 3e-4
    for other in world[1:]:
        for key in ("params", "mu", "nu"):
            for a, b in zip(world[0]["f32"][key], other["f32"][key]):
                assert torch.equal(a, b)


def test_sharded_bf16_step_matches_the_reference_sharded_run(
        world, reference_sharded):
    """bf16 compute on f32 masters: the port's sharded losses within 4x the
    reference's own sharded-vs-unsharded gap of its sharded losses."""
    plain, sharded = reference_sharded["plain"], reference_sharded["sharded"]
    gap = max(abs(a - b) for a, b in zip(plain, sharded))
    assert gap > 0
    for rank in world:
        got = rank["bf16"]["losses"]
        for a, b in zip(got, sharded):
            assert abs(a - b) <= 4 * gap, (got, sharded, plain)


def test_the_collective_ledger_counts_by_op_and_axis(world):
    """Every rank's ledger names each collective with its axis, and no
    XDMA wire: the trainer's collectives are torch.distributed's."""
    led = world[0]["ledger"]
    for op in ("all_gather:data", "reduce_scatter:data", "all_reduce:model",
               "broadcast:data", "all_reduce_max:model"):
        assert led.get(f"calls:{op}", 0) > 0, op
        assert led.get(f"bytes:{op}", 0) > 0, op
    assert led.get("host_hop_bytes", 0) == 0          # CPU tensors
