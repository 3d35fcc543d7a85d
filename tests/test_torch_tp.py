"""The port's sharded trainer (tensor parallelism and FSDP on a ('data',
'model') process mesh) against the reference.

One (2, 2) gloo world on the CPU (``tests/torch_remote_cases.py::tp_body``)
runs every case; the reference computes each unsharded, in f32, on the same
numpy inputs and its ``init_params`` weights:

* attention in its three regimes on a model axis of 2 (head-parallel,
  the KV heads repeated, sequence-parallel), the SwiGLU and GeLU MLPs, the
  vocab-parallel embedding and head with the vocab-parallel cross-entropy:
  outputs, input gradients and every weight's gradient;
* Mamba, mLSTM, sLSTM and cross-attention (each with a head whole on a
  rank and split or repeated), held to the reference's unsharded vjp, and
  the MoE layer's four distributed paths and its int8 wire, held to the
  reference's ``shard_map`` vjp on a (2, 2) mesh of 4 XLA CPU devices
  (routing, capacity and aux are each rank's slice's there);
* the whole model's gradient of one microbatch, every leaf (jamba's, with
  Mamba and MoE slots, against the reference's sharded program; xlstm's
  and whisper's, with the encoder and cross-attention, unsharded);
* the sharded f32 step, 2 steps of 2 microbatches, against the reference's
  jitted single-process ``make_train_step``: the loss within 1e-5, the
  gathered parameters and moments within 1e-4, on a config whose
  embedding and FFN matrices FSDP really shards;
* jamba's sharded f32 step against the reference's own sharded f32 run
  (loss within 1e-5, parameters and moments within 1e-4);
* the sharded bf16 step against the reference's own sharded run (a (2, 2)
  mesh of 4 XLA CPU devices, built as ``launch/train.py:61-73`` builds
  it): the loss within 4x the reference's own gap between its sharded and
  unsharded runs, measured here.
"""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_remote_cases as RC  # noqa: E402
from conftest import SRC  # noqa: E402
from repro import configs as RCF  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.layers import attention as RA  # noqa: E402
from repro.layers import embedding as RE  # noqa: E402
from repro.layers import mamba as RMB  # noqa: E402
from repro.layers import mlp as RM  # noqa: E402
from repro.layers import xlstm as RX  # noqa: E402
from repro.models import lm as RL  # noqa: E402
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


def _jit_vjp(fn, args, dy):
    """``(fn(*args), the gradients of args[0], args[1:], ...)`` for the
    cotangent ``dy``, jitted (the scans of the recurrent layers are slow
    eagerly)."""
    def run(args, dy):
        y, vjp = jax.vjp(fn, *args)
        return (y, *vjp(dy))
    return jax.jit(run)(args, dy)


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
        x = RE.embed(cfg, p, jnp.asarray(inp["tokens"] % cfg.vocab))
        logits = RE.lm_head(cfg, p, x).astype(jnp.float32)
        logz = jax.scipy.special.logsumexp(logits, axis=-1)
        labels = jnp.asarray(inp["labels"] % cfg.vocab)
        ll = jnp.take_along_axis(logits, labels[..., None], axis=-1)[..., 0]
        return (logz - ll).mean() + 1e-4 * (logz ** 2).mean()

    for i, name in enumerate(("head", "untied", "odd")):
        cfg = cfgs[name]
        inp["embed"][name] = p = _np(RE.init_embed(keys[5 + i], cfg))
        loss, g = jax.value_and_grad(lambda p: embed_loss(cfg, p))(p)
        ref["embed_" + name] = {"loss": float(loss),
                                "grads": jax.tree.leaves(g)}

    # the other slots, held to the unsharded vjp
    init = {"mamba": RMB.init_mamba, "mlstm": RX.init_mlstm,
            "slstm": RX.init_slstm,
            "cross": lambda k, c: RA.init_attn(k, c, cross=True)}
    apply = {"mamba": RMB.mamba_apply, "mlstm": RX.mlstm_apply,
             "slstm": RX.slstm_apply}
    inp["slot"] = {}
    scfgs = RC.tp_slot_configs(RCF, dataclasses, jnp.float32)
    inp["kv"] = kv = rng.standard_normal(
        (B, RC.TP_CROSS_SK, scfgs["cross"].d_model)).astype(np.float32)
    for i, (name, cfg) in enumerate(scfgs.items()):
        slot = name.split("_")[0]
        p = _np(_jitter(init[slot](jax.random.PRNGKey(10 + i), cfg), 10 + i))
        x = rng.standard_normal((B, SEQ, cfg.d_model)).astype(np.float32)
        dy = rng.standard_normal((B, SEQ, cfg.d_model)).astype(np.float32)
        inp["slot"][name], inp["x"][name], inp["dy"][name] = {slot: p}, x, dy
        if slot == "cross":
            fn = (lambda p, x, kv, cfg=cfg: RA.attn_apply(  # noqa: E731
                cfg, p, x, pos, causal=False, kv_x=kv, apply_rope=False,
                cross=True)[0])
            args = (p, x, kv)
        else:
            fn = (lambda p, x, cfg=cfg, f=apply[slot]:  # noqa: E731
                  f(cfg, p, x)[0])
            args = (p, x)
        y, gp, *gin = _jit_vjp(fn, args, dy)
        ref[name] = {"y": y, "dx": gin[0], "dextra": gin[1:],
                     "grads": jax.tree.leaves(gp)}

    # the MoE cases' inputs (the reference runs them sharded, below)
    inp["moe"] = {}
    for i, (name, (_, seq)) in enumerate(RC.TP_MOE.items()):
        cfg = RC.tp_moe_config(RCF, dataclasses, jnp.float32, name)
        inp["moe"][name] = {
            "p": RC.moe_params(cfg.n_experts, cfg.d_model, cfg.d_ff_expert,
                               30 + i),
            "x": rng.standard_normal((B, seq, cfg.d_model)).astype(
                np.float32),
            "dy": rng.standard_normal((B, seq, cfg.d_model)).astype(
                np.float32)}

    # jamba, xlstm, whisper: their init and batches; xlstm's and whisper's
    # gradient held to the unsharded one (jamba's MoE to the sharded run)
    inp["models"] = {}
    for name in RC.TP_MODELS:
        cfg = RC.tp_model_config(RCF, dataclasses, jnp.float32, name)
        ds = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                         seed=1, family=cfg.family, d_model=cfg.d_model,
                         encoder_seq=cfg.encoder_seq)
        params = _np(jax.jit(RL.init_params, static_argnums=1)(
            jax.random.PRNGKey(0), cfg))
        inp["models"][name] = {"params": params,
                               "batches": [ds.batch_at(i) for i in range(2)]}
        if name == "jamba":
            continue
        loss, g = jax.jit(jax.value_and_grad(
            lambda p, b, cfg=cfg: RS.loss_fn(cfg, p, b)[0]))(
                params, ds.batch_at(0))
        ref["model_" + name] = {"loss": float(loss),
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
def world(case, reference_runs, tmp_path_factory):
    inp, _ = case
    return S.run_spmd(RC.tp_body, *RC.TP_MESH, device="cpu", args=(inp,),
                      workdir=str(tmp_path_factory.mktemp("tp_spmd")))


def _sharded_bf16_snippet():
    """The reference's bf16 losses over the same two batches, unsharded and
    sharded on a (2, 2) mesh as its launcher shards them: the snippet's
    last line, JSON."""
    return f"""
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


def _mesh_snippet(inp, src, dst):
    """The reference's own sharded runs on a (2, 2) mesh of 4 XLA CPU
    devices, their arrays saved to ``dst``: each MoE case's ``shard_map``
    vjp (output, aux, input and weight gradients; the aux cotangent
    ``TP_MOE_DAUX``) on the inputs saved to ``src``, and jamba's widened
    f32 config as its launcher shards it (``launch/train.py:61-73``): one
    microbatch's gradient, then 2 steps of 2 microbatches with no warmup,
    the state they leave; for the int8 wire, the all-to-all bytes
    (``repro.launch.dryrun.collective_bytes``) in the compiled HLO of the
    vjp's program and of its forward alone."""
    flat = {}
    for name, c in inp["moe"].items():
        flat.update({f"moe/{name}/{k}": v for k, v in c["p"].items()})
        flat[f"moe/{name}/x"], flat[f"moe/{name}/dy"] = c["x"], c["dy"]
    np.savez(src, **flat)
    return f"""
import dataclasses, os
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.configs.base import ShapeConfig
from repro.data.pipeline import SyntheticLM
from repro.launch import mesh as MM
from repro.layers import moe as RMOE
from repro.optim.adamw import AdamWConfig
from repro.sharding import Axes, make_mesh_compat
from repro.train.step import init_state, loss_fn, make_train_step

mesh = make_mesh_compat((2, 2), ('data', 'model'))
flags = os.environ['XLA_FLAGS']      # the dry run sets its own on import
from repro.launch.dryrun import collective_bytes
os.environ['XLA_FLAGS'] = flags
inp, out = np.load({src!r}), {{}}
axes = Axes(batch=('data',), model='model', model_size=2, batch_size=2)
for name, (kw, _) in {RC.TP_MOE!r}.items():
    cfg = dataclasses.replace(configs.smoke_config('qwen3_moe_30b_a3b'),
                              dtype=jnp.float32, **kw).with_axes(axes)
    p = {{k: jnp.asarray(inp[f'moe/{{name}}/{{k}}'])
         for k in ('router', 'w_gate', 'w_up', 'w_down')}}

    def run(p, x, dy, cfg=cfg):
        (y, aux), vjp = jax.vjp(
            lambda p, x: RMOE.moe_apply(cfg, p, x, mesh=mesh), p, x)
        gp, gx = vjp((dy, jnp.float32({RC.TP_MOE_DAUX!r})))
        return y, aux, gp, gx
    y, aux, gp, gx = jax.jit(run)(p, inp[f'moe/{{name}}/x'],
                                  inp[f'moe/{{name}}/dy'])
    if name == 'int8':
        args = (p, inp[f'moe/{{name}}/x'])
        fwd = jax.jit(lambda p, x, cfg=cfg: RMOE.moe_apply(
            cfg, p, x, mesh=mesh)).lower(*args).compile().as_text()
        both = jax.jit(run).lower(*args, inp[f'moe/{{name}}/dy']).compile(
            ).as_text()
        out['moe/int8/a2a_fwd'] = collective_bytes(fwd).get('all-to-all', 0)
        out['moe/int8/a2a_both'] = collective_bytes(both).get('all-to-all', 0)
    out.update({{f'moe/{{name}}/y': y, f'moe/{{name}}/aux': aux,
                f'moe/{{name}}/dx': gx}})
    for i, g in enumerate(jax.tree.leaves(gp)):
        out[f'moe/{{name}}/g{{i}}'] = g

cfg = dataclasses.replace(configs.smoke_config({RC.TP_ARCH['jamba']!r}),
                          dtype=jnp.float32, **{RC.TP_WIDE['jamba']!r})
shape = ShapeConfig('t', {SEQ}, {BATCH}, 'train', {MICRO})
ds = SyntheticLM(vocab=cfg.vocab, seq_len={SEQ}, global_batch={BATCH},
                 seed=1, family=cfg.family, d_model=cfg.d_model,
                 encoder_seq=cfg.encoder_seq)
batches = [{{k: jnp.asarray(v) for k, v in ds.batch_at(i).items()}}
           for i in range(2)]
cfg = dataclasses.replace(cfg.with_axes(MM.axes_for(mesh, shape)), fsdp=True)
state = init_state(jax.random.PRNGKey(0), cfg)
shapes = jax.eval_shape(lambda: state)
ns = MM.fit_specs(mesh, MM.infer_state_specs(shapes, cfg.axes), shapes)
ns = jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s), ns,
                  is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
state = jax.device_put(state, ns)
with mesh:
    loss, g = jax.jit(jax.value_and_grad(
        lambda p: loss_fn(cfg, p, batches[0], mesh=mesh)[0]))(state['params'])
    step = jax.jit(make_train_step(cfg, shape,
                                   AdamWConfig(**{RC.TP_JAMBA_OPT!r}),
                                   mesh=mesh),
                   in_shardings=(ns, None), out_shardings=(ns, None))
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m['loss']))
out['jamba/loss'], out['jamba/losses'] = loss, np.asarray(losses)
for key, tree in (('grads', g), ('params', state['params']),
                  ('mu', state['opt']['mu']), ('nu', state['opt']['nu'])):
    for i, a in enumerate(jax.tree.leaves(tree)):
        out[f'jamba/{{key}}/{{i}}'] = np.asarray(a)
np.savez({dst!r}, **{{k: np.asarray(v) for k, v in out.items()}})
"""


@pytest.fixture(scope="module")
def reference_runs(case, tmp_path_factory):
    """One subprocess with 4 XLA CPU devices for the reference's sharded
    runs, started before the gloo world so that the two run together;
    ``wait()`` gives its output."""
    inp, _ = case
    root = tmp_path_factory.mktemp("tp_reference")
    dst = str(root / "out.npz")
    snippet = (_mesh_snippet(inp, str(root / "in.npz"), dst)
               + _sharded_bf16_snippet())
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", snippet], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    done = {}

    def wait():
        if not done:
            out, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"subprocess failed:\n{out}\n{err}")
            done.update(stdout=out, arrays=dict(np.load(dst)))
        return done
    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference_sharded(reference_runs):
    return json.loads(reference_runs()["stdout"].splitlines()[-1])


@pytest.fixture(scope="module")
def reference_mesh(reference_runs):
    got = reference_runs()["arrays"]

    def seq(prefix):
        n = sum(k.startswith(prefix) for k in got)
        return [got[f"{prefix}{i}"] for i in range(n)]
    ref = {"moe": {}, "jamba": {
        "loss": float(got["jamba/loss"]),
        "losses": [float(v) for v in got["jamba/losses"]],
        **{k: seq(f"jamba/{k}/") for k in ("grads", "params", "mu", "nu")}}}
    ref["int8_a2a"] = {k: int(got[f"moe/int8/a2a_{k}"])
                       for k in ("fwd", "both")}
    for name in RC.TP_MOE:
        ref["moe"][name] = {"y": got[f"moe/{name}/y"],
                            "aux": float(got[f"moe/{name}/aux"]),
                            "dx": got[f"moe/{name}/dx"],
                            "grads": seq(f"moe/{name}/g")}
    return ref


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


@pytest.mark.parametrize("slot", list(RC.tp_slot_configs(
    RCF, dataclasses, jnp.float32)))
def test_sharded_slot_matches_the_unsharded_reference(case, world, slot):
    """Mamba (SSM heads whole on a rank, and a head split between two),
    mLSTM (heads whole, and a head's value channels split), sLSTM (heads
    whole, and one head run whole on every rank) and cross-attention over a
    kv_x of 24 rows against 16 queries (head-parallel, the KV head
    repeated, sequence-parallel): output, input gradients (kv_x's
    too) and every weight's gradient within 1e-5 of their scale, in every
    rank, against the reference's unsharded ``jax.vjp``.  A weight whose
    gradient cancels to rounding noise (sLSTM's ``b_i``: the stabilised
    input gate's bias, about 7e-7 against the layer's largest gradient of
    45, where the port's own unsharded layer is as far off) is held to
    1e-7 of the layer's largest weight gradient."""
    _, ref = case
    want = ref[slot]
    top = max(_scale(w) for w in want["grads"])
    for rank in world:
        got = rank[slot]
        _close(got["y"], want["y"], 1e-5 * _scale(want["y"]), "output")
        _close(got["dx"], want["dx"], 1e-5 * _scale(want["dx"]), "dx")
        assert len(got["dextra"]) == len(want["dextra"])
        for g, w in zip(got["dextra"], want["dextra"]):
            _close(g, w, 1e-5 * _scale(w), "kv_x's gradient")
        assert len(got["grads"]) == len(want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            _close(g, w, 1e-5 * _scale(w) + 1e-7 * top, "weight gradient")


@pytest.mark.parametrize("path", list(RC.TP_MOE))
def test_sharded_moe_matches_the_reference_shard_map(world, reference_mesh,
                                                     path):
    """The MoE layer's distributed paths on the model axis of 2 — experts
    split with the sequence split and without it, d_ff split, replicated
    experts — and the int8 wire, against the reference's ``shard_map``
    vjp on a (2, 2) mesh of 4 XLA CPU devices (not its unsharded layer:
    routing, capacity and aux are each rank's slice's): the output, the
    aux loss, the input gradient and every weight's gradient within 1e-5
    of their scale, in every rank."""
    want = reference_mesh["moe"][path]
    for rank in world:
        got = rank["moe_" + path]
        _close(got["y"], want["y"], 1e-5 * _scale(want["y"]), "output")
        assert abs(float(got["aux"]) - want["aux"]) <= 1e-6 * want["aux"]
        _close(got["dx"], want["dx"], 1e-5 * _scale(want["dx"]), "dx")
        assert len(got["grads"]) == len(want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            _close(g, w, 1e-5 * _scale(w) + 1e-7, "weight gradient")


def test_int8_wire_backward_moves_the_reference_bytes(world, reference_mesh):
    """The int8 MoE wire's backward moves what the reference's transpose
    moves: the scales' cotangent, one f32 a row of each all-to-all.  The
    port's all-to-all bytes of the vjp alone (the ``collectives`` and
    ``wire`` ledgers around ``torch.autograd.grad``) in every rank equal the
    all-to-all bytes of the reference's ``shard_map`` vjp on the same (2, 2)
    mesh: those of the compiled HLO of forward and vjp less those of its
    forward alone (``collective_bytes`` counts each all-to-all's result
    shapes, the bytes it moves a device)."""
    ref = reference_mesh["int8_a2a"]
    want = ref["both"] - ref["fwd"]
    assert want > 0
    for rank in world:
        assert rank["moe_int8"]["a2a_vjp"] == want, (
            rank["moe_int8"]["a2a_vjp"], ref)


@pytest.mark.parametrize("model", RC.TP_MODELS)
def test_every_leaf_gradient_of_the_sharded_slots(case, world,
                                                  reference_mesh, model):
    """One microbatch through the whole sharded jamba (Mamba and MoE
    slots), xlstm and whisper (encoder and cross-attention): the loss and
    every parameter's gradient, gathered, against ``jax.value_and_grad`` of
    the reference's ``loss_fn``: unsharded for xlstm and whisper, for
    jamba the reference's own sharded program (its MoE routes each rank's
    slice).  FSDP shards an expert and a Mamba matrix of jamba and the
    encoder's FFN of whisper."""
    _, ref = case
    want = (reference_mesh["jamba"] if model == "jamba"
            else ref["model_" + model])
    for rank in world:
        got = rank["model_" + model]
        assert abs(float(got["loss"]) - want["loss"]) <= 1e-5 * max(
            1.0, abs(want["loss"])), (float(got["loss"]), want["loss"])
    grads = world[0]["model_" + model]["grads"]
    assert len(grads) == len(want["grads"])
    for g, w in zip(grads, want["grads"]):
        _close(g, w, 1e-4 * _scale(w) + 1e-7, "gradient")
    fsdp = set(world[0]["model_" + model]["fsdp"])
    must = {"jamba": {"blocks/1/ffn/w_gate", "blocks/1/mamba/w_x"},
            "xlstm": set(), "whisper": {"encoder/ffn/w_up"}}[model]
    assert must <= fsdp, sorted(fsdp)


def test_sharded_jamba_f32_step_matches_the_reference_sharded_run(
        case, world, reference_mesh):
    """jamba's widened config, 2 steps of 2 microbatches with no warmup
    (Adam's eps at 1e-4: ``TP_JAMBA_OPT``): the loss within 1e-5, the
    gathered parameters and Adam moments within 1e-4 of the reference's own
    sharded f32 run on a (2, 2) mesh of 4 XLA CPU devices, every rank's
    losses the same; every leaf moved by more than three times the
    parameters' bound."""
    inp, _ = case
    want = reference_mesh["jamba"]
    for rank in world:
        got = rank["jamba_f32"]
        assert int(got["step"]) == 2
        for a, b in zip(got["losses"], want["losses"]):
            assert abs(a - b) < 1e-5, (got["losses"], want["losses"])
    got = world[0]["jamba_f32"]
    for key in ("params", "mu", "nu"):
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            _close(g, w, 1e-4, key)
    start = jax.tree.leaves(inp["models"]["jamba"]["params"])
    for w, p0 in zip(want["params"], start):
        assert _scale(np.asarray(w) - p0) > 3e-4


@pytest.mark.parametrize("head", ["head", "untied", "odd"])
def test_vocab_parallel_embedding_and_loss(case, world, head):
    """The embedding looked up by vocabulary block, the head's logits left
    vocab-sharded and the cross-entropy reduced over the blocks: the loss
    and the embedding's (and an untied head's) gradients; a vocabulary of
    255, which does not split over the axis, replicated (whisper's 51865
    over 2)."""
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
