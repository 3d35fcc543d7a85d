"""Sharded serving: ``lm.prefill``, ``lm.decode_step``, ``ServingEngine``
and ``ContinuousBatchingEngine`` with ``mesh=`` on a ('data', 'model')
process mesh, against the reference.

One (2, 2) gloo world on the CPU (``tests/torch_remote_cases.py::
serve_body``) runs every case, each on the world's own mesh or on a (1, 4)
view of the same 4 ranks.  The weights are the reference's
``init_params`` through numpy, cut to each rank's blocks by the serving
specs (no FSDP); the reference runs each case unsharded, jitted, in f32,
on the same seeded prompts and decode tokens:

* every smoke config on both meshes, prefill B 4 x S 16 then 4 decode
  steps: the KV cache split by heads (KV 2 on a model axis of 2), by
  sequence (KV 2 on 4: the repeat regime in the prefill; qwen2's KV 1:
  the sequence-parallel regime), the cross cache (whisper, and by frames
  with 3 heads), the recurrent caches (jamba's Mamba, xlstm's mLSTM and
  sLSTM, a one-head xlstm whose state is whole on every rank or split
  inside a head), MoE (jamba, mixtral, qwen3-moe);
* qwen3 and gemma3 with the XDMA cache layout (gemma3's window of 8
  against 16 prompt tokens: the rolled write), a ragged decode of each;
* on (1, 4) a max_len of 30, which the model axis does not divide: the
  KV cache whole on every rank (qwen3; gemma3's global layers beside its
  window's split cache; whisper with 18 frames, its cross cache whole);
* every step's logits within 2e-5 of max|logit|, in every rank; every
  rank's final cache leaf within 2e-5 of its scale of the matching block
  of the reference's cache (``pos`` and ``len`` exact), each block the
  ``local_shape`` of its fitted spec;
* one decode step's collective bytes under one layer's K block: no rank
  gathers a cache;
* a Mamba layer whose SSM heads divide neither axis (its state whole on
  every rank, its channel blocks splitting heads) through a prefill and
  the decode steps, against the reference's layer with a cache;
* ``ServingEngine`` and ``ContinuousBatchingEngine`` (6 requests of mixed
  length) with ``mesh=``: the single-process port engines' tokens, also
  on a pool so small that every rank evicts and restores pages;
* the reference's own sharded run (qwen3, (1, 4), the XDMA cache, in a
  subprocess with 4 XLA CPU devices, started before the world): the
  port's logits within the same bound of it.
"""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402
import functools  # noqa: E402
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
from repro.layers import mamba as RMB  # noqa: E402
from repro.models import lm as RL  # noqa: E402
from repro_torch import _pytree  # noqa: E402
from repro_torch import configs as PCF  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import lm as PL  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 ServingEngine, trace_stream)
from torch_parity import reset_global_state  # noqa: E402,F401

BOUND = 2e-5                    # x max|logit|, x each cache leaf's scale
CASES = RC.serve_cases()
KEYS = sorted({(a, v) for a, v, *_ in CASES.values()})
SHAPES = RC.SERVE_MESHES
B, MAX_LEN, STEPS = RC.SERVE["B"], RC.SERVE["max_len"], RC.SERVE["steps"]


def _seed(key):
    return KEYS.index(key)


def _rcfg(key):
    return RC.serve_config(RCF, dataclasses, jnp.float32, *key)


def _pcfg(key):
    return RC.serve_config(PCF, dataclasses, torch.float32, *key)


def _reference(rcfg, params, b, steps, ragged, max_len):
    """The reference's jitted, unsharded prefill and decode steps: every
    step's logits and the final cache (numpy)."""
    pre = jax.jit(functools.partial(RL.prefill, rcfg))
    dec = jax.jit(functools.partial(RL.decode_step, rcfg))
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    logits, cache = pre(params, batch, RL.init_cache(rcfg, B, max_len,
                                                     jnp.float32))
    out = [np.asarray(logits)]
    if ragged:
        cache = dict(cache, pos=jnp.asarray(RC.SERVE_RAGGED, jnp.int32))
    for t in steps:
        logits, cache = dec(params, jnp.asarray(t), cache)
        out.append(np.asarray(logits))
    return out, jax.tree.map(np.asarray, cache)


def _mamba_cfg(configs, f32):
    return dataclasses.replace(configs.smoke_config("jamba_1p5_large_398b"),
                               dtype=f32, **RC.SERVE_MAMBA)


@pytest.fixture(scope="module")
def inp():
    params, inputs = {}, {}
    for key in KEYS:
        rcfg = _rcfg(key)
        params[key] = jax.tree.map(np.asarray, RL.init_params(
            jax.random.PRNGKey(_seed(key)), rcfg))
        inputs[key] = RC.serve_inputs(rcfg, _seed(key))
    rcfg = _mamba_cfg(RCF, jnp.float32)
    rng = np.random.default_rng(99)
    mamba = {"p": jax.tree.map(np.asarray, RMB.init_mamba(
        jax.random.PRNGKey(99), rcfg)),
        "x": rng.standard_normal((B, RC.SERVE["S"], rcfg.d_model)).astype(
            np.float32),
        "steps": rng.standard_normal((STEPS, B, 1, rcfg.d_model)).astype(
            np.float32)}
    return {"params": params, "inputs": inputs, "mamba": mamba}


_REFERENCE_SHARDED = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, {tests!r})
import torch_remote_cases as RC
from repro import configs
from repro.configs.base import ShapeConfig
from repro.launch import mesh as MM
from repro.models import lm
from repro.sharding import make_mesh_compat

key = ('qwen3_1p7b', 'xdma')
cfg = RC.serve_config(configs, dataclasses, jnp.float32, *key)
params = lm.init_params(jax.random.PRNGKey({seed}), cfg)
b, steps = RC.serve_inputs(cfg, {seed})
B, S, L = RC.SERVE['B'], RC.SERVE['S'], RC.SERVE['max_len']
mesh = make_mesh_compat((1, 4), ('data', 'model'))
cfg = cfg.with_axes(MM.axes_for(mesh, ShapeConfig('p', S, B, 'prefill')))
cache = lm.init_cache(cfg, B, L, jnp.float32)

def named(specs, tree):
    return jax.tree.map(lambda s: jax.sharding.NamedSharding(mesh, s),
                        MM.fit_specs(mesh, specs, tree),
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))
pshape, cshape = jax.eval_shape(lambda: params), jax.eval_shape(lambda: cache)
pn = named(MM.infer_param_specs(pshape, cfg.axes), pshape)
cn = named(MM.cache_specs(cfg, cshape, cfg.axes), cshape)
pre = jax.jit(lambda p, b, c: lm.prefill(cfg, p, b, c, mesh=mesh),
              in_shardings=(pn, None, cn), out_shardings=(None, cn))
dec = jax.jit(lambda p, t, c: lm.decode_step(cfg, p, t, c, mesh=mesh),
              in_shardings=(pn, None, cn), out_shardings=(None, cn))
with mesh:
    p, c = jax.device_put(params, pn), jax.device_put(cache, cn)
    logits, c = pre(p, {{k: jnp.asarray(v) for k, v in b.items()}}, c)
    out = [np.asarray(logits)]
    for t in steps:
        logits, c = dec(p, jnp.asarray(t), c)
        out.append(np.asarray(logits))
np.savez({dst!r}, *out)
"""


@pytest.fixture(scope="module")
def reference_sharded(tmp_path_factory):
    """The reference's own sharded qwen3 run, (1, 4), the XDMA cache, in a
    subprocess with 4 XLA CPU devices, started before the world;
    ``wait()`` gives every step's logits."""
    root = tmp_path_factory.mktemp("serve_reference")
    dst = str(root / "out.npz")
    code = _REFERENCE_SHARDED.format(
        tests=os.path.dirname(os.path.abspath(__file__)),
        seed=_seed(("qwen3_1p7b", "xdma")), dst=dst)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    done = []

    def wait():
        if not done:
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"subprocess failed:\n{out}\n{err}")
            got = np.load(dst)
            done.append([got[f"arr_{i}"] for i in range(len(got.files))])
        return done[0]
    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def world(inp, reference_sharded, tmp_path_factory):
    return S.run_spmd(RC.serve_body, *RC.SERVE_WORLD, device="cpu",
                      args=(inp,),
                      workdir=str(tmp_path_factory.mktemp("serve_world")))


@pytest.fixture(scope="module")
def reference(inp):
    """Each (arch, variant, ragged, max_len)'s unsharded reference run."""
    out = {}
    for arch, variant, _, ragged, L in CASES.values():
        key = (arch, variant)
        if (key, ragged, L) not in out:
            b, steps = inp["inputs"][key]
            out[(key, ragged, L)] = _reference(
                _rcfg(key), inp["params"][key], b, steps, ragged, L)
    return out


def _scale(a):
    return float(np.abs(np.asarray(a, np.float64)).max())


def _err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def _rank_view(shape, rank):
    """A rank's coordinates on the mesh ``shape`` (row-major), for
    ``shard_tree``'s blocks."""
    return S.Mesh(shape, ("data", "model"), rank, torch.device("cpu"),
                  "gloo", "", {"data": S.MeshAxis("data", shape[0],
                                                  rank // shape[1]),
                               "model": S.MeshAxis("model", shape[1],
                                                   rank % shape[1])})


def _axes_cfg(key):
    return _pcfg(key).with_axes(S.Axes(batch=("data",), model="model"))


def _cache_specs(key, shape, max_len=MAX_LEN):
    """The fitted specs of the case's cache on ``shape``, in leaf order,
    and the whole cache's meta tree."""
    cfg = _axes_cfg(key)
    whole = PL._whole_cache(cfg, B, max_len, torch.float32,
                            torch.device("meta"))
    mesh = M.MeshSpec(shape, ("data", "model"))
    return M.spec_leaves(M.serving_cache_specs(cfg, whole, mesh), whole), \
        whole


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_logits_match_the_unsharded_reference(world, reference,
                                                      case):
    """Prefill's and every decode step's logits, whole (B, 1, V) on every
    rank, within 2e-5 of max|logit| of the reference's unsharded run."""
    arch, variant, _, ragged, L = CASES[case]
    want, _ = reference[((arch, variant), ragged, L)]
    for rank in world:
        got = rank["cases"][case]["logits"]
        assert len(got) == len(want) == STEPS + 1
        for i, (g, w) in enumerate(zip(got, want)):
            assert tuple(g.shape) == w.shape == (B, 1, _pcfg(
                (arch, variant)).vocab)
            assert _err(g, w) <= BOUND * _scale(w), (case, i, _err(g, w),
                                                     _scale(w))


@pytest.mark.parametrize("case", list(CASES))
def test_every_rank_holds_its_block_of_the_reference_cache(world, reference,
                                                           case):
    """Each rank's cache after the decode steps: every leaf the matching
    block (by its fitted spec and the rank's mesh coordinates) of the
    reference's final cache, within 2e-5 of that block's scale; ``pos`` and
    ``len`` exact; every leaf of the fresh cache ``local_shape`` of its
    fitted spec."""
    arch, variant, mname, ragged, L = CASES[case]
    shape = SHAPES[mname]
    _, cache = reference[((arch, variant), ragged, L)]
    specs, whole = _cache_specs((arch, variant), shape, L)
    ref = PL.params_from_numpy(cache, device="cpu")
    mesh = M.MeshSpec(shape, ("data", "model"))
    names = [_pytree.path_key(p) for p, _ in _pytree.flatten_with_paths(ref)]
    for r, rank in enumerate(world):
        got = rank["cases"][case]
        assert got["shapes"] == [
            M.local_shape(t.shape, sp, mesh) if t.dim() else ()
            for t, sp in zip(_pytree.leaves(whole), specs)]
        want = _pytree.leaves(M.shard_tree(ref, _pytree.unflatten(
            ref, specs), _rank_view(shape, r)))
        assert len(got["cache"]) == len(want)
        for name, g, w in zip(names, got["cache"], want):
            assert g.shape == w.shape, (name, g.shape, w.shape)
            if name.endswith(("pos", "len")):
                assert torch.equal(g, w), name
            else:
                assert _err(g, w) <= BOUND * max(_scale(w), 1e-30), (
                    name, _err(g, w), _scale(w))


def test_the_caches_split_as_the_specs_say():
    """The cases reach both KV splits and the recurrent leaves' blocks:
    qwen3's KV heads over a model axis of 2, its sequence over 4 (KV 2),
    whisper's cross cache by heads and, with 3 heads, by frames; jamba's
    Mamba state by heads; the one-head xlstm's mLSTM state whole and its
    sLSTM state split inside the head."""
    def spec_of(key, shape, want):
        specs, whole = _cache_specs(key, shape)
        for (path, _), sp in zip(_pytree.flatten_with_paths(whole), specs):
            if _pytree.path_key(path) == want:
                return sp
        raise KeyError(want)
    q3, wh = ("qwen3_1p7b", ""), ("whisper_small", "")
    assert spec_of(q3, (2, 2), "blocks/0/k") == (None, "data", None, "model")
    assert spec_of(q3, (1, 4), "blocks/0/k") == (None, "data", "model")
    assert spec_of(("qwen3_1p7b", "xdma"), (1, 4), "blocks/0/k") == (
        None, "data", None, None, "model")
    assert spec_of(("qwen2_0p5b", ""), (2, 2), "blocks/0/v") == (
        None, "data", "model")
    assert spec_of(wh, (1, 4), "cross/k") == (None, "data", None, "model")
    assert spec_of(("whisper_small", "cross_seq"), (2, 2), "cross/k") == (
        None, "data", "model")
    jb = ("jamba_1p5_large_398b", "")
    assert spec_of(jb, (1, 4), "blocks/1/h") == (None, "data", "model")
    assert spec_of(jb, (1, 4), "blocks/1/conv") == (None, "data", None,
                                                    "model")
    one = ("xlstm_125m", "one_head")
    assert spec_of(one, (1, 4), "blocks/0/mlstm/0") == (None, "data")
    assert spec_of(one, (1, 4), "blocks/1/slstm/0") == (None, "data",
                                                        "model")


@pytest.mark.parametrize("mesh", RC.SERVE_MESHES)
def test_a_decode_step_gathers_no_cache(world, mesh):
    """qwen3 with a cache of 256 slots: one decode step's collective bytes
    (every op, handed by this rank) under one layer's K block of this
    rank, so no cache crosses a collective; the step's all-reduces and
    all-gathers move activations, and a sequence split merges its softmax
    with an all-reduce of the row max."""
    for rank in world:
        got = rank["bytes"][mesh]
        moved = sum(v for k, v in got["step"].items()
                    if k.startswith("bytes:"))
        assert 0 < moved < got["layer_k_block"], got
        if mesh == "1x4":
            assert got["step"].get("calls:all_reduce_max:model", 0) > 0


@pytest.fixture(scope="module")
def single_process(inp):
    """The single-process port engines on the CPU: ``ServingEngine``'s
    tokens and the continuous engine's per request."""
    out = {}
    for arch in RC.SERVE_ENGINE_ARCHS:
        key = (arch, "")
        cfg = _pcfg(key)
        params = PL.params_from_numpy(inp["params"][key], device="cpu")
        b, _ = inp["inputs"][key]
        toks = ServingEngine(cfg, params, MAX_LEN, cache_dtype=torch.float32,
                             device="cpu").generate(
            {k: torch.from_numpy(v) for k, v in b.items()}, STEPS)
        served = {}
        for L in {MAX_LEN, RC.SERVE_TIGHT["max_len"]}:
            served[L] = ContinuousBatchingEngine(
                cfg, params, L, max_batch=4, cache_dtype=torch.float32,
                capacity_pages=RC.SERVE_POOL_PAGES, device="cpu").serve(
                    trace_stream(cfg, RC.SERVE_STREAM, seed=5)).tokens
        out[arch] = {"tokens": toks, "served": served[MAX_LEN],
                     "tight": served[RC.SERVE_TIGHT["max_len"]]}
    return out


ENGINE_CASES = [f"{a}@{m}" for m in RC.SERVE_MESHES
                for a in RC.SERVE_ENGINE_ARCHS]


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_serving_engine_with_a_mesh_gives_the_single_process_tokens(
        world, single_process, case):
    """``ServingEngine(mesh=)``: the whole (B, n_steps) tokens on every
    rank, the single-process engine's."""
    want = single_process[case.split("@")[0]]["tokens"]
    for rank in world:
        got = rank["engines"][case]["tokens"]
        assert tuple(got.shape) == (B, STEPS)
        assert torch.equal(got, want), (got, want)


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_continuous_engine_with_a_mesh_gives_the_single_process_tokens(
        world, single_process, case):
    """``ContinuousBatchingEngine(mesh=)`` over 6 requests of mixed length
    (4 at a time: the later ones admitted as slots free, ragged decode
    steps): every request's tokens the single-process engine's, and every
    rank made the same decisions (steps, pool traffic, clock)."""
    want = single_process[case.split("@")[0]]["served"]
    r0 = world[0]["engines"][case]
    for rank in world:
        got = rank["engines"][case]
        assert sorted(got["served"]) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got["served"][rid], want[rid])
        assert (got["steps"], got["pool"], got["elapsed_s"]) == (
            r0["steps"], r0["pool"], r0["elapsed_s"])


@pytest.mark.parametrize("mesh", RC.SERVE_MESHES)
def test_continuous_engine_with_a_mesh_evicts_and_restores_its_blocks(
        world, single_process, mesh):
    """``ContinuousBatchingEngine(mesh=)`` on a pool too small for the
    stream (``SERVE_TIGHT``: on (1, 4) each page a rank's rows of a
    sequence-split block): every rank preempts, evicts and restores pages,
    all make the same decisions, and every request's tokens are the
    single-process engine's (a pool that evicts nothing)."""
    want = single_process["qwen3_1p7b"]["tight"]
    r0 = world[0]["engines"][f"tight@{mesh}"]
    for rank in world:
        got = rank["engines"][f"tight@{mesh}"]
        assert got["preemptions"] > 0
        assert got["pool"]["evictions"] > 0 and got["pool"]["restores"] > 0
        assert sorted(got["served"]) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got["served"][rid], want[rid])
        assert (got["steps"], got["pool"], got["elapsed_s"]) == (
            r0["steps"], r0["pool"], r0["elapsed_s"])


def test_the_reference_sharded_run_agrees(world, reference_sharded):
    """The reference's own sharded qwen3 run ((1, 4), the XDMA cache,
    GSPMD on 4 XLA CPU devices): the port's logits within 2e-5 of max|logit|
    of it at every step."""
    want = reference_sharded()
    for rank in world:
        got = rank["cases"]["qwen3_1p7b+xdma@1x4"]["logits"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert _err(g, w) <= BOUND * _scale(w)


@pytest.mark.parametrize("mesh", RC.SERVE_MESHES)
def test_a_mamba_state_whole_on_every_rank_steps_as_the_reference(
        inp, world, mesh):
    """A Mamba layer whose 3 SSM heads divide neither model axis while its
    96 inner channels do (``SERVE_MAMBA``): the fitted spec keeps the state
    ``h`` whole on every rank and splits ``conv`` by channels; the prefill
    (each rank's channels running as heads of ``gcd`` channels, its state
    gathered once) and every decode step (the state stepped whole from the
    gathered channels): each output, whole, within 2e-5 of its scale of
    the reference's ``mamba_apply`` with a cache, and each rank's final
    ``conv`` and ``h`` the matching blocks of the reference's."""
    rcfg = _mamba_cfg(RCF, jnp.float32)
    m = inp["mamba"]
    cache = RMB.init_mamba_cache(rcfg, B)
    want = []
    for x in [m["x"]] + list(m["steps"]):
        y, cache = RMB.mamba_apply(rcfg, m["p"], jnp.asarray(x), cache=cache)
        want.append(np.asarray(y))
    shape = SHAPES[mesh]
    pcfg = _mamba_cfg(PCF, torch.float32).with_axes(
        S.Axes(batch=("data",), model="model"))
    whole = PL._whole_cache(pcfg, B, MAX_LEN, torch.float32,
                            torch.device("meta"))
    specs = M.serving_cache_specs(pcfg, whole, M.MeshSpec(shape, ("data",
                                                                  "model")))
    spec = {k: sp[1:] for k, sp in specs["blocks"][1].items()}
    assert spec == {"conv": ("data", None, "model"), "h": ("data",)}
    ref = {k: torch.from_numpy(np.array(v)) for k, v in cache.items()}
    for r, rank in enumerate(world):
        got = rank["mamba"][mesh]
        for g, w in zip(got["y"], want):
            assert _err(g, w) <= BOUND * _scale(w), (_err(g, w), _scale(w))
        block = M.shard_tree(ref, spec, _rank_view(shape, r))
        for k in ("conv", "h"):
            assert got["cache"][k].shape == block[k].shape
            assert _err(got["cache"][k], block[k]) <= BOUND * _scale(
                block[k]), k


def test_init_cache_keeps_a_sequence_that_does_not_split_whole():
    """A sequence-split KV cache (KV 2 on a model axis of 4) whose max_len
    the axis does not divide: every rank holds the whole sequence, as the
    fitted spec says (the ``+uneven`` cases serve it against the
    reference); one that divides splits."""
    cfg = _axes_cfg(("qwen3_1p7b", ""))
    with S.axis_scope([S.MeshAxis("data", 1, 0), S.MeshAxis("model", 4, 0)]):
        whole = PL.init_cache(cfg, B, 30, torch.float32, device="meta")
        split = PL.init_cache(cfg, B, 32, torch.float32, device="meta")
    assert tuple(whole["blocks"][0]["k"].shape) == (2, B, 30, 2, 16)
    assert tuple(split["blocks"][0]["k"].shape) == (2, B, 8, 2, 16)


@pytest.mark.parametrize("slots, sl, want", [
    (None, 8, (16, 32, "model")), (32, 8, (16, 32, "model")),
    (30, 30, (0, 30, None)), (None, 30, ValueError), (30, 8, ValueError),
    (32, 32, ValueError)])
def test_seq_block_tells_a_split_cache_from_a_whole_one(slots, sl, want):
    """``attention.seq_block`` on rank 2 of a model axis of 4: a block the
    axis divides is a split cache without ``max_len``; a block it does not
    divide needs it (a whole cache of 30 slots and a block of 120 look
    alike); a leaf that is neither is refused."""
    from repro_torch.layers import attention as A
    ax = S.MeshAxis("model", 4, 2)
    if want is ValueError:
        with pytest.raises(ValueError):
            A.seq_block(sl, ax, slots)
    else:
        assert A.seq_block(sl, ax, slots) == want
