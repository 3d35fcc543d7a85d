"""The production mesh's last regimes against the reference: a batch over
two mesh axes and the context-parallel decode cache.

* Every config's fitted parameter, train-state, cache and batch specs on
  both production meshes, (16, 16) ("data", "model") and (2, 16, 16)
  ("pod", "data", "model"), for every input shape, equal the reference's
  (its ``axes_for`` and ``fit_specs`` fed a mesh stub, no 512 devices).
* One (2, 2, 1) ("pod", "data", "model") gloo world on the CPU
  (``tests/torch_remote_cases.py::regime_body``) runs:
  - the sharded f32 step, the batch and FSDP over the pair ("pod",
    "data"): 2 steps of 2 microbatches against the reference's jitted
    single-process step (``tests/test_torch_tp.py``'s f32 bounds: the loss
    within 1e-5, the gradient norm within 1e-5 relative, the gathered
    parameters and Adam moments within 1e-4);
  - prefill and decode with the batch over the pair;
  - on a (2, 2) ("data", "model") view of the same ranks, with
    ``seq="data"``, context-parallel decode in both ``kv_cache_spec``
    regimes: KV heads that divide the model axis (each rank's heads split
    by sequence over "data") and KV heads that do not (the sequence over
    the pair), the XDMA layouts, a ragged ``cache_pos``, gemma3's rolled
    window cache, and a slot count the pair does not divide (whole on
    every rank).  The serving bounds of ``tests/test_torch_serve_sharded
    .py``: logits within 2e-5 of max|logit| of the reference's unsharded
    jitted run, every rank's cache leaf within 2e-5 of its block's scale;
  - ``ContinuousBatchingEngine(mesh=)`` on the same context-parallel
    caches (ROADMAP §1 item 10e), requests arriving staggered on a pool
    that evicts and restores: every request's tokens those of the port's
    single-process engine and of the reference's unsharded engine on the
    same seeded stream, its logits within twice the gap one ulp on every
    weight opens in the single-process engine's.
"""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402
import functools  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_remote_cases as RC  # noqa: E402
from repro import configs as RCF  # noqa: E402
from repro.configs import specs as RSP  # noqa: E402
from repro.configs.base import SHAPES as RSHAPES  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.launch import mesh as RMM  # noqa: E402
from repro.layers import attention as RA  # noqa: E402
from repro import serving as RSV  # noqa: E402
from repro.models import lm as RL  # noqa: E402
from repro.optim import adamw as ROpt  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch import _pytree  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.configs import specs as SP  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import lm as PL  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 ServingEngine, trace_stream)
from torch_parity import reset_global_state  # noqa: E402,F401

BOUND = 2e-5                    # x max|logit|, x each cache leaf's scale
ALIASES = sorted(configs._ALIASES)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SEQ, BATCH = RC.REGIME_SHAPE["seq"], RC.REGIME_SHAPE["batch"]
MICRO = RC.REGIME_SHAPE["microbatches"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _canon(p):
    t = tuple(p)
    while t and t[-1] is None:
        t = t[:-1]
    return t


def _ref_leaves(tree):
    """The reference's spec tree's leaves as the port's tuples."""
    from jax.sharding import PartitionSpec as P
    return [_canon(p) for p in
            jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))]


def _scale(a):
    return float(np.abs(np.asarray(a, np.float64)).max())


def _err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


def _close(got, want, tol, what):
    assert _err(got, want) <= tol, (what, _err(got, want), tol)


# -- the specs, on both production meshes --------------------------------------
@pytest.mark.parametrize("arch", ALIASES)
def test_fitted_specs_match_the_reference_on_both_production_meshes(arch):
    """For each input shape and production mesh: the axis roles, the
    fitted train-state specs (FSDP and ZeRO over the batch axes, a pair on
    the two-pod mesh), the fitted serving parameter specs, the fitted
    cache specs (the context-parallel ``seq`` axis and its ``(seq,
    model)`` pair for ``long_500k``) and the fitted batch and decode-token
    specs equal the reference's, as tuples."""
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    rcfg = RCF.get_config(arch)
    rstate = jax.eval_shape(lambda k: RS.init_state(k, rcfg), key)
    rparams = jax.eval_shape(lambda k: RL.init_params(k, rcfg), key)
    for mname, (shape_, names) in MESHES.items():
        stub = types.SimpleNamespace(axis_names=names,
                                     shape=dict(zip(names, shape_)))
        mesh = M.MeshSpec(shape_, names)
        for sname, shape in SHAPES.items():
            where = (arch, mname, sname)
            rax = RMM.axes_for(stub, RSHAPES[sname])
            cfg = DR.cell_config(arch, shape, mesh)
            ax = cfg.axes
            assert (ax.batch, ax.model, ax.seq, ax.model_size,
                    ax.batch_size) == (rax.batch, rax.model, rax.seq,
                                       rax.model_size, rax.batch_size), where
            if shape.kind == "train":
                specs, shapes = M.state_specs(cfg, mesh)
                want = RMM.fit_specs(stub, RMM.infer_state_specs(rstate, rax),
                                     rstate)
                assert M.spec_leaves(specs, shapes) == _ref_leaves(want), where
            else:
                specs, shapes = M.serving_specs(cfg, mesh)
                want = RMM.fit_specs(stub, RMM.infer_param_specs(rparams, rax),
                                     rparams)
                assert M.spec_leaves(specs, shapes) == _ref_leaves(want), where
                rcache = jax.eval_shape(lambda: RL.init_cache(
                    rcfg, shape.global_batch, shape.seq_len))
                cache = PL._whole_cache(cfg, shape.global_batch,
                                        shape.seq_len, torch.bfloat16,
                                        torch.device("meta"))
                got = M.serving_cache_specs(cfg, cache, mesh)
                want = RMM.fit_specs(stub, RMM.cache_specs(rcfg, rcache, rax),
                                     rcache)
                assert M.spec_leaves(got, cache) == _ref_leaves(want), where
            rb = RSP.batch_specs(rcfg, RSHAPES[sname])
            b = SP.batch_specs(cfg, shape)
            got = M.fit_specs(mesh, M.batch_input_specs(b, ax), b)
            want = RMM.fit_specs(stub, RMM.batch_input_specs(rb, rax), rb)
            assert [got[k] for k in sorted(got)] == _ref_leaves(want), where
            if shape.kind == "decode":
                rt = RSP.decode_token_specs(rcfg, RSHAPES[sname])
                t = SP.decode_token_specs(cfg, shape)
                got = M.fit_specs(mesh, M.batch_input_specs(t, ax), t)
                want = RMM.fit_specs(stub, RMM.batch_input_specs(rt, rax), rt)
                assert [got[k] for k in sorted(got)] == _ref_leaves(want), \
                    where


def test_the_production_regimes_are_the_reference_launchers():
    """The cells this slice opens: ``train_4k`` and ``prefill_32k`` batch
    over ("pod", "data") on the two-pod mesh and FSDP shards over the
    pair; ``long_500k`` splits gemma3's KV sequence over "data" (its 16
    KV heads take "model") and a KV count that does not divide 16 over
    ("data", "model")."""
    mesh = M.MeshSpec(*MESHES["2x16x16"])
    cfg = DR.cell_config("qwen3-1.7b", SHAPES["train_4k"], mesh)
    assert cfg.axes.batch == ("pod", "data") and cfg.fsdp
    specs, _ = M.state_specs(cfg, mesh)
    assert specs["params"]["blocks"][0]["attn"]["wq"] == (
        None, ("pod", "data"), "model")
    one = M.MeshSpec(*MESHES["16x16"])
    for arch, n_kv in (("gemma3-27b", None), ("gemma3-27b", 8)):
        base = configs.get_config(arch)
        if n_kv:
            base = dataclasses.replace(base, n_kv_heads=n_kv)
        cfg = DR.cell_config(base, SHAPES["long_500k"], one)
        assert cfg.axes.seq == "data" and cfg.axes.batch == ()
        cache = PL._whole_cache(cfg, 1, 1 << 19, torch.bfloat16,
                                torch.device("meta"))
        k = M.serving_cache_specs(cfg, cache, one)["blocks"][-1]["k"]
        assert k == ((None, None, "data", "model") if n_kv is None
                     else (None, None, ("data", "model"))), (n_kv, k)


# -- one (2, 2, 1) world --------------------------------------------------------
def _reference_decode(rcfg, params, b, steps, ragged, max_len):
    """The reference's jitted, unsharded prefill and decode steps: every
    step's logits and the final cache (numpy)."""
    pre = jax.jit(functools.partial(RL.prefill, rcfg))
    dec = jax.jit(functools.partial(RL.decode_step, rcfg))
    B = b["tokens"].shape[0]
    logits, cache = pre(params, {k: jnp.asarray(v) for k, v in b.items()},
                        RL.init_cache(rcfg, B, max_len, jnp.float32))
    out = [np.asarray(logits)]
    if ragged is not None:
        cache = dict(cache, pos=jnp.asarray(ragged, jnp.int32))
    for t in steps:
        logits, cache = dec(params, jnp.asarray(t), cache)
        out.append(np.asarray(logits))
    return out, jax.tree.map(np.asarray, cache)


@pytest.fixture(scope="module")
def case():
    """The world's inputs (the reference's state, batches and weights
    through numpy) and the reference's runs."""
    inp, ref = {}, {}
    cfg = RC.tp_step_config(RCF, dataclasses, jnp.float32)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                     seed=1)
    inp["batches"] = [ds.batch_at(i) for i in range(2)]
    state = RS.init_state(jax.random.PRNGKey(0), cfg)
    inp["state"] = _np(state)
    step = jax.jit(RS.make_train_step(
        cfg, RShape("t", SEQ, BATCH, "train", MICRO),
        RC.tp_opt_config(ROpt.AdamWConfig, "f32")))
    losses, norms = [], []
    for b in inp["batches"]:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    ref["step"] = {"losses": losses, "grad_norms": norms,
                   "params": jax.tree.leaves(state["params"]),
                   "mu": jax.tree.leaves(state["opt"]["mu"]),
                   "nu": jax.tree.leaves(state["opt"]["nu"])}

    R = RC.REGIME_SERVE
    rcfg = dataclasses.replace(RCF.smoke_config(R["arch"]), dtype=jnp.float32)
    params = _np(RL.init_params(jax.random.PRNGKey(3), rcfg))
    rng = np.random.default_rng(3)
    b = {"tokens": rng.integers(0, rcfg.vocab, (R["B"], R["S"])).astype(
        np.int32)}
    steps = rng.integers(0, rcfg.vocab, (R["steps"], R["B"], 1)).astype(
        np.int32)
    inp["pod_serve"] = {"params": params, "inputs": (b, steps)}
    ref["pod_serve"] = _reference_decode(rcfg, params, b, steps, None,
                                         R["max_len"])
    rcfg = RC.uneven_config(RCF, dataclasses, jnp.float32)
    U = RC.UNEVEN
    rng = np.random.default_rng(21)
    p = _np(RA.init_attn(jax.random.PRNGKey(21), rcfg))
    u = {"p": p, "x": rng.standard_normal(
        (U["B"], U["S"], rcfg.d_model)).astype(np.float32),
        "kv": rng.standard_normal((U["B"], U["Sk"], rcfg.d_model)).astype(
            np.float32),
        "dy": rng.standard_normal((U["B"], U["S"], rcfg.d_model)).astype(
            np.float32),
        "pos": np.broadcast_to(np.arange(U["S"])[None],
                               (U["B"], U["S"])).astype(np.int32).copy()}
    inp["uneven"], ref["uneven"] = u, {}
    for name in ("self", "cross"):
        def fn(p, x, kv, name=name):
            return RA.attn_apply(rcfg, p, x, jnp.asarray(u["pos"]),
                                 kv_x=kv if name == "cross" else None,
                                 apply_rope=name == "self")[0]
        y, vjp = jax.vjp(fn, p, u["x"], u["kv"])
        gp, gx, gkv = vjp(jnp.asarray(u["dy"]))
        ref["uneven"][name] = {"y": y, "dx": gx, "dkv": gkv,
                               "grads": jax.tree.leaves(gp)}
    inp["cp"], ref["cp"] = {}, {}
    for i, (name, (_, _, ragged, L)) in enumerate(RC.CP_CASES.items()):
        rcfg = RC.cp_config(RCF, dataclasses, jnp.float32, name)
        params = _np(RL.init_params(jax.random.PRNGKey(10 + i), rcfg))
        b, steps = RC.cp_inputs(rcfg, 10 + i)
        inp["cp"][name] = {"params": params, "inputs": (b, steps)}
        ref["cp"][name] = _reference_decode(
            rcfg, params, b, steps, RC.CP_RAGGED if ragged else None, L)
    return inp, ref


@pytest.fixture(scope="module")
def world(case, tmp_path_factory):
    inp, _ = case
    return S.run_spmd(RC.regime_body, *RC.REGIME_WORLD, device="cpu",
                      args=(inp,),
                      workdir=str(tmp_path_factory.mktemp("regime_world")))


def test_multi_pod_f32_step_matches_the_reference_step(case, world):
    """The batch over ("pod", "data") and FSDP over the pair: 2 steps of 2
    microbatches with no warmup, the loss within 1e-5, the gradient norm
    within 1e-5 relative, the gathered parameters and Adam moments within
    1e-4 of the reference's jitted single-process step; every rank's
    gathered state the same."""
    _, ref = case
    want = ref["step"]
    for rank in world:
        got = rank["step"]
        assert got["axes"] == ("pod", "data")
        assert got["fsdp"] == [str(("pod", "data"))]
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
    for other in world[1:]:
        for key in ("params", "mu", "nu"):
            for a, b in zip(world[0]["step"][key], other["step"][key]):
                assert torch.equal(a, b)


def test_the_multi_pod_step_reduces_over_the_pair(world):
    """The step's collectives name the pair's group: the FSDP gathers and
    the gradients' reduce-scatters over "pod+data", nothing over a single
    batch axis."""
    led = world[0]["ledger"]
    for op in ("all_gather:pod+data", "reduce_scatter:pod+data",
               "all_reduce:pod+data"):
        assert led.get(f"calls:{op}", 0) > 0, (op, led)
    assert not any(k.endswith((":pod", ":data")) for k in led), led


def _rank_view(shape, names, rank):
    """A rank's coordinates on a mesh (row-major), for ``shard_tree``."""
    idx, r = {}, rank
    for n, s in reversed(list(zip(names, shape))):
        idx[n] = r % s
        r //= s
    return S.Mesh(shape, names, rank, torch.device("cpu"), "gloo", "",
                  {n: S.MeshAxis(n, s, idx[n])
                   for n, s in zip(names, shape)})


def _check_serving(got_ranks, want, shape, names):
    logits, cache = want
    ref = PL.params_from_numpy(cache, device="cpu")
    keys = [_pytree.path_key(p) for p, _ in _pytree.flatten_with_paths(ref)]
    for r, got in enumerate(got_ranks):
        assert len(got["logits"]) == len(logits)
        for i, (g, w) in enumerate(zip(got["logits"], logits)):
            assert tuple(g.shape) == w.shape
            assert _err(g, w) <= BOUND * _scale(w), (r, i, _err(g, w),
                                                     _scale(w))
        blocks = _pytree.leaves(M.shard_tree(
            ref, _pytree.unflatten(ref, got["specs"]),
            _rank_view(shape, names, r)))
        assert len(got["cache"]) == len(blocks)
        for key, g, w in zip(keys, got["cache"], blocks):
            assert g.shape == w.shape, (r, key, g.shape, w.shape)
            if key.endswith(("pos", "len")):
                assert torch.equal(g, w), key
            else:
                assert _err(g, w) <= BOUND * max(_scale(w), 1e-30), (
                    r, key, _err(g, w), _scale(w))


def test_multi_pod_serving_matches_the_reference(case, world):
    """Prefill and 3 decode steps with the batch over ("pod", "data") (one
    row a rank): whole logits on every rank within 2e-5 of max|logit| of
    the reference's unsharded run, and every rank's cache its block of the
    reference's."""
    _, ref = case
    _check_serving([rank["pod_serve"] for rank in world], ref["pod_serve"],
                   *RC.REGIME_WORLD)
    assert world[0]["pod_serve"]["specs"][0] == (None, ("pod", "data"),
                                                 None, "model")


@pytest.mark.parametrize("name", list(RC.CP_CASES))
def test_context_parallel_decode_matches_the_reference(case, world, name):
    """Context-parallel decode on the (2, 2) view: whole logits on every
    rank within 2e-5 of max|logit| of the reference's unsharded run, every
    rank's cache its block of the reference's by the fitted spec (each
    rank's KV heads split by sequence over "data", or the sequence over
    ("data", "model"), or whole where the pair does not divide it)."""
    _, ref = case
    _check_serving([rank["cp"][name] for rank in world], ref["cp"][name],
                   (2, 2), ("data", "model"))
    arch, kw, _, L = RC.CP_CASES[name]
    k_spec = world[0]["cp"][name]["specs"][0]
    xdma = kw.get("xdma_cache", False)
    seq = k_spec[4 if xdma else 2] if len(k_spec) > (4 if xdma else 2) \
        else None
    if L % 4:
        want = None
    elif name.startswith("heads"):
        want = "data"
    else:
        want = ("data", "model")
    assert seq == want, (name, k_spec)


@pytest.mark.parametrize("name", RC.CP_ENGINE)
def test_serving_engine_on_a_context_parallel_cache(case, world, name):
    """``ServingEngine(mesh=)`` on the context-parallel cache (each rank's
    blocks through the KV plane): every rank's greedy tokens equal the
    single-process port engine's on the same weights and prompts."""
    inp, _ = case
    cfg = RC.cp_config(configs, dataclasses, torch.float32, name)
    b, _ = inp["cp"][name]["inputs"]
    params = PL.params_from_numpy(inp["cp"][name]["params"], device="cpu")
    want = ServingEngine(cfg, params, RC.CP_CASES[name][3],
                         cache_dtype=torch.float32, device="cpu").generate(
        {k: torch.from_numpy(v) for k, v in b.items()}, RC.CP["steps"])
    for rank in world:
        assert torch.equal(rank["cp_engine"][name], want), name


@pytest.mark.parametrize("name", ["self", "cross"])
def test_sequence_parallel_attention_over_rows_the_axis_does_not_divide(
        case, world, name):
    """3 heads on a model axis of 2 (the sequence-parallel regime) over 15
    query rows: each rank a block of 8, the last padded, the padding
    dropped. The output, the input gradients and every weight's gradient
    (gathered whole) within 1e-5 of their scale of the reference's
    unsharded ``jax.vjp``, in every rank (whisper's 1500 encoder frames
    on a model axis of 16 take this path)."""
    _, ref = case
    want = ref["uneven"][name]
    for rank in world:
        got = rank["uneven"][name]
        _close(got["y"], want["y"], 1e-5 * _scale(want["y"]), "output")
        _close(got["dx"], want["dx"], 1e-5 * _scale(want["dx"]), "dx")
        if name == "cross":
            _close(got["dkv"], want["dkv"], 1e-5 * _scale(want["dkv"]),
                   "dkv_x")
        assert len(got["grads"]) == len(want["grads"])
        for g, w in zip(got["grads"], want["grads"]):
            _close(g, w, 1e-5 * _scale(w) + 1e-7, "weight gradient")


# -- continuous batching on the context-parallel cache -------------------------
def _one_ulp(tree, seed):
    """Every float weight of a numpy tree one ulp up or down, by a seeded
    coin an element: how far rounding alone moves a run."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x)
        if x.dtype != np.float32:
            return x
        up = rng.random(x.shape) < 0.5
        return np.where(up, np.nextafter(x, np.float32(np.inf)),
                        np.nextafter(x, np.float32(-np.inf))).astype(
                            np.float32)
    return jax.tree.map(move, tree)


def _single_engine(cfg, params, L, keep_logits=True):
    return ContinuousBatchingEngine(
        cfg, params, L, cache_dtype=torch.float32, capacity_pages=512,
        device="cpu", keep_logits=keep_logits, **RC.CP_CB_ENGINE)


@pytest.fixture(scope="module")
def cb_single(case):
    """Each ``CP_CB`` case unsharded on a pool that evicts nothing: the
    reference's engine's tokens, the port's single-process engine's tokens
    and logits, and the gap one ulp on every weight opens in the port's
    logits (the same stream, its tokens fed back as they come)."""
    inp, _ = case
    out = {}
    for name, (cp, L, _) in RC.CP_CB.items():
        params = inp["cp"][cp]["params"]
        rcfg = RC.cp_config(RCF, dataclasses, jnp.float32, cp)
        ref = RSV.ContinuousBatchingEngine(
            rcfg, jax.tree.map(jnp.asarray, params), L,
            cache_dtype=jnp.float32, capacity_pages=512,
            **RC.CP_CB_ENGINE).serve(
                RSV.trace_stream(rcfg, RC.CP_CB_STREAM, seed=4))
        cfg = RC.cp_config(configs, dataclasses, torch.float32, cp)
        rep = _single_engine(cfg, PL.params_from_numpy(params, "cpu"),
                             L).serve(trace_stream(cfg, RC.CP_CB_STREAM,
                                                   seed=4))
        moved = _single_engine(cfg, PL.params_from_numpy(
            _one_ulp(params, 11), "cpu"), L).serve(
                trace_stream(cfg, RC.CP_CB_STREAM, seed=4))
        gap = 0.0
        for rid, lg in rep.logits.items():
            # up to the first token the moved weights pick otherwise
            diff = np.nonzero(moved.tokens[rid] != rep.tokens[rid])[0]
            n = int(diff[0]) + 1 if len(diff) else len(lg)
            gap = max(gap, _err(moved.logits[rid][:n], lg[:n]))
        out[name] = {"reference": ref.tokens, "tokens": rep.tokens,
                     "logits": rep.logits, "gap": gap}
    return out


@pytest.mark.parametrize("name", list(RC.CP_CB))
def test_continuous_engine_on_a_context_parallel_cache(case, world,
                                                       cb_single, name):
    """``ContinuousBatchingEngine(mesh=)`` on the (2, 2) view with
    ``seq="data"``: KV sequences over "data" alone, over the pair, whole
    on every rank where the pair does not divide max_len, and gemma3's
    XDMA cache with its rolled window.  Requests arrive staggered (ragged
    positions in a decode) onto a pool that evicts and restores the
    youngest on every rank.  Every rank serves every request the tokens
    of the port's single-process engine and of the reference's unsharded
    engine on the same stream, its logits within twice the one-ulp gap of
    the single-process engine's, and every rank makes the same decisions
    (steps, pool traffic, the simulated clock)."""
    want = cb_single[name]
    bound = 2 * want["gap"]
    assert bound > 0
    r0 = world[0]["cp_cb"][name]
    for r, rank in enumerate(world):
        got = rank["cp_cb"][name]
        assert got["preemptions"] > 0, (r, got["pool"])
        assert got["pool"]["evictions"] > 0 and \
            got["pool"]["restores"] > 0, (r, got["pool"])
        assert (got["steps"], got["pool"], got["elapsed_s"]) == (
            r0["steps"], r0["pool"], r0["elapsed_s"]), r
        assert sorted(got["tokens"]) == sorted(want["tokens"]) == \
            sorted(want["reference"]) == list(range(len(RC.CP_CB_STREAM)))
        for rid, toks in want["tokens"].items():
            np.testing.assert_array_equal(got["tokens"][rid], toks)
            np.testing.assert_array_equal(want["reference"][rid], toks)
            err = _err(got["logits"][rid], want["logits"][rid])
            assert err <= bound, (r, rid, err, want["gap"])
