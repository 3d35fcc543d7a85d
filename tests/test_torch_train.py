"""The port's training substrate (``repro_torch.optim.adamw``,
``repro_torch.train.step``, the backward through ``repro_torch.layers.
attention`` and ``repro_torch.models.lm``) against the reference's.

The reference's ``tests/test_train.py`` runs on the port (loss falls, the
1-vs-4 microbatch equivalence, AdamW toward a minimum, the schedule's
shape, the data stream), each held to the reference on the same inputs;
gradients through ``chunked_attention`` and through the stacked period
leaves are held to ``jax.grad`` of the reference's functions in f32.
The loss-falls case runs in ``tests/test_torch_train_loss.py``.
"""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_model_cases as TC  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.data.pipeline import SyntheticLM as RSyn  # noqa: E402
from repro.layers import attention as RA  # noqa: E402
from repro.optim import adamw as RO  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch import _pytree  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShape  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM as PSyn  # noqa: E402
from repro_torch.layers import attention as PA  # noqa: E402
from repro_torch.optim import adamw as PO  # noqa: E402
from repro_torch.train import step as PS  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401


def _grad_close(got, want, what, rel=1e-3, floor=1e-6):
    """Per-leaf bound: rel * max|want| + floor (a leaf whose reference
    gradient is noise near zero needs the absolute floor)."""
    want = np.asarray(want, np.float32)
    got = np.zeros_like(want) if got is None else np.asarray(got, np.float32)
    tol = rel * float(np.abs(want).max()) + floor
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


# -- the repaired fault: autograd through chunked_attention -------------------
@pytest.mark.parametrize("window,q_offset", [(None, 0), (24, 0), (None, 16),
                                             (24, 16)])
def test_chunked_attention_backward_matches_reference(window, q_offset):
    """Gradients of q, k and v through the block-sparse chunked attention
    (causal; several q- and kv-chunks, so each q-chunk's running state is
    updated more than once) within 1e-5 x max|g| of ``jax.grad`` of the
    reference's; the forward bitwise as before the repair (one pass)."""
    rng = np.random.default_rng(3)
    B, Sq, H, KV, hd = 2, 32, 4, 2, 16
    Sk = Sq + q_offset
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    w = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    kw = dict(causal=True, window=window, q_offset=q_offset, q_chunk=8,
              kv_chunk=16)

    def ref_loss(q, k, v):
        return jnp.sum(RA.chunked_attention(q, k, v, **kw) * w)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(jnp.asarray(q),
                                                 jnp.asarray(k),
                                                 jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = PA.chunked_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        _grad_close(got.numpy(), ref, f"d{name}", rel=1e-5, floor=0.0)
    with torch.no_grad():
        again = PA.chunked_attention(tq, tk, tv, **kw)
    assert torch.equal(out.detach(), again)


def test_stacked_period_leaf_gradients_match_reference():
    """The stacked (n_periods, ...) leaves, unbound once per forward: their
    gradients (both periods of the qwen3 smoke model, f32) within 1e-3 x
    max|g| of the reference's, the same with and without block remat (the
    recompute is bitwise the first pass on the CPU)."""
    rcfg, pcfg = TC.configs("qwen3_1p7b", dtype=TC.F32)
    rp, pp = TC.params(rcfg)
    b = TC.batch(rcfg, B=2, S=16)
    b["labels"] = np.random.default_rng(5).integers(
        0, rcfg.vocab, (2, 16)).astype(np.int32)
    rb, pb = TC.inputs(b, rcfg, pcfg)
    want = jax.grad(lambda p: RS.loss_fn(rcfg, p, rb)[0])(rp)
    _, _, got = PS._value_and_grad(pcfg, pp, pb)
    flat = _pytree.flatten_with_paths(pp)
    stacked = 0
    for (path, leaf), g, r in zip(flat, got, jax.tree.leaves(want)):
        if path[0][1] == "blocks":
            assert tuple(g.shape) == tuple(leaf.shape)
            stacked += 1
        _grad_close(g, r, _pytree.path_key(path))
    assert stacked >= 8
    _, _, plain = PS._value_and_grad(
        dataclasses.replace(pcfg, remat="none"), pp, pb)
    for a, c in zip(got, plain):
        assert torch.equal(a, c)


def test_forward_is_unchanged_under_autograd():
    """lm.forward with gradients on (block remat) returns the same logits,
    bitwise, as the inference forward."""
    _, pcfg = TC.configs("gemma3_27b", dtype=TC.F32)
    params = TC.PL.init_params(pcfg, 0, device="cpu")
    tokens = torch.from_numpy(TC.batch(pcfg)["tokens"])
    with torch.no_grad():
        want, _ = TC.PL.forward(pcfg, params, {"tokens": tokens})
    live = _pytree.tree_map_with_path(
        lambda _, p: p.detach().requires_grad_(), params)
    got, _ = TC.PL.forward(pcfg, live, {"tokens": tokens})
    assert got.requires_grad and torch.equal(got.detach(), want)


# -- tests/test_train.py on the port ----------------------------------------


def test_bf16_step_keeps_f32_masters():
    """The bf16 qwen3 smoke model trains f32 master parameters, as the
    reference does: ``init_state``'s floating leaves are f32, and one step
    at lr(1) = 3e-6 (below half a bf16 step of most weights) matches the
    reference's jitted step within 2 lr(1) + 1e-5 |p|, the loss within bf16
    rounding.  The same step stored in bf16 would be outside that bound."""
    rcfg, pcfg = TC.configs("qwen3_1p7b")
    assert pcfg.dtype == torch.bfloat16
    own = PS.init_state(pcfg, 0, device="cpu")
    assert {p.dtype for p in _pytree.leaves(own["params"])} == {torch.float32}
    raw = RSyn(vocab=rcfg.vocab, seq_len=16, global_batch=4,
               seed=2).batch_at(0)
    rstate = RS.init_state(jax.random.PRNGKey(0), rcfg)
    state = TC.PL.params_from_numpy(jax.tree.map(np.asarray, rstate),
                                    device="cpu")
    shape = ("t", 16, 4, "train")
    new, m = PS.make_train_step(pcfg, PShape(*shape))(
        state, {k: torch.from_numpy(v) for k, v in raw.items()})
    rnew, rm = jax.jit(RS.make_train_step(rcfg, RShape(*shape)))(
        rstate, {k: jnp.asarray(v) for k, v in raw.items()})
    assert abs(float(m["loss"]) - float(rm["loss"])) \
        <= 2.5e-2 * abs(float(rm["loss"]))
    lr1 = float(PO.cosine_schedule(PO.AdamWConfig(), 1))
    rounded_out = 0
    for a, r in zip(_pytree.leaves(new["params"]),
                    jax.tree.leaves(rnew["params"])):
        assert a.dtype == torch.float32
        r = torch.from_numpy(np.array(r))
        bound = 2 * lr1 + 1e-5 * r.abs()
        assert ((a - r).abs() <= bound).all()
        rounded_out += int(((a.to(torch.bfloat16).float() - r).abs()
                            > bound).sum())
    assert rounded_out > 0


def test_grad_accum_equivalence():
    """microbatches=4 matches microbatches=1 on the same data within the
    reference's bounds (loss 1e-3, parameters 5e-3), and each matches the
    reference's jitted step with the same microbatches (loss within 1e-5
    relative, parameters within 2 lr(1) + 1e-5 |p|)."""
    rcfg, pcfg = TC.configs("qwen2_0p5b", dtype=TC.F32)
    ds = RSyn(vocab=rcfg.vocab, seq_len=16, global_batch=8, seed=1)
    raw = ds.batch_at(0)
    rstate = RS.init_state(jax.random.PRNGKey(0), rcfg)
    lr1 = float(PO.cosine_schedule(PO.AdamWConfig(), 1))
    outs = {}
    for n_micro in (1, 4):
        state = TC.PL.params_from_numpy(jax.tree.map(np.asarray, rstate),
                                        device="cpu")
        new, m = PS.make_train_step(pcfg, PShape("t", 16, 8, "train",
                                                 n_micro))(
            state, {k: torch.from_numpy(v) for k, v in raw.items()})
        outs[n_micro] = (new, float(m["loss"]))
        rnew, rm = jax.jit(RS.make_train_step(
            rcfg, RShape("t", 16, 8, "train", n_micro)))(
            rstate, {k: jnp.asarray(v) for k, v in raw.items()})
        assert abs(float(m["loss"]) - float(rm["loss"])) \
            <= 1e-5 * abs(float(rm["loss"]))
        for a, r in zip(_pytree.leaves(new["params"]),
                        jax.tree.leaves(rnew["params"])):
            r = np.asarray(r)
            assert (np.abs(a.numpy() - r) <= 2 * lr1 + 1e-5 * np.abs(r)).all()
    l1, l4 = outs[1][1], outs[4][1]
    assert abs(l1 - l4) < 1e-3, (l1, l4)
    p1 = _pytree.leaves(outs[1][0]["params"])
    p4 = _pytree.leaves(outs[4][0]["params"])
    worst = max(float((a - b).abs().max()) for a, b in zip(p1, p4))
    assert worst < 5e-3, worst


def test_adamw_moves_toward_minimum():
    """200 AdamW steps on w^2 from the same start: |w| < 0.3 (the
    reference's bound), and every step's parameters within 1e-6 of the
    reference's."""
    cfg_kw = dict(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=1000,
                  clip_norm=10.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = PO.adamw_init(params)
    rparams = {"w": jnp.asarray([5.0, -3.0])}
    ropt = RO.adamw_init(rparams)
    for _ in range(200):
        params, opt, _ = PO.adamw_update(PO.AdamWConfig(**cfg_kw), params,
                                         {"w": 2 * params["w"]}, opt)
        rparams, ropt, _ = RO.adamw_update(RO.AdamWConfig(**cfg_kw), rparams,
                                           {"w": 2 * rparams["w"]}, ropt)
        np.testing.assert_allclose(params["w"].numpy(),
                                   np.asarray(rparams["w"]), atol=1e-6)
    assert float(params["w"].abs().max()) < 0.3
    assert int(opt["count"]) == 200 and opt["mu"]["w"].dtype == torch.float32


def test_cosine_schedule_shape():
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    steps = (0, 5, 10, 55, 100)
    lrs = [float(PO.cosine_schedule(PO.AdamWConfig(**kw), torch.tensor(s)))
           for s in steps]
    ref = [float(RO.cosine_schedule(RO.AdamWConfig(**kw), jnp.asarray(s)))
           for s in steps]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 0.5) < 1e-6          # mid-warmup
    assert abs(lrs[2] - 1.0) < 1e-6          # peak
    assert lrs[3] < lrs[2]
    assert abs(lrs[4] - 0.1) < 1e-6          # floor
    np.testing.assert_allclose(lrs, ref, rtol=1e-6, atol=0)


def test_data_pipeline_determinism_and_sharding():
    ds = PSyn(vocab=100, seq_len=8, global_batch=8, seed=3)
    a, b = ds.batch_at(7), ds.batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    ref = RSyn(vocab=100, seq_len=8, global_batch=8, seed=3).batch_at(7)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k], ref[k])
    h0 = PSyn(vocab=100, seq_len=8, global_batch=8, seed=3, host_id=0,
              n_hosts=2)
    h1 = PSyn(vocab=100, seq_len=8, global_batch=8, seed=3, host_id=1,
              n_hosts=2)
    b0, b1 = h0.batch_at(7), h1.batch_at(7)
    assert b0["tokens"].shape == (4, 8) and b1["tokens"].shape == (4, 8)
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    # labels are next-token shifted
    same = a["tokens"][:, 1:] == a["labels"][:, :-1]
    assert np.array_equal(a["labels"][:, :-1][same], a["tokens"][:, 1:][same])


# -- the optimizer's edges ---------------------------------------------------
def test_adamw_update_matches_reference_on_a_mixed_tree():
    """A tree of matrices (decayed), vectors (not) and a leaf with no
    gradient (``None``, zeros to ``jax.grad``: its weight still decays), at
    a clip that binds: parameters, moments, lr and grad norm within f32
    rounding of the reference's over three steps."""
    rng = np.random.default_rng(11)
    shapes = {"a": (8, 16), "b": (16,), "c": (2, 4, 8), "u": (4, 4)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    cfg_kw = dict(lr=1e-2, clip_norm=0.5, warmup_steps=2, total_steps=10)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    rparams = {k: jnp.asarray(v) for k, v in p0.items()}
    opt, ropt = PO.adamw_init(params), RO.adamw_init(rparams)
    for i in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        g["u"] = np.zeros(shapes["u"], np.float32)
        pg = {k: torch.from_numpy(v) for k, v in g.items()}
        pg["u"] = None
        params, opt, m = PO.adamw_update(PO.AdamWConfig(**cfg_kw), params,
                                         pg, opt)
        rparams, ropt, rm = RO.adamw_update(
            RO.AdamWConfig(**cfg_kw), rparams,
            {k: jnp.asarray(v) for k, v in g.items()}, ropt)
        for k in shapes:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(rparams[k]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(opt["nu"][k].numpy(),
                                       np.asarray(ropt["nu"][k]), rtol=1e-5,
                                       atol=1e-9)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
    assert not np.array_equal(params["u"].numpy(), p0["u"])   # decayed
