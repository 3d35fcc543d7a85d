"""Parity of the port's models (``repro_torch.configs``, ``layers``,
``models.lm``) with the reference's.

The reference's ``init_params`` output crosses to the port through numpy;
the same seeded numpy batches go through the reference's jitted ``forward``
/ ``prefill`` / ``decode_step`` and the port's.  Logits are held within a
tolerance scaled by max|logit| (``torch_model_cases.logit_tol``: f32 1e-5,
bf16 2.5e-2).  The reference's own model tests (``tests/test_models.py``
decode against forward, the sliding window, M-RoPE; ``tests/test_ssm_blocks.py``;
``tests/test_xdma_integration.py`` the layout-optimal cache) run on the
port with their tolerances, the MoE archs among them (f32: the routing
of a bf16 run may pick another expert where two are within a rounding).
The prefill and decode cases run in ``tests/test_torch_models_decode.py``.
"""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_model_cases as TC  # noqa: E402
from repro.layers import mamba as RM  # noqa: E402
from repro.layers import rope as RR  # noqa: E402
from repro.layers import xlstm as RX  # noqa: E402
from repro.models import lm as RL  # noqa: E402
from repro_torch import _pytree  # noqa: E402
from repro_torch.configs.base import ATTN, LayerSpec  # noqa: E402
from repro_torch.layers import mamba as PM  # noqa: E402
from repro_torch.layers import rope as PR  # noqa: E402
from repro_torch.layers import xlstm as PX  # noqa: E402
from repro_torch.layers._init import Init  # noqa: E402
from repro_torch.models import lm as PL  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401

_JIT = {}


def _ref(fn_name, rcfg):
    """The reference's jitted ``forward`` / ``prefill`` / ``decode_step``."""
    key = (fn_name, rcfg)
    if key not in _JIT:
        fn = getattr(RL, fn_name)
        _JIT[key] = jax.jit(lambda *a: fn(rcfg, *a))
    return _JIT[key]


# -- forward, every ported arch, f32 and bf16 ---------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", TC.DENSE_ARCHS)
def test_forward_matches_reference(arch, dtype):
    kw = {"dtype": TC.F32} if dtype == "float32" else {}
    rcfg, pcfg = TC.configs(arch, **kw)
    rp, pp = TC.params(rcfg)
    rb, pb = TC.inputs(TC.batch(rcfg), rcfg, pcfg)
    want, _ = _ref("forward", rcfg)(rp, rb)
    got, aux = PL.forward(pcfg, pp, pb)
    assert tuple(got.shape) == tuple(want.shape) == (2, 16, pcfg.vocab)
    assert got.dtype == pcfg.dtype and float(aux) == 0.0
    want = TC.f32(want)
    tol = TC.logit_tol(pcfg.dtype, np.abs(want).max())
    assert np.abs(TC.f32(got) - want).max() <= tol


@pytest.mark.parametrize("arch", TC.MOE_ARCHS)
def test_moe_forward_matches_reference(arch):
    """The MoE archs in f32: logits within 1e-5 of max|logit|, the summed
    load-balance loss within 1e-5 of itself."""
    rcfg, pcfg = TC.configs(arch, dtype=TC.F32)
    rp, pp = TC.params(rcfg)
    rb, pb = TC.inputs(TC.batch(rcfg), rcfg, pcfg)
    want, want_aux = _ref("forward", rcfg)(rp, rb)
    got, aux = PL.forward(pcfg, pp, pb)
    assert tuple(got.shape) == tuple(want.shape) == (2, 16, pcfg.vocab)
    want = TC.f32(want)
    assert np.abs(TC.f32(got) - want).max() <= TC.logit_tol(
        pcfg.dtype, np.abs(want).max())
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))
    assert float(aux) > 0


# -- prefill + decode against the jitted reference ------------------------------


# -- the reference's model tests, on the port ----------------------------------


def test_sliding_window_masks_old_tokens():
    """tests/test_models.py:89 on the port: the reference's case (one
    windowed MoE layer), its parameters and tokens."""
    from repro.configs.base import ATTN as R_ATTN
    from repro.configs.base import LayerSpec as RLayerSpec
    rbase, base = TC.configs("mixtral_8x7b", dtype=TC.F32)
    rcfg = dataclasses.replace(rbase, period=(RLayerSpec(R_ATTN, window=4,
                                                         moe=True),),
                               n_periods=1)
    cfg = dataclasses.replace(base, period=(LayerSpec(ATTN, window=4,
                                                      moe=True),),
                              n_periods=1)
    _, params = TC.params(rcfg)
    S = 10
    r1 = jax.random.randint(jax.random.PRNGKey(1), (1, S), 0, cfg.vocab)
    t1 = torch.from_numpy(np.array(r1))
    t2 = t1.clone()
    t2[:, 0] = (t1[:, 0] + 1) % cfg.vocab            # differ outside window
    l1, _ = PL.forward(cfg, params, {"tokens": t1})
    l2, _ = PL.forward(cfg, params, {"tokens": t2})
    np.testing.assert_allclose(l1[:, -1].numpy(), l2[:, -1].numpy(),
                               atol=1e-4)
    assert float((l1[:, 0] - l2[:, 0]).abs().max()) > 1e-3


def test_mrope_text_equals_rope_and_the_reference():
    """tests/test_models.py:119 on the port, and both against the reference
    on the same input (f32 math, within 1e-5)."""
    x = np.random.default_rng(0).standard_normal((2, 8, 4, 128)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(8)[None], (2, 8)).astype(np.int32)
    pos3 = np.stack([pos, pos, pos])
    xt, pt, pt3 = (torch.from_numpy(np.array(a)) for a in (x, pos, pos3))
    r1 = PR.apply_rope(xt, pt, 10000.0)
    r2 = PR.apply_mrope(xt, pt3, (16, 24, 24), 10000.0)
    np.testing.assert_allclose(r1.numpy(), r2.numpy(), rtol=1e-5, atol=1e-5)
    want = RR.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), (16, 24, 24),
                          10000.0)
    np.testing.assert_allclose(r2.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # distinct t/h/w streams: the sections rotate by their own positions
    pos3b = pos3 * np.array([1, 2, 3])[:, None, None]
    want = RR.apply_mrope(jnp.asarray(x), jnp.asarray(pos3b.astype(np.int32)),
                          (16, 24, 24), 10000.0)
    got = PR.apply_mrope(xt, torch.from_numpy(pos3b.astype(np.int32)),
                         (16, 24, 24), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# -- tests/test_ssm_blocks.py on the port -------------------------------------
def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("seed,B,T", [(0, 1, 8), (7, 2, 12), (42, 4, 16)])
def test_ssd_chunked_matches_sequential(seed, B, T):
    """The chunked SSD scan against the step oracle at chunks 1, 3, 4 and T
    (2e-4), and against the reference's scan on the same inputs at chunk 4
    (1e-5)."""
    Hm, Pd, N = 2, 4, 4
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, Hm, Pd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, Hm)))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, T, N)).astype(np.float32)
              for _ in range(2))
    log_a = (-np.exp(rng.standard_normal((B, T, Hm)) * 0.5) * dt).astype(
        np.float32)
    args = _t(x, dt, Bm, Cm, log_a)
    y2, h2 = PM.ssd_sequential(*args)
    for chunk in (1, 3, 4, T):
        y1, h1 = PM.ssd_scan(*args, chunk=chunk)
        np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=2e-4,
                                   atol=2e-4)
    wy, wh = RM.ssd_scan(*(jnp.asarray(a) for a in (x, dt, Bm, Cm, log_a)),
                         chunk=4)
    y1, h1 = PM.ssd_scan(*args, chunk=4)
    np.testing.assert_allclose(y1.numpy(), np.asarray(wy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h1.numpy(), np.asarray(wh), rtol=1e-5,
                               atol=1e-5)


def _mlstm_inputs(seed, B, T, H, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = (rng.standard_normal((B, T, H, hd)) * hd ** -0.5).astype(np.float32)
    v = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    li = rng.standard_normal((B, T, H)).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(
        rng.standard_normal((B, T, H)) + 2.0, jnp.float32)))
    return q, k, v, li, lf


@pytest.mark.parametrize("seed", [0, 13, 77])
def test_mlstm_chunked_matches_sequential(seed):
    """Chunks 1, 4, 6 and T against the step oracle (5e-4), and against the
    reference's chunked scan at chunk 4 (1e-5)."""
    arrays = _mlstm_inputs(seed, 2, 12, 2, 8)
    args = _t(*arrays)
    h2, s2 = PX.mlstm_sequential(*args)
    for chunk in (1, 4, 6, 12):
        h1, s1 = PX.mlstm_scan(*args, chunk=chunk)
        np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=5e-4,
                                   atol=5e-4)
        np.testing.assert_allclose(s1[0].numpy(), s2[0].numpy(), rtol=5e-4,
                                   atol=5e-4)
    wh, _ = RX.mlstm_scan(*(jnp.asarray(a) for a in arrays), chunk=4)
    h1, _ = PX.mlstm_scan(*args, chunk=4)
    np.testing.assert_allclose(h1.numpy(), np.asarray(wh), rtol=1e-5,
                               atol=1e-5)


def test_mlstm_state_carry_split():
    """Scanning two halves with carried state == scanning the whole."""
    q, k, v, li, lf = _t(*_mlstm_inputs(5, 1, 16, 2, 8))
    h_full, _ = PX.mlstm_scan(q, k, v, li, lf, chunk=4)
    ha, st = PX.mlstm_scan(q[:, :8], k[:, :8], v[:, :8], li[:, :8],
                           lf[:, :8], chunk=4)
    hb, _ = PX.mlstm_scan(q[:, 8:], k[:, 8:], v[:, 8:], li[:, 8:], lf[:, 8:],
                          chunk=4, state=st)
    np.testing.assert_allclose(torch.cat([ha, hb], 1).numpy(), h_full.numpy(),
                               rtol=5e-4, atol=5e-4)


# -- tests/test_xdma_integration.py:18,43 on the port -------------------------


def test_xdma_cache_shapes_match_reference():
    rcfg, cfg = TC.configs("phi4_mini_3p8b", xdma_cache=True)
    cache = PL.init_cache(cfg, B=2, max_len=32, device="cpu")
    k, v = cache["blocks"][0]["k"], cache["blocks"][0]["v"]
    assert k.shape == (cfg.n_periods, 2, cfg.n_kv_heads, cfg.head_dim, 32)
    assert v.shape == (cfg.n_periods, 2, cfg.n_kv_heads, 32, cfg.head_dim)
    want = RL.init_cache(rcfg, B=2, max_len=32)
    assert [tuple(a.shape) for a in jax.tree.leaves(want)] == [
        tuple(a.shape) for a in _pytree.leaves(cache)]


# -- the trees: the port's initializer, and the reference's through numpy -----
@pytest.mark.parametrize("arch", TC.ARCHS)
def test_init_params_and_cache_trees_match_reference(arch):
    """The port's own initializer makes the reference's tree: the same
    paths, shapes and dtypes (f32 masters), each stacked slot drawn per
    period; ``init_cache`` likewise (``pos`` a 0-d int32)."""
    rcfg, cfg = TC.configs(arch)
    want = jax.eval_shape(lambda: RL.init_params(jax.random.PRNGKey(0), rcfg))
    got = PL.init_params(cfg, 3, device="cpu")
    flat = _pytree.flatten_with_paths(got)
    wflat = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(wflat)
    for (path, g), (wpath, w) in zip(flat, wflat):
        assert tuple(g.shape) == tuple(w.shape), (path, wpath)
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
    if cfg.n_periods > 1:                 # period copies are drawn apart
        wq = got["blocks"][0]
        first = next(iter(_pytree.leaves(wq)))
        assert not torch.equal(first[0], first[1]) or first.std() == 0
    rc = jax.eval_shape(lambda: RL.init_cache(rcfg, 2, 24))
    pc = PL.init_cache(cfg, 2, 24, device="cpu")
    assert [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(rc)] == [
        (tuple(a.shape), str(a.dtype).replace("torch.", ""))
        for a in _pytree.leaves(pc)]


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_params_from_numpy_round_trips(arch):
    """Reference params -> numpy -> the port's tree -> numpy: bitwise, the
    stacked period axis kept; a bf16 cache tree crosses as its bits."""
    rcfg, cfg = TC.configs(arch)
    rp, pp = TC.params(rcfg)
    back = TC.tree_to_numpy(pp)
    for w, g in zip(jax.tree.leaves(rp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(w), g)
    assert pp["blocks"][0]["norm_mix"]["scale"].shape[0] == cfg.n_periods
    rc = RL.init_cache(rcfg, 2, 24)
    rc = jax.tree.map(lambda a: a + jnp.ones_like(a) * 0.3
                      if a.dtype == jnp.bfloat16 else a, rc)
    pc = PL.params_from_numpy(jax.tree.map(np.asarray, rc), device="cpu")
    assert pc["pos"].device.type == "cpu" and pc["pos"].dim() == 0
    for w, g in zip(jax.tree.leaves(rc), jax.tree.leaves(
            TC.tree_to_numpy(pc))):
        w = np.asarray(w)
        if w.dtype == jnp.bfloat16:
            w = w.view(np.uint16)
        np.testing.assert_array_equal(w, g)


def test_init_draws_the_reference_std():
    """The port's initializer draws each weight with the reference's
    standard deviation (a wide layer, so the sample std is within 3%)."""
    _, cfg = TC.configs("phi4_mini_3p8b", d_model=256, d_ff=512,
                        n_periods=1)
    p = PL.init_params(cfg, 0, device="cpu")
    attn = p["blocks"][0]["attn"]
    for w, std in ((attn["wq"], 256 ** -0.5), (attn["wo"], 64 ** -0.5),
                   (p["blocks"][0]["ffn"]["w_down"], 512 ** -0.5),
                   (p["embed"]["embed"], 1.0)):
        assert abs(float(w.std()) / std - 1) < 0.03
    init = Init(torch.Generator().manual_seed(0), "cpu").stacked(4)
    assert init.normal((3, 5), 1.0).shape == (4, 3, 5)
