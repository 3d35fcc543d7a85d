"""Prefill and decode of the port's models (``repro_torch.models.lm``)
against the reference's and against the port's own forward: the cases
moved from ``tests/test_torch_models.py``, unchanged, so that their time
runs beside that file's.
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch_model_cases as TC  # noqa: E402
from repro.layers import mamba as RM  # noqa: E402
from repro.layers import xlstm as RX  # noqa: E402
from repro.models import lm as RL  # noqa: E402
from repro_torch.layers import mamba as PM  # noqa: E402
from repro_torch.layers import xlstm as PX  # noqa: E402
from repro_torch.models import lm as PL  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401
from test_torch_models import (  # noqa: E402
    _ref, _t)


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """f32: logits after prefill and three decode steps, and every cache
    leaf after them, within 1e-5 of max|logit| / of the leaf's max."""
    rcfg, pcfg = TC.configs(arch, dtype=TC.F32)
    rp, pp = TC.params(rcfg)
    B, S = 2, 12
    b = TC.batch(rcfg, B=B, S=S + 3)
    rb, pb = TC.inputs(b, rcfg, pcfg)
    cut = lambda d: {k: (v[..., :S] if k == "positions" else  # noqa: E731
                         v[:, :S] if k in ("tokens", "embeds") else v)
                     for k, v in d.items()}
    rc = RL.init_cache(rcfg, B, max_len=S + 8, dtype=jnp.float32)
    pc = PL.init_cache(pcfg, B, max_len=S + 8, dtype=torch.float32,
                       device="cpu")
    want, rc = _ref("prefill", rcfg)(rp, cut(rb), rc)
    got, pc = PL.prefill(pcfg, pp, cut(pb), pc)
    scale = np.abs(TC.f32(want)).max()
    assert np.abs(TC.f32(got) - TC.f32(want)).max() <= 1e-5 * scale
    key = "embeds" if "embeds" in b else "tokens"
    for t in range(3):
        want, rc = _ref("decode_step", rcfg)(rp, rb[key][:, S + t:S + t + 1],
                                             rc)
        got, pc = PL.decode_step(pcfg, pp, pb[key][:, S + t:S + t + 1], pc)
        assert np.abs(TC.f32(got) - TC.f32(want)).max() <= 1e-5 * scale, t
    assert int(pc["pos"]) == int(rc["pos"]) == S + 3
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(rc),
                            jax.tree.leaves(TC.tree_to_numpy(pc))):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        lim = 1e-5 * max(1.0, float(np.abs(w[np.abs(w) < 1e29]).max()
                                    if np.any(np.abs(w) < 1e29) else 1.0))
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=lim,
                                   err_msg=str(path))


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_decode_matches_forward(arch):
    """tests/test_models.py:62 on the port: prefill + decode logits equal
    the full forward's at the same positions, within 2e-3 of max|logit|
    (capacity factor 8, as there: no token drops in either)."""
    rcfg, cfg = TC.configs(arch, dtype=TC.F32, capacity_factor=8.0)
    params = PL.init_params(cfg, 0, device="cpu")
    B, S = 2, 12
    _, batch = TC.inputs(TC.batch(cfg, B=B, S=S + 3), rcfg, cfg)
    full, _ = PL.forward(cfg, params, batch)
    cache = PL.init_cache(cfg, B, max_len=S + 8, dtype=torch.float32,
                          device="cpu")
    pb = dict(batch)
    for k in ("tokens", "embeds"):
        if k in pb:
            pb[k] = batch[k][:, :S]
    if "positions" in pb:
        pb["positions"] = batch["positions"][:, :, :S]
    logits, cache = PL.prefill(cfg, params, pb, cache)
    scale = float(full.abs().max())
    assert float((logits[:, 0] - full[:, S - 1]).abs().max()) < 2e-3 * scale
    key = "embeds" if "embeds" in batch else "tokens"
    for t in range(3):
        logits, cache = PL.decode_step(cfg, params,
                                       batch[key][:, S + t:S + t + 1], cache)
        err = float((logits[:, 0] - full[:, S + t]).abs().max())
        assert err < 2e-3 * scale, (arch, t, err)


def test_slstm_shapes_and_decode_consistency():
    """Step-by-step decode == the full scan (2e-4), and the full scan ==
    the reference's on the reference's weights (1e-5)."""
    rcfg, cfg = TC.configs("xlstm_125m", dtype=TC.F32)
    rp = RX.init_slstm(jax.random.PRNGKey(0), rcfg)
    p = PL.params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 10, cfg.d_model)).astype(
        np.float32)
    (xt,) = _t(x)
    full, _ = PX.slstm_apply(cfg, p, xt)
    assert full.shape == xt.shape
    want, _ = RX.slstm_apply(rcfg, rp, jnp.asarray(x))
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    zero = torch.zeros((2, cfg.n_heads * cfg.head_dim))
    cache = {"slstm": (zero, zero, zero, torch.full_like(zero, -1e30))}
    outs = []
    for t in range(10):
        o, cache = PX.slstm_apply(cfg, p, xt[:, t:t + 1], cache=cache)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_mamba_prefill_then_decode_matches_full():
    rcfg, cfg = TC.configs("jamba_1p5_large_398b", dtype=TC.F32)
    rp = RM.init_mamba(jax.random.PRNGKey(0), rcfg)
    p = PL.params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 14, cfg.d_model)).astype(
        np.float32)
    (xt,) = _t(x)
    full, _ = PM.mamba_apply(cfg, p, xt)
    want, _ = RM.mamba_apply(rcfg, rp, jnp.asarray(x))
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    cache = PM.init_mamba_cache(cfg, 2, torch.float32, device="cpu")
    pre, cache = PM.mamba_apply(cfg, p, xt[:, :10], cache=cache)
    np.testing.assert_allclose(pre.numpy(), full[:, :10].numpy(), rtol=2e-4,
                               atol=2e-4)
    for t in range(10, 14):
        o, cache = PM.mamba_apply(cfg, p, xt[:, t:t + 1], cache=cache)
        np.testing.assert_allclose(o[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ["phi4_mini_3p8b", "gemma3_27b",
                                  "mixtral_8x7b", "whisper_small"])
def test_xdma_cache_decode_exact(arch):
    """Decode with the layout-optimal cache (K as K^T) == full forward
    (capacity factor 8, as there: no MoE token drops)."""
    _, cfg = TC.configs(arch, dtype=TC.F32, xdma_cache=True,
                        capacity_factor=8.0)
    params = PL.init_params(cfg, 0, device="cpu")
    B, S = 2, 12
    batch = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S + 3)))}
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.from_numpy(np.random.default_rng(
            2).standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
                np.float32))
    full, _ = PL.forward(cfg, params, batch)
    cache = PL.init_cache(cfg, B, max_len=S + 8, dtype=torch.float32,
                          device="cpu")
    pb = dict(batch, tokens=batch["tokens"][:, :S])
    logits, cache = PL.prefill(cfg, params, pb, cache)
    scale = float(full.abs().max())
    assert float((logits[:, 0] - full[:, S - 1]).abs().max()) < 2e-3 * scale
    for t in range(3):
        logits, cache = PL.decode_step(
            cfg, params, batch["tokens"][:, S + t:S + t + 1], cache)
        err = float((logits[:, 0] - full[:, S + t]).abs().max())
        assert err < 2e-3 * scale, (arch, t, err)
