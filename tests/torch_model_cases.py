"""Shared cases of the model and serving parity tests
(``tests/test_torch_models.py``, ``tests/test_torch_serving_engine.py``).

The same smoke configuration on both packages (a keyword that differs by
package, such as ``dtype``, is given as a ``(jax value, torch value)`` pair),
the reference's ``init_params`` output carried to the port through numpy,
and seeded numpy batches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as RC
from repro_torch import _pytree
from repro.models import lm as RL
from repro_torch import configs as PC
from repro_torch.models import lm as PL

# the archs whose layers are ported: every one without an MoE slot
DENSE_ARCHS = tuple(a for a in RC.ARCHS if not any(
    s.moe for s in RC.smoke_config(a).period + RC.smoke_config(a).tail))
MOE_ARCHS = tuple(a for a in RC.ARCHS if a not in DENSE_ARCHS)
F32 = (jnp.float32, torch.float32)


def configs(arch, **kw):
    """(reference cfg, port cfg) of ``arch``'s smoke config with ``kw``."""
    ref = {k: (v[0] if isinstance(v, tuple) else v) for k, v in kw.items()}
    port = {k: (v[1] if isinstance(v, tuple) else v) for k, v in kw.items()}
    return (dataclasses.replace(RC.smoke_config(arch), **ref),
            dataclasses.replace(PC.smoke_config(arch), **port))


def params(rcfg, seed=0):
    """The reference's parameters and the port's copy of them (CPU)."""
    rp = RL.init_params(jax.random.PRNGKey(seed), rcfg)
    return rp, PL.params_from_numpy(jax.tree.map(np.asarray, rp),
                                    device="cpu")


def batch(cfg, B=2, S=16, seed=0):
    """Seeded numpy inputs of the arch's family (embeds and positions for
    the vlm, audio frames for whisper)."""
    rng = np.random.default_rng(seed)
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
    return b


def inputs(b, rcfg, pcfg):
    """A numpy batch as the reference's and the port's (CPU) inputs; embeds
    in the model dtype."""
    rb = {k: jnp.asarray(v) for k, v in b.items()}
    pb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    if "embeds" in b:
        rb["embeds"] = rb["embeds"].astype(rcfg.dtype)
        pb["embeds"] = pb["embeds"].to(pcfg.dtype)
    return rb, pb


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def logit_tol(cfg_dtype, scale):
    """Logit tolerance, scaled by max|logit|: f32 1e-5 (measured up to 7e-7
    against the jitted reference); bf16 2.5e-2 (about two bf16 ulps; XLA
    and torch round bf16 products and sums in different places, measured
    up to 8.7e-3)."""
    return (1e-5 if cfg_dtype in (jnp.float32, torch.float32) else 2.5e-2) \
        * scale


def tree_to_numpy(tree):
    """The port's tree as numpy arrays (bf16 as a ``uint16`` view): the
    inverse of ``params_from_numpy``."""
    def leaf(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return _pytree.tree_map_with_path(leaf, tree)


def planeless_generate(cfg, params, batch, n_steps, max_len, cache_dtype):
    """The serving loop with no movement at all (prefill, then greedy
    decode steps): what ``ServingEngine.generate`` is bitwise equal to.
    Returns (tokens (B, n_steps), final cache)."""
    lead = batch.get("tokens", batch.get("embeds"))
    cache = PL.init_cache(cfg, lead.shape[0], max_len, cache_dtype,
                          device=lead.device)
    logits, cache = PL.prefill(cfg, params, batch, cache)
    outs = []
    for _ in range(n_steps):
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        outs.append(tok)
        logits, cache = PL.decode_step(cfg, params, tok, cache)
    return torch.cat(outs, 1), cache
