"""Stacked decoder LM covering the dense / MoE / hybrid / SSM / VLM /
audio families (PyTorch port: the twin of ``repro.models.lm``).

The depth is ``n_periods`` stacked copies of a heterogeneous ``period``
(tuple of LayerSpec) plus an optional unstacked ``tail``; the parameters and
caches of a period slot are stacked on a leading ``n_periods`` axis, as the
reference's are, and a Python loop walks the copies where the reference
scans.  ``mesh=`` reaches the MoE slots (:func:`repro_torch.layers.moe.
moe_apply`); called in every rank of an SPMD body, the batch is the rank's
block.

:func:`forward` unbinds the stacked leaves once, so a backward stacks each
leaf's per-period gradients once.

**The sharded trainer.**  Where ``cfg.axes`` names mesh axes that are
registered (every rank of a :func:`repro_torch.sharding.run_spmd` body),
:func:`forward` takes this rank's blocks of the parameters, by their fitted
train-state specs (:func:`repro_torch.launch.mesh.state_specs`), and this
rank's block of the batch: the layers run tensor-parallel over the model
axis, and each weight is made whole over the batch axis where it is used
(FSDP: cast to ``cfg.dtype`` first, then all-gathered, inside the layer
loop, so ``remat="block"`` redoes the gather in the backward), as the
reference's GSPMD program computes it.  The logits come back
vocab-sharded (whole where the vocabulary does not split over the model
axis).  Every slot is covered: attention (self and cross), dense
and MoE FFNs, Mamba, mLSTM and sLSTM, and the encoder's layers.

**Sharded serving.**  Under the same registered axes :func:`prefill` and
:func:`decode_step` run in every rank, the weights this rank's blocks by
the serving specs (:func:`repro_torch.launch.mesh.serving_specs`: no
FSDP), the batch's rows split over the batch axes where they divide it
(one axis, or a pair such as ("pod", "data")), and :func:`init_cache`
gives this rank's blocks of the cache (KV heads over the model axis, the
sequence over the model axis, over a context-parallel ``seq`` axis or
over the pair of both, recurrent states by blocks); no rank gathers a
cache.  The logits come back whole on every rank.

Where a gradient is taken (autograd on and a parameter that requires one)
under ``cfg.remat == "block"``, it checkpoints each period's slots and each
encoder layer (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of its scanned block).

Modes:
  forward(...)                       train / prefill logits (+ MoE aux)
  prefill(...)                       logits + filled decode cache
  decode_step(...)                   one token with cache

Entry points that make tensors (:func:`init_params`, :func:`init_cache`,
:func:`params_from_numpy`) put them on the card unless given
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import _pytree
from repro_torch import sharding as SH
from repro_torch.configs.base import (ATTN, MAMBA, MLSTM, SLSTM, LayerSpec,
                                      ModelConfig)
from repro_torch.layers import attention as A
from repro_torch.layers import embedding as E
from repro_torch.layers import mamba as M
from repro_torch.layers import mlp as F
from repro_torch.layers import moe as MOE
from repro_torch.layers import xlstm as X
from repro_torch.layers._init import Init
from repro_torch.layers.norms import init_rms, rms_norm
from repro_torch.layers.rope import rope_for

__all__ = ["init_params", "forward", "prefill", "decode_step", "init_cache",
           "params_from_numpy", "period_slice", "Shards", "shards_of"]

def _device(device):
    return torch.device("cuda" if device is None else device)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_slot(init: Init, cfg: ModelConfig, spec: LayerSpec):
    p: Dict[str, Any] = {"norm_mix": init_rms(init, cfg.d_model)}
    if spec.kind == ATTN:
        p["attn"] = A.init_attn(init, cfg)
        if cfg.encoder_layers:          # decoder w/ cross-attention (whisper)
            p["norm_cross"] = init_rms(init, cfg.d_model)
            p["cross"] = A.init_attn(init, cfg, cross=True)
    elif spec.kind == MAMBA:
        p["mamba"] = M.init_mamba(init, cfg)
    elif spec.kind == MLSTM:
        p["mlstm"] = X.init_mlstm(init, cfg)
    elif spec.kind == SLSTM:
        p["slstm"] = X.init_slstm(init, cfg)
    if spec.ffn:
        p["norm_ffn"] = init_rms(init, cfg.d_model)
        if spec.moe:
            p["ffn"] = MOE.init_moe(init, cfg)
        elif cfg.ffn_kind == "gelu":
            p["ffn"] = F.init_gelu_mlp(init, cfg.d_model, cfg.d_ff)
        else:
            p["ffn"] = F.init_swiglu(init, cfg.d_model, cfg.d_ff)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                store=None):
    """The port's own seeded initializer: the reference's tree, shapes,
    dtypes (f32 masters) and standard deviations, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card unless
    given ``"cpu"``; ``"meta"`` gives the shapes and dtypes with no
    storage).  The values are not JAX's.  With ``store`` (``"cpu"``) each
    weight is drawn on ``device`` and the tree is kept on ``store``: the
    same values, ``device`` holding one weight at a time."""
    cfg.validate()
    dev = _device(device)
    # the meta device holds shapes only (no values, so no generator)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(int(seed)))
    init = Init(gen, dev, store=store)
    params: Dict[str, Any] = {"embed": E.init_embed(init, cfg)}
    params["blocks"] = tuple(_init_slot(init.stacked(cfg.n_periods), cfg, spec)
                             for spec in cfg.period)
    params["tail"] = tuple(_init_slot(init, cfg, spec) for spec in cfg.tail)
    params["norm_final"] = init_rms(init, cfg.d_model)
    if cfg.encoder_layers:
        enc_cfg = dataclasses.replace(cfg, encoder_layers=0)  # no cross
        params["encoder"] = _init_slot(init.stacked(cfg.encoder_layers),
                                       enc_cfg, LayerSpec(ATTN))
        params["enc_norm"] = init_rms(init, cfg.d_model)
    return params


# ---------------------------------------------------------------------------
# the reference's trees, through numpy
# ---------------------------------------------------------------------------
def _leaf_from_numpy(a, device):
    if isinstance(a, (int, float, bool, np.generic)):
        a = np.asarray(a)
    if not isinstance(a, np.ndarray):
        return a
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = a.copy(order="C")           # torch takes only writable arrays
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        # bf16 crosses as its bits (a uint16 view, or ml_dtypes' bfloat16)
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device=None):
    """The reference's parameter (or ``init_cache``) tree, its leaves numpy
    arrays, as the port's tree on ``device`` (the card unless given
    ``"cpu"``): same keys and nesting, tensors stacked over ``n_periods``
    stay stacked.  bf16 crosses as a ``uint16`` view (or ml_dtypes'
    bfloat16); a 0-d ``pos`` counter stays on the CPU, where the port keeps
    it."""
    dev = _device(device)
    out = _pytree.tree_map_with_path(
        lambda path, a: _leaf_from_numpy(a, dev), tree)
    if isinstance(out, dict) and isinstance(out.get("pos"), torch.Tensor) \
            and out["pos"].dim() == 0:
        out["pos"] = out["pos"].cpu()
    return out


def period_slice(tree, i: int):
    """Period ``i`` of a tree stacked over ``n_periods``."""
    return _pytree.tree_map_with_path(lambda path, a: a[i], tree)


def _unstack(tree, n: int):
    """Every period's tree of a tree stacked over ``n`` periods.  The stacked
    leaves are unbound once, so under autograd the backward stacks the
    per-period gradients once; indexing one period at a time would build a
    zero buffer the size of the whole stacked leaf for each.  A rank's block
    of a leaf sharded over its periods holds fewer: period ``i`` then takes
    its slot ``i % len`` (the slot of the layer it holds, or a stand-in that
    :meth:`Shards.at_use` replaces by the holder's layer)."""
    flat = _pytree.leaves(tree)
    parts = [torch.unbind(a) for a in flat]
    return [_pytree.unflatten(tree, [p[i % len(p)] for p in parts])
            for i in range(n)]


def _needs_grad(params) -> bool:
    """A gradient is being taken: autograd on and a parameter requires
    one."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in _pytree.leaves(params))


def _checkpoint(fn, *args):
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _stack(trees):
    """The inverse of :func:`period_slice` over every period's tree."""
    flat = [_pytree.leaves(t) for t in trees]
    return _pytree.unflatten(trees[0], [torch.stack(ls) for ls in zip(*flat)])


# ---------------------------------------------------------------------------
# one sublayer slot
# ---------------------------------------------------------------------------
def _constrain_slot_params(cfg, tree, shards=None, specs=None, period=None,
                           n_stack=None):
    """The identity with no mesh axis set; with one, the reference pins each
    weight's sharding (the identity here) and casts matrices to the compute
    dtype inside the layer loop.  Under the sharded trainer (``shards``)
    each leaf is made ready for use from its stored block by its spec
    (``specs``, in ``tree``'s leaf order): :meth:`Shards.at_use`."""
    if shards is not None:
        return _pytree.unflatten(tree, [
            shards.at_use(w, sp, period=period, n_stack=n_stack)
            for w, sp in zip(_pytree.leaves(tree), specs)])
    if cfg.axes.model is None and not cfg.axes.batch:
        return tree

    def cast(path, w):
        return (w.to(cfg.dtype) if w.dim() >= 2 and w.is_floating_point()
                else w)
    return _pytree.tree_map_with_path(cast, tree)


# ---------------------------------------------------------------------------
# the sharded trainer: where each weight lives, and FSDP at use
# ---------------------------------------------------------------------------
class Shards:
    """This rank's view of a sharded config's parameters: each leaf's
    fitted spec and the mesh axes the config names, all registered.  The
    specs are the train state's (:func:`repro_torch.launch.mesh.
    state_specs`), or with ``serving`` the serving parameter specs
    (:func:`repro_torch.launch.mesh.serving_specs`: no FSDP, so
    :meth:`at_use` gathers nothing).  ``data`` is the batch axes as one
    (a name, or a tuple such as ``("pod", "data")`` registered as a pair)
    and ``dp`` their product; ``mesh`` the named axes and their sizes,
    the context-parallel ``seq`` axis among them."""

    def __init__(self, cfg: ModelConfig, serving: bool = False):
        from repro_torch.launch.mesh import (MeshSpec, mesh_axes,
                                             serving_specs, spec_leaves,
                                             state_specs)
        self.cfg = cfg
        ax = cfg.axes
        # the batch axes as one: a name, or a tuple registered as a pair
        self.data = ax.batch_spec
        self.model = ax.model
        self.dp = SH.axis_size(self.data) if self.data else 1
        names = tuple(ax.batch) + tuple(
            n for n in (ax.seq, ax.model)
            if n is not None and n not in ax.batch)
        self.mesh = MeshSpec(tuple(SH.axis_size(n) for n in names), names)
        self.axes = mesh_axes(cfg.axes, self.mesh)
        if serving:
            pspecs, pshapes = serving_specs(cfg, self.mesh)
        else:
            specs, shapes = state_specs(cfg, self.mesh)
            pspecs, pshapes = specs["params"], shapes["params"]
        flat = zip(_pytree.flatten_with_paths(pshapes),
                   spec_leaves(pspecs, pshapes))
        self.specs: Dict[str, list] = {}
        for (path, _), sp in flat:
            top = _pytree.path_key(path[:1] if path[0][1] != "tail"
                                   else path[:2])
            self.specs.setdefault(top, []).append(sp)

    def at_use(self, w, spec, *, period=None, n_stack=None):
        """A stored block ready for use: cast to ``cfg.dtype`` (a float
        matrix), then whole over the batch axis — all-gathered along the dim
        its spec shards there (the gradient reduce-scattered), or, for a
        leaf of the stacked ``period`` held by one data rank, broadcast from
        it (the gradient summed back to it); a leaf replicated over the
        batch axis enters through ``copy_to_axis``.  The model axis's
        shards stay for the layers.  ``period`` marks ``w`` as period
        ``period``'s slot of a leaf stacked over ``n_stack`` layers
        (``cfg.n_periods``, or the encoder's ``cfg.encoder_layers``)."""
        spec = tuple(spec)
        lead = None
        if period is not None:
            lead, spec = (spec[0] if spec else None), spec[1:]
        if w.dim() >= 2 and w.is_floating_point():
            w = w.to(self.cfg.dtype)
        d = self.data
        if d is None:
            return w
        if lead == d:
            n_stack = self.cfg.n_periods if n_stack is None else n_stack
            return SH.broadcast_from(w, d, period // (n_stack // self.dp))
        if lead is not None:
            raise ValueError(f"a stacked leaf's period dim over {lead!r}")
        dims = [i for i, e in enumerate(spec) if e == d]
        if not dims:
            return SH.copy_to_axis(w, d)
        for i in dims:
            w = SH.gather_along(w, d, i)
        return w

    def embed_at_use(self, p, tokens: bool):
        """The embedding leaves the forward reads, at use: the table for a
        token lookup or a tied head, the untied head."""
        out = {}
        for k, w in p.items():
            if k == "embed" and not (tokens or self.cfg.tie_embeddings):
                continue
            out[k] = self.at_use(w, self.specs["embed"][sorted(p).index(k)])
        return out

    # -- serving: the batch's data block and the cache's blocks -------------
    def splits_batch(self, B: int) -> bool:
        """A batch of ``B`` rows splits over the batch axes when it divides
        (the fitted cache specs' rule); else every data rank holds every
        row."""
        return self.data is not None and self.dp > 1 and B % self.dp == 0

    def rows(self, t: torch.Tensor, B: int, dim: int = 0) -> torch.Tensor:
        """This rank's rows of ``t`` (``B`` rows along ``dim``)."""
        if not self.splits_batch(B):
            return t
        n = B // self.dp
        return t.narrow(dim, SH.axis_index(self.data) * n, n)

    def batch_block(self, batch, B: int):
        """This rank's rows of every batch leaf (dim 1 of M-RoPE's (3, B,
        S) ``positions``, dim 0 of the others)."""
        return {k: (v if v.dim() == 0 else self.rows(
            v, B, 1 if k == "positions" and v.dim() == 3 else 0))
            for k, v in batch.items()}

    def whole_rows(self, t: torch.Tensor, B: int) -> torch.Tensor:
        """The rows of every data rank, in order (an all-gather over the
        data axis where the batch splits)."""
        return SH.all_gather(t, self.data, 0) if self.splits_batch(B) else t


def shards_of(cfg: ModelConfig, serving: bool = False) -> Optional[Shards]:
    """The :class:`Shards` (the sharded trainer's, or with ``serving``
    sharded serving's) where ``cfg.axes`` names registered mesh axes; None
    where it names none, or none of them is registered (the reference's
    sharding constraints are the identity outside a mesh).  Some
    registered and some not raises."""
    names = tuple(cfg.axes.batch) + tuple(
        n for n in (cfg.axes.model, cfg.axes.seq) if n)
    live = [SH.active_axis(n) is not None for n in names]
    if not any(live):
        return None
    if not all(live):
        raise LookupError(f"cfg.axes names {names}, of which only "
                          f"{[n for n, ok in zip(names, live) if ok]} are "
                          "registered mesh axes")
    return Shards(cfg, serving)


def _ffn(cfg, spec, p, x, mesh):
    """The FFN sublayer: ``(x + ffn(norm(x)), aux)``."""
    h = rms_norm(x, p["norm_ffn"]["scale"], cfg.norm_eps)
    if spec.moe:
        out, aux = MOE.moe_apply(cfg, p["ffn"], h, mesh=mesh)
        return x + out, aux
    if cfg.ffn_kind == "gelu":
        return x + F.gelu_mlp(cfg, p["ffn"], h), _zero_aux(x)
    return x + F.swiglu(cfg, p["ffn"], h), _zero_aux(x)


def _apply_slot(cfg, spec: LayerSpec, p, x, positions, *, cache=None,
                cache_pos=None, enc_out=None, cross_cache=None, mesh=None,
                causal=True, max_len=None):
    """One slot: ``(x, new_cache, aux)``; ``max_len`` the decode cache's
    (:func:`_slots`)."""
    aux = _zero_aux(x)
    new_cache = {}
    h = rms_norm(x, p["norm_mix"]["scale"], cfg.norm_eps)
    if spec.kind == ATTN:
        kv_cache = None if cache is None else {"k": cache["k"], "v": cache["v"]}
        out, kv_cache = A.attn_apply(cfg, p["attn"], h, positions,
                                     causal=causal, window=spec.window,
                                     cache=kv_cache, cache_pos=cache_pos,
                                     cache_slots=_slots(spec, max_len))
        if kv_cache is not None:
            new_cache.update(kv_cache)
        x = x + out
        if enc_out is not None or cross_cache is not None:
            hc = rms_norm(x, p["norm_cross"]["scale"], cfg.norm_eps)
            out, _ = A.attn_apply(cfg, p["cross"], hc, positions,
                                  causal=False, kv_x=enc_out,
                                  cache=cross_cache, apply_rope=False,
                                  cross=True)
            x = x + out
    else:
        apply = {MAMBA: lambda: M.mamba_apply(cfg, p["mamba"], h, cache=cache),
                 MLSTM: lambda: X.mlstm_apply(cfg, p["mlstm"], h, cache=cache),
                 SLSTM: lambda: X.slstm_apply(cfg, p["slstm"], h, cache=cache)}
        out, mc = apply[spec.kind]()
        if mc is not None:
            new_cache.update(mc)
        x = x + out
    if spec.ffn:
        x, aux = _ffn(cfg, spec, p, x, mesh)
    return x, new_cache, aux


def _slots(spec: LayerSpec, max_len):
    """An attention slot's cache slots for ``max_len`` (None: unknown),
    as :func:`_slot_cache` sizes them."""
    if max_len is None:
        return None
    return min(spec.window, max_len) if spec.window else max_len


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------
def _slot_cache(cfg, spec: LayerSpec, B, max_len, dtype, lead, dev):
    z = lambda shape, dt=dtype: torch.zeros(lead + shape, dtype=dt,  # noqa: E731
                                            device=dev)
    if spec.kind == ATTN:
        smax = min(spec.window, max_len) if spec.window else max_len
        KV, hd = cfg.n_kv_heads, cfg.head_dim
        if cfg.xdma_cache:
            # XDMA layout-optimal: K stored transposed, V dot-contiguous
            return {"k": z((B, KV, hd, smax)), "v": z((B, KV, smax, hd))}
        return {"k": z((B, smax, KV, hd)), "v": z((B, smax, KV, hd))}
    f32 = torch.float32
    if spec.kind == MAMBA:
        di, N, Hm = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        return {"conv": z((B, M.CONV_K - 1, di)),
                "h": z((B, Hm, di // Hm, N), f32)}
    H, hd = cfg.n_heads, cfg.head_dim
    if spec.kind == MLSTM:
        return {"mlstm": (z((B, H, hd, hd), f32), z((B, H, hd), f32),
                          torch.full(lead + (B, H), -1e30, dtype=f32,
                                     device=dev))}
    if spec.kind == SLSTM:
        shape = (B, H * hd)
        return {"slstm": (z(shape, f32), z(shape, f32), z(shape, f32),
                          torch.full(lead + shape, -1e30, dtype=f32,
                                     device=dev))}
    raise ValueError(spec.kind)


def _whole_cache(cfg, B, max_len, dtype, dev):
    lead = (cfg.n_periods,)
    cache = {
        "blocks": tuple(_slot_cache(cfg, s, B, max_len, dtype, lead, dev)
                        for s in cfg.period),
        "tail": tuple(_slot_cache(cfg, s, B, max_len, dtype, (), dev)
                      for s in cfg.tail),
        "pos": torch.zeros((), dtype=torch.int32),
    }
    if cfg.encoder_layers:
        kv = (cfg.n_periods, B, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        cache["cross"] = {
            "k": torch.zeros(kv, dtype=dtype, device=dev),
            "v": torch.zeros(kv, dtype=dtype, device=dev),
            "len": torch.full((cfg.n_periods,), cfg.encoder_seq,
                              dtype=torch.int32, device=dev),
        }
    return cache


def _local_cache(cfg, sh: Shards, B, max_len, dtype, dev):
    """This rank's blocks of the cache by its fitted specs, each filled as
    :func:`_whole_cache` fills the whole leaf.  A KV sequence the model
    axis does not divide stays whole on every rank, as the fitted spec
    says."""
    from repro_torch.launch.mesh import (local_shape, serving_cache_specs,
                                         spec_leaves)
    whole = _whole_cache(cfg, B, max_len, dtype, torch.device("meta"))
    fills = [t.reshape(-1)[0].item() for t in _pytree.leaves(
        _whole_cache(cfg, 1, 1, dtype, torch.device("cpu")))]
    fitted = spec_leaves(serving_cache_specs(cfg, whole, sh.mesh), whole)
    out = []
    for t, sp, fill in zip(_pytree.leaves(whole), fitted, fills):
        if t.dim() == 0:                # pos: host-side control state
            out.append(torch.full((), fill, dtype=t.dtype))
            continue
        out.append(torch.full(local_shape(t.shape, sp, sh.mesh), fill,
                              dtype=t.dtype, device=dev))
    return _pytree.unflatten(whole, out)


def init_cache(cfg: ModelConfig, B: int, max_len: int,
               dtype=torch.bfloat16, *, device=None):
    """The decode cache, on ``device`` (the card unless given ``"cpu"``):
    the reference's tree, period slots stacked over ``n_periods``.  ``pos``
    is a 0-d int32 tensor on the CPU (host-side control state; a ragged
    batch's (B,) positions live on the card).  Under sharded serving
    (``cfg.axes`` names registered mesh axes) it is this rank's blocks of
    the whole cache of ``B`` rows, by ``launch.mesh.serving_cache_specs``:
    the rows split over the data axis where ``B`` divides it, the KV heads
    or the sequence over the model axis (a sequence the axis does not
    divide whole on every rank: pass the same ``max_len`` to
    :func:`prefill` and :func:`decode_step`), the recurrent states by
    blocks of channels or heads where they divide it."""
    dev = _device(device)
    sh = shards_of(cfg, serving=True)
    if sh is not None:
        return _local_cache(cfg, sh, B, max_len, dtype, dev)
    return _whole_cache(cfg, B, max_len, dtype, dev)


# ---------------------------------------------------------------------------
# encoder (whisper)
# ---------------------------------------------------------------------------
def _encode(cfg, params, audio_embeds, sh=None):
    """The encoder's layers over the audio frames, then its norm; under the
    sharded trainer (``sh``) each layer's weights made ready at use."""
    enc_cfg = dataclasses.replace(cfg, encoder_layers=0)
    spec = LayerSpec(ATTN)
    x = audio_embeds.to(cfg.dtype)
    pos = torch.arange(x.shape[1], device=x.device)[None].expand(x.shape[:2])

    def layer(x, p, i):
        p = _constrain_slot_params(
            enc_cfg, p, sh, None if sh is None else sh.specs["encoder"],
            period=i, n_stack=cfg.encoder_layers)
        return _apply_slot(enc_cfg, spec, p, x, pos, causal=False)[0]

    remat = cfg.remat == "block" and _needs_grad(params)  # jax.checkpoint
    for i, p in enumerate(_unstack(params["encoder"], cfg.encoder_layers)):
        x = _checkpoint(layer, x, p, i) if remat else layer(x, p, i)
    scale = params["enc_norm"]["scale"]
    if sh is not None:
        scale = sh.at_use(scale, sh.specs["enc_norm"][0])
    return rms_norm(x, scale, cfg.norm_eps)


def _inputs(cfg, params, batch, embed=None, sh=None):
    """``(x, positions, enc_out)``; ``embed`` the embedding leaves at use
    and ``sh`` the :class:`Shards` (the sharded trainer's), else
    ``params["embed"]``."""
    embed = params["embed"] if embed is None else embed
    if "embeds" in batch:
        x = batch["embeds"].to(cfg.dtype)
        B, S = x.shape[:2]
    else:
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = E.embed(cfg, embed, tokens)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    enc_out = None
    if cfg.encoder_layers:
        enc_out = _encode(cfg, params, batch["audio_embeds"], sh)
    return x, positions, enc_out


# ---------------------------------------------------------------------------
# forward (train / prefill without cache)
# ---------------------------------------------------------------------------
def forward(cfg: ModelConfig, params, batch, *, mesh=None):
    """batch: {tokens (B,S)} or {embeds}, optional {positions}, optional
    {audio_embeds} for enc-dec.  Returns (logits, aux): aux sums the MoE
    slots' load-balance losses.  Under the sharded trainer ``params`` and
    ``batch`` are this rank's blocks and the logits this rank's block of
    the vocabulary (see the module's docstring)."""
    sh = shards_of(cfg)
    embed = (None if sh is None
             else sh.embed_at_use(params["embed"], "embeds" not in batch))
    x, positions, enc_out = _inputs(cfg, params, batch, embed, sh)
    aux_total = _zero_aux(x)

    def block(x, aux, slot_params, i):
        slot_params = _constrain_slot_params(
            cfg, slot_params, sh, None if sh is None else sh.specs["blocks"],
            period=i)
        for spec, p in zip(cfg.period, slot_params):
            x, _, a = _apply_slot(cfg, spec, p, x, positions,
                                  enc_out=enc_out, mesh=mesh)
            aux = aux + a
        return x, aux

    remat = cfg.remat == "block" and _needs_grad(params)  # jax.checkpoint
    for i, slot_params in enumerate(_unstack(params["blocks"],
                                             cfg.n_periods)):
        if remat:
            x, aux_total = _checkpoint(block, x, aux_total, slot_params, i)
        else:
            x, aux_total = block(x, aux_total, slot_params, i)
    for t, (spec, p) in enumerate(zip(cfg.tail, params["tail"])):
        if sh is not None:
            p = _constrain_slot_params(cfg, p, sh, sh.specs[f"tail/{t}"])
        x, _, a = _apply_slot(cfg, spec, p, x, positions, enc_out=enc_out,
                              mesh=mesh)
        aux_total = aux_total + a
    scale = params["norm_final"]["scale"]
    if sh is not None:
        scale = sh.at_use(scale, sh.specs["norm_final"][0])
    x = rms_norm(x, scale, cfg.norm_eps)
    return E.lm_head(cfg, params["embed"] if embed is None else embed,
                     x), aux_total


# ---------------------------------------------------------------------------
# prefill (fills cache) and decode
# ---------------------------------------------------------------------------
def _write_kv_cache(cfg, attn_p, x_normed, positions, slot_cache,
                    slots=None):
    """Project K/V from the normed input and write them into the cache
    (rolled for sliding-window layers; transposed under ``xdma_cache``).
    Under a registered model axis the cache is this rank's block:
    :func:`_write_kv_block` (``slots`` the whole cache's)."""
    tp = SH.active_axis(cfg.axes.model)
    if tp is not None:
        return _write_kv_block(cfg, attn_p, x_normed, positions, slot_cache,
                               tp, slots)
    B, S, _ = x_normed.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    xd = x_normed.dtype

    def proj(w, b):
        y = x_normed @ attn_p[w].to(xd)
        return (y + attn_p[b].to(xd) if b in attn_p else y).reshape(B, S, KV,
                                                                     hd)
    k, v = proj("wk", "bk"), proj("wv", "bv")
    if cfg.qk_norm:
        k = rms_norm(k, attn_p["k_norm"])
    k = rope_for(cfg, k, positions)
    return _store_kv(cfg, k, v, slot_cache)


def _store_kv(cfg, k, v, slot_cache):
    """The prompt's K / V (B, S, KV, hd) into every slot of the cache: the
    prefix, or for ``S >= Smax`` the last ``Smax`` rolled to their slots."""
    S = k.shape[1]
    dt = slot_cache["k"].dtype
    smax = slot_cache["k"].shape[3] if cfg.xdma_cache else slot_cache["k"].shape[1]
    if S >= smax:
        shift = S % smax
        kk = torch.roll(k[:, S - smax:], shift, dims=1)
        vv = torch.roll(v[:, S - smax:], shift, dims=1)
        if cfg.xdma_cache:
            # relayout fused into the store (paper: transform-on-transfer)
            return dict(slot_cache,
                        k=kk.permute(0, 2, 3, 1).to(dt).contiguous(),
                        v=vv.permute(0, 2, 1, 3).to(dt).contiguous())
        return dict(slot_cache, k=kk.to(dt), v=vv.to(dt))
    ck, cv = slot_cache["k"].clone(), slot_cache["v"].clone()
    if cfg.xdma_cache:
        ck[:, :, :, :S] = k.permute(0, 2, 3, 1).to(dt)      # (B,KV,hd,S)
        cv[:, :, :S, :] = v.permute(0, 2, 1, 3).to(dt)      # (B,KV,S,hd)
    else:
        ck[:, :S] = k.to(dt)
        cv[:, :S] = v.to(dt)
    return dict(slot_cache, k=ck, v=cv)


def _write_kv_block(cfg, attn_p, x_normed, positions, slot_cache, ax,
                    slots=None):
    """:func:`_write_kv_cache` into this rank's block of the cache, the
    model axis ``ax`` and the cache's sequence split by ``kv_cache_spec``
    (``A.kv_seq_axis``).  KV heads that divide the model axis: this rank's
    heads, from its columns of ``wk`` / ``wv``; otherwise every head, the
    weights whole.  A sequence split (over ``seq``, ``(seq, model)`` or
    the model axis) gives the block slots ``[r Smax / n, (r + 1) Smax /
    n)``, or all ``Smax`` where the split does not divide them
    (``A.seq_block``): the positions those slots hold (the prompt's, or
    the rolled last ``Smax`` for ``S >= Smax``) are projected, and a slot
    the prompt does not reach keeps its value.  With no sequence split
    every slot is written."""
    B, S, _ = x_normed.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    xd = x_normed.dtype
    m = ax.name
    heads = KV % ax.size == 0
    part = SH.block_of if heads else SH.whole_of
    split = A.kv_seq_axis(cfg, ax)
    src, pos = x_normed, positions
    if split is not None:
        sl = slot_cache["k"].shape[3 if cfg.xdma_cache else 1]
        lo, smax, _ = A.seq_block(sl, split, slots)
        slot = lo + torch.arange(sl, device=x_normed.device)
        idx = (S - smax + (slot - S % smax) % smax if S >= smax
               else torch.clamp(slot, max=S - 1))
        src, pos = x_normed[:, idx], positions[..., idx]

    def proj(w, b):
        y = src @ part(attn_p[w], m, KV * hd, 1).to(xd)
        if b in attn_p:
            y = y + part(attn_p[b], m, KV * hd, 0).to(xd)
        return y.reshape(B, src.shape[1], -1, hd)
    k, v = proj("wk", "bk"), proj("wv", "bv")
    if cfg.qk_norm:
        k = rms_norm(k, attn_p["k_norm"])
    k = rope_for(cfg, k, pos)
    if split is None:
        return _store_kv(cfg, k, v, slot_cache)
    dt = slot_cache["k"].dtype
    if S >= smax:                       # every slot holds a prompt position
        keep = torch.ones_like(slot, dtype=torch.bool)
    else:
        keep = slot < S
    if cfg.xdma_cache:
        k, v = k.permute(0, 2, 3, 1), v.permute(0, 2, 1, 3)
        kk, vk = keep[None, None, None, :], keep[None, None, :, None]
    else:
        kk = vk = keep[None, :, None, None]
    return dict(slot_cache,
                k=torch.where(kk, k.to(dt), slot_cache["k"]).contiguous(),
                v=torch.where(vk, v.to(dt), slot_cache["v"]).contiguous())


def _prefill_slot(cfg, spec, p, x, positions, slot_cache, *, enc_out=None,
                  mesh=None, max_len=None):
    """Apply one slot in prefill mode, producing both output and cache."""
    h = rms_norm(x, p["norm_mix"]["scale"], cfg.norm_eps)
    if spec.kind == ATTN:
        out, _ = A.attn_apply(cfg, p["attn"], h, positions, causal=True,
                              window=spec.window)
        new_cache = _write_kv_cache(cfg, p["attn"], h, positions, slot_cache,
                                    _slots(spec, max_len))
        x = x + out
        if enc_out is not None:
            hc = rms_norm(x, p["norm_cross"]["scale"], cfg.norm_eps)
            out, _ = A.attn_apply(cfg, p["cross"], hc, positions,
                                  causal=False, kv_x=enc_out, apply_rope=False)
            x = x + out
    else:
        apply = {MAMBA: M.mamba_apply, MLSTM: X.mlstm_apply,
                 SLSTM: X.slstm_apply}[spec.kind]
        name = {MAMBA: "mamba", MLSTM: "mlstm", SLSTM: "slstm"}[spec.kind]
        out, new_cache = apply(cfg, p[name], h, cache=slot_cache)
        x = x + out
    if spec.ffn:
        x, _ = _ffn(cfg, spec, p, x, mesh)
    return x, new_cache


def _cross_cache(cfg, params, enc_out, cross):
    """The cross K / V of every decoder period from the encoder's output,
    by the first slot's weights; under a registered model axis this rank's
    block of them by ``kv_cache_spec``: its KV heads where they divide the
    axis (every head otherwise), and its rows of the encoder's frames where
    the frames split (over ``seq``, ``(seq, model)`` or the model axis:
    ``A.kv_seq_axis``; all of them where the split does not divide
    them)."""
    B = enc_out.shape[0]
    KV, hd, dt = cfg.n_kv_heads, cfg.head_dim, cfg.dtype
    w = params["blocks"][0]["cross"]
    tp = SH.active_axis(cfg.axes.model)
    split = None if tp is None else A.kv_seq_axis(cfg, tp)

    def kv(name, i):
        wi, src = w[name][i], enc_out
        if tp is not None:
            part = SH.block_of if KV % tp.size == 0 else SH.whole_of
            wi = part(wi, tp.name, KV * hd, 1)
        frames = enc_out.shape[1]
        if split is not None and frames % split.size == 0:
            rows = frames // split.size
            src = enc_out[:, split.index * rows:(split.index + 1) * rows]
        return (src @ wi.to(dt)).reshape(B, src.shape[1], -1, hd)
    k = torch.stack([kv("wk", i) for i in range(cfg.n_periods)])
    v = torch.stack([kv("wv", i) for i in range(cfg.n_periods)])
    return {"k": k.to(dt), "v": v.to(dt), "len": cross["len"]}


def _check_rows(cache, B: int):
    """The cache holds the rows the batch block has."""
    slots = cache["blocks"] + tuple(cache["tail"])
    if slots:
        t = _pytree.leaves(slots[0])[0]
        have = t.shape[1 if cache["blocks"] else 0]
        if have != B:
            raise ValueError(f"the cache holds {have} rows, the batch block "
                             f"{B}: init_cache with the whole batch")


def _whole_logits(cfg, sh, logits, B: int):
    """The logits whole on every rank of a sharded run (the reference's
    ``out_shardings=None``): gathered along the vocabulary over the model
    axis where it splits there, and over the data axis where the rows
    do."""
    if sh is None:
        return logits
    ax = E.vocab_axis(cfg)
    if ax is not None:
        logits = SH.all_gather(logits, ax.name, -1)
    return sh.whole_rows(logits, B)


def _slot_params(cfg, sh, tree, key, period=None):
    if sh is None:
        return _constrain_slot_params(cfg, tree)
    return _constrain_slot_params(cfg, tree, sh, sh.specs[key],
                                  period=period)


def prefill(cfg: ModelConfig, params, batch, cache, *, mesh=None,
            max_len=None):
    """Run the prompt through the model, writing KV/state caches.

    Returns (logits_last (B,1,V), cache).

    Sharded serving (``cfg.axes`` names registered mesh axes; every rank
    of the mesh calls it): ``params`` are this rank's blocks by
    ``launch.mesh.serving_specs``, ``batch`` the whole batch, of which the
    rank takes its rows, and ``cache`` this rank's blocks
    (:func:`init_cache`).  The layers run the sharded trainer's
    tensor-parallel regimes and write this rank's block of each cache; the
    logits come back whole on every rank.  ``max_len`` is the cache's
    (:func:`init_cache`'s): needed where the model axis takes a KV
    sequence and the block's slot count does not tell a split cache from
    a whole one (``layers.attention.seq_block``)."""
    sh = shards_of(cfg, serving=True)
    B = batch.get("tokens", batch.get("embeds")).shape[0]
    if sh is not None:
        batch = sh.batch_block(batch, B)
    embed = (None if sh is None
             else sh.embed_at_use(params["embed"], "embeds" not in batch))
    x, positions, enc_out = _inputs(cfg, params, batch, embed, sh)
    _check_rows(cache, x.shape[0])
    cache = dict(cache)
    if cfg.encoder_layers:
        cache["cross"] = _cross_cache(cfg, params, enc_out, cache["cross"])
    per_period = []
    for i in range(cfg.n_periods):
        slot_params = _slot_params(cfg, sh, period_slice(params["blocks"], i),
                                   "blocks", period=i)
        slot_caches = period_slice(cache["blocks"], i)
        new = []
        for spec, p, c in zip(cfg.period, slot_params, slot_caches):
            x, nc = _prefill_slot(cfg, spec, p, x, positions, c,
                                  enc_out=enc_out, mesh=mesh,
                                  max_len=max_len)
            new.append(nc)
        per_period.append(tuple(new))
    new_tail = []
    for t, (spec, p, c) in enumerate(zip(cfg.tail, params["tail"],
                                         cache["tail"])):
        if sh is not None:
            p = _slot_params(cfg, sh, p, f"tail/{t}")
        x, nc = _prefill_slot(cfg, spec, p, x, positions, c, enc_out=enc_out,
                              mesh=mesh, max_len=max_len)
        new_tail.append(nc)
    x = rms_norm(x, _final_scale(params, sh), cfg.norm_eps)
    logits = E.lm_head(cfg, params["embed"] if embed is None else embed,
                       x[:, -1:])
    cache.update(blocks=_stack(per_period), tail=tuple(new_tail),
                 pos=torch.tensor(x.shape[1], dtype=torch.int32))
    return _whole_logits(cfg, sh, logits, B), cache


def _final_scale(params, sh):
    scale = params["norm_final"]["scale"]
    return scale if sh is None else sh.at_use(scale,
                                              sh.specs["norm_final"][0])


def decode_step(cfg: ModelConfig, params, tokens, cache, *, mesh=None,
                max_len=None):
    """One decode step.  tokens (B,1) (or embeds (B,1,d)); returns
    (logits (B,1,V), new cache).  The cache passed in is not modified.

    Sharded serving (see :func:`prefill`): ``tokens`` are the whole
    batch's, of which the rank takes its rows (and of a ragged ``pos``),
    ``cache`` this rank's blocks, ``max_len`` its ``max_len``; the logits
    come back whole on every rank."""
    sh = shards_of(cfg, serving=True)
    pos = cache["pos"]
    B = tokens.shape[0]
    if sh is not None:
        tokens = sh.rows(tokens, B)
    embed = (None if sh is None
             else sh.embed_at_use(params["embed"], tokens.dim() != 3))
    if tokens.dim() == 3:
        x = tokens.to(cfg.dtype)
    else:
        x = E.embed(cfg, params["embed"] if embed is None else embed, tokens)
    Bl = x.shape[0]
    _check_rows(cache, Bl)
    if pos.dim() >= 1:
        # ragged batch: per-request positions, shape (B,) -> (B, 1)
        mine = pos if sh is None else sh.rows(pos, B)
        positions = mine.to(torch.int32)[:, None].to(x.device)
        cache_pos = mine.to(x.device)
    else:
        cache_pos = int(pos)
        positions = torch.full((Bl, 1), cache_pos, dtype=torch.int32,
                               device=x.device)
    cross = cache.get("cross")
    per_period = []
    for i in range(cfg.n_periods):
        slot_params = _slot_params(cfg, sh, period_slice(params["blocks"], i),
                                   "blocks", period=i)
        slot_caches = period_slice(cache["blocks"], i)
        cross_i = None if cross is None else period_slice(cross, i)
        new = []
        for spec, p, c in zip(cfg.period, slot_params, slot_caches):
            x, nc, _ = _apply_slot(cfg, spec, p, x, positions, cache=c,
                                   cache_pos=cache_pos, cross_cache=cross_i,
                                   mesh=mesh, max_len=max_len)
            new.append(dict(c, **nc))
        per_period.append(tuple(new))
    new_tail = []
    for t, (spec, p, c) in enumerate(zip(cfg.tail, params["tail"],
                                         cache["tail"])):
        if sh is not None:
            p = _slot_params(cfg, sh, p, f"tail/{t}")
        x, nc, _ = _apply_slot(cfg, spec, p, x, positions, cache=c,
                               cache_pos=cache_pos, mesh=mesh,
                               max_len=max_len)
        new_tail.append(dict(c, **nc))
    x = rms_norm(x, _final_scale(params, sh), cfg.norm_eps)
    logits = E.lm_head(cfg, params["embed"] if embed is None else embed, x)
    new_cache = dict(cache, blocks=_stack(per_period), tail=tuple(new_tail),
                     pos=pos + 1)
    return _whole_logits(cfg, sh, logits, B), new_cache
