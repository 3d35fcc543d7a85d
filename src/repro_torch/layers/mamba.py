"""Selective SSM (Mamba) block in the chunked SSD formulation.

The twin of ``repro.layers.mamba``: intra-chunk work is (Q x Q) matmuls,
inter-chunk state a small sequential carry (a Python loop over chunks where
the reference scans).  Shapes: heads ``Hm`` with head dim ``P`` (d_inner =
Hm * P), state size ``N``.  Per-step decay is scalar-per-head:
a_t = exp(-exp(A_log) * dt_t).

Under a registered model axis (``cfg.axes.model``, the sharded trainer)
the training block runs tensor-parallel as the reference's GSPMD program
partitions it by its path rules: each rank a block of ``d_inner`` (``w_z``,
``w_x``, ``conv_w`` by column, ``norm`` by element, ``w_out`` by row, its
partial sums reduced over the axis), ``w_B``, ``w_C``, ``w_dt`` and the
per-head ``dt_bias``, ``A_log``, ``D`` replicated.  A channel's scan reads
only its own head's ``dt``, ``A_log`` and ``D``, so a block that splits a
head takes that head's: the block runs as heads of ``gcd(P, d_inner / n)``
channels, each with its real head's values.  The gated RMSNorm sums its
squares over the axis.  Sharded serving runs the same decomposition with
this rank's block of the cache (:func:`_mamba_tp`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import sharding as SH

from ._cumsum import cumsum
from .norms import rms_norm, rms_norm_tp
from ._init import Init

CONV_K = 4
_F32 = torch.float32


def init_mamba(init: Init, cfg):
    d, di, N, Hm = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "w_z": init.normal((d, di), d ** -0.5),
        "w_x": init.normal((d, di), d ** -0.5),
        "w_B": init.normal((d, N), d ** -0.5),
        "w_C": init.normal((d, N), d ** -0.5),
        "w_dt": init.normal((d, Hm), d ** -0.5),
        "dt_bias": init.zeros((Hm,)),
        "A_log": init.const(torch.log(torch.linspace(1.0, 16.0, Hm,
                                                     dtype=_F32))),
        "D": init.ones((Hm,)),
        "conv_w": init.normal((CONV_K, di), d ** -0.5) * 3.0,
        "norm": init.ones((di,)),
        "w_out": init.normal((di, d), di ** -0.5),
    }


def _causal_conv(xin, w, state=None):
    """Depthwise causal conv width CONV_K. xin (B,T,di), w (K,di).

    state (B, K-1, di) holds the trailing inputs from the previous segment;
    returns (y, new_state)."""
    B, T, di = xin.shape
    if state is None:
        state = torch.zeros((B, CONV_K - 1, di), dtype=xin.dtype,
                            device=xin.device)
    xp = torch.cat([state, xin], dim=1)                   # (B, T+K-1, di)
    y = 0
    for k in range(CONV_K):
        y = y + xp[:, k:k + T] * w[k].to(xin.dtype)
    return y, xp[:, -(CONV_K - 1):]


def _ssd_chunk(h, xc, dtc, Bc, Cc, la):
    """One chunk of the SSD scan.  h: (B,Hm,P,N)."""
    cum = cumsum(la, 1)                                   # (B,Q,Hm)
    total = cum[:, -1]                                    # (B,Hm)
    y_inter = torch.einsum("bqn,bqh,bhpn->bqhp", Cc, torch.exp(cum), h)
    dot = torch.einsum("bqn,bkn->bqk", Cc, Bc)
    Q = xc.shape[1]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xc.device))
    diff = cum[:, :, None, :] - cum[:, None, :, :]        # (B,Q,Q,H) i,j
    # mask the exponent, not the exp (the reference's order)
    decay = torch.exp(torch.where(mask[None, :, :, None], diff, -1e30))
    scores = dot[..., None] * decay
    scores = scores * dtc[:, None, :, :]                  # dt_j
    y_intra = torch.einsum("bqkh,bkhp->bqhp", scores, xc)
    w_j = torch.exp(total[:, None, :] - cum) * dtc        # (B,Q,H)
    h_new = torch.exp(total)[:, :, None, None] * h + torch.einsum(
        "bkh,bkn,bkhp->bhpn", w_j, Bc, xc)
    return h_new, y_inter + y_intra


def ssd_scan(x, dt, Bm, Cm, log_a, *, chunk=128, h0=None):
    """x (B,T,Hm,P) f32; dt,log_a (B,T,Hm); Bm,Cm (B,T,N) -> (y, h_final)."""
    B, T, Hm, Pd = x.shape
    N = Bm.shape[-1]
    Q = max(1, min(chunk, T))
    while T % Q:
        Q -= 1
    h = h0 if h0 is not None else torch.zeros((B, Hm, Pd, N), dtype=_F32,
                                              device=x.device)
    ys = []
    for c in range(T // Q):
        sl = slice(c * Q, (c + 1) * Q)
        h, y = _ssd_chunk(h, x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl],
                          log_a[:, sl])
        ys.append(y)
    return torch.cat(ys, dim=1), h


def ssd_sequential(x, dt, Bm, Cm, log_a, h0=None):
    """Step-by-step oracle for ssd_scan (tests only)."""
    B, T, Hm, Pd = x.shape
    N = Bm.shape[-1]
    h = h0 if h0 is not None else torch.zeros((B, Hm, Pd, N), dtype=_F32,
                                              device=x.device)
    ys = []
    for t in range(T):
        a = torch.exp(log_a[:, t])                        # (B,Hm)
        h = a[:, :, None, None] * h + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], Bm[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h


def mamba_apply(cfg, p, x, *, cache=None):
    """x (B,T,d).  cache = {"conv": (B,K-1,di), "h": (B,Hm,P,N)} for decode."""
    tp = SH.active_axis(cfg.axes.model)
    if tp is not None and cfg.ssm_d_inner % tp.size == 0:
        return _mamba_tp(cfg, p, x, tp, cache)
    B, T, d = x.shape
    dt_ = x.dtype
    di, N, Hm = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    Pd = di // Hm

    z = x @ p["w_z"].to(dt_)
    xin = x @ p["w_x"].to(dt_)
    conv_state = cache.get("conv") if cache else None
    xin, new_conv = _causal_conv(xin, p["conv_w"], conv_state)
    xin = F.silu(xin)

    Bm = (x @ p["w_B"].to(dt_)).to(_F32)
    Cm = (x @ p["w_C"].to(dt_)).to(_F32)
    dtv = F.softplus((x @ p["w_dt"].to(dt_)).to(_F32) + p["dt_bias"])
    log_a = -torch.exp(p["A_log"])[None, None] * dtv       # (B,T,Hm) < 0

    xh = xin.to(_F32).reshape(B, T, Hm, Pd)
    if cache is None or T > 1:
        h0 = cache.get("h") if cache else None
        y, h = ssd_scan(xh, dtv, Bm, Cm, log_a, chunk=min(128, T), h0=h0)
    else:
        # single-step decode: h = a h + dt B (x) ; y = C . h
        a = torch.exp(log_a[:, 0])                         # (B,Hm)
        contrib = torch.einsum("bh,bn,bhp->bhpn", dtv[:, 0], Bm[:, 0],
                               xh[:, 0])
        h = a[:, :, None, None] * cache["h"] + contrib
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], h)[:, None]
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(B, T, di).to(dt_)
    y = rms_norm(y * F.silu(z), p["norm"])
    out = y @ p["w_out"].to(dt_)
    new_cache = {"conv": new_conv, "h": h} if cache is not None else None
    return out, new_cache


def _mamba_tp(cfg, p, x, ax, cache=None):
    """The block tensor-parallel over ``ax`` (see the module's docstring):
    ``x`` and the output replicated over the axis.  Returns ``(out, new
    cache)``, the cache None without one.  With a cache (serving) it is
    this rank's block by its fitted spec: ``conv`` its channels of
    ``d_inner``; ``h`` its SSM heads where they divide the axis (then the
    block is whole heads), else every head on every rank.  A whole ``h``
    is stepped whole on every rank from the channels all-gathered (an
    activation of ``d_inner``) at decode, and gathered from the ranks'
    blocks once after a prefill."""
    B, T, d = x.shape
    dt_ = x.dtype
    di, Hm, N = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_state
    Pd = di // Hm
    m, n, r = ax.name, ax.size, ax.index
    cb = di // n                      # this rank's channels of d_inner
    g = math.gcd(Pd, cb)              # channels a head of the block
    head = torch.div(r * cb + g * torch.arange(cb // g, device=x.device), Pd,
                     rounding_mode="floor")      # each one's real head
    whole_h = Hm % n != 0             # the fitted spec keeps h whole
    x = SH.copy_to_axis(x, m)

    def col(name, dim):               # this rank's block of d_inner
        return SH.block_of(p[name], m, di, dim)

    def rep(name):                    # replicated, read in part by each rank
        return SH.copy_to_axis(p[name], m)

    z = x @ col("w_z", 1).to(dt_)
    xin, new_conv = _causal_conv(x @ col("w_x", 1).to(dt_), col("conv_w", 1),
                                 None if cache is None else cache["conv"])
    xin = F.silu(xin)
    Bm = (x @ rep("w_B").to(dt_)).to(_F32)
    Cm = (x @ rep("w_C").to(dt_)).to(_F32)
    dt_all = F.softplus((x @ rep("w_dt").to(dt_)).to(_F32) + rep("dt_bias"))
    dtv = dt_all[..., head]
    A = -torch.exp(rep("A_log"))
    log_a = A[head][None, None] * dtv
    xh = xin.to(_F32).reshape(B, T, cb // g, g)
    new_h = None
    if cache is not None and T == 1 and whole_h:
        # every head stepped on every rank: h = a h + dt B (x) ; y = C . h
        xw = SH.all_gather(xin.to(_F32), m, -1).reshape(B, Hm, Pd)
        a = torch.exp(A[None] * dt_all[:, 0])
        new_h = a[:, :, None, None] * cache["h"] + torch.einsum(
            "bh,bn,bhp->bhpn", dt_all[:, 0], Bm[:, 0], xw)
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], new_h).reshape(B, 1, di)
        y = y[..., r * cb:(r + 1) * cb].reshape(B, 1, cb // g, g)
    elif cache is not None and T == 1:
        h = cache["h"].reshape(B, cb // g, g, N)
        h = torch.exp(log_a[:, 0])[:, :, None, None] * h + torch.einsum(
            "bh,bn,bhp->bhpn", dtv[:, 0], Bm[:, 0], xh[:, 0])
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], h)[:, None]
        new_h = h.reshape(cache["h"].shape)
    else:
        h0 = None
        if cache is not None:
            h0 = (cache["h"].reshape(B, di // g, g, N)[:, r * cb // g:
                                                        (r + 1) * cb // g]
                  if whole_h else cache["h"].reshape(B, cb // g, g, N))
        y, h = ssd_scan(xh, dtv, Bm, Cm, log_a, chunk=min(128, T), h0=h0)
        if cache is not None:
            new_h = (SH.all_gather(h, m, 1) if whole_h else h).reshape(
                cache["h"].shape)
    y = y + rep("D")[head][None, None, :, None] * xh
    y = y.reshape(B, T, cb).to(dt_)
    y = rms_norm_tp(y * F.silu(z), col("norm", 0), di, m)
    out = SH.reduce_from_axis(y @ col("w_out", 0).to(dt_), m)
    if cache is None:
        return out, None
    return out, {"conv": new_conv, "h": new_h}


def init_mamba_cache(cfg, B, dtype=torch.float32, device=None):
    di, N, Hm = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "conv": torch.zeros((B, CONV_K - 1, di), dtype=dtype, device=device),
        "h": torch.zeros((B, Hm, di // Hm, N), dtype=_F32, device=device),
    }
