"""Selective SSM (Mamba) block in the chunked SSD formulation.

The twin of ``repro.layers.mamba``: intra-chunk work is (Q x Q) matmuls,
inter-chunk state a small sequential carry (a Python loop over chunks where
the reference scans).  Shapes: heads ``Hm`` with head dim ``P`` (d_inner =
Hm * P), state size ``N``.  Per-step decay is scalar-per-head:
a_t = exp(-exp(A_log) * dt_t).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._cumsum import cumsum
from .norms import rms_norm
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


def init_mamba_cache(cfg, B, dtype=torch.float32, device=None):
    di, N, Hm = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    return {
        "conv": torch.zeros((B, CONV_K - 1, di), dtype=dtype, device=device),
        "h": torch.zeros((B, Hm, di // Hm, N), dtype=_F32, device=device),
    }
