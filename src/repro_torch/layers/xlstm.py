"""xLSTM blocks: chunked-parallel mLSTM (matrix memory) and recurrent sLSTM.

The twin of ``repro.layers.xlstm``.  mLSTM is linear attention with
exponential gating and a matrix state C in R^{hd x hd}, in the stabilized
chunkwise form (log-space gates, running max stabilizer); ``mlstm_sequential``
is the step oracle.  sLSTM has recurrent gate weights and runs step by step.
The reference's scans are Python loops here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .norms import rms_norm
from ._cumsum import cumsum
from ._init import Init

_F32 = torch.float32


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def init_mlstm(init: Init, cfg):
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "wq": init.normal((d, H * hd), d ** -0.5),
        "wk": init.normal((d, H * hd), d ** -0.5),
        "wv": init.normal((d, H * hd), d ** -0.5),
        "wi": init.normal((d, H), d ** -0.5),
        "wf": init.normal((d, H), d ** -0.5),
        "f_bias": init.full((H,), 3.0),            # open forget gates at init
        "norm": init.ones((H * hd,)),
        "wo": init.normal((H * hd, d), (H * hd) ** -0.5),
    }


def _mlstm_chunk(state, q, k, v, li, lf):
    """state: (C (B,H,hd,hd), n (B,H,hd), m (B,H)); one chunk of inputs."""
    C, n, m = state
    B, Q, H, hd = q.shape
    Fc = cumsum(lf, 1)                                    # (B,Q,H)
    b = li - Fc                                           # log i_j - F_j
    b_run = torch.cummax(b, dim=1).values                 # running max, j<=i
    m_intra = Fc + b_run
    m_inter = Fc + m[:, None, :]
    m_i = torch.maximum(m_intra, m_inter)                 # (B,Q,H)

    w_inter = torch.exp(m_inter - m_i)
    num_inter = torch.einsum("bqhd,bhde->bqhe", q, C) * w_inter[..., None]
    den_inter = torch.einsum("bqhd,bhd->bqh", q, n) * w_inter

    logw = Fc[:, :, None, :] + b[:, None, :, :] - m_i[:, :, None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    w_intra = torch.exp(torch.where(mask[None, :, :, None], logw, -1e30))
    qk = torch.einsum("bqhd,bjhd->bqjh", q, k)            # (B,Q,Q,H)
    num_intra = torch.einsum("bqjh,bjhe->bqhe", w_intra * qk, v)
    den_intra = torch.einsum("bqjh->bqh", w_intra * qk)

    num = num_inter + num_intra
    den = den_inter + den_intra
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_i))[..., None]

    Ftot = Fc[:, -1]                                      # (B,H)
    b_max = b_run[:, -1]
    m_new = Ftot + torch.maximum(m, b_max)
    wC = torch.exp(Ftot + m - m_new)                      # (B,H)
    wj = torch.exp(Ftot[:, None] + b - m_new[:, None])    # (B,Q,H)
    C_new = wC[:, :, None, None] * C + torch.einsum("bjh,bjhd,bjhe->bhde",
                                                    wj, k, v)
    n_new = wC[:, :, None] * n + torch.einsum("bjh,bjhd->bhd", wj, k)
    return (C_new, n_new, m_new), h


def _mlstm_zero(B, H, hd, device):
    return (torch.zeros((B, H, hd, hd), dtype=_F32, device=device),
            torch.zeros((B, H, hd), dtype=_F32, device=device),
            torch.full((B, H), -1e30, dtype=_F32, device=device))


def mlstm_scan(q, k, v, log_i, log_f, *, chunk=128, state=None):
    """q,k,v (B,T,H,hd) f32; log_i/log_f (B,T,H).  Returns (h, state)."""
    B, T, H, hd = q.shape
    Q = max(1, min(chunk, T))
    while T % Q:
        Q -= 1
    if state is None:
        state = _mlstm_zero(B, H, hd, q.device)
    hs = []
    for c in range(T // Q):
        sl = slice(c * Q, (c + 1) * Q)
        state, h = _mlstm_chunk(state, q[:, sl], k[:, sl], v[:, sl],
                                log_i[:, sl], log_f[:, sl])
        hs.append(h)
    return torch.cat(hs, dim=1), state


def mlstm_sequential(q, k, v, log_i, log_f, state=None):
    """Step oracle (tests; and one-token decode)."""
    B, T, H, hd = q.shape
    C, n, m = state if state is not None else _mlstm_zero(B, H, hd, q.device)
    hs = []
    for t in range(T):
        m_new = torch.maximum(log_f[:, t] + m, log_i[:, t])
        fw = torch.exp(log_f[:, t] + m - m_new)
        iw = torch.exp(log_i[:, t] - m_new)
        C = fw[:, :, None, None] * C + iw[:, :, None, None] * torch.einsum(
            "bhd,bhe->bhde", k[:, t], v[:, t])
        n = fw[:, :, None] * n + iw[:, :, None] * k[:, t]
        m = m_new
        num = torch.einsum("bhd,bhde->bhe", q[:, t], C)
        den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q[:, t], n)),
                            torch.exp(-m))
        hs.append(num / den[..., None])
    return torch.stack(hs, 1), (C, n, m)


def mlstm_apply(cfg, p, x, *, cache=None):
    B, T, d = x.shape
    dt_ = x.dtype
    H, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"].to(dt_)).reshape(B, T, H, hd).to(_F32)
    k = (x @ p["wk"].to(dt_)).reshape(B, T, H, hd).to(_F32) * hd ** -0.5
    v = (x @ p["wv"].to(dt_)).reshape(B, T, H, hd).to(_F32)
    log_i = (x @ p["wi"].to(dt_)).to(_F32)
    log_f = F.logsigmoid((x @ p["wf"].to(dt_)).to(_F32) + p["f_bias"])
    state = cache.get("mlstm") if cache else None
    if cache is not None and T == 1:
        h, state = mlstm_sequential(q, k, v, log_i, log_f, state=state)
    else:
        h, state = mlstm_scan(q, k, v, log_i, log_f, chunk=min(128, T),
                              state=state)
    h = rms_norm(h.reshape(B, T, H * hd).to(dt_), p["norm"])
    out = h @ p["wo"].to(dt_)
    new_cache = {"mlstm": state} if cache is not None else None
    return out, new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def init_slstm(init: Init, cfg):
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    p = {"w_out": init.normal((d, d), d ** -0.5), "norm": init.ones((d,))}
    for g in ("z", "i", "f", "o"):
        p[f"w_{g}"] = init.normal((d, H * hd), d ** -0.5)
        p[f"r_{g}"] = init.normal((H, hd, hd), hd ** -0.5)
        p[f"b_{g}"] = (init.full((H * hd,), 3.0) if g == "f"
                       else init.zeros((H * hd,)))
    return p


def _slstm_step(cfg, p, carry, xw):
    """carry: (c, n, h, m) each (B,H*hd); xw: pre-projected inputs
    (B, 4, H*hd)."""
    c, n, h, m = carry
    B = c.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    hf = h.reshape(B, H, hd)

    def rec(g):
        return torch.einsum("bhd,hde->bhe", hf, p[f"r_{g}"]).reshape(B, H * hd)

    z = torch.tanh(xw[:, 0] + rec("z"))
    it = xw[:, 1] + rec("i")
    ft = xw[:, 2] + rec("f")
    o = torch.sigmoid(xw[:, 3] + rec("o"))
    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    iw = torch.exp(it - m_new)
    fw = torch.exp(lf + m - m_new)
    c = fw * c + iw * z
    n = fw * n + iw
    h = o * c / torch.clamp(n, min=1e-6)
    return (c, n, h, m_new)


def slstm_apply(cfg, p, x, *, cache=None, chunk=64):
    B, T, d = x.shape
    dt_ = x.dtype
    H, hd = cfg.n_heads, cfg.head_dim
    xw = torch.stack([
        (x @ p["w_z"].to(dt_)) + p["b_z"].to(dt_),
        (x @ p["w_i"].to(dt_)) + p["b_i"].to(dt_),
        (x @ p["w_f"].to(dt_)) + p["b_f"].to(dt_),
        (x @ p["w_o"].to(dt_)) + p["b_o"].to(dt_),
    ], dim=2).to(_F32)                                    # (B,T,4,H*hd)
    if cache is not None and cache.get("slstm") is not None:
        carry = cache["slstm"]
    else:
        zero = torch.zeros((B, H * hd), dtype=_F32, device=x.device)
        carry = (zero, zero, zero, torch.full_like(zero, -1e30))
    hs = []
    for t in range(T):
        carry = _slstm_step(cfg, p, carry, xw[:, t])
        hs.append(carry[2])
    hs = torch.stack(hs, dim=1).to(dt_)
    y = rms_norm(hs, p["norm"]) @ p["w_out"].to(dt_)
    new_cache = {"slstm": carry} if cache is not None else None
    return y, new_cache
