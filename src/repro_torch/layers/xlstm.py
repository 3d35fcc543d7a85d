"""xLSTM blocks: chunked-parallel mLSTM (matrix memory) and recurrent sLSTM.

The twin of ``repro.layers.xlstm``.  mLSTM is linear attention with
exponential gating and a matrix state C in R^{hd x hd}, in the stabilized
chunkwise form (log-space gates, running max stabilizer); ``mlstm_sequential``
is the step oracle.  sLSTM has recurrent gate weights and runs step by step.
The reference's scans are Python loops here.

Under a registered model axis (``cfg.axes.model``, the sharded trainer)
the training blocks run tensor-parallel as the reference's GSPMD program
partitions them by its path rules, ``x`` and the output replicated over
the axis:

* mLSTM: each rank a block of the ``H * hd`` value channels (``wv`` by
  column, ``wo`` by row, its partial sums reduced over the axis).  A value
  channel reads its head's whole q and k and gates, so the block runs as
  heads of ``gcd(hd, H * hd / n)`` value channels, each with its real
  head's q, k (from this rank's columns of ``wq`` / ``wk`` where the block
  is whole heads, else from the weights gathered whole) and gates (``wi``,
  ``wf``, ``f_bias`` replicated).  The norm sums its squares over the axis.
* sLSTM: the recurrence couples a head's channels step by step, so each
  rank runs whole heads (``w_z`` by column, the other gates' replicated
  weights and biases read by block, ``r_*`` by head), with no collective in
  the time loop; the norm sums its squares over the axis and ``w_out`` is
  row-parallel.  Where the heads do not divide the axis every rank runs
  the whole block, its sharded weights gathered.

Sharded serving keeps the cache in this rank's block by its fitted spec
(heads for mLSTM where they divide the axis, else whole; ``H * hd``
channels for sLSTM) and steps it in the same decompositions
(:func:`_mlstm_tp`, :func:`_slstm_tp`, :func:`_slstm_channels`).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import sharding as SH

from .norms import rms_norm, rms_norm_tp
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


def _mlstm_zero(B, H, hd, device, hd_v=None):
    return (torch.zeros((B, H, hd, hd if hd_v is None else hd_v),
                        dtype=_F32, device=device),
            torch.zeros((B, H, hd), dtype=_F32, device=device),
            torch.full((B, H), -1e30, dtype=_F32, device=device))


def mlstm_scan(q, k, v, log_i, log_f, *, chunk=128, state=None):
    """q,k (B,T,H,hd), v (B,T,H,hd_v) f32; log_i/log_f (B,T,H).  Returns
    (h, state)."""
    B, T, H, hd = q.shape
    Q = max(1, min(chunk, T))
    while T % Q:
        Q -= 1
    if state is None:
        state = _mlstm_zero(B, H, hd, q.device, v.shape[-1])
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
    tp = SH.active_axis(cfg.axes.model)
    if tp is not None and cfg.n_heads * cfg.head_dim % tp.size == 0:
        return _mlstm_tp(cfg, p, x, tp, cache)
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


def _mlstm_tp(cfg, p, x, ax, cache=None):
    """The block tensor-parallel over ``ax`` (see the module's docstring).
    Returns ``(out, new cache)``, the cache None without one.  With a cache
    (serving) it is this rank's block by its fitted spec: its heads where
    they divide the axis (the block is whole heads), else every head on
    every rank.  A whole state is stepped whole on every rank at decode
    (q, k and v all-gathered: activations of ``H * hd``), and after a
    prefill gathered from the ranks' blocks of value channels once."""
    B, T, d = x.shape
    dt_ = x.dtype
    H, hd = cfg.n_heads, cfg.head_dim
    m, n, r = ax.name, ax.size, ax.index
    cb = H * hd // n                  # this rank's value channels
    g = math.gcd(hd, cb)              # value channels a head of the block
    head = torch.div(r * cb + g * torch.arange(cb // g, device=x.device), hd,
                     rounding_mode="floor")      # each one's real head
    whole_c = H % n != 0              # the fitted spec keeps the state whole
    x = SH.copy_to_axis(x, m)

    def qk(name):
        if cb % hd == 0:              # whole heads: this rank's columns
            w = SH.block_of(p[name], m, H * hd, 1)
            return (x @ w.to(dt_)).reshape(B, T, cb // hd, hd).to(_F32)
        lo, hi = r * cb // hd, (r * cb + cb - 1) // hd + 1
        w = SH.whole_of(p[name], m, H * hd, 1)[:, lo * hd:hi * hd]
        y = (x @ w.to(dt_)).reshape(B, T, hi - lo, hd).to(_F32)
        return y[:, :, head - lo]

    log_i = (x @ SH.copy_to_axis(p["wi"], m).to(dt_)).to(_F32)
    log_f = F.logsigmoid((x @ SH.copy_to_axis(p["wf"], m).to(dt_)).to(_F32)
                         + SH.copy_to_axis(p["f_bias"], m))
    if cache is not None and T == 1 and whole_c:
        # every head stepped on every rank from the whole q, k, v
        def whole(name):
            y = x @ SH.block_of(p[name], m, H * hd, 1).to(dt_)
            return SH.all_gather(y, m, -1).reshape(B, T, H, hd).to(_F32)
        h, state = mlstm_sequential(whole("wq"), whole("wk") * hd ** -0.5,
                                    whole("wv"), log_i, log_f,
                                    state=cache["mlstm"])
        h = h.reshape(B, T, H * hd)[..., r * cb:(r + 1) * cb]
    else:
        q = qk("wq")
        k = qk("wk") * hd ** -0.5
        v = (x @ SH.block_of(p["wv"], m, H * hd, 1).to(dt_)).reshape(
            B, T, cb // g, g).to(_F32)
        state = None if cache is None else cache["mlstm"]
        if state is not None and whole_c:
            # this rank's heads of g value channels of the whole state
            C, nn, mm = state
            C = C.reshape(B, H, hd, hd // g, g).permute(0, 1, 3, 2, 4)
            C = C.reshape(B, H * hd // g, hd, g)[:, r * cb // g:
                                                 (r + 1) * cb // g]
            state = (C, nn[:, head], mm[:, head])
        if cache is not None and T == 1:
            h, state = mlstm_sequential(q, k, v, log_i[..., head],
                                        log_f[..., head], state=state)
        else:
            h, state = mlstm_scan(q, k, v, log_i[..., head],
                                  log_f[..., head], chunk=min(128, T),
                                  state=state)
        if cache is not None and whole_c:
            # the blocks' heads of g value channels back to whole heads
            C, nn, mm = (SH.all_gather(t, m, 1) for t in state)
            C = C.reshape(B, H, hd // g, hd, g).permute(0, 1, 3, 2, 4)
            state = (C.reshape(B, H, hd, hd), nn[:, ::hd // g],
                     mm[:, ::hd // g])
    h = rms_norm_tp(h.reshape(B, T, cb).to(dt_),
                    SH.block_of(p["norm"], m, H * hd, 0), H * hd, m)
    out = SH.reduce_from_axis(
        h @ SH.block_of(p["wo"], m, H * hd, 0).to(dt_), m)
    return out, (None if cache is None else {"mlstm": state})


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
        return torch.einsum("bhd,hde->bhe", hf,
                            p[f"r_{g}"].to(hf.dtype)).reshape(B, H * hd)
    return _slstm_gates(carry, xw, rec)


def _slstm_gates(carry, xw, rec):
    """The step's gates and state update, elementwise in the channels of
    ``carry`` and ``xw`` (``rec(g)``: gate ``g``'s recurrent input)."""
    c, n, h, m = carry
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
    tp = SH.active_axis(cfg.axes.model)
    block = None                      # this rank's channels of the cache
    if tp is not None:
        H, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
        if H % tp.size == 0:
            return _slstm_tp(cfg, p, x, tp, cache)
        if cache is not None and H * hd % tp.size == 0:
            if x.shape[1] == 1:
                return _slstm_channels(cfg, p, x, tp, cache)
            cb = H * hd // tp.size
            block = slice(tp.index * cb, (tp.index + 1) * cb)
            cache = {"slstm": tuple(SH.all_gather(t, tp.name, -1)
                                    for t in cache["slstm"])}
        # every rank runs the whole block: its sharded weights gathered
        p = dict(p, w_z=SH.replica_of(p["w_z"], tp.name, H * hd, 1),
                 w_out=SH.replica_of(p["w_out"], tp.name, d, 0))
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
    if block is not None:
        carry = tuple(t[:, block] for t in carry)
    new_cache = {"slstm": carry} if cache is not None else None
    return y, new_cache


def _slstm_channels(cfg, p, x, ax, cache):
    """One decode step with the heads not dividing ``ax`` and the cache
    this rank's block of ``H * hd`` channels (its fitted spec's): the
    rank's channels of every gate, their recurrent input from the whole
    ``h`` (all-gathered, an activation of ``H * hd``) through ``r_*``
    (whole: they do not split), the update elementwise on its channels;
    the norm sums its squares over the axis and ``w_out`` is
    row-parallel."""
    B, _, d = x.shape
    dt_ = x.dtype
    H, hd = cfg.n_heads, cfg.head_dim
    m, n, r = ax.name, ax.size, ax.index
    cb = H * hd // n
    x = SH.copy_to_axis(x, m)

    def col(name, dim):
        return SH.block_of(p[name], m, H * hd, dim)

    xw = torch.stack([(x[:, 0] @ col(f"w_{g}", 1).to(dt_))
                      + col(f"b_{g}", 0).to(dt_)
                      for g in ("z", "i", "f", "o")], dim=1).to(_F32)
    carry = cache["slstm"]
    hf = SH.all_gather(carry[2], m, -1).reshape(B, H, hd)

    def rec(g):
        y = torch.einsum("bhd,hde->bhe", hf, p[f"r_{g}"].to(hf.dtype))
        return y.reshape(B, H * hd)[:, r * cb:(r + 1) * cb]
    carry = _slstm_gates(carry, xw, rec)
    y = rms_norm_tp(carry[2][:, None].to(dt_),
                    SH.block_of(p["norm"], m, d, 0), d, m)
    y = SH.reduce_from_axis(y @ SH.block_of(p["w_out"], m, d, 0).to(dt_), m)
    return y, {"slstm": carry}


def _slstm_tp(cfg, p, x, ax, cache=None):
    """The block tensor-parallel over ``ax``: this rank's heads (see the
    module's docstring), the cache (serving) this rank's block of their
    channels.  Returns ``(out, new cache)``, the cache None without
    one."""
    B, T, d = x.shape
    dt_ = x.dtype
    H, hd = cfg.n_heads, cfg.head_dim
    m, n = ax.name, ax.size
    cb = H * hd // n
    x = SH.copy_to_axis(x, m)

    def col(name, dim):
        return SH.block_of(p[name], m, H * hd, dim)

    xw = torch.stack([(x @ col(f"w_{g}", 1).to(dt_)) + col(f"b_{g}", 0).to(dt_)
                      for g in ("z", "i", "f", "o")], dim=2).to(_F32)
    local = {f"r_{g}": SH.block_of(p[f"r_{g}"], m, H, 0)
             for g in ("z", "i", "f", "o")}
    lcfg = dataclasses.replace(cfg, n_heads=H // n)
    if cache is not None:
        carry = cache["slstm"]
    else:
        zero = torch.zeros((B, cb), dtype=_F32, device=x.device)
        carry = (zero, zero, zero, torch.full_like(zero, -1e30))
    hs = []
    for t in range(T):
        carry = _slstm_step(lcfg, local, carry, xw[:, t])
        hs.append(carry[2])
    hs = torch.stack(hs, dim=1).to(dt_)
    y = rms_norm_tp(hs, SH.block_of(p["norm"], m, d, 0), d, m)
    y = SH.reduce_from_axis(y @ SH.block_of(p["w_out"], m, d, 0).to(dt_), m)
    return y, (None if cache is None else {"slstm": carry})
