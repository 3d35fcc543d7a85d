"""Kernel 6: flash attention, forward (the twin of
``repro.kernels.flash_attention``).

Online-softmax attention: f32 running max / sum / accumulator, scale
``hd ** -0.5`` after the f32 ``q . k``, causal and sliding-window masks that
write the finite ``NEG_INF = -1e30``, P rounded to v's dtype before ``P . V``.
On a CUDA tensor both entry points launch ``csrc/flash_attention.cu``, which
addresses heads by strides: :func:`flash_attention_gqa` hands it the
``(B, S, H, hd)`` / ``(B, S, KV, hd)`` tensors as they are, and query head
``h`` reads kv head ``h // G``.  It has four paths, chosen in one place,
:func:`_path`, and counted in ``FLASH.paths`` by label: bf16 and f16 at a
head dim of 33 to 256 take ``"wgmma"`` (Hopper's warpgroup tensor cores,
fed by TMA through tensor maps of the views' own strides) where every base
and stepped stride is a multiple of 16 bytes, which TMA needs; other bf16 /
f16 views take ``"mma"`` (``mma.sync``) up to 128 and ``"fma"`` above; f32
takes ``"fma"`` (full f32 products, as the reference's f32 dot); a head dim
above 256 takes ``"chunked"`` (the FMA path's arithmetic over the head dim
in chunks), in every dtype.  Up to 256 the kernel runs a head dim on the
next larger of its instance widths with the columns past ``hd``
zero; q, k and v of different dtypes are cast up to
their promoted dtype first (exactly) and the result comes back in q's
dtype, as the reference's dots promote.  On a CPU tensor they take the plain
version, :func:`flash_attention_plain`, which runs the reference's own
update over the reference's ``(q_chunk, kv_chunk)`` blocks; the chunks shape
only that version (the kernel has its own tiles).  On a meta tensor the dry
run (an active ``launch.op_cost.OpCost``) takes the plain version's shapes
and counts the call as one op (:func:`repro_torch.launch.op_cost.one_op`);
elsewhere a meta tensor raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.launch import op_cost

from . import _build, maps

__all__ = ["flash_attention", "flash_attention_gqa", "flash_attention_plain",
           "flash_attention_gqa_plain", "flash_args", "FLASH", "PATHS",
           "NEG_INF"]

NEG_INF = -1e30
_FMA_HEAD_DIM = 256         # the widest FMA instance; above it, chunked
_MMA_HEAD_DIM = 128         # the widest mma.sync instance
_WGMMA_HEAD_DIMS = (33, 256)    # the head dims the wgmma path takes

# The kernel's code paths, by their index in FlashArgs.path
PATHS = ("fma", "mma", "chunked", "wgmma")


def _path(dtype: torch.dtype, hd: int, vec: bool) -> int:
    """The path a launch takes: the only place the choice is made (the C
    entry point launches the path named in the arguments and refuses one
    that does not fit the dtype, head dim or alignment).  ``vec``: every
    base and stepped stride is a multiple of 16 bytes, as TMA needs."""
    if hd > _FMA_HEAD_DIM:
        return PATHS.index("chunked")
    if dtype == torch.float32:
        return PATHS.index("fma")
    lo, hi = _WGMMA_HEAD_DIMS
    if vec and lo <= hd <= hi:
        return PATHS.index("wgmma")
    return PATHS.index("mma" if hd <= _MMA_HEAD_DIM else "fma")


FLASH = _build.register(_build.Kernel(
    "flash_attention", "flash_attention.cu", "xdma_flash_attention",
    [ctypes.c_void_p] * 5,
    replaces="src/repro/kernels/flash_attention.py:80"))


class _FlashArgs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int64) for name in (
        "B", "H", "G", "Sq", "Sk", "hd", "causal", "has_window", "window",
        "dtype", "vec", "path")] + [("scale", ctypes.c_double)] + [
        (name, ctypes.c_int64) for name in (
            "q_sb", "q_sh", "q_ss", "k_sb", "k_sh", "k_ss",
            "v_sb", "v_sh", "v_ss", "o_sb", "o_sh", "o_ss")]


def _chunk(c: int, extent: int) -> int:
    """The reference's block: the largest divisor of ``extent`` <= ``c``."""
    c = min(c, extent)
    while extent % c:
        c -= 1
    return c


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          q_chunk: int = 512, kv_chunk: int = 512):
    """The plain version: the reference kernel's update, block by block."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    qc, kc = _chunk(q_chunk, Sq), _chunk(kv_chunk, Sk)
    scale = hd ** -0.5
    f32 = torch.float32
    kf, vf = k.to(f32), v.to(f32)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for i in range(0, Sq, qc):
        qb = q[:, i:i + qc].to(f32)
        qp = torch.arange(i, i + qc, device=q.device)[:, None]
        m = torch.full((BH, qc, 1), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((BH, qc, 1), dtype=f32, device=q.device)
        acc = torch.zeros((BH, qc, hd), dtype=f32, device=q.device)
        for j in range(0, Sk, kc):
            s = torch.matmul(qb, kf[:, j:j + kc].transpose(1, 2)) * scale
            kp = torch.arange(j, j + kc, device=q.device)[None, :]
            if causal:
                s = torch.where(kp <= qp, s, NEG_INF)
            if window is not None:
                s = torch.where(kp > qp - window, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            # P in v's dtype, products and sums in f32 (the reference's
            # preferred_element_type)
            acc = acc * corr + torch.matmul(p.to(v.dtype).to(f32),
                                            vf[:, j:j + kc])
            m = m_new
        out[:, i:i + qc] = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out


def flash_attention_gqa_plain(q, k, v, *, causal=True, window=None,
                              q_chunk: int = 512, kv_chunk: int = 512):
    """The plain GQA form, as the reference builds it: heads folded into the
    batch, K/V repeated over each group of H // KV query heads."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd)
    kf = k.transpose(1, 2).repeat_interleave(G, dim=1).reshape(B * H, Sk, hd)
    vf = v.transpose(1, 2).repeat_interleave(G, dim=1).reshape(B * H, Sk, hd)
    o = flash_attention_plain(qf, kf, vf, causal=causal, window=window,
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    return o.reshape(B, H, Sq, hd).transpose(1, 2)


def flash_args(q, k, v, out, *, causal: bool, window: Optional[int]
               ) -> _FlashArgs:
    """Kernel 6's arguments for ``q``/``out`` (B, Sq, H, hd) and ``k``/``v``
    (B, Sk, KV, hd), strided views whose head dim is contiguous; query head
    ``h`` reads kv head ``h // (H // KV)``.  A (BH, S, hd) tensor enters as
    its (BH, S, 1, hd) view.  ``vec`` is 1 when every base address and every
    stride the kernel steps by is a multiple of 16 bytes (TMA's rule, and
    the mma path's 16-byte copies); ``path`` is :func:`_path`'s."""
    a = _FlashArgs()
    a.B, a.Sq, a.H, a.hd = q.shape
    a.G = a.H // k.shape[2]
    a.Sk = k.shape[1]
    a.causal = int(bool(causal))
    a.has_window = int(window is not None)
    a.window = 0 if window is None else int(window)
    a.dtype = maps.dtype_code(q.dtype)
    a.scale = a.hd ** -0.5
    a.vec = 1
    for name, t in (("q", q), ("k", k), ("v", v), ("o", out)):
        sb, ss, sh, sd = t.stride()
        if sd != 1 and t.shape[3] > 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
        setattr(a, f"{name}_sb", sb)
        setattr(a, f"{name}_ss", ss)
        setattr(a, f"{name}_sh", sh)
        steps = [st for n, st in zip(t.shape[:3], (sb, ss, sh)) if n > 1]
        if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                    for st in steps):
            a.vec = 0
    a.path = _path(q.dtype, a.hd, bool(a.vec))
    return a


def _launch(q, k, v, out, *, causal: bool, window):
    """Kernel 6 over (B, S, heads, hd) views; writes ``out`` (q's dtype)."""
    if q.shape[3] < 1:
        raise ValueError(f"head dim {q.shape[3]}: nothing to attend over")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    dtype = torch.promote_types(torch.promote_types(q.dtype, k.dtype),
                                v.dtype)
    maps.dtype_code(dtype)                  # raises on a dtype it does not run
    q, k, v = (t.to(dtype) for t in (q, k, v))
    res = out if out.dtype == dtype else torch.empty(
        out.shape, dtype=dtype, device=out.device)
    a = flash_args(q, k, v, res, causal=causal, window=window)
    FLASH(ctypes.addressof(a), q.data_ptr(), k.data_ptr(), v.data_ptr(),
          res.data_ptr(), path=PATHS[a.path])
    if res is not out:
        out.copy_(res)
    return out


def _check(q, k, v, rank: int):
    if q.dim() != rank or k.dim() != rank or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit together")


@op_cost.one_op
def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_chunk: int = 512, kv_chunk: int = 512):
    """q (BH, Sq, hd); k, v (BH, Sk, hd).  Returns (BH, Sq, hd)."""
    _check(q, k, v, 3)
    if op_cost.plain_on(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no flash attention kernel for {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), out.unsqueeze(2),
            causal=causal, window=window)
    return out


@op_cost.one_op
def flash_attention_gqa(q, k, v, *, causal=True, window=None,
                        q_chunk: int = 512, kv_chunk: int = 512):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) -> (B,Sq,H,hd) via the kernel."""
    _check(q, k, v, 4)
    H, KV = q.shape[2], k.shape[2]
    if KV <= 0 or H % KV:
        raise ValueError(f"{H} query heads do not share {KV} kv heads evenly")
    if op_cost.plain_on(q):
        return flash_attention_gqa_plain(q, k, v, causal=causal, window=window,
                                         q_chunk=q_chunk, kv_chunk=kv_chunk)
    if q.device.type != "cuda":
        raise NotImplementedError(f"no flash attention kernel for {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, out, causal=causal, window=window)
