"""Parity of the port's flash attention (kernel 6) with the reference's.

The same numpy inputs go through the reference's Pallas kernel (interpret
mode, as ``tests/test_flash_kernel.py`` runs it) and through the port on the
CPU, which takes the plain version: rtol/atol 2e-5 on f32, 2e-2 on bf16.
The CUDA kernel's algorithm — 64 x 64 tiles, its key-block skip rule, the
ragged last block, strided heads read in place for GQA — is checked on the
CPU by an emulation over the kernel's own argument struct; the kernel itself
by the ``cuda`` tests on a GPU.
"""
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as rref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as r_flash  # noqa: E402
from repro.kernels.flash_attention import flash_attention_gqa as r_gqa  # noqa: E402
from repro_torch.kernels import flash_attention as PF  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402
from torch_parity import reset_global_state, to_f32, to_torch  # noqa: E402,F401

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _both(fn_ref, fn_port, arrays, **kw):
    want = fn_ref(*(jnp.asarray(a) for a in arrays), **kw)
    got = fn_port(*(to_torch(a) for a in arrays), **kw)
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).replace("torch.", "") == want.dtype.name
    return to_f32(got), to_f32(want)


@pytest.mark.parametrize("BH,S,hd", [(2, 64, 32), (3, 128, 64), (1, 96, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_flash_matches_reference(BH, S, hd, causal, chunk):
    arrays = [rand((BH, S, hd), i) for i in range(3)]
    got, want = _both(r_flash, PF.flash_attention, arrays, causal=causal,
                      q_chunk=chunk, kv_chunk=chunk)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("window", [8, 24, 64])
def test_flash_window(window):
    arrays = [rand((2, 128, 32), i + 10) for i in range(3)]
    got, want = _both(r_flash, PF.flash_attention, arrays, causal=True,
                      window=window, q_chunk=32, kv_chunk=32)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None)])
def test_flash_bf16(causal, window):
    import ml_dtypes
    arrays = [rand((2, 96, 32), i + 20).astype(ml_dtypes.bfloat16)
              for i in range(3)]
    got, want = _both(r_flash, PF.flash_attention, arrays, causal=causal,
                      window=window, q_chunk=16, kv_chunk=64)
    np.testing.assert_allclose(got, want, **BF16_TOL)


@pytest.mark.parametrize("dtype,window", [("float32", None),
                                          ("float32", 24),
                                          ("bfloat16", None)])
def test_flash_gqa_matches_reference(dtype, window):
    import ml_dtypes
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    q = rand((2, 96, 8, 32), 30).astype(dt)
    k = rand((2, 96, 2, 32), 31).astype(dt)
    v = rand((2, 96, 2, 32), 32).astype(dt)
    got, want = _both(r_gqa, PF.flash_attention_gqa, [q, k, v],
                      window=window, q_chunk=32, kv_chunk=64)
    np.testing.assert_allclose(got, want,
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None), (False, 16)])
def test_attention_ref_twin(causal, window):
    arrays = [rand((2, 80, 16), i + 40) for i in range(3)]
    got, want = _both(rref.attention_ref, pref.attention_ref, arrays,
                      causal=causal, window=window)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_flash_refuses_shapes_that_do_not_fit():
    q = torch.zeros(2, 64, 4, 32)
    with pytest.raises(ValueError, match="evenly"):
        PF.flash_attention_gqa(q, torch.zeros(2, 64, 3, 32),
                               torch.zeros(2, 64, 3, 32))
    with pytest.raises(ValueError, match="fit together"):
        PF.flash_attention(q[:, :, 0], torch.zeros(2, 64, 16),
                           torch.zeros(2, 64, 16))


@pytest.mark.parametrize("fn,rank", [(PF.flash_attention, 3),
                                     (PF.flash_attention_gqa, 4)])
def test_flash_launches_or_raises_off_the_cpu(fn, rank):
    q = torch.empty((1, 64, 1, 32) if rank == 4 else (1, 64, 32),
                    device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        fn(q, q, q)


# -- kernel 6's algorithm over its own arguments, emulated --------------------
_DTYPE_OF = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}


def _emulate_flash(qf, kf, vf, a, out_numel):
    """``csrc/flash_attention.cu`` step by step over flat buffers: 64 x 64
    tiles, the key-block skip rule, keys past Sk at -inf, -1e30 masks, P
    rounded to the dtype, the output rounded once."""
    BQ = BK = 64
    d = torch.arange(a.hd)
    scale = torch.tensor(a.scale, dtype=torch.float32)
    out = torch.full((out_numel,), float("nan"))

    def lo(qp):
        return max(0, qp - a.window + 1) if a.has_window else 0

    def hi(qp):
        return min(qp, a.Sk - 1) if a.causal else a.Sk - 1

    for bh in range(a.B * a.H):
        b, h = divmod(bh, a.H)
        hk = h // a.G

        def tile(flat, sb, sh, ss, head, pos, limit):
            t = torch.zeros(len(pos), a.hd)
            ok = pos < limit
            idx = b * sb + head * sh + pos[ok, None] * ss + d[None, :]
            t[ok] = flat[idx].float()
            return t

        for q0 in range(0, a.Sq, BQ):
            rows = torch.arange(q0, q0 + BQ)
            Q = tile(qf, a.q_sb, a.q_sh, a.q_ss, h, rows, a.Sq)
            q1 = min(q0 + BQ, a.Sq) - 1
            kbeg, kend = 0, a.Sk
            if lo(q1) <= hi(q1):
                kbeg, kend = lo(q0) // BK * BK, hi(q1) + 1
            m = torch.full((BQ,), PF.NEG_INF)
            l = torch.zeros(BQ)
            acc = torch.zeros(BQ, a.hd)
            for k0 in range(kbeg, kend, BK):
                cols = torch.arange(k0, k0 + BK)
                K = tile(kf, a.k_sb, a.k_sh, a.k_ss, hk, cols, a.Sk)
                V = tile(vf, a.v_sb, a.v_sh, a.v_ss, hk, cols, a.Sk)
                s = (Q @ K.T) * scale
                qp, kp = rows[:, None], cols[None, :]
                masked = torch.zeros(BQ, BK, dtype=torch.bool)
                if a.causal:
                    masked |= kp > qp
                if a.has_window:
                    masked |= kp <= qp - a.window
                s = torch.where(masked, PF.NEG_INF, s)
                s = torch.where(kp >= a.Sk, float("-inf"), s)
                m_new = torch.maximum(m, s.amax(1))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new[:, None])
                l = l * corr + p.sum(1)
                p = p.to(_DTYPE_OF[a.dtype]).float()
                acc = acc * corr[:, None] + p @ V
                m = m_new
            o = acc / torch.clamp(l, min=1e-30)[:, None]
            ok = rows < a.Sq
            idx = b * a.o_sb + h * a.o_sh + rows[ok, None] * a.o_ss + d[None, :]
            out[idx] = o[ok].to(_DTYPE_OF[a.dtype]).float()
    return out


def _emulated(q, k, v, causal, window, gqa):
    """Kernel 6's arguments as the wrapper builds them, then the emulation."""
    if gqa:
        out = torch.empty(q.shape, dtype=q.dtype)
        views = (q, k, v, out)
    else:
        out = torch.empty(q.shape, dtype=q.dtype)
        views = tuple(t.unsqueeze(2) for t in (q, k, v, out))
    a = PF.flash_args(*views, causal=causal, window=window)
    flat = _emulate_flash(*(t.reshape(-1) for t in (q, k, v)), a, out.numel())
    assert not torch.isnan(flat).any()
    return flat.reshape(out.shape), a


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (96, 96, True, None), (96, 96, False, None), (96, 96, True, 24),
    (200, 200, True, 70), (130, 130, False, 8), (40, 100, False, None),
    (100, 40, True, None), (130, 40, False, 8), (64, 64, True, 0)])
def test_kernel_algorithm_emulated_matches_reference(Sq, Sk, causal, window):
    """Covers the skip rule (windows, causal), ragged blocks, Sq != Sk, rows
    with no live key at all (the reference then averages every V row) and a
    window of 0."""
    q, k, v = rand((2, Sq, 16), 50), rand((2, Sk, 16), 51), rand((2, Sk, 16), 52)
    got, a = _emulated(*(to_torch(t) for t in (q, k, v)), causal, window,
                       gqa=False)
    assert (a.B, a.H, a.G, a.Sq, a.Sk, a.hd) == (2, 1, 1, Sq, Sk, 16)
    want = r_flash(*(jnp.asarray(t) for t in (q, k, v)), causal=causal,
                   window=window, q_chunk=32, kv_chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("dtype,window", [("float32", None),
                                          ("bfloat16", 24)])
def test_kernel_gqa_args_emulated_match_reference(dtype, window):
    """The GQA form is read in place: per-head strides, kv head h // G."""
    import ml_dtypes
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    q = rand((2, 80, 6, 16), 60).astype(dt)
    k = rand((2, 80, 2, 16), 61).astype(dt)
    v = rand((2, 80, 2, 16), 62).astype(dt)
    got, a = _emulated(*(to_torch(t) for t in (q, k, v)), True, window,
                       gqa=True)
    assert (a.B, a.H, a.G, a.q_sh, a.k_sh, a.q_ss, a.k_ss) == (
        2, 6, 3, 16, 16, 96, 32)
    want = r_gqa(*(jnp.asarray(t) for t in (q, k, v)), window=window,
                 q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), to_f32(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
