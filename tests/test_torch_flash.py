"""Parity of the port's flash attention (kernel 6) with the reference's.

The same numpy inputs go through the reference's Pallas kernel (interpret
mode, as ``tests/test_flash_kernel.py`` runs it) and through the port on the
CPU, which takes the plain version: rtol/atol 2e-5 on f32, 2e-2 on bf16.
The CUDA kernel's algorithm — 64 x 64 tiles, its key-block skip rule, the
ragged last block, strided heads read in place for GQA, and on the bf16 /
f16 path the exp2 softmax and masks on edge blocks only — is checked on the
CPU by an emulation over the kernel's own argument struct; the tensor-core
path's fragment maps (mma.m16n8k16, ldmatrix, the C -> A reuse of P) by
products built lane by lane and held bitwise against ``torch.matmul``; the
kernel itself by the ``cuda`` tests on a GPU.
"""
import math

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
    rounded to the dtype, the output rounded once.  f32 follows the FMA path
    (exp, every block masked), as does the chunked path (head dims above
    256, whose chunks keep the FMA path's sums); bf16 / f16 the mma path,
    as ``a.path`` names it: scores scaled by f32(hd^-0.5 * log2 e), exp2, and masks applied
    only on blocks that cross Sk, the causal diagonal or the window's lower
    edge (the emulation asserts that the other blocks mask nothing)."""
    BQ = BK = 64
    mma = PF.PATHS[a.path] == "mma"
    d = torch.arange(a.hd)
    if mma:
        scale = torch.tensor(a.scale * math.log2(math.e), dtype=torch.float32)
        exp = torch.exp2
    else:
        scale = torch.tensor(a.scale, dtype=torch.float32)
        exp = torch.exp
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
                past = (kp >= a.Sk).expand(BQ, BK)
                full = (k0 + BK <= a.Sk
                        and (not a.causal or k0 + BK - 1 <= q0)
                        and (not a.has_window or k0 > q1 - a.window))
                if mma and full:
                    live_rows = rows < a.Sq
                    assert not (masked | past)[live_rows].any()
                else:
                    s = torch.where(masked, PF.NEG_INF, s)
                    s = torch.where(past, float("-inf"), s)
                m_new = torch.maximum(m, s.amax(1))
                corr = exp(m - m_new)
                p = exp(s - m_new[:, None])
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (96, 96, True, None), (96, 96, False, None), (96, 96, True, 24),
    (200, 200, True, 70), (130, 130, False, 8), (40, 100, False, None),
    (100, 40, True, None), (130, 40, False, 8), (64, 64, True, 0)])
def test_kernel_algorithm_emulated_matches_reference(Sq, Sk, causal, window,
                                                     dtype):
    """Covers the skip rule (windows, causal), ragged blocks, Sq != Sk, rows
    with no live key at all (the reference then averages every V row) and a
    window of 0, on the FMA path (f32) and the mma path (bf16)."""
    import ml_dtypes
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    q, k, v = (rand((2, n, 16), 50 + i).astype(dt)
               for i, n in enumerate((Sq, Sk, Sk)))
    got, a = _emulated(*(to_torch(t) for t in (q, k, v)), causal, window,
                       gqa=False)
    assert (a.B, a.H, a.G, a.Sq, a.Sk, a.hd) == (2, 1, 1, Sq, Sk, 16)
    want = r_flash(*(jnp.asarray(t) for t in (q, k, v)), causal=causal,
                   window=window, q_chunk=32, kv_chunk=32)
    np.testing.assert_allclose(got.numpy(), to_f32(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("dtype,window", [("float32", None),
                                          ("bfloat16", 24),
                                          ("float16", 24)])
def test_kernel_gqa_args_emulated_match_reference(dtype, window):
    """The GQA form is read in place: per-head strides, kv head h // G."""
    import ml_dtypes
    dt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
          "float16": np.float16}[dtype]
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


@pytest.mark.parametrize("dtype,path", [(torch.float32, "fma"),
                                        (torch.bfloat16, "mma"),
                                        (torch.float16, "mma")])
def test_kernel_args_name_the_path_by_dtype(dtype, path):
    """The arguments carry the path the C entry point launches; the wrapper
    counts the launch under the same label."""
    q = torch.zeros(1, 8, 2, 16, dtype=dtype)
    k = torch.zeros(1, 8, 1, 16, dtype=dtype)
    a = PF.flash_args(q, k, k, torch.empty_like(q), causal=True, window=None)
    assert PF.PATHS[a.path] == path


@pytest.mark.parametrize("dtype,hd,path", [
    (torch.bfloat16, 8, "mma"), (torch.float16, 80, "mma"),
    (torch.bfloat16, 128, "mma"), (torch.bfloat16, 192, "fma"),
    (torch.float32, 256, "fma"), (torch.bfloat16, 320, "chunked"),
    (torch.float16, 512, "chunked"), (torch.float32, 257, "chunked")])
def test_kernel_args_name_the_path_by_head_dim(dtype, hd, path):
    """A head dim between the instance widths keeps its dtype's path and
    its own scale; from 129 to 256 every dtype takes the FMA path, above
    256 the chunked path."""
    q = torch.zeros(1, 8, 2, hd, dtype=dtype)
    k = torch.zeros(1, 8, 1, hd, dtype=dtype)
    a = PF.flash_args(q, k, k, torch.empty_like(q), causal=True, window=None)
    assert PF.PATHS[a.path] == path
    assert a.hd == hd and a.scale == hd ** -0.5


# -- head dims between the kernel's instance widths, and mixed dtypes --------
@pytest.mark.parametrize("hd", [8, 80])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_any_head_dim_matches_reference(hd, dtype):
    """The reference's Pallas kernel takes any head dim (its blocks are
    (1, qc, hd)); so does the port: hd 8 is the qwen2 smoke width, 80 lies
    between the kernel's instances."""
    import ml_dtypes
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    arrays = [rand((2, 96, hd), 70 + i).astype(dt) for i in range(3)]
    got, want = _both(r_flash, PF.flash_attention, arrays, causal=True,
                      window=40, q_chunk=32, kv_chunk=32)
    np.testing.assert_allclose(got, want,
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("hd,dtype", [(8, "bfloat16"), (80, "float16"),
                                      (192, "bfloat16"), (100, "float32")])
def test_kernel_any_head_dim_emulated_matches_reference(hd, dtype):
    """The kernel's arguments at a head dim between its instances (and
    above 128, where bf16 takes the FMA path with P rounded to bf16)."""
    import ml_dtypes
    dt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
          "float16": np.float16}[dtype]
    q, k, v = (rand((1, 100, hd), 80 + i).astype(dt) for i in range(3))
    got, a = _emulated(*(to_torch(t) for t in (q, k, v)), True, 50,
                       gqa=False)
    assert a.hd == hd
    want = r_flash(*(jnp.asarray(t) for t in (q, k, v)), causal=True,
                   window=50, q_chunk=20, kv_chunk=20)
    np.testing.assert_allclose(got.numpy(), to_f32(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("q_dtype,kv_dtype", [("bfloat16", "float32"),
                                              ("float32", "bfloat16")])
def test_flash_mixed_dtypes_match_reference(q_dtype, kv_dtype):
    """q, k and v of different dtypes: the reference's dots promote, and
    the result takes q's dtype."""
    import ml_dtypes
    dts = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
    q = rand((2, 64, 32), 90).astype(dts[q_dtype])
    k, v = (rand((2, 64, 32), 91 + i).astype(dts[kv_dtype]) for i in range(2))
    got, want = _both(r_flash, PF.flash_attention, [q, k, v], causal=True,
                      q_chunk=32, kv_chunk=32)
    np.testing.assert_allclose(got, want, **BF16_TOL)


# -- head dims above 256: the chunked path ----------------------------------
WIDE_BF16_TOL = dict(rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("hd", [320, 512])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_head_dims_above_256_match_reference(hd, window, dtype):
    """The reference takes any head dim; so does the port (on the card the
    chunked path, here the plain version): causal and windowed, f32 and
    bf16, the plain and the GQA forms."""
    import ml_dtypes
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    tol = F32_TOL if dtype == "float32" else WIDE_BF16_TOL
    arrays = [(rand((2, 96, hd), 100 + i) / 4).astype(dt) for i in range(3)]
    got, want = _both(r_flash, PF.flash_attention, arrays, causal=True,
                      window=window, q_chunk=32, kv_chunk=32)
    np.testing.assert_allclose(got, want, **tol)
    arrays = [(rand((1, 80, h, hd), 110 + i) / 4).astype(dt)
              for i, h in enumerate((4, 2, 2))]
    got, want = _both(r_gqa, PF.flash_attention_gqa, arrays, causal=True,
                      window=window, q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("hd,dtype", [(320, "bfloat16"), (512, "float32")])
def test_kernel_chunked_path_emulated_matches_reference(hd, dtype):
    """The chunked path's arguments (the FMA path's rules; its chunks keep
    the FMA path's sum order) against the reference."""
    import ml_dtypes
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    q, k, v = ((rand((1, 100, hd), 120 + i) / 4).astype(dt) for i in range(3))
    got, a = _emulated(*(to_torch(t) for t in (q, k, v)), True, 50,
                       gqa=False)
    assert PF.PATHS[a.path] == "chunked" and a.hd == hd
    want = r_flash(*(jnp.asarray(t) for t in (q, k, v)), causal=True,
                   window=50, q_chunk=20, kv_chunk=20)
    np.testing.assert_allclose(got.numpy(), to_f32(want),
                               **(F32_TOL if dtype == "float32"
                                  else WIDE_BF16_TOL))


def test_flash_kernel_refuses_an_empty_head_dim():
    q = torch.zeros(1, 8, 1, 0)
    with pytest.raises(ValueError, match="head dim 0"):
        PF._launch(q, q, q, torch.empty_like(q), causal=True, window=None)


# -- the mma path's fragment maps, lane by lane ------------------------------
# The PTX ISA's layouts (mma.m16n8k16 with a floating-point type; ldmatrix),
# lane = 4 g + t, as the comment at the top of csrc/flash_attention.cu lists
# them; a register holds two 16-bit values, `half` 0 the low one.
LANES = torch.arange(32)
G, T = LANES // 4, LANES % 4
REG4 = torch.arange(4)[None, :, None]
REG2 = torch.arange(2)[None, :, None]
HALF = torch.arange(2)[None, None, :]


def a_map():
    """A (16 x 16, row): reg r, half h of a lane -> (row, col)."""
    row = G[:, None, None] + 8 * (REG4 & 1) + 0 * HALF
    col = 2 * T[:, None, None] + HALF + 8 * (REG4 >> 1)
    return row, col


def b_map():
    """B (16 x 8, col): reg r, half h of a lane -> (k, n)."""
    k = 2 * T[:, None, None] + HALF + 8 * REG2
    n = G[:, None, None] + 0 * REG2 + 0 * HALF
    return k, n


def c_map():
    """C / D (16 x 8, f32): element e of a lane -> (row, col)."""
    e = torch.arange(4)[None, :]
    return G[:, None] + 8 * (e >> 1), 2 * T[:, None] + (e & 1)


def ldmatrix_map(trans):
    """ldmatrix.x4: reg i, half h of a lane -> (row, col) in matrix i."""
    r = G[:, None, None] + 0 * REG4 + 0 * HALF
    c = 2 * T[:, None, None] + HALF + 0 * REG4
    return (c, r) if trans else (r, c)


# the row and column each lane addresses in the kernel's ldmatrix calls
def q_address(lane):
    return (lane & 7) + 8 * ((lane >> 3) & 1), 8 * (lane >> 4)


def k_address(lane):
    return (lane & 7) + 8 * (lane >> 4), 8 * ((lane >> 3) & 1)


def v_address(lane):
    return (lane & 7) + 8 * ((lane >> 3) & 1), 8 * (lane >> 4)


def ldmatrix_x4(tile, r0, c0, address, trans=False):
    """Lanes 8i .. 8i+7 give the rows of matrix i, each 8 values from the
    column the lane addresses; returns the lanes' registers (32, 4, 2)."""
    rows, cols = address(LANES)
    rows, cols = (r0 + rows).view(4, 8), (c0 + cols).view(4, 8)
    mats = torch.stack([torch.stack([tile[rows[i, j], cols[i, j]:cols[i, j] + 8]
                                     for j in range(8)]) for i in range(4)])
    r, c = ldmatrix_map(trans)
    return mats[REG4.expand(32, 4, 2), r, c]


def mma_m16n8k16(d, a, b):
    """d (32, 4) += A . B from the lanes' fragments, in f32."""
    A, B, C = torch.zeros(16, 16), torch.zeros(16, 8), torch.zeros(16, 8)
    A[a_map()] = a
    B[b_map()] = b
    C[c_map()] = d
    return (torch.matmul(A, B) + C)[c_map()]


def _small_ints(shape, seed):
    """Values whose every product and sum is exact in f32 (and in bf16)."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -3, 4, shape).astype(np.float32))


@pytest.mark.parametrize("name", ["A", "B", "C", "ldmatrix", "ldmatrix.trans"])
def test_fragment_maps_cover_each_element_once(name):
    rows, cols, shape = {
        "A": (*a_map(), (16, 16)), "B": (*b_map(), (16, 8)),
        "C": (*c_map(), (16, 8)),
        "ldmatrix": (*ldmatrix_map(False), (8, 8)),
        "ldmatrix.trans": (*ldmatrix_map(True), (8, 8))}[name]
    if name.startswith("ldmatrix"):       # per matrix: (reg i, row, col)
        flat = (REG4 * 64 + rows * 8 + cols).flatten()
        assert sorted(flat.tolist()) == list(range(4 * 64))
    else:
        flat = (rows * shape[1] + cols).flatten()
        assert sorted(flat.tolist()) == list(range(shape[0] * shape[1]))


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_mma_fragments_build_scores_bitwise(hd):
    """S = Q K^T of one 64-query, 64-key block, as the kernel's 4 warps build
    it: Q's A-fragments by ldmatrix.x4 once, K's B-fragments by ldmatrix.x4
    (two key n-tiles a call), the f32 C-fragments gathered back by the C
    map; bitwise torch.matmul's."""
    LDS = hd + 8
    Q, K = _small_ints((64, hd), 70), _small_ints((64, hd), 71)
    sQ, sK = torch.zeros(64, LDS), torch.zeros(64, LDS)
    sQ[:, :hd], sK[:, :hd] = Q, K
    S = torch.full((64, 64), float("nan"))
    for w in range(4):
        qf = [ldmatrix_x4(sQ, 16 * w, 16 * kk, q_address)
              for kk in range(hd // 16)]
        s = [torch.zeros(32, 4) for _ in range(8)]
        for kk in range(hd // 16):
            for np_ in range(4):
                bf = ldmatrix_x4(sK, 16 * np_, 16 * kk, k_address)
                s[2 * np_] = mma_m16n8k16(s[2 * np_], qf[kk], bf[:, 0:2])
                s[2 * np_ + 1] = mma_m16n8k16(s[2 * np_ + 1], qf[kk],
                                              bf[:, 2:4])
        r, c = c_map()
        for j in range(8):
            S[16 * w + r, 8 * j + c] = s[j]
    assert torch.equal(S, torch.matmul(Q, K.T))


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_mma_fragments_build_output_bitwise(hd):
    """O = P V of one block: P's C-fragments (as the softmax leaves them)
    reused as A-fragments, V's B-fragments by ldmatrix.x4.trans (two column
    n-tiles a call); then the epilogue's staging, each lane writing its
    C-fragment pairs into the warp's 16 rows and reading back 16-byte
    chunks; bitwise torch.matmul's."""
    LDS, CPR = hd + 8, hd // 8
    P, V = _small_ints((64, 64), 72), _small_ints((64, hd), 73)
    sV = torch.zeros(64, LDS)
    sV[:, :hd] = V
    out = torch.full((64, hd), float("nan"))
    r, c = c_map()
    for w in range(4):
        p = [P[16 * w + r, 8 * j + c] for j in range(8)]     # C-fragments
        acc = [torch.zeros(32, 4) for _ in range(hd // 8)]
        for kk in range(4):
            # A regs: C(2kk) c0c1, C(2kk) c2c3, C(2kk+1) c0c1, C(2kk+1) c2c3
            pa = torch.stack([p[2 * kk + (reg >> 1)][:, 2 * (reg & 1):
                                                     2 * (reg & 1) + 2]
                              for reg in range(4)], dim=1)
            for dp in range(hd // 16):
                bf = ldmatrix_x4(sV, 16 * kk, 16 * dp, v_address, trans=True)
                acc[2 * dp] = mma_m16n8k16(acc[2 * dp], pa, bf[:, 0:2])
                acc[2 * dp + 1] = mma_m16n8k16(acc[2 * dp + 1], pa, bf[:, 2:4])
        so = torch.full((16, LDS), float("nan"))
        for j in range(hd // 8):
            so[r, 8 * j + c] = acc[j]
        for i in range(16 * CPR // 32):
            chunk = LANES + 32 * i
            row, col = chunk // CPR, (chunk % CPR) * 8
            for lane in range(32):
                out[16 * w + row[lane], col[lane]:col[lane] + 8] = \
                    so[row[lane], col[lane]:col[lane] + 8]
    assert torch.equal(out, torch.matmul(P, V))
