"""Parity of the port's flash attention (kernel 6) with the reference's.

The same numpy inputs go through the reference's Pallas kernel (interpret
mode, as ``tests/test_flash_kernel.py`` runs it) and through the port on the
CPU, which takes the plain version: rtol/atol 2e-5 on f32, 2e-2 on bf16.
The CUDA kernel's algorithm — its tiles on each path (64 x 64; on the
wgmma path blocks of 128 query rows as two consumers of 64, key blocks of
128 or 80), its key-block skip rules, the ragged last block, strided heads
read in place for GQA, and on the bf16 / f16 paths the exp2 softmax and
masks on edge blocks only — is checked on the CPU by an emulation over the
kernel's own argument struct; the tensor-core paths' fragment maps
(mma.m16n8k16, ldmatrix, the C -> A reuse of P; wgmma m64nNk16's
accumulators and A registers, TMA's 128-byte swizzle and what the wgmma
descriptors read) by products built thread by thread and held bitwise
against ``torch.matmul``; the kernel itself by the ``cuda`` tests on a GPU
and by ``chip_smoke.py`` phase 8.  The emulated kernel's cases run in
``tests/test_torch_flash_emulated.py``.
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


def _tiles(a):
    """(query rows a block, keys a block, rows a consumer, instance width)
    of the path ``a.path`` names: the wgmma path's block of 128 rows is two
    consumers of 64, each with its own skip and mask rule; the others' is
    one of 64.  The width is the instance a head dim runs on."""
    path = PF.PATHS[a.path]
    if path == "wgmma":
        width = next(w for w in (64, 128, 256) if a.hd <= w)
        return 128, 128 if width <= 128 else 80, 64, width
    if path == "mma":
        return 64, 64, 64, next(w for w in (16, 32, 64, 128) if a.hd <= w)
    return 64, 64, 64, a.hd


def _emulate_flash(qf, kf, vf, a, out_numel, stats=None):
    """``csrc/flash_attention.cu`` step by step over flat buffers: its tiles
    (``_tiles``), the key-block skip rule, keys past Sk at -inf, -1e30
    masks, P rounded to the dtype, the output rounded once.  Q, K and V
    enter zero-padded to the instance width, as the kernel holds them.  f32
    follows the FMA path (exp, every block masked), as does the chunked path
    (head dims above 256, whose chunks keep the FMA path's sums); bf16 /
    f16 the mma or the wgmma path, as ``a.path`` names it: scores scaled by
    f32(hd^-0.5 * log2 e), exp2, and masks applied only on blocks that cross
    Sk, the causal diagonal or the window's lower edge for one of the
    consumer's rows (the emulation asserts that the other blocks mask
    nothing).  On the wgmma path each 64-row consumer also skips the blocks
    of the block's range that lie outside its own rows' live keys, where
    each of its rows has one.  ``stats`` counts the key blocks each consumer
    skipped, masked and took whole."""
    BQ, BK, BC, W = _tiles(a)
    stats = {} if stats is None else stats
    half = PF.PATHS[a.path] in ("mma", "wgmma")
    d = torch.arange(a.hd)
    if half:
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
            t = torch.zeros(len(pos), W)
            ok = pos < limit
            idx = b * sb + head * sh + pos[ok, None] * ss + d[None, :]
            t[ok, :a.hd] = flat[idx].float()
            return t

        for q0 in range(0, a.Sq, BQ):
            q1 = min(q0 + BQ, a.Sq) - 1
            kbeg, kend = 0, a.Sk
            if lo(q1) <= hi(q1):
                kbeg, kend = lo(q0) // BK * BK, hi(q1) + 1
            for r0 in range(q0, min(q0 + BQ, a.Sq), BC):
                r1 = min(r0 + BC, a.Sq) - 1
                rows = torch.arange(r0, r0 + BC)
                Q = tile(qf, a.q_sb, a.q_sh, a.q_ss, h, rows, a.Sq)
                m = torch.full((BC,), PF.NEG_INF)
                l = torch.zeros(BC)
                acc = torch.zeros(BC, W)
                for k0 in range(kbeg, kend, BK):
                    if (BC < BQ and lo(r1) <= hi(r1)
                            and (k0 + BK <= lo(r0) or k0 > hi(r1))):
                        stats["skipped"] = stats.get("skipped", 0) + 1
                        continue                # outside the consumer's keys
                    cols = torch.arange(k0, k0 + BK)
                    K = tile(kf, a.k_sb, a.k_sh, a.k_ss, hk, cols, a.Sk)
                    V = tile(vf, a.v_sb, a.v_sh, a.v_ss, hk, cols, a.Sk)
                    s = (Q @ K.T) * scale
                    qp, kp = rows[:, None], cols[None, :]
                    masked = torch.zeros(BC, BK, dtype=torch.bool)
                    if a.causal:
                        masked |= kp > qp
                    if a.has_window:
                        masked |= kp <= qp - a.window
                    past = (kp >= a.Sk).expand(BC, BK)
                    full = (k0 + BK <= a.Sk
                            and (not a.causal or k0 + BK - 1 <= r0)
                            and (not a.has_window or k0 > r1 - a.window))
                    kind = "full" if half and full else "masked"
                    stats[kind] = stats.get(kind, 0) + 1
                    if half and full:
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
                o = acc[:, :a.hd] / torch.clamp(l, min=1e-30)[:, None]
                ok = rows < a.Sq
                idx = (b * a.o_sb + h * a.o_sh + rows[ok, None] * a.o_ss
                       + d[None, :])
                out[idx] = o[ok].to(_DTYPE_OF[a.dtype]).float()
    return out


def _emulated(q, k, v, causal, window, gqa, stats=None):
    """Kernel 6's arguments as the wrapper builds them, then the emulation."""
    if gqa:
        out = torch.empty(q.shape, dtype=q.dtype)
        views = (q, k, v, out)
    else:
        out = torch.empty(q.shape, dtype=q.dtype)
        views = tuple(t.unsqueeze(2) for t in (q, k, v, out))
    a = PF.flash_args(*views, causal=causal, window=window)
    flat = _emulate_flash(*(t.reshape(-1) for t in (q, k, v)), a, out.numel(),
                          stats)
    assert not torch.isnan(flat).any()
    return flat.reshape(out.shape), a


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
    (torch.bfloat16, 8, "mma"), (torch.float16, 80, "wgmma"),
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 192, "wgmma"),
    (torch.float32, 256, "fma"), (torch.bfloat16, 320, "chunked"),
    (torch.float16, 512, "chunked"), (torch.float32, 257, "chunked")])
def test_kernel_args_name_the_path_by_head_dim(dtype, hd, path):
    """A head dim keeps its own scale on any path: aligned bf16 / f16 views
    take the wgmma path from 33 to 256, the mma path below; f32 the FMA
    path; above 256 every dtype the chunked path."""
    q = torch.zeros(1, 8, 2, hd, dtype=dtype)
    k = torch.zeros(1, 8, 1, hd, dtype=dtype)
    a = PF.flash_args(q, k, k, torch.empty_like(q), causal=True, window=None)
    assert PF.PATHS[a.path] == path
    assert a.hd == hd and a.scale == hd ** -0.5


def _view(dtype, hd, aligned, width=None):
    """(q, k, out) views (1, 8, 2, hd), (1, 8, 1, hd) and (1, 8, 2, hd) with
    a row pitch of ``width`` elements, starting on a 16-byte boundary or one
    element past it."""
    width = width or hd
    flat = torch.zeros(8 * 5 * width + 1, dtype=dtype)
    flat = flat[:-1] if aligned else flat[1:]
    buf = flat.view(1, 8, 5, width)[..., :hd]
    return buf[:, :, :2], buf[:, :, 2:3], buf[:, :, 3:]


@pytest.mark.parametrize("dtype,hd,width,aligned,path", [
    (torch.bfloat16, 64, None, True, "wgmma"),
    (torch.bfloat16, 64, None, False, "mma"),
    (torch.float16, 128, None, False, "mma"),
    (torch.bfloat16, 192, None, False, "fma"),
    (torch.bfloat16, 256, None, True, "wgmma"),
    (torch.bfloat16, 32, None, True, "mma"),
    (torch.bfloat16, 33, 40, True, "wgmma"),
    (torch.float16, 33, None, True, "mma"),
    (torch.float32, 64, None, True, "fma"),
    (torch.bfloat16, 264, None, True, "chunked")])
def test_kernel_args_name_the_path_by_alignment(dtype, hd, width, aligned,
                                                path):
    """The wgmma path takes bf16 / f16 at 33 <= hd <= 256 where every base
    and stepped stride of q, k, v and the output is a multiple of 16 bytes
    (TMA's rule); a view that is not takes the mma path up to 128 and the
    FMA path above.  hd 33 packed has a 66-byte row, so it is not (nor is
    the packed output the entry points allocate at such a head dim)."""
    q, k, out = _view(dtype, hd, aligned, width)
    a = PF.flash_args(q, k, k, out, causal=True, window=None)
    assert PF.PATHS[a.path] == path
    assert a.vec == int(aligned and (hd * q.element_size() % 16 == 0
                                     or width is not None))


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


# -- the wgmma path's maps ---------------------------------------------------
# hopper.cuh's layouts for wgmma m64nNk16 (PTX ISA, "Register Fragments and
# Shared Memory Matrix Layouts" of wgmma), thread = 32 warp + 4 g + t: the f32
# accumulators, the A operand in registers, the 128-byte swizzle TMA writes,
# and what a descriptor of that swizzle reads.
WG = torch.arange(128)
WG_WARP, WG_G, WG_T = WG // 32, (WG % 32) // 4, WG % 4


def wg_acc_map(n):
    """m64nNk16 f32 accumulators: thread, register 4 j + e -> (row, col)."""
    i = torch.arange(n // 2)[None, :]
    j, e = i // 4, i % 4
    row = 16 * WG_WARP[:, None] + WG_G[:, None] + 8 * (e >> 1)
    col = 8 * j + 2 * WG_T[:, None] + (e & 1)
    return row, col


def wg_a_map():
    """A (64 x 16) in registers: thread, reg r, half h -> (row, col)."""
    reg, half = REG4, HALF
    row = (16 * WG_WARP + WG_G)[:, None, None] + 8 * (reg & 1) + 0 * half
    col = 2 * WG_T[:, None, None] + half + 8 * (reg >> 1)
    return row, col


def p_as_a(acc, kk):
    """The kernel's A registers of P V's step kk (keys 16 kk .. 16 kk + 15)
    from P's accumulators: reg i = (acc[8 kk + 2 i], acc[8 kk + 2 i + 1])."""
    return torch.stack([acc[:, 8 * kk + 2 * i:8 * kk + 2 * i + 2]
                        for i in range(4)], dim=1)


def sw128(row, col, rows):
    """Byte offset of 16-bit element (row, col) of a tile held as 64-column
    blocks of ``rows`` rows of 128 bytes, 128-byte swizzled: TMA's layout."""
    blk, c = col // 64, col % 64
    return blk * rows * 128 + row * 128 + ((c // 8) ^ (row % 8)) * 16 \
        + (c % 8) * 2


def swizzle(addr):
    """The 128-byte swizzle on a byte address: bits 4-6 ^= bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def desc_read(mem, start, lbo, sbo, shape, mn_major):
    """The operand a 128-byte-swizzle descriptor at byte ``start`` reads
    from ``mem`` (16-bit values by byte offset // 2).  K-major (MN, 16):
    row r at (r % 8) 128 + (r // 8) sbo, k at 2 k bytes.  MN-major (16, N):
    k at (k % 8) 128 + (k // 8) sbo, n at (n // 64) lbo + (n % 64) 2."""
    r = torch.arange(shape[0])[:, None]
    c = torch.arange(shape[1])[None, :]
    if mn_major:
        addr = start + (r % 8) * 128 + (r // 8) * sbo + (c // 64) * lbo \
            + (c % 64) * 2
    else:
        addr = start + (r % 8) * 128 + (r // 8) * sbo + c * 2
    return mem[swizzle(addr) // 2]


def tma_write(tile, rows):
    """``tile`` (rows x hd) laid out as TMA writes it: 16-bit values by
    byte offset // 2."""
    r = torch.arange(tile.shape[0])[:, None].expand(tile.shape)
    c = torch.arange(tile.shape[1])[None, :].expand(tile.shape)
    mem = torch.full((tile.numel(),), float("nan"))
    mem[sw128(r, c, rows) // 2] = tile
    return mem


@pytest.mark.parametrize("name,n", [("acc", 64), ("acc", 80), ("acc", 128),
                                    ("acc", 256), ("A", 16)])
def test_wgmma_maps_cover_each_element_once(name, n):
    rows, cols = wg_acc_map(n) if name == "acc" else wg_a_map()
    flat = (rows * n + cols).flatten()
    assert sorted(flat.tolist()) == list(range(64 * n))


@pytest.mark.parametrize("rows,hd", [(64, 64), (64, 128), (64, 256),
                                     (128, 128), (80, 256)])
def test_swizzle_128b_is_a_bijection_on_a_tile(rows, hd):
    """TMA's 128-byte swizzle maps a tile's elements one to one onto its
    bytes, each 16-byte chunk within its own 128-byte row; the descriptor's
    swizzle of the unswizzled address agrees with it."""
    r = torch.arange(rows)[:, None].expand(rows, hd)
    c = torch.arange(hd)[None, :].expand(rows, hd)
    off = sw128(r, c, rows)
    assert sorted(off.flatten().tolist()) == list(range(0, rows * hd * 2, 2))
    assert torch.equal(off // 128, (c // 64) * rows + r)
    plain = (c // 64) * rows * 128 + r * 128 + (c % 64) * 2
    assert torch.equal(swizzle(plain), off)


def _bk(hd):
    return 128 if hd <= 128 else 80


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_wgmma_fragments_build_scores_bitwise(hd):
    """S = Q K^T of one consumer's 64 rows and one key block, as the kernel
    builds it: Q and K as TMA writes them, hd / 16 steps of m64nBKk16 whose
    descriptors start 32 (kk % 4) bytes into 64-column block kk // 4 (8-row
    groups 1024 bytes apart), the accumulators gathered by the map; bitwise
    torch.matmul's."""
    BK = _bk(hd)
    Q, K = _small_ints((64, hd), 74), _small_ints((BK, hd), 75)
    mq, mk = tma_write(Q, 64), tma_write(K, BK)
    rows, cols = wg_acc_map(BK)
    acc = torch.zeros(128, BK // 2)
    for kk in range(hd // 16):
        A = desc_read(mq, (kk // 4) * 64 * 128 + (kk % 4) * 32, 16, 1024,
                      (64, 16), False)
        B = desc_read(mk, (kk // 4) * BK * 128 + (kk % 4) * 32, 16, 1024,
                      (BK, 16), False)
        acc += torch.matmul(A, B.T)[rows, cols]
    S = torch.full((64, BK), float("nan"))
    S[rows, cols] = acc
    assert torch.equal(S, torch.matmul(Q, K.T))


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_wgmma_fragments_build_output_bitwise(hd):
    """O = P V of one block: P's accumulators (as the softmax leaves them)
    reused as the A registers of BK / 16 steps of m64nHDk16, V read MN-major
    from TMA's layout (steps 16 rows = 2048 bytes apart, 64-column blocks
    BK 128 bytes apart, 8-row groups 1024); then the epilogue's swizzled
    stores into the Q tile, read back as TMA stores it; bitwise
    torch.matmul's."""
    BK = _bk(hd)
    P, V = _small_ints((64, BK), 76), _small_ints((BK, hd), 77)
    mv = tma_write(V, BK)
    prow, pcol = wg_acc_map(BK)
    p = P[prow, pcol]                                   # the accumulators
    arow, acol = wg_a_map()
    orow, ocol = wg_acc_map(hd)
    acc = torch.zeros(128, hd // 2)
    for kk in range(BK // 16):
        A = torch.full((64, 16), float("nan"))
        A[arow, acol] = p_as_a(p, kk)
        B = desc_read(mv, kk * 16 * 128, BK * 128, 1024, (16, hd), True)
        acc += torch.matmul(A, B)[orow, ocol]
    # the kernel's epilogue: (j / 8) 8192 + row 128 + ((j % 8) ^ (row % 8))
    # 16 + 4 t bytes for registers 4 j + 2 r, 4 j + 2 r + 1 of row 16 warp +
    # g + 8 r
    mo = torch.full((64 * hd,), float("nan"))
    for j in range(hd // 8):
        for r in range(2):
            row = 16 * WG_WARP + WG_G + 8 * r
            byte = (j // 8) * 8192 + row * 128 + ((j % 8) ^ (row % 8)) * 16 \
                + 4 * WG_T
            mo[byte // 2] = acc[:, 4 * j + 2 * r]
            mo[byte // 2 + 1] = acc[:, 4 * j + 2 * r + 1]
    r = torch.arange(64)[:, None].expand(64, hd)
    c = torch.arange(hd)[None, :].expand(64, hd)
    assert torch.equal(mo[sw128(r, c, 64) // 2], torch.matmul(P, V))


def wg_tiles(nq, nbh, grid):
    """``wg_tile<true>`` of csrc/flash_attention.cu: each persistent block's
    tiles (query block, batch * head) in order; round k's tile index is
    k G + x (G - 1 - x on odd rounds), query blocks heaviest first."""
    out = []
    for x in range(grid):
        mine, k = [], 0
        while True:
            t = k * grid + ((grid - 1 - x) if k & 1 else x)
            if t >= nq * nbh:
                break
            mine.append((nq - 1 - t // nbh, t % nbh))
            k += 1
        out.append(mine)
    return out


@pytest.mark.parametrize("nq,nbh", [(32, 24), (32, 32), (8, 3), (40, 7),
                                    (1, 1)])
def test_persistent_tiles_cover_each_once_heaviest_first(nq, nbh):
    """Over a grid of min(tiles, 132 SMs) blocks every tile runs once, each
    block's query blocks in falling order (causal work falling); at the
    phi4-mini layer (32 query blocks x 24 heads) every block gets the same
    causal work, 96 key blocks of 128."""
    grid = min(nq * nbh, 132)
    tiles = wg_tiles(nq, nbh, grid)
    assert sorted(t for mine in tiles for t in mine) == \
        [(q, bh) for q in range(nq) for bh in range(nbh)]
    for mine in tiles:
        assert [q for q, _ in mine] == sorted((q for q, _ in mine),
                                              reverse=True)
    if (nq, nbh) == (32, 24):
        assert {sum(q + 1 for q, _ in mine) for mine in tiles} == {96}
