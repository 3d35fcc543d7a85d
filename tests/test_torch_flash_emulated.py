"""Kernel 6 emulated over its argument struct on each path against the
reference's Pallas kernel (interpret mode): the cases moved from
``tests/test_torch_flash.py``, unchanged (the emulator, ``_emulated``,
and the helpers stay there), so that their time runs beside that file's.
"""
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as r_flash)
from repro_torch.kernels import flash_attention as PF  # noqa: E402
from torch_parity import (reset_global_state, to_f32,  # noqa: E402,F401
                          to_torch)
from test_torch_flash import (  # noqa: E402
    BF16_TOL, F32_TOL, WIDE_BF16_TOL, _emulated, _tiles, rand)


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


@pytest.mark.parametrize("hd", [64, 80, 192])
@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (96, 96, True, None), (96, 96, False, None), (96, 96, True, 24),
    (200, 200, True, 70), (130, 130, False, 8), (40, 100, False, None),
    (100, 40, True, None), (130, 40, False, 8), (64, 64, True, 0),
    (520, 520, True, 300)])
def test_kernel_wgmma_emulated_matches_reference(Sq, Sk, causal, window, hd):
    """The wgmma path's tiles over its own arguments: blocks of 128 query
    rows as two consumers of 64, key blocks of 128 (width 128, hd 64 and 80
    zero-padded to 64 and 128) or 80 (hd 192 zero-padded to 256), each
    consumer's skip and mask rule, against the reference, bf16."""
    import ml_dtypes
    q, k, v = ((rand((2, n, hd), 130 + i) / (4 if i < 2 else 1)).astype(
        ml_dtypes.bfloat16) for i, n in enumerate((Sq, Sk, Sk)))
    stats = {}
    got, a = _emulated(*(to_torch(t) for t in (q, k, v)), causal, window,
                       gqa=False, stats=stats)
    assert PF.PATHS[a.path] == "wgmma" and a.hd == hd
    assert _tiles(a)[:3] == (128, 80 if hd > 128 else 128, 64)
    want = r_flash(*(jnp.asarray(t) for t in (q, k, v)), causal=causal,
                   window=window, q_chunk=32, kv_chunk=32)
    np.testing.assert_allclose(got.numpy(), to_f32(want), **WIDE_BF16_TOL)
    if (Sq, causal, window) == (520, True, 300):
        # the crossing blocks masked, the inner ones whole, and blocks of
        # the 128-row block's range that one consumer skips
        assert stats["masked"] and stats["full"] and stats["skipped"]
        want_q = PF.flash_attention_plain(*(to_torch(t) for t in (q, k, v)),
                                          causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), to_f32(want_q),
                                   **WIDE_BF16_TOL)


@pytest.mark.parametrize("hd,dtype", [(8, "bfloat16"), (80, "float16"),
                                      (192, "bfloat16"), (100, "float32")])
def test_kernel_any_head_dim_emulated_matches_reference(hd, dtype):
    """The kernel's arguments at a head dim between its instances: hd 8 on
    the mma path, 80 and 192 on the wgmma path (zero-padded to 128 and
    256), 100 in f32 on the FMA path."""
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
