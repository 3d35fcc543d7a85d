"""Parity of the port's plugin datapath (kernels 2 and 3) with the reference's.

* The policy (``can_fuse``, ``_burst_rows``, the template chosen) and
  ``cfg_stats`` equal the reference's.
* Streamed and block chains agree with the reference within
  ``tests/oracle.py``'s chain tolerances, and bitwise where the chain only
  moves data (transposes, gathers, masks).
* The kernels' host code (op and stage lists, constants, layout maps,
  scratch buffers, launch order) runs against emulators of the CUDA code's
  index and value arithmetic, reading and writing the same CPU memory the
  kernel would on the card.
"""
import pytest

pytest.importorskip("torch")

import ctypes  # noqa: E402
import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import oracle as O  # noqa: E402
import test_differential as TD  # noqa: E402
from repro import core as RC  # noqa: E402
from repro.core import plugin_compiler as rpc  # noqa: E402
from repro.core import plugins as RP  # noqa: E402
from repro.core import xdma as rx  # noqa: E402
from repro_torch.core import layouts as PL  # noqa: E402
from repro_torch.core import plugin_compiler as ppc  # noqa: E402
from repro_torch.core import plugins as PP  # noqa: E402
from repro_torch.core import xdma as px  # noqa: E402
from repro_torch.kernels import datapath as DP  # noqa: E402
from torch_parity import (assert_same_payload, bits, port_desc,  # noqa: E402,F401
                          reset_global_state, to_f32, to_torch)


def _x(shape, seed=0, zero_rows=0, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if zero_rows:
        x[..., :zero_rows, :] = 0.0
    return x.astype(dtype)


def _perm(n, seed=1):
    return np.random.default_rng(seed).permutation(n)


# (src, dst, chain builder, logical shape, input dtype); the builder takes the
# plugin module and the logical shape, so one spelling serves both packages
def _bf16(M):
    return jnp.bfloat16 if M is RP else torch.bfloat16


def _arr(M, a):
    """An array constant for the reference (numpy) or the port (tensor)."""
    return a if M is RP else to_torch(a)


STREAMED_CASES = {
    "rmsnorm_store": ("MN", "MNM16N128",
                      lambda M, s: (M.RMSNormPlugin(),), (64, 256), np.float32),
    "rmsnorm_weight_bf16": ("MN", "MNM16N128", lambda M, s: (M.RMSNormPlugin(
        weight=_arr(M, np.linspace(-2, 2, s[-1]).astype(jnp.bfloat16))),), (64, 256),
        jnp.bfloat16),
    "cast_scale_bias": ("MN", "MNM16N128", lambda M, s: (
        M.Cast(_bf16(M)), M.Scale(1.5), M.BiasAdd(0.25)), (64, 256),
        np.float32),
    "scale_bias_vectors": ("MNM8N128", "MNP64", lambda M, s: (
        M.Scale(_arr(M, np.linspace(0.5, 2.0, s[-1]).astype(np.float32))),
        M.BiasAdd(_arr(M, np.linspace(-1, 1, s[-1]).astype(np.float32)))),
        (64, 256),
        np.float32),
    "identity_nm": ("NM", "MNM8N128", lambda M, s: (M.Identity(),), (64, 256),
                    np.float32),
    "cast_f16_rmsnorm": ("MN", "MN", lambda M, s: (
        M.Cast(jnp.float16 if M is RP else torch.float16),
        M.RMSNormPlugin(eps=1e-5)), (32, 384), np.float32),
}

BLOCK_CASES = {
    "load_transpose": ("MNM16N128", "MN", lambda M, s: (M.Transpose(),),
                       (64, 256), jnp.bfloat16),
    "gather_rows": ("MN", "MN", lambda M, s: (M.GatherScatter(
        indices=_perm(s[0])),), (64, 256), jnp.bfloat16),
    "gather_fill": ("MN", "MN", lambda M, s: (M.GatherScatter(
        indices=np.r_[_perm(s[0] - 1), s[0] + 5]),), (64, 256), np.float32),
    "gather_cols_neg": ("MN", "MNM8N128", lambda M, s: (M.GatherScatter(
        indices=np.arange(-1, -s[-1] - 1, -1), axis=-1),), (64, 256),
        np.float32),
    "compress": ("MN", "MNM8N128", lambda M, s: (M.Compress(block_rows=8),),
                 (64, 256), np.float32),
    "compress_roundtrip": ("MN", "MN", lambda M, s: (
        M.Compress(block_rows=8), M.Decompress()), (64, 256), jnp.bfloat16),
    "reduce_sum": ("MN", "MN", lambda M, s: (M.ReduceStage("sum"),),
                   (64, 256), np.float32),
    "reduce_max_bf16": ("MNM16N128", "MN", lambda M, s: (
        M.ReduceStage("max"),), (64, 256), jnp.bfloat16),
    "rmsnorm_rowpad": ("MN", "rowpad", lambda M, s: (M.RMSNormPlugin(),),
                       (64, 256), np.float32),
    "rank3_rmsnorm": ("MN", "KV4M8N128", lambda M, s: (
        M.RMSNormPlugin(), M.Scale(2.0)), (8, 32, 256), np.float32),
    "transpose_rmsnorm_sum": ("NMM8N128", "MNP64", lambda M, s: (
        M.Transpose(), M.RMSNormPlugin(), M.ReduceStage("sum")),
        (128, 256), np.float32),
    "max_transpose_sum": ("MN", "MN", lambda M, s: (
        M.ReduceStage("max"), M.Transpose(), M.ReduceStage("sum")),
        (64, 256), np.float32),
    "hypothesis_case": ("MN", "MN", lambda M, s: (
        M.Cast(_bf16(M)), M.Scale(1.5), M.ReduceStage("sum")), (128, 128),
        np.float32),
}


def _layouts(name):
    if name == "rowpad":
        return (RC.Layout(None, "rowpad", pad=(8, 0)),
                PL.Layout(None, "rowpad", pad=(8, 0)))
    return RC.by_name(name), PL.by_name(name)


def _case(cases, name, backend="auto", d_buf=9):
    src, dst, chain, shape, dtype = cases[name]
    (rs, ps), (rd, pd) = _layouts(src), _layouts(dst)
    ref = RC.XDMADescriptor(src=RC.Endpoint.local(rs), dst=RC.Endpoint.local(rd),
                            pre=chain(RP, shape), d_buf=d_buf, backend=backend)
    zero = 8 if "compress" in name else 0
    x = _x(shape, seed=3, zero_rows=zero, dtype=dtype)
    xin = np.asarray(rs.from_logical(jnp.asarray(x)))
    return ref, port_desc(ref), xin


def _tol(desc, dtype):
    half = np.dtype(dtype).itemsize < 4
    return dict(rtol=2e-2, atol=1e-2) if half else O.chain_tolerance(desc)


def _exact(name):
    return not any(k in name for k in ("rmsnorm", "sum", "scale", "cast",
                                       "hypothesis"))


# -- policy parity -------------------------------------------------------------
@pytest.mark.parametrize("chain", [(), ("rmsnorm",), ("quantize",),
                                   ("transpose", "quantize"),
                                   ("gather", "reduce")])
def test_can_fuse_matches_reference(chain):
    def build(M):
        made = {"rmsnorm": M.RMSNormPlugin(), "quantize": M.Quantize(),
                "transpose": M.Transpose(), "reduce": M.ReduceStage(),
                "gather": M.GatherScatter(indices=np.arange(8))}
        return tuple(made[c] for c in chain)
    ref = RC.describe("MN", "MN", *build(RP))
    assert ppc.can_fuse(port_desc(ref)) == rpc.can_fuse(ref)


@pytest.mark.parametrize("src,dst", [("MN", "MNM8N128"), ("MNM16N128", "MN"),
                                     ("MNM8N128", "MNM32N128"),
                                     ("MNP64", "MN")])
@pytest.mark.parametrize("m,d_buf", [(128, 9), (96, 3), (256, 1), (24, 5)])
def test_burst_rows_match_reference(src, dst, m, d_buf):
    want = rpc._burst_rows((), RC.by_name(src), RC.by_name(dst), m, d_buf)
    got = ppc._burst_rows((), PL.by_name(src), PL.by_name(dst), m, d_buf)
    assert got == want


@pytest.mark.parametrize("name", sorted(STREAMED_CASES) + sorted(BLOCK_CASES))
def test_template_choice(name):
    cases = STREAMED_CASES if name in STREAMED_CASES else BLOCK_CASES
    _, desc, xin = _case(cases, name)
    fn = ppc.compile_local(desc)
    fn(to_torch(xin))
    (prog,) = fn.kernels.values()
    want = DP.StreamedDatapath if cases is STREAMED_CASES else DP.BlockDatapath
    assert type(prog) is want


# -- value parity vs the reference ----------------------------------------------
@pytest.mark.parametrize("backend", ["auto", "compiled"])
@pytest.mark.parametrize("name", sorted(STREAMED_CASES) + sorted(BLOCK_CASES))
def test_chain_matches_reference(name, backend):
    cases = STREAMED_CASES if name in STREAMED_CASES else BLOCK_CASES
    ref, desc, xin = _case(cases, name, backend=backend)
    if name == "scale_bias_vectors":
        # the reference's Pallas kernels refuse vector constants (their
        # kernel bodies capture them); its fused composition is the same
        # function
        ref = dataclasses.replace(ref, backend="fused")
    want = rx.transfer(jnp.asarray(xin), ref)
    got = px.transfer(to_torch(xin), desc)
    tol = _tol(ref, xin.dtype)
    if name == "hypothesis_case":
        # the reference's bf16 row sum is one bf16 ulp off the oracle's
        # (ROADMAP.md §3); the port agrees with the oracle
        tol = dict(rtol=2 ** -6, atol=0.125)
    if _exact(name):
        assert_same_payload(got, want, context=name)
    else:
        assert_same_payload(got, want, context=name, **tol)


@pytest.mark.parametrize("name", sorted(STREAMED_CASES) + sorted(
    set(BLOCK_CASES) - {"gather_fill"}))          # the oracle has no fill
def test_chain_matches_oracle(name):
    cases = STREAMED_CASES if name in STREAMED_CASES else BLOCK_CASES
    ref, desc, xin = _case(cases, name)
    want = O.oracle_transfer(xin, ref)
    got = px.transfer(to_torch(xin), desc)
    if isinstance(want, O.OCTensor):
        np.testing.assert_array_equal(bits(got.mask), bits(want.mask))
        got, want = got.values, want.values
    tol = _tol(ref, xin.dtype)
    if name == "hypothesis_case":
        # bf16 sums of 128 rows: the oracle and the port both accumulate in
        # f32; one bf16 ulp of the result is 2^-8 relative
        tol = dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(to_f32(got), np.asarray(want, np.float32),
                               **tol)


def test_hypothesis_case_against_reference_and_oracle():
    """The example Hypothesis stored against the reference (local MN->MN,
    cast_bf16 -> scale -> reduce_sum, 128x128, d_buf=1): the reference sums
    bf16 rows differently from the oracle; the port accumulates in f32 and
    rounds once, which is what the oracle does."""
    case = TD.DescCase(kind="local", m=128, n=128, src="MN", dst="MN",
                       segments=("cast_bf16", "scale"), terminal="reduce_sum",
                       split=0, d_buf=1, seed=0)
    x, ref = case.build()
    desc = port_desc(ref)
    xin = np.asarray(x)
    got = to_f32(px.transfer(to_torch(xin), desc))
    want_ref = np.asarray(rx.transfer(x, ref), np.float32)
    want_oracle = np.asarray(O.oracle_transfer(xin, ref), np.float32)
    port_vs_oracle = np.abs(got - want_oracle).max()
    ref_vs_oracle = np.abs(want_ref - want_oracle).max()
    # one bf16 ulp of a sum near 16..32 is 0.125
    assert port_vs_oracle <= ref_vs_oracle
    np.testing.assert_allclose(got, want_oracle, rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(got, want_ref, rtol=2 ** -6, atol=0.125)


@pytest.mark.parametrize("i", range(10))
def test_seeded_local_sweep_matches_reference(i):
    rng = np.random.default_rng(1000 + i)
    case = TD.make_case(rng, kind="local")
    x, ref = case.build()
    desc = port_desc(ref)
    want = rx.transfer(x, ref)
    got = px.transfer(to_torch(np.asarray(x)), desc)
    tol = O.chain_tolerance(ref)
    if any(isinstance(p, RP.ReduceStage) and p.op == "sum" for p in ref.pre):
        tol = dict(rtol=2e-2, atol=2e-2) if tol["rtol"] > 1e-4 else \
            dict(rtol=1e-4, atol=1e-4)
    if isinstance(want, RP.QTensor):
        dv = np.abs(bits(got.values).view(np.int8).astype(np.int32)
                    - np.asarray(want.values).astype(np.int32))
        assert dv.max(initial=0) <= 1, repr(case)
        np.testing.assert_allclose(to_f32(got.scales),
                                   np.asarray(want.scales), **tol)
        return
    assert_same_payload(got, want, context=repr(case), **tol)


def test_cfg_stats_match_reference_after_the_same_sequence():
    rpc.clear_stats()
    ppc.clear_stats()
    names = sorted(set(STREAMED_CASES) - {"scale_bias_vectors"})
    for name in names + sorted(BLOCK_CASES):
        cases = STREAMED_CASES if name in STREAMED_CASES else BLOCK_CASES
        ref, desc, xin = _case(cases, name)
        rx.transfer(jnp.asarray(xin), ref)
        px.transfer(to_torch(xin), desc)
    for ref in (RC.describe("MN", "MNM8N128"),
                RC.describe("MN", "MN", RP.Quantize())):
        xin = jnp.asarray(_x((64, 256)))
        rx.transfer(xin, ref)
        px.transfer(to_torch(np.asarray(xin)), port_desc(ref))
    assert ppc.cfg_stats() == rpc.cfg_stats()
    assert ppc.cfg_stats()["reasons"] == {"empty-chain": 1,
                                          "no-emit:quantize_int8": 1}


def test_compile_local_refuses_a_non_fusible_chain():
    desc = port_desc(RC.describe("MN", "MN", RP.Quantize()))
    with pytest.raises(ValueError, match="no-emit:quantize_int8"):
        ppc.compile_local(desc)


def test_decompress_without_compress_raises():
    prog = DP.BlockDatapath((PP.Decompress(),), PL.MN, PL.MN, (16, 32),
                            torch.float32)
    with pytest.raises(ValueError, match="Decompress"):
        prog._compile("cpu")


def test_kernels_refuse_integer_streams():
    prog = DP.BlockDatapath((PP.Transpose(),), PL.MN, PL.MN, (16, 32),
                            torch.int8)
    with pytest.raises(NotImplementedError, match="float32"):
        prog._compile("cpu")


def test_gather_follows_jnp_take_out_of_range():
    idx = np.array([3, -1, 9, -12])
    x = _x((8, 16))
    want = np.asarray(RP.GatherScatter(indices=idx)(jnp.asarray(x)))
    got = PP.GatherScatter(indices=idx)(to_torch(x))
    np.testing.assert_array_equal(bits(got), bits(want))


# -- kernel emulators: the CUDA arithmetic over the same memory ----------------
_F32, _BF16, _F16 = 0, 1, 2
_SIZE = {_F32: 4, _BF16: 2, _F16: 2}


def _round(v, dt):
    v = np.float32(v)
    if dt == _BF16:
        b = np.array([v], np.float32).view(np.uint32)
        b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
            & np.uint32(0xFFFF0000)
        return b.view(np.float32)[0]
    if dt == _F16:
        return np.float32(np.float16(v))
    return v


def _at(ctype, addr):
    return ctype.from_address(int(addr))


def _load(addr, i, dt):
    if dt == _F32:
        return np.float32(_at(ctypes.c_float, addr + 4 * i).value)
    raw = _at(ctypes.c_uint16, addr + 2 * i).value
    if dt == _BF16:
        return np.array([raw << 16], np.uint32).view(np.float32)[0]
    return np.float32(np.array([raw], np.uint16).view(np.float16)[0])


def _store_all(addr, values, dt):
    t = torch.from_numpy(np.asarray(values, np.float32))
    t = t.to({_F32: torch.float32, _BF16: torch.bfloat16,
              _F16: torch.float16}[dt]).contiguous()
    ctypes.memmove(addr, t.data_ptr(), t.numel() * t.element_size())


def _f32_at(addr, i):
    return np.float32(_at(ctypes.c_float, addr + 4 * i).value)


def _dim_off(m, i):
    return (i // m.tile) * m.sgrid + (i % m.tile) * m.stile


class _Emulated:
    """Stands in for a Kernel: emulates the launch, counts it."""

    def __init__(self, fn):
        self.fn, self.launches, self.name = fn, 0, "emulated"

    def __call__(self, *args):
        self.fn(*args)
        self.launches += 1


def _emulate_streamed(args_addr, src, dst):
    a = DP._StreamArgs.from_address(args_addr)
    out = {}
    for i in range(a.rows):
        row = [_load(src, _dim_off(a.src[0], i) + _dim_off(a.src[1], j),
                     a.in_dtype) for j in range(a.cols)]
        for k in range(a.nops):
            op = a.ops[k]
            vec = [_f32_at(op.vec, j) for j in range(a.cols)] if op.vec else None
            if op.code == DP._OP_RMSNORM:
                ss = np.float32(sum(np.float32(v) * np.float32(v) for v in row))
                inv = np.float32(1.0) / np.sqrt(np.float32(ss / np.float32(
                    a.cols) + np.float32(op.a)))
                row = [_round(np.float32(v * inv) * (vec[j] if vec else 1),
                              op.dtype) for j, v in enumerate(row)]
            else:
                c = [vec[j] if vec else np.float32(op.a)
                     for j in range(a.cols)]
                if op.code == DP._OP_SCALE:
                    row = [np.float32(v * c[j]) for j, v in enumerate(row)]
                elif op.code == DP._OP_BIAS:
                    row = [np.float32(v + c[j]) for j, v in enumerate(row)]
                row = [_round(v, op.dtype) for v in row]
        for j in range(a.pcols):
            d = _dim_off(a.dst[0], i) + _dim_off(a.dst[1], j)
            out[d] = row[j] if j < a.cols else 0.0
    _store_all(dst, [out[d] for d in range(len(out))], a.out_dtype)


class _BlockEmu:
    """csrc/block_datapath.cu's device functions, one element at a time."""

    def __init__(self, a, src):
        self.a, self.src = a, src

    def walk_back(self, lo, hi, co):
        for s in range(hi - 1, lo - 1, -1):
            st = self.a.st[s]
            r = st.in_rank
            co[s] = list(co[s + 1][:r]) + [0] * (4 - r)
            if st.code == DP._ST_TRANSPOSE:
                co[s][r - 2], co[s][r - 1] = co[s + 1][r - 1], co[s + 1][r - 2]
            elif st.code == DP._ST_GATHER:
                j = _at(ctypes.c_int64, 
                    st.aux + 8 * co[s + 1][st.axis]).value
                if j < 0:
                    return s
                co[s][st.axis] = j
        return -1

    def apply(self, st, v, c):
        r = st.in_rank
        vec = (lambda j: _f32_at(st.vec, j)) if st.vec else None
        if st.code == DP._ST_CAST:
            return _round(v, st.dtype)
        if st.code == DP._ST_SCALE:
            return _round(v * (vec(c[r - 1]) if vec else np.float32(st.a)),
                          st.dtype)
        if st.code == DP._ST_BIAS:
            return _round(v + (vec(c[r - 1]) if vec else np.float32(st.a)),
                          st.dtype)
        if st.code == DP._ST_RMSNORM:
            row = 0
            for d in range(r - 1):
                row = row * st.in_shape[d] + c[d]
            y = np.float32(v * _f32_at(st.aux, row))
            if vec:
                y = np.float32(y * vec(c[r - 1]))
            return _round(y, st.dtype)
        if st.code == DP._ST_DECOMPRESS:
            nb = st.in_shape[r - 2] // st.block_rows
            lead = 0
            for d in range(r - 2):
                lead = lead * st.in_shape[d] + c[d]
            m = lead * nb + c[r - 2] // st.block_rows
            keep = _at(ctypes.c_uint8, st.aux + m).value != 0
            return _round(v * np.float32(1.0 if keep else 0.0), st.dtype)
        return v

    def eval_plain(self, k, co):
        fill = self.walk_back(0, k, co)
        if fill >= 0:
            v, start = np.float32(np.nan), fill + 1
        else:
            off = sum(_dim_off(self.a.src[d], co[0][d])
                      for d in range(self.a.src_rank))
            v, start = _load(self.src, off, self.a.in_dtype), 0
        for s in range(start, k):
            v = self.apply(self.a.st[s], v, co[s])
        return v

    def eval(self, k, co):
        R = self.a.reduce_at
        if R < 0 or R >= k:
            return self.eval_plain(k, co)
        fill = self.walk_back(R + 1, k, co)
        if fill >= 0:
            v, start = np.float32(np.nan), fill + 1
        else:
            st = self.a.st[R]
            n = st.in_rank
            acc = np.float32(0.0) if st.code == DP._ST_REDUCE_SUM \
                else np.float32(-np.inf)
            for r in range(st.in_shape[n - 2]):
                out = co[R + 1]
                inner = [[0] * 4 for _ in range(9)]
                if st.keepdims:
                    inner[R] = list(out)
                else:
                    inner[R] = list(out[:n - 2]) + [0, out[n - 2]] + \
                        [0] * (4 - n)
                inner[R][n - 2] = r
                x = self.eval_plain(R, inner)
                if st.code == DP._ST_REDUCE_SUM:
                    acc = np.float32(acc + x)
                elif not (acc != acc or x <= acc):
                    acc = x
            v, start = _round(acc, st.dtype), R + 1
        for s in range(start, k):
            v = self.apply(self.a.st[s], v, co[s])
        return v


def _emulate_block(args_addr, src, dst, mode):
    a = DP._BlockArgs.from_address(args_addr)
    emu = _BlockEmu(a, src)
    k = a.upto
    co = [[0] * 4 for _ in range(9)]
    if mode == DP._MODE_OUT:
        vals = []
        for p in range(a.total):
            c = [0] * 4
            rem = p
            for q in range(a.nphys - 1, -1, -1):
                c[a.pdim[q]] += (rem % a.pext[q]) * a.pw[q]
                rem //= a.pext[q]
            if any(c[d] >= a.out_shape[d] for d in range(a.out_rank)):
                vals.append(0.0)
                continue
            co[k] = c
            vals.append(emu.eval(k, co))
        _store_all(dst, vals, a.out_dtype)
        return
    st = a.st[k]
    r = st.in_rank
    shape = list(st.in_shape[:r])
    if mode == DP._MODE_STAT:
        for row in range(a.total):
            lead = np.unravel_index(row, shape[:-1])
            ss = np.float32(0.0)
            for j in range(shape[-1]):
                co[k] = list(lead) + [j] + [0] * (4 - r)
                v = emu.eval(k, co)
                ss = np.float32(ss + v * v)
            inv = np.float32(1.0) / np.sqrt(np.float32(
                ss / np.float32(shape[-1]) + np.float32(st.a)))
            _at(ctypes.c_float, st.aux + 4 * row).value = inv
        return
    nb = shape[-2] // st.block_rows
    for e in range(a.total):
        lead, blk = divmod(e, nb)
        lead_c = list(np.unravel_index(lead, shape[:-2])) if r > 2 else []
        hit = 0
        for t in range(st.block_rows * shape[-1]):
            co[k] = lead_c + [blk * st.block_rows + t // shape[-1],
                              t % shape[-1]] + [0] * (4 - r)
            if emu.eval(k, co) != 0:
                hit = 1
                break
        _at(ctypes.c_uint8, st.aux + e).value = hit


_EMU_SHAPES = {(64, 256): (16, 128), (32, 384): (16, 128),
               (128, 256): (32, 128), (8, 32, 256): (4, 8, 128),
               (128, 128): (32, 128)}


def _emulation_input(cases, name):
    src, dst, chain, shape, dtype = cases[name]
    shape = _EMU_SHAPES[shape]
    (_, ps), (_, pd) = _layouts(src), _layouts(dst)
    x = _x(shape, seed=9, zero_rows=8 if "compress" in name else 0,
           dtype=dtype)
    return ps.from_logical(to_torch(x)), chain(PP, shape), ps, pd


@pytest.mark.parametrize("name", sorted(STREAMED_CASES))
def test_streamed_kernel_host_code_under_emulation(name, monkeypatch):
    x, plugins, ps, pd = _emulation_input(STREAMED_CASES, name)
    emu = _Emulated(_emulate_streamed)
    monkeypatch.setattr(DP, "STREAMED", emu)
    prog = DP.StreamedDatapath(plugins, ps, pd, tuple(x.shape), x.dtype)
    got = prog.launch(x)
    want = DP.plain(x, plugins, ps, pd)
    assert emu.launches == 1
    assert got.dtype == want.dtype and got.shape == want.shape
    if not any(isinstance(p, PP.RMSNormPlugin) for p in plugins):
        np.testing.assert_array_equal(bits(got), bits(want))
    else:
        np.testing.assert_allclose(to_f32(got), to_f32(want),
                                   rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_block_kernel_host_code_under_emulation(name, monkeypatch):
    x, plugins, ps, pd = _emulation_input(BLOCK_CASES, name)
    emu = _Emulated(_emulate_block)
    monkeypatch.setattr(DP, "BLOCK", emu)
    prog = DP.BlockDatapath(plugins, ps, pd, tuple(x.shape), x.dtype)
    got = prog.launch(x)
    want = DP.plain(x, plugins, ps, pd)
    passes = sum(isinstance(p, (PP.RMSNormPlugin, PP.Compress))
                 for p in plugins)
    segments = max(1, sum(isinstance(p, PP.ReduceStage) for p in plugins))
    assert emu.launches == passes + segments
    if isinstance(want, PP.CTensor):
        np.testing.assert_array_equal(bits(got.mask), bits(want.mask))
        got, want = got.values, want.values
    assert got.dtype == want.dtype and got.shape == want.shape
    if _exact(name):
        np.testing.assert_array_equal(bits(got), bits(want))
    else:
        np.testing.assert_allclose(to_f32(got), to_f32(want),
                                   rtol=2e-2, atol=1e-2)


def test_block_segments_cut_before_a_second_reduce():
    chain = (PP.ReduceStage("max"), PP.Transpose(), PP.ReduceStage("sum"),
             PP.Scale(2.0), PP.ReduceStage("sum"))
    prog = DP.BlockDatapath(chain, PL.MN, PL.MN, (16, 32), torch.float32)
    stages = prog._compile("cpu")
    assert prog._segments(stages) == [(0, 2), (2, 4), (4, 5)]
