"""Parity of the port's remote engine (``repro_torch.core.remote`` and the
remote branch of ``xdma.transfer``) with the reference's, on 8 ranks.

The reference runs its cases of ``test_remote.py`` and ``test_api.py`` in
one subprocess with 8 XLA CPU devices under ``shard_map`` (its mesh from
``repro.sharding.make_mesh_compat``); the port runs the same cases in one
8-rank gloo world on the CPU (``tests/torch_remote_cases.py``, launched by
``repro_torch.sharding.run_spmd``).  One world a side for the module; each
test compares one case.  The reference's shard_maps run under ``jax.jit``,
as its training and serving steps do.  Moves and int8 payloads are held
bitwise, and so is ``compressed_psum`` (XLA contracts the dequantize into
the sum of the shards: one fused multiply-add a rank, in rank order, which
the port computes the same way) and the error-feedback residual (one fused
multiply-add); the plain all-reduce within rtol 1e-5 (gloo and XLA add the
ranks in different orders).

Below the world: remote descriptors on a size-1 axis
(``sharding.local_axis`` against the reference's size-1 ``shard_map``) for
seeded descriptor cases of every remote kind.
"""
import pytest

pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import oracle as O  # noqa: E402
import test_differential as TD  # noqa: E402
import torch_remote_cases as RC  # noqa: E402
from conftest import run_multidevice  # noqa: E402
from repro.core import plugins as RP  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.core import xdma as px  # noqa: E402
from test_torch_plugin_compiler import _assert_quantize_bitwise  # noqa: E402
from torch_parity import (assert_same_payload, bits, port_desc,  # noqa: E402,F401
                          reset_global_state, to_torch)

_REF = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as PS
from repro import core as C
from repro.core import plugin_compiler, xdma
from repro.core.descriptor import Endpoint
from repro.runtime.trace import capture
from repro.serving.transfer import cross_stage_transfer
from repro.sharding import make_mesh_compat, shard_map_compat
sys.path.insert(0, TESTS)
from torch_remote_cases import HALF, N, RING, global_inputs
mesh = make_mesh_compat((N,), ('x',))
inp = {k: jnp.asarray(v) for k, v in global_inputs().items()}
g, x, kv, a = inp['g'], inp['x'], inp['kv'], inp['a']
out, meta = {}, {}
def sm(f, v, local=True):
    body = (lambda xs: f(xs[0])[None]) if local else f
    return np.asarray(jax.jit(shard_map_compat(body, mesh, PS('x'), PS('x')))(v))
out['compressed_psum'] = sm(lambda v: C.compressed_psum(v, 'x', N), g)
def fb(gs, es):
    r, e = C.compressed_psum_with_feedback(gs[0].reshape(125, 8), es[0], 'x', N)
    return r[None], e[None]
red, err = jax.jit(shard_map_compat(fb, mesh, (PS('x'), PS('x')),
                                    (PS('x'), PS('x'))))(g, jnp.zeros((N, 125, 8)))
out['feedback_reduced'], out['feedback_err'] = np.asarray(red), np.asarray(err)
out['ppermute_codec'] = sm(lambda v: C.xdma_ppermute(
    v, 'x', list(RING), pre=[C.Quantize()], post=[C.Dequantize(jnp.float32)]),
    x, local=False)
out['ppermute_plain'] = sm(lambda v: C.xdma_ppermute(v, 'x', list(RING)), x,
                           local=False)
out['ppermute_half'] = sm(lambda v: C.xdma_ppermute(v, 'x', list(HALF)), x,
                          local=False)
out['cross_stage'] = sm(lambda v: cross_stage_transfer(v, 'x', HALF), kv)
out['cross_stage_transposed'] = sm(
    lambda v: cross_stage_transfer(v, 'x', HALF, transpose=True), kv)
peer_codec = C.describe(Endpoint.local(C.MN), Endpoint.peer('x', RING),
                        pre=(C.Quantize(),), post=(C.Dequantize(jnp.float32),))
out['transfer_peer_codec'] = sm(lambda v: xdma.transfer(v, peer_codec), x,
                                local=False)
pq = C.describe(Endpoint.local(C.MN), Endpoint.peer('x', RING),
                pre=(C.Quantize(),))
def pq_body(v):
    return tuple(xdma.transfer(v, pq).tree_flatten()[0])
qv, qs = jax.jit(shard_map_compat(pq_body, mesh, PS('x'), (PS('x'), PS('x'))))(x)
out['peer_quantize_values'], out['peer_quantize_scales'] = np.asarray(qv), np.asarray(qs)
# the same shard_map run eagerly (no jit): its Quantize divides by 127
_, qs_eager = shard_map_compat(pq_body, mesh, PS('x'), (PS('x'), PS('x')))(x)
out['peer_quantize_scales_eager'] = np.asarray(qs_eager)
a2a = C.describe(Endpoint.local(C.MN), Endpoint.all_to_all('x', 0, 1))
out['transfer_all_to_all'] = sm(lambda v: xdma.transfer(v, a2a), a)
out['all_to_all'] = sm(lambda v: C.xdma_all_to_all(v, 'x', split_axis=0,
                                                   concat_axis=1), a)
a2a_codec = C.describe(Endpoint.local(C.MN), Endpoint.all_to_all('x', 0, 1),
                       pre=(C.Quantize(),), post=(C.Dequantize(jnp.float32),))
out['all_to_all_codec'] = sm(lambda v: xdma.transfer(v, a2a_codec), a)
red_codec = C.describe(Endpoint.local(C.MN), Endpoint.reduce('x', N),
                       pre=(C.Quantize(),), post=(C.Dequantize(jnp.float32),))
out['reduce_codec'] = sm(lambda v: xdma.transfer(v, red_codec), g)
scaled = C.describe(Endpoint.local(C.MN), Endpoint.reduce('x', N),
                    pre=(C.Scale(2.0), C.Quantize()),
                    post=(C.Dequantize(jnp.float32),))
out['reduce_scaled'] = sm(lambda v: xdma.transfer(v, scaled), g)
plain = C.describe(Endpoint.local(C.MN), Endpoint.reduce('x', N),
                   post=(C.BiasAdd(1.0),))
out['reduce_bias'] = sm(lambda v: xdma.transfer(v, plain), g)
out['reduce_descriptor'] = sm(
    lambda v: xdma.transfer(v, C.reduce_descriptor('x', N)), g)
out['reduce_descriptor_codec'] = sm(lambda v: xdma.transfer(
    v, C.reduce_descriptor('x', N, compressed=True)), g)
orphan = C.describe(Endpoint.local(C.MN), Endpoint.reduce('x', N),
                    post=(C.Dequantize(jnp.bfloat16),))
try:
    sm(lambda v: xdma.transfer(v, orphan), g)
    meta['orphan_dequantize_raises'] = False
except Exception:
    meta['orphan_dequantize_raises'] = True
plugin_compiler.clear_stats()
side_cast = C.describe(Endpoint.local(C.MN), Endpoint.peer('x', RING),
                       post=(C.Cast(jnp.bfloat16), C.Scale(0.5)))
out['side_dst_cast_scale'] = sm(lambda v: xdma.transfer(v, side_cast), x).view(np.uint16)
side_t = C.describe(Endpoint.local(C.MN), Endpoint.peer('x', RING, C.MNM8N8),
                    pre=(C.Transpose(),))
out['side_src_transpose'] = sm(lambda v: xdma.transfer(v, side_t), x)
side_norm = C.describe(Endpoint.local(C.MNM8N128), Endpoint.all_to_all('x', 0, 0),
                       pre=(C.RMSNormPlugin(),))
out['side_src_rmsnorm_a2a'] = sm(lambda v: xdma.transfer(
    C.MNM8N128.from_logical(v), side_norm), x)
mcast = C.describe(Endpoint.local(C.MN), Endpoint.multicast_axis('x', RING))
out['multicast_axis'] = sm(lambda v: xdma.transfer(v, mcast), x, local=False)
sm(lambda v: xdma.transfer(v, peer_codec), x, local=False)
meta['cfg_stats'] = plugin_compiler.cfg_stats()
with capture(name='remote') as tr:
    sm(lambda v: xdma.transfer(v, peer_codec), x)
    sm(lambda v: xdma.transfer(v, red_codec), x)
    sm(lambda v: xdma.transfer(v, C.reduce_descriptor('x', N)), x)
meta['trace'] = [(e.endpoint, e.nbytes, e.wire_nbytes, list(e.logical_shape),
                  e.label) for e in tr.events]
np.savez(OUT + '.npz', **out)
with open(OUT + '.json', 'w') as f:
    json.dump(meta, f)
print('OK')
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "out")
    tests = os.path.dirname(os.path.abspath(__file__))
    out = run_multidevice(f"TESTS = {tests!r}\nOUT = {path!r}\n" + _REF)
    assert "OK" in out
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    with open(path + ".json") as f:
        arrays.update(json.load(f))
    return arrays


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    ranks = S.run_spmd(RC.port_body, (RC.N,), ("x",), device="cpu",
                       workdir=str(tmp_path_factory.mktemp("spmd")))
    out = {}
    for k, v in ranks[0].items():
        out[k] = torch.cat([r[k] for r in ranks]) \
            if isinstance(v, torch.Tensor) else [r[k] for r in ranks]
    return out


BITWISE = ["compressed_psum", "feedback_reduced", "feedback_err",
           "ppermute_codec", "ppermute_plain", "ppermute_half", "cross_stage",
           "cross_stage_transposed", "transfer_peer_codec",
           "peer_quantize_values", "peer_quantize_scales",
           "transfer_all_to_all", "all_to_all", "all_to_all_codec",
           "reduce_codec", "reduce_scaled", "reduce_descriptor_codec",
           "side_src_transpose", "multicast_axis"]


@pytest.mark.parametrize("case", BITWISE)
def test_remote_case_bitwise(ref, port, case):
    got, want = port[case], ref[case]
    assert tuple(got.shape) == want.shape, (case, got.shape, want.shape)
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=case)


def test_compressed_psum_within_the_reference_bound(port):
    g = RC.global_inputs()["g"]
    exact = g.astype(np.float64).sum(0)
    for case in ("compressed_psum", "reduce_codec", "reduce_descriptor_codec"):
        got = port[case].numpy().astype(np.float64)
        for r in range(RC.N):
            rel = np.abs(got[r] - exact).max() / np.abs(exact).max()
            assert rel < 0.02, (case, r, rel)
    scaled = port["reduce_scaled"].numpy()
    rel2 = np.abs(scaled[0] - 2 * exact).max() / np.abs(2 * exact).max()
    assert rel2 < 0.02, rel2
    # error feedback: the residual is bounded by the input
    assert np.abs(port["feedback_err"].numpy()).max() < np.abs(g).max()


def test_codec_transfers_equal_the_backend_functions(port):
    """The descriptor spelling lowers to exactly the backend function."""
    for a, b in (("transfer_peer_codec", "ppermute_codec"),
                 ("reduce_codec", "compressed_psum"),
                 ("reduce_descriptor_codec", "compressed_psum"),
                 ("transfer_all_to_all", "all_to_all"),
                 ("multicast_axis", "ppermute_plain")):
        np.testing.assert_array_equal(bits(port[a]), bits(port[b]),
                                      err_msg=f"{a} vs {b}")


@pytest.mark.parametrize("case", ["reduce_bias", "reduce_descriptor"])
def test_plain_reduce_within_rtol(ref, port, case):
    g = RC.global_inputs()["g"].astype(np.float64)
    bias = 1.0 if case == "reduce_bias" else 0.0
    np.testing.assert_allclose(port[case].numpy(), ref[case], rtol=1e-5,
                               atol=1e-5)
    for r in range(RC.N):
        np.testing.assert_allclose(port[case].numpy()[r], g.sum(0) + bias,
                                   rtol=1e-5, atol=1e-5)


def test_moves_land_where_the_perm_sends_them(port):
    inp = RC.global_inputs()
    np.testing.assert_array_equal(port["ppermute_plain"].numpy(),
                                  np.roll(inp["x"], 1, axis=0))
    half = port["ppermute_half"].numpy()
    np.testing.assert_array_equal(half[4:], inp["x"][:4])
    assert not half[:4].any()                  # no pair sends to ranks 0-3
    np.testing.assert_array_equal(port["cross_stage"].numpy()[4:],
                                  inp["kv"][:4])


def test_side_with_a_cast_on_the_dst_host(ref, port):
    got = port["side_dst_cast_scale"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(got), ref["side_dst_cast_scale"])


def test_side_rmsnorm_on_the_src_host(ref, port):
    np.testing.assert_allclose(port["side_src_rmsnorm_a2a"].numpy(),
                               ref["side_src_rmsnorm_a2a"], rtol=2e-5,
                               atol=1e-5)


def test_reference_eager_shard_map_divides_where_jit_multiplies(ref, port):
    """A gap between the reference's own backends: run eagerly (no jit
    around the shard_map), its Quantize divides amax by 127; under jit XLA
    multiplies by f32(1/127).  The port follows the jitted program."""
    x = RC.global_inputs()["x"]
    amax = np.abs(x).max(-1, keepdims=True)
    np.testing.assert_array_equal(ref["peer_quantize_scales_eager"],
                                  np.roll(amax / np.float32(127), 1, axis=0))
    np.testing.assert_array_equal(ref["peer_quantize_scales"],
                                  np.roll(amax * np.float32(1 / 127), 1,
                                          axis=0))
    differ = (bits(ref["peer_quantize_scales_eager"])
              != bits(port["peer_quantize_scales"])).sum()
    assert differ == 6, differ                 # of 128 rows


def test_orphan_dequantize_fails_loudly(ref, port):
    assert ref["orphan_dequantize_raises"] is True
    assert port["orphan_dequantize_raises"] == [True] * RC.N


def test_side_cfg_stats_match_reference(ref, port):
    for stats in port["cfg_stats"]:
        assert stats == ref["cfg_stats"]
    assert ref["cfg_stats"]["fused"] == 3       # dst cast, src transpose, norm


def test_trace_prices_remote_wires_as_the_reference(ref, port):
    want = [tuple(e) for e in ref["trace"]]
    for events in port["trace"]:
        assert [tuple(e) for e in events] == want
    assert [e[0] for e in want] == ["peer", "reduce", "reduce"]


def test_every_collective_is_issued_from_the_remote_engine(port):
    for calls in port["collective_calls"]:
        kinds = {name for name, _ in calls}
        assert {"all_to_all_single", "all_reduce", "all_gather"} <= kinds
        assert all(in_plane for _, in_plane in calls), \
            [name for name, ok in calls if not ok]


def test_wire_bank_counts_the_codec_payload(port):
    # a (1, 16, 128) f32 shard through Quantize: int8 values, then one f32
    # scale a row, each an all_to_all of the bytes this rank sends
    for wire in port["wire"]:
        assert wire["bytes:all_to_all"] == 16 * 128 + 16 * 4
        assert wire["calls:all_to_all"] == 2
        assert wire["backend:gloo"] == 2
        assert "host_hop_bytes" not in wire    # CPU tensors: no hop


# -- size-1 axes: every remote kind, seeded descriptor cases --------------------
@pytest.mark.parametrize("kind", ["peer", "all_to_all", "reduce"])
@pytest.mark.parametrize("i", range(8))
def test_seeded_remote_case_on_a_size_one_axis(kind, i):
    rng = np.random.default_rng(2000 + 10 * i + TD.KINDS.index(kind))
    case = TD.make_case(rng, kind=kind)
    x, ref = case.build()
    desc = port_desc(ref)
    want = TD.run_transfer(x, ref)          # in a size-1 shard_map
    with S.local_axis("m"):
        got = px.transfer(to_torch(np.asarray(x)), desc)
    tol = O.chain_tolerance(ref)
    if any(isinstance(p, RP.ReduceStage) and p.op == "sum"
           for p in ref.plugins):
        tol = dict(rtol=2e-2, atol=2e-2) if tol["rtol"] > 1e-4 else \
            dict(rtol=1e-4, atol=1e-4)
    if isinstance(want, RP.QTensor):
        _assert_quantize_bitwise(x, ref, desc, got, tol, repr(case))
        return
    assert_same_payload(got, want, context=repr(case), **tol)


def test_an_unregistered_axis_raises():
    from repro_torch import core as C
    desc = C.describe(C.Endpoint.local(C.MN), C.Endpoint.peer("y", [(0, 0)]))
    with pytest.raises(LookupError, match="'y' is not registered"):
        px.transfer(torch.zeros(8, 128), desc)
    with S.local_axis("x"):
        with pytest.raises(LookupError, match="'y'"):
            px.transfer(torch.zeros(8, 128), desc)
    assert "y" not in S.registered_axes() and "x" not in S.registered_axes()


# -- sharding: the mesh, the backend, the launcher -------------------------------
def test_a_two_axis_mesh_groups_ranks_row_major(tmp_path):
    ranks = S.run_spmd(RC.mesh2d_body, (2, 4), ("data", "model"),
                       device="cpu", workdir=str(tmp_path))
    for rank, out in enumerate(ranks):
        d, m = divmod(rank, 4)
        assert out["data"] == (d, 2) and out["model"] == (m, 4)
        row = [4 * d + j for j in range(4)]
        np.testing.assert_array_equal(out["sum_model"].numpy(),
                                      np.full(4, float(sum(row))))
        np.testing.assert_array_equal(out["sum_data"].numpy(),
                                      np.full(4, float(m + (m + 4))))
        np.testing.assert_array_equal(out["sum_all"].numpy(),
                                      np.full(4, float(sum(range(8)))))
        assert out["backend"] == "gloo"


def test_a_failing_rank_fails_the_run(tmp_path):
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        S.run_spmd(RC.failing_body, (2,), ("x",), device="cpu",
                   workdir=str(tmp_path))


def test_backend_follows_the_cards():
    assert S.pick_backend(8, "cpu")[0] == "gloo"
    if not torch.cuda.is_available():
        # a CUDA world here has no card a rank: gloo, never NCCL
        backend, note = S.pick_backend(4, "cuda")
        assert backend == "gloo" and "gloo" in note


@pytest.mark.parametrize("layout", ["bshd", "bkhs", "bksh"])
@pytest.mark.parametrize("axes", [
    dict(), dict(batch=("pod", "data"), model="model", seq="data",
                 model_size=4, batch_size=8),
    dict(batch=("data",), model="model", model_size=3),
    dict(batch=(), model=None, seq=None)])
def test_kv_cache_spec_matches_reference(axes, layout):
    from repro import sharding as RS
    for n_kv in (4, 8, 6):
        want = RS.kv_cache_spec(RS.Axes(**axes), n_kv, layout)
        got = S.kv_cache_spec(S.Axes(**axes), n_kv, layout)
        assert got == tuple(want)
    assert S.Axes(**axes).batch_spec == RS.Axes(**axes).batch_spec
    assert S.constrain("x", S.spec("data")) == "x"
    assert S.CPU_AXES == S.Axes(batch=(), model=None, seq=None)
