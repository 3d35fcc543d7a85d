"""Parity of the port's MoE layer (``repro_torch.layers.moe``) with the
reference's.

Local path: the reference's ``init_moe`` parameters cross through numpy,
the same seeded tokens go through the reference's jitted ``moe_apply`` and
the port's on the CPU; the routing (expert ids, slots, kept flags, the
expert-sorted order) is held bitwise, the output and the load-balance loss
within 1e-5 of max|y|.  The reference's MoE tests of
``tests/test_xdma_integration.py`` run on the port, with a tie case (the
top-k's tie order) and a k = 8 combine whose sum order shows in the bits.

Distributed paths: one 8-rank gloo world on the CPU over a (2, 4) mesh
('data', 'model') runs the expert-parallel, int8-wire, decode-scale
(no sequence split), scheduled and tensor-parallel paths and the ring
all-gather (``tests/torch_remote_cases.py::moe_body``); one 8-device
reference subprocess runs the same cases under ``jax.jit`` and
``shard_map``.  Each is held to the port's local path with the reference's
own bounds (``tests/test_remote.py:62,86``, ``tests/test_api.py:417``,
``tests/test_runtime.py:351``) and to the reference's outputs.
"""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_model_cases as TC  # noqa: E402
import torch_remote_cases as RC  # noqa: E402
from conftest import given, run_multidevice, settings, st  # noqa: E402
from repro.layers import moe as RM  # noqa: E402
from repro_torch import configs as PCF  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.core import Dequantize, Quantize  # noqa: E402
from repro_torch.layers import moe as PM  # noqa: E402
from repro_torch.layers._init import Init  # noqa: E402
from repro_torch.models import lm as PL  # noqa: E402
from repro_torch.runtime import DistributedScheduler, Topology  # noqa: E402
from repro_torch.runtime import telemetry  # noqa: E402
from repro_torch.runtime.trace import capture  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401

# the MoE FFN of each MoE arch's smoke config
MOE_CFGS = {"qwen3_moe": "qwen3_moe_30b_a3b", "mixtral": "mixtral_8x7b",
            "jamba": "jamba_1p5_large_398b"}


def _moe(rcfg, pcfg, seed=0, shape=(2, 16)):
    """The reference's init_moe parameters (and the port's copy), tokens."""
    rp = RM.init_moe(jax.random.PRNGKey(seed), rcfg)
    pp = PL.params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        shape + (rcfg.d_model,)).astype(np.float32)
    return rp, pp, x


# -- the local path ------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(MOE_CFGS))
def test_local_moe_matches_reference(name):
    rcfg, pcfg = TC.configs(MOE_CFGS[name], dtype=TC.F32)
    rp, pp, x = _moe(rcfg, pcfg)
    tokens = x.reshape(-1, rcfg.d_model)
    T = tokens.shape[0]
    cap = int(rcfg.capacity_factor * rcfg.top_k * T // rcfg.n_experts) + 1
    assert PM._capacity(pcfg, T) == cap

    def ref(p, t):
        gates, eidx, aux = RM._route(rcfg, p["router"], t)
        buf, slot, keep, order, tok_of = RM._dispatch(rcfg, t, eidx, gates,
                                                      cap)
        return gates, eidx, aux, buf, slot, keep, order, tok_of

    r = jax.jit(ref)(rp, jnp.asarray(tokens))
    pt = torch.from_numpy(tokens)
    gates, eidx, aux = PM._route(pcfg, pp["router"], pt)
    buf, slot, keep, order, tok_of = PM._dispatch(pcfg, pt, eidx, gates, cap)
    for what, got, want in (("eidx", eidx, r[1]), ("slot", slot, r[4]),
                            ("keep", keep, r[5]), ("order", order, r[6]),
                            ("tok_of", tok_of, r[7])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=what)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(r[3]))
    assert int((~keep).sum()) == int((~np.asarray(r[5])).sum())
    want_y, want_aux = jax.jit(lambda p, v: RM.moe_apply(rcfg, p, v))(
        rp, jnp.asarray(x))
    got_y, got_aux = PM.moe_apply(pcfg, pp, torch.from_numpy(x))
    want_y = np.asarray(want_y)
    scale = np.abs(want_y).max()
    assert np.abs(got_y.numpy() - want_y).max() <= 1e-5 * scale
    assert abs(float(got_aux) - float(want_aux)) <= 1e-5 * scale


def test_local_moe_drops_the_reference_tokens_at_decode():
    """T = B at decode: two slots an expert in the smoke config (one in the
    full qwen3-moe config: 128 experts, top-8), so choices drop, and the
    port drops the reference's."""
    rcfg, pcfg = TC.configs("qwen3_moe_30b_a3b", dtype=TC.F32)
    rp, pp, x = _moe(rcfg, pcfg, seed=3, shape=(4, 1))
    want, _ = jax.jit(lambda p, v: RM.moe_apply(rcfg, p, v))(
        rp, jnp.asarray(x))
    got, _ = PM.moe_apply(pcfg, pp, torch.from_numpy(x))
    assert PM._capacity(pcfg, 4) == 2
    assert PM._capacity(PCF.get_config("qwen3_moe_30b_a3b"), 4) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())


def test_top_k_ties_go_to_the_lower_expert():
    """Uniform router probabilities: lax.top_k picks experts 0..k-1, so
    does the port."""
    rcfg, pcfg = TC.configs("qwen3_moe_30b_a3b", dtype=TC.F32, top_k=4)
    tokens = np.random.default_rng(0).standard_normal(
        (6, rcfg.d_model)).astype(np.float32)
    w = np.zeros((rcfg.d_model, rcfg.n_experts), np.float32)
    _, want, _ = RM._route(rcfg, jnp.asarray(w), jnp.asarray(tokens))
    gates, got, _ = PM._route(pcfg, torch.from_numpy(w),
                              torch.from_numpy(tokens))
    assert (np.asarray(want) == np.arange(4)).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gates.numpy(), np.full((6, 4), 0.25,
                                                         np.float32))


def test_combine_sums_in_the_reference_order():
    """k = 8: each token's eight weighted expert outputs, of magnitudes
    from 1e-4 to 1e4, summed in increasing position of the expert-sorted
    order (by expert id), bitwise the reference's scatter-add; summed in
    the reverse order they differ in the last bits."""
    E, k, T, d = 16, 8, 12, 32
    rcfg, pcfg = TC.configs("qwen3_moe_30b_a3b", dtype=TC.F32, n_experts=E,
                            top_k=k, capacity_factor=4.0)
    rng = np.random.default_rng(5)
    eidx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)
    gates = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    mag = (10.0 ** rng.uniform(-4, 4, (E, 1, 1))).astype(np.float32)
    cap = int(rcfg.capacity_factor * k * T // E) + 1
    out_buf = (rng.standard_normal((E, cap, d)) * mag).astype(np.float32)
    tokens = np.zeros((T, d), np.float32)
    _, slot, keep, order, _ = RM._dispatch(rcfg, jnp.asarray(tokens),
                                           jnp.asarray(eidx),
                                           jnp.asarray(gates), cap)
    want = np.asarray(jax.jit(lambda *a: RM._combine(rcfg, *a, T, d))(
        jnp.asarray(out_buf), slot, keep, order, jnp.asarray(gates)))
    pt = [torch.from_numpy(np.array(a)) for a in (slot, keep, order)]
    got = PM._combine(pcfg, torch.from_numpy(out_buf), *pt,
                      torch.from_numpy(gates), T, d)
    np.testing.assert_array_equal(got.numpy(), want)
    # the reverse order gives other bits: the order is what the test holds
    flat = np.concatenate([out_buf.reshape(-1, d), np.zeros((1, d),
                                                            np.float32)])
    slot_, keep_, order_ = (np.asarray(a) for a in (slot, keep, order))
    contrib = flat[np.minimum(slot_, len(flat) - 1)] \
        * gates.reshape(-1)[order_][:, None] * keep_[:, None]
    rev = np.zeros((T, d), np.float32)
    for i in reversed(range(T * k)):
        rev[order_[i] // k] += contrib[i]
    assert not np.array_equal(rev, want)


# -- tests/test_xdma_integration.py:55,83,94 on the port ----------------------
@given(st.integers(0, 50), st.sampled_from([2, 4, 8]))
@settings(max_examples=10, deadline=None)
def test_moe_combine_conserves_weighted_expert_outputs(seed, top_k_e):
    """With capacity >> tokens (no drops), MoE output == sum_k gate_k *
    expert_k(token) computed densely."""
    cfg = dataclasses.replace(
        PCF.smoke_config("qwen3_moe_30b_a3b"), dtype=torch.float32,
        n_experts=top_k_e * 2, top_k=2, capacity_factor=16.0)
    gen = torch.Generator().manual_seed(seed)
    p = PM.init_moe(Init(gen, "cpu"), cfg)
    x = torch.randn((1, 6, cfg.d_model), generator=gen)
    y, _ = PM.moe_apply(cfg, p, x)
    tokens = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(tokens @ p["router"], -1)
    gates, eidx = torch.topk(probs, 2)
    gates = gates / gates.sum(-1, keepdim=True)
    dense = torch.einsum("td,edf->tef", tokens, p["w_gate"])
    up = torch.einsum("td,edf->tef", tokens, p["w_up"])
    outs = torch.einsum("tef,efd->ted", torch.nn.functional.silu(dense) * up,
                        p["w_down"])
    ref = torch.zeros_like(tokens)
    for kk in range(2):
        ref = ref + gates[:, kk:kk + 1] * outs[torch.arange(len(tokens)),
                                               eidx[:, kk]]
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(),
                               ref.numpy(), rtol=2e-4, atol=2e-4)


def test_moe_dropping_bounded_by_capacity():
    """With capacity factor ~0, most tokens drop -> output ~ 0 (never NaN)."""
    cfg = dataclasses.replace(PCF.smoke_config("mixtral_8x7b"),
                              dtype=torch.float32, capacity_factor=0.01)
    p = PM.init_moe(Init(torch.Generator().manual_seed(0), "cpu"), cfg)
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    y, aux = PM.moe_apply(cfg, p, x)
    assert torch.isfinite(y).all()
    assert np.isfinite(float(aux))


def test_int8_wire_roundtrip_precision():
    x = torch.randn((64, 256), generator=torch.Generator().manual_seed(0))
    deq = Dequantize(torch.float32)(Quantize()(x))
    rel = float((deq - x).abs().max() / x.abs().max())
    assert rel < 0.01


def test_init_moe_draws_the_reference_shapes_and_std():
    rcfg, pcfg = TC.configs("qwen3_moe_30b_a3b", dtype=TC.F32, d_model=256,
                            d_ff_expert=512)
    want = jax.eval_shape(lambda: RM.init_moe(jax.random.PRNGKey(0), rcfg))
    got = PM.init_moe(Init(torch.Generator().manual_seed(0), "cpu"), pcfg)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape and got[k].dtype == torch.float32
    for k, std in (("router", 256 ** -0.5), ("w_gate", 256 ** -0.5),
                   ("w_down", 512 ** -0.5)):
        assert abs(float(got[k].std()) / std - 1) < 0.03


# -- the distributed paths: one world a side -----------------------------------
_REF = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.layers import moe as MOE
from repro.runtime import DistributedScheduler, Topology
from repro.sharding import Axes, P, shard_map_compat
sys.path.insert(0, TESTS)
import torch_remote_cases as RC
inp = RC.moe_inputs()
cfg, cfg2, cfg_tp, cfg_tp2 = RC.moe_configs(configs, dataclasses, Axes,
                                            jnp.float32)
p = {k: jnp.asarray(v) for k, v in inp['p'].items()}
p_tp = {k: jnp.asarray(v) for k, v in inp['p_tp'].items()}
x = jnp.asarray(inp['x'])
mesh = jax.make_mesh(*RC.MOE_MESH)
out, meta = {}, {}
run = lambda c, v, **kw: jax.jit(lambda xx: MOE.moe_apply(c, p if c.n_experts == 8 else p_tp, xx, mesh=mesh, **kw))(v)
with mesh:
    out['ep'], out['ep_aux'] = run(cfg2, x)
    out['int8'], _ = run(dataclasses.replace(cfg2, moe_wire_int8=True), x)
    out['nosplit'], _ = run(cfg2, x[:, :2])
    sched = DistributedScheduler(Topology.parallel(2, prefix='a2a'), name='moe')
    out['sched'], _ = run(cfg2, x, scheduler=sched)
    tight = dataclasses.replace(cfg2, capacity_factor=1.0)
    out['tight'], _ = run(tight, x)
    out['tight_sched'], _ = run(tight, x, scheduler=DistributedScheduler(
        Topology.parallel(2, prefix='a2a'), name='moe2'))
    out['tp'], _ = run(cfg_tp2, x)
    def body(v):
        return (MOE._ring_all_gather(v, 'model', 4),
                jax.lax.all_gather(v, 'model', axis=1, tiled=True))
    out['ring'], out['ring_lax'] = jax.jit(shard_map_compat(
        body, mesh, in_specs=P(None, 'model', None),
        out_specs=P(None, 'model', None)))(jnp.asarray(inp['v']))
meta['sched_spans'] = [(s.label, s.resource, s.start, s.end)
                       for s in sched.report().spans]
np.savez(OUT + '.npz', **{k: np.asarray(v) for k, v in out.items()})
with open(OUT + '.json', 'w') as f:
    json.dump(meta, f)
print('OK')
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moe_ref") / "out")
    tests = os.path.dirname(os.path.abspath(__file__))
    out = run_multidevice(f"TESTS = {tests!r}\nOUT = {path!r}\n" + _REF)
    assert "OK" in out
    with np.load(path + ".npz") as z:
        got = {k: z[k] for k in z.files}
    with open(path + ".json") as f:
        got.update(json.load(f))
    return got


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return S.run_spmd(RC.moe_body, *RC.MOE_MESH, device="cpu",
                      workdir=str(tmp_path_factory.mktemp("moe_spmd")))


@pytest.fixture(scope="module")
def local():
    """The port's local path on the world's inputs."""
    inp = RC.moe_inputs()
    cfg, _, cfg_tp, _ = RC.moe_configs(PCF, dataclasses, S.Axes,
                                       torch.float32)
    p = {k: torch.from_numpy(v) for k, v in inp["p"].items()}
    p_tp = {k: torch.from_numpy(v) for k, v in inp["p_tp"].items()}
    x = torch.from_numpy(inp["x"])
    tight = dataclasses.replace(cfg, capacity_factor=1.0)
    return {"ep": PM.moe_apply(cfg, p, x)[0], "int8": PM.moe_apply(cfg, p, x)[0],
            "nosplit": PM.moe_apply(cfg, p, x[:, :2])[0],
            "sched": PM.moe_apply(cfg, p, x)[0],
            "tight": PM.moe_apply(tight, p, x)[0],
            "tp": PM.moe_apply(cfg_tp, p_tp, x)[0]}


def _global(world, case):
    """The case's output over the mesh: each data block from its model
    ranks, which must agree (the out spec replicates over model)."""
    blocks = []
    for i in range(2):
        ranks = [world[4 * i + j][case] for j in range(4)]
        for other in ranks[1:]:
            assert torch.equal(other, ranks[0]), case
        blocks.append(ranks[0])
    return torch.cat(blocks).numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


# (case, bound against the port's local path: the reference's own)
DIST_CASES = {"ep": 5e-4, "nosplit": 5e-4, "sched": 5e-4, "tp": 5e-4,
              "int8": 0.05}


@pytest.mark.parametrize("case", sorted(DIST_CASES))
def test_distributed_path_matches_local_and_reference(world, ref, local,
                                                      case):
    got = _global(world, case)
    assert _rel(got, local[case].numpy()) < DIST_CASES[case]
    # against the reference's multi-device output: f32 paths to rounding
    # (the same math, summed in other orders), the int8 wire to its bound
    tol = 0.05 if case == "int8" else 1e-5
    assert _rel(got, ref[case]) < tol, case


def test_ep_aux_is_the_pmean_of_the_ranks(world, ref):
    auxs = [float(r["ep_aux"]) for r in world]
    assert max(auxs) == min(auxs)
    assert abs(auxs[0] - float(ref["ep_aux"])) <= 1e-5 * abs(auxs[0])


def test_scheduled_dispatch_matches_unscheduled_at_tight_capacity(world, ref,
                                                                  local):
    """tests/test_runtime.py:351: capacity factor 1.0 drops tokens; the
    chunked path pads the buffer, never the capacity, so it drops the
    same ones."""
    got, want = _global(world, "tight_sched"), _global(world, "tight")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # each rank routes its own sequence slice with its own capacity, so the
    # drops differ from the local path's; the reference's run drops the same
    np.testing.assert_allclose(want, ref["tight"], rtol=1e-5, atol=1e-6)
    assert np.abs(want - local["tight"].numpy()).max() > 1e-3


def test_scheduled_dispatch_timeline_is_the_reference(world, ref):
    """Both chunks' dispatches run at once on their own links, the FFN on a
    compute engine between dispatch and return: the reference's simulated
    spans, label by label."""
    got = world[0]["sched_spans"]
    want = [tuple(s) for s in ref["sched_spans"]]
    assert [s[:2] for s in got] == [s[:2] for s in want]
    np.testing.assert_allclose([s[2:] for s in got], [s[2:] for s in want],
                               rtol=1e-12, atol=0)
    spans = {s[0]: s for s in got}
    d0, d1 = spans["a2a_dispatch[0]"], spans["a2a_dispatch[1]"]
    assert d0[1] != d1[1] and d1[2] < d0[3]
    for c in range(2):
        assert spans[f"a2a_return[{c}]"][2] >= spans[f"expert_ffn[{c}]"][3]


def test_ring_all_gather_is_bitwise(world, ref):
    """tests/test_multicast.py:345 / tests/test_trace.py: n - 1 one-hop
    multicasts are the tiled all-gather, bitwise."""
    v = RC.moe_inputs()["v"]
    for r in world:
        np.testing.assert_array_equal(r["ring"].numpy(), v)
    np.testing.assert_array_equal(ref["ring"], ref["ring_lax"])
    # the out spec stacks the four model ranks' (identical) gathers
    np.testing.assert_array_equal(ref["ring"], np.concatenate([v] * 4, 1))


def test_moe_plane_has_no_out_of_plane_collectives(world):
    """tests/test_trace.py:266: the EP path's ledger holds the dispatch and
    return all-to-alls, the ring's multicast hops and the aux reduce; every
    collective a rank called came from the movement plane."""
    for r in world:
        kinds = r["ep_kinds"]
        assert kinds.get("all_to_all", 0) >= 2, kinds
        assert kinds.get("multicast", 0) >= 3, kinds
        assert kinds.get("reduce", 0) >= 1, kinds
        assert r["calls"] and all(ok for _, ok in r["calls"]), r["calls"]


def test_three_way_parity_moe_capture():
    """tests/test_telemetry.py:146: on a size-1 model mesh with a scheduler,
    the links bank, the trace and the scheduler agree on every link's
    bytes."""
    cfg = dataclasses.replace(PCF.smoke_config("qwen3_moe_30b_a3b"),
                              dtype=torch.float32, capacity_factor=4.0)
    cfg = cfg.with_axes(S.Axes(batch=(), model="model", model_size=1,
                               batch_size=1))
    p = PM.init_moe(Init(torch.Generator().manual_seed(0), "cpu"), cfg)
    x = torch.randn((2, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    mesh = S.Mesh((1,), ("model",), 0, torch.device("cpu"), "local",
                  "a size-1 axis", {"model": S.MeshAxis("model", 1, 0)})
    sched = DistributedScheduler(Topology.parallel(2, prefix="a2a"),
                                 name="moe")
    telemetry.reset("links")
    with telemetry.session(name="moe") as tel, capture(name="moe") as tr:
        with mesh:
            y, _ = PM.moe_apply(cfg, p, x, mesh=mesh, scheduler=sched)
    want = {}
    for t in sched.sim_tasks():
        if t.resource in sched.topology and t.nbytes:
            want[t.resource] = want.get(t.resource, 0) + t.nbytes
    bank = {k: v for k, v in
            telemetry.bank("links").with_prefix("bytes:").items() if v}
    assert tr.per_link_bytes()
    assert bank == tr.per_link_bytes() == want
    for i, s in enumerate(tel.spans):
        assert s.parent < i
    local_y, _ = PM.moe_apply(cfg.with_axes(S.CPU_AXES), p, x)
    torch.testing.assert_close(y, local_y, rtol=0, atol=0)
