"""Parity of the port's continuous-batching server
(``repro_torch.serving.continuous``, ``serving.requests``) with the
reference's.

The reference's ``tests/test_paged_serving.py:120-244`` run on the port
(bitwise against the fixed batch, parity through preemption, ragged
composition, vector-position decode, the page-movement ledger under
``capture()``, continuous beating static under load, the explicit
topology), as do its continuous cases in ``tests/test_rings.py`` and
``tests/test_telemetry.py``.  The port's engines serve the reference's
request streams (the same seeds draw the same prompts) on the reference's
parameters carried through numpy, and give the reference engine's tokens,
steps, preemptions and pool counters, and its simulated makespan within
1e-9.  Every decoder config serves through both engines, bitwise the
port's fixed-batch ``ServingEngine``.
"""
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_model_cases as TC  # noqa: E402
from repro import serving as RS  # noqa: E402
from repro_torch import _pytree  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime import Topology, telemetry  # noqa: E402
from repro_torch.runtime.trace import capture  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 PagedKVPool, ServingEngine,
                                 StaticBatchEngine, poisson_stream,
                                 trace_stream, uniform_stream)
from repro_torch.serving.continuous import HW_FLOPS, _leaf_metas  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401

F32 = torch.float32


@pytest.fixture(scope="module")
def model():
    """qwen3's smoke config in f32, the reference's parameters on both."""
    rcfg, cfg = TC.configs("qwen3_1p7b", dtype=TC.F32)
    rp, pp = TC.params(rcfg)
    return rcfg, rp, cfg, pp


def _engine(cls, cfg, params, **kw):
    kw.setdefault("cache_dtype", F32)
    return cls(cfg, params, device="cpu", **kw)


def _fixed_tokens(cfg, params, reqs, max_len, n_steps):
    toks = torch.from_numpy(np.stack([r.tokens for r in reqs]))
    eng = ServingEngine(cfg, params, max_len=max_len, cache_dtype=F32,
                        device="cpu")
    return eng.generate({"tokens": toks}, n_steps).numpy()


# -- tests/test_paged_serving.py:120-244 on the port ----------------------------
def test_continuous_matches_fixed_batch_bitwise(model):
    *_, cfg, params = model
    reqs = uniform_stream(cfg, 2, 0.0, prompt_len=4, max_new=3)
    ref = _fixed_tokens(cfg, params, reqs, 24, 3)
    rep = _engine(ContinuousBatchingEngine, cfg, params, max_len=24,
                  max_batch=4).serve(reqs)
    assert rep.n_requests == 2 and rep.preemptions == 0
    for r in reqs:
        np.testing.assert_array_equal(rep.tokens[r.rid], ref[r.rid])


def test_continuous_parity_survives_preemption(model):
    *_, cfg, params = model
    reqs = uniform_stream(cfg, 3, 0.0, prompt_len=8, max_new=4)
    ref = _fixed_tokens(cfg, params, reqs, 24, 4)
    rep = _engine(ContinuousBatchingEngine, cfg, params, max_len=24,
                  max_batch=3, pool=PagedKVPool(7, 32)).serve(reqs)
    assert rep.preemptions > 0, "pool of 7 pages must force preemption"
    assert rep.pool_stats["evictions"] > 0
    assert rep.pool_stats["restores"] == rep.pool_stats["evictions"]
    for r in reqs:
        np.testing.assert_array_equal(rep.tokens[r.rid], ref[r.rid])


def test_ragged_batch_tokens_independent_of_composition(model):
    *_, cfg, params = model
    stream = trace_stream(cfg, [(0.0, 4, 4), (10e-6, 8, 3), (30e-6, 4, 5)],
                          seed=3)
    rep = _engine(ContinuousBatchingEngine, cfg, params, max_len=24,
                  max_batch=4).serve(stream)
    assert rep.n_requests == 3
    for r in stream:
        solo = _engine(ContinuousBatchingEngine, cfg, params, max_len=24,
                       max_batch=1).serve([r])
        np.testing.assert_array_equal(solo.tokens[r.rid], rep.tokens[r.rid])


def test_vector_pos_decode_matches_scalar(model):
    *_, cfg, params = model
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 6)).astype(np.int32))
    cache = lm.init_cache(cfg, 2, 24, F32, device="cpu")
    logits, cache = lm.prefill(cfg, params, {"tokens": toks}, cache)
    nxt = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    l_s, c_s = lm.decode_step(cfg, params, nxt, cache)
    cache_v = dict(cache, pos=torch.full((2,), int(cache["pos"]),
                                         dtype=torch.int32))
    l_v, c_v = lm.decode_step(cfg, params, nxt, cache_v)
    np.testing.assert_array_equal(l_s.numpy(), l_v.numpy())
    assert tuple(c_v["pos"].shape) == (2,)
    np.testing.assert_array_equal(c_v["pos"].numpy(),
                                  np.full((2,), int(c_s["pos"])))


def test_every_page_movement_is_captured(model):
    *_, cfg, params = model
    reqs = uniform_stream(cfg, 3, 5e-6, prompt_len=4, max_new=3)
    eng = _engine(ContinuousBatchingEngine, cfg, params, max_len=24,
                  max_batch=2, pool=PagedKVPool(8, 32))
    with capture(name="serve") as tr:
        rep = eng.serve(reqs)
    page_events = tr.labelled("page:")
    assert len(page_events) == rep.pool_stats["movements"]
    assert rep.pool_stats["movements"] > 0
    assert all(e.link is not None for e in page_events)
    by_op = {}
    for e in page_events:
        op = e.label.split(":")[2]
        by_op[op] = by_op.get(op, 0) + 1
    assert (by_op.get("store", 0) + by_op.get("decode", 0)
            == rep.pool_stats["stores"])
    assert by_op.get("load", 0) == rep.pool_stats["loads"]
    assert by_op.get("evict", 0) == rep.pool_stats["evictions"]
    assert by_op.get("restore", 0) == rep.pool_stats["restores"]


@pytest.mark.parametrize("fabric", ["host_device1", "host_device2"])
def test_continuous_beats_static_under_load(model, fabric):
    *_, cfg, params = model
    n_pairs = 1 if fabric == "host_device1" else 2
    for rate in (5e4, 1.5e5):
        stream = poisson_stream(cfg, 10, rate, prompt_lens=(4, 8),
                                max_new=(2, 6), seed=1)
        rc = _engine(ContinuousBatchingEngine, cfg, params, max_len=24,
                     max_batch=4,
                     topology=Topology.host_device(n_pairs)).serve(
                         list(stream))
        rs = _engine(StaticBatchEngine, cfg, params, max_len=24,
                     max_batch=4,
                     topology=Topology.host_device(n_pairs)).serve(
                         list(stream))
        assert rc.n_requests == rs.n_requests == 10
        assert rc.total_tokens == rs.total_tokens
        assert rc.tokens_per_s > rs.tokens_per_s, (fabric, rate)


def test_serving_engine_topology_is_explicit(model):
    *_, cfg, params = model
    eng = ServingEngine(cfg, params, max_len=16, cache_dtype=F32,
                        device="cpu")
    assert eng.topology.link_names == Topology.host_device(2).link_names
    ring = Topology.ring(4)
    eng2 = ServingEngine(cfg, params, max_len=16, cache_dtype=F32,
                         topology=ring, device="cpu")
    assert eng2.topology is ring
    assert eng2._new_scheduler().topology is ring
    cb = _engine(ContinuousBatchingEngine, cfg, params, max_len=16)
    assert cb.topology.link_names == Topology.host_device(2).link_names


# -- the port's engines against the reference's, on the same stream -----------
def _streams(mod, cfg):
    return {
        "aligned": (lambda: mod.uniform_stream(cfg, 2, 0.0, prompt_len=4,
                                               max_new=3),
                    dict(max_batch=4)),
        "preempted": (lambda: mod.uniform_stream(cfg, 3, 0.0, prompt_len=8,
                                                 max_new=4),
                      dict(max_batch=3, pool=(7, 32))),
        "ragged": (lambda: mod.trace_stream(
            cfg, [(0.0, 4, 4), (10e-6, 8, 3), (30e-6, 4, 5)], seed=3),
            dict(max_batch=4)),
        "poisson": (lambda: mod.poisson_stream(cfg, 6, 1.5e5,
                                               prompt_lens=(4, 8),
                                               max_new=(2, 5), seed=1),
                    dict(max_batch=2, pool=(10, 32))),
    }


@pytest.mark.parametrize("engine", ["continuous", "static"])
@pytest.mark.parametrize("stream", ["aligned", "preempted", "ragged",
                                    "poisson"])
def test_engine_matches_reference_engine(model, stream, engine):
    rcfg, rp, cfg, pp = model
    make_r, kw = _streams(RS, rcfg)[stream]
    make_p, _ = _streams(
        __import__("repro_torch.serving", fromlist=["x"]), cfg)[stream]
    rreqs, preqs = make_r(), make_p()
    for a, b in zip(rreqs, preqs):
        assert a.rid == b.rid and a.arrival_s == b.arrival_s \
            and a.max_new == b.max_new
        np.testing.assert_array_equal(a.tokens, b.tokens)
    rkw, pkw = dict(kw), dict(kw)
    if "pool" in kw:
        rkw["pool"] = RS.PagedKVPool(*kw["pool"])
        pkw["pool"] = PagedKVPool(*kw["pool"])
    rcls = {"continuous": RS.ContinuousBatchingEngine,
            "static": RS.StaticBatchEngine}[engine]
    pcls = {"continuous": ContinuousBatchingEngine,
            "static": StaticBatchEngine}[engine]
    want = rcls(rcfg, rp, max_len=24, cache_dtype=jnp.float32,
                **rkw).serve(rreqs)
    got = _engine(pcls, cfg, pp, max_len=24, **pkw).serve(preqs)
    assert got.engine == want.engine
    assert (got.n_requests, got.total_tokens, got.steps, got.preemptions) \
        == (want.n_requests, want.total_tokens, want.steps,
            want.preemptions)
    assert got.pool_stats == want.pool_stats
    assert sorted(got.tokens) == sorted(want.tokens)
    for rid in want.tokens:
        np.testing.assert_array_equal(got.tokens[rid], want.tokens[rid])
    for f in ("elapsed_s", "p50_s", "p99_s", "ttft_p50_s", "ttft_p99_s",
              "tbt_p50_s", "tbt_p99_s"):
        assert abs(getattr(got, f) - getattr(want, f)) <= 1e-9 * max(
            1.0, abs(getattr(want, f))), f


def test_leaf_metas_and_clock_constants_match_reference(model):
    """The cache-leaf classification (probed on the meta device, nothing
    allocated) and the simulated clock's constants are the reference's."""
    from repro.serving import continuous as RCo
    rcfg, rp, cfg, pp = model
    for arch in ("qwen3_1p7b", "jamba_1p5_large_398b", "xlstm_125m",
                 "gemma3_27b"):
        rc, pc = TC.configs(arch, dtype=TC.F32)
        want, _ = RCo._leaf_metas(rc, 24, jnp.float32)
        got, template = _leaf_metas(pc, 24, F32)
        assert [dataclasses_tuple(m) for m in got] == [
            dataclasses_tuple(m) for m in want], arch
        assert all(t.device.type == "meta" or t.dim() == 0
                   for t in _pytree.leaves(template))
    assert HW_FLOPS == RCo.HW_FLOPS
    eng = _engine(ContinuousBatchingEngine, cfg, pp, max_len=24)
    reng = RCo.ContinuousBatchingEngine(rcfg, rp, max_len=24)
    assert eng._n_params == reng._n_params


def dataclasses_tuple(m):
    return (m.index, m.kind, m.batch_axis, m.seq_axis, m.rpt, m.rows, m.cols)


# -- every decoder config, both engines -----------------------------------------
DECODER_ARCHS = [a for a in TC.ARCHS if a != "whisper_small"]


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_every_decoder_config_serves_through_both_engines(arch):
    """Two requests arriving together: both engines give the fixed-batch
    engine's tokens bitwise (a smoke config in f32, the port's weights);
    a vlm prompt is token ids here, as the reference's stream draws them."""
    _, cfg = TC.configs(arch, dtype=TC.F32)
    params = lm.init_params(cfg, 0, device="cpu")
    reqs = uniform_stream(cfg, 2, 0.0, prompt_len=6, max_new=3)
    ref = _fixed_tokens(cfg, params, reqs, 24, 3)
    for cls in (ContinuousBatchingEngine, StaticBatchEngine):
        rep = _engine(cls, cfg, params, max_len=24, max_batch=2).serve(reqs)
        assert rep.n_requests == 2, (arch, cls.name)
        for r in reqs:
            np.testing.assert_array_equal(rep.tokens[r.rid], ref[r.rid])


def test_encoder_decoder_configs_use_the_fixed_batch_engine():
    _, cfg = TC.configs("whisper_small", dtype=TC.F32)
    with pytest.raises(NotImplementedError, match="ServingEngine"):
        ContinuousBatchingEngine(cfg, {}, max_len=16, device="cpu")


# -- tests/test_rings.py:316 and tests/test_telemetry.py:326 on the port --------
def test_depth2_rings_survive_forced_preemption_with_token_parity(model):
    *_, cfg, params = model
    reqs = uniform_stream(cfg, 3, 0.0, prompt_len=8, max_new=4)

    def serve(ring_depth, backpressure):
        return _engine(ContinuousBatchingEngine, cfg, params, max_len=24,
                       max_batch=3, pool=PagedKVPool(7, 32),
                       ring_depth=ring_depth,
                       backpressure=backpressure).serve(reqs)

    ref = serve(None, "block")
    for policy in ("block", "error"):
        got = serve(2, policy)
        assert got.preemptions > 0
        for r in reqs:
            np.testing.assert_array_equal(got.tokens[r.rid],
                                          ref.tokens[r.rid])


def test_snapshot_subsumes_surfaces_and_slo_histograms(model):
    *_, cfg, params = model
    reqs = uniform_stream(cfg, 3, 1e-5, prompt_len=8, max_new=3, seed=0)
    eng = _engine(ContinuousBatchingEngine, cfg, params, max_len=24,
                  max_batch=2, capacity_pages=48)
    telemetry.reset("links")
    with telemetry.session(name="serve") as tel, \
            capture(name="serve") as tr:
        rep = eng.serve(reqs)
        snap = telemetry.snapshot()
    assert snap["session"] == "serve"
    for key in ("cache_stats", "agu_stats", "cfg_stats", "scheduler_links",
                "pool_stats"):
        assert key in snap["surfaces"]
    got = {k[len("bytes:"):]: v
           for k, v in snap["surfaces"]["scheduler_links"].items()
           if k.startswith("bytes:") and v}
    assert got == tr.per_link_bytes()
    assert snap["histograms"]["ttft_s"]["count"] == rep.n_requests
    assert snap["histograms"]["tbt_s"]["count"] \
        == rep.total_tokens - rep.n_requests
    assert rep.ttft_p99_s >= rep.ttft_p50_s >= 0.0
    assert rep.tbt_p99_s >= rep.tbt_p50_s >= 0.0
    phases = {s.name for s in tel.spans_on("engine")}
    assert {"engine.prefill", "engine.gather", "engine.decode",
            "engine.scatter"} <= phases


def test_finished_tasks_release_their_pages(model):
    """The engine releases each step's landed page movements on the
    scheduler: the last step's tasks hold no buffers, and their timeline
    stays."""
    *_, cfg, params = model
    reqs = uniform_stream(cfg, 2, 0.0, prompt_len=4, max_new=3)
    eng = _engine(ContinuousBatchingEngine, cfg, params, max_len=24,
                  max_batch=2)
    eng.serve(reqs)
    sched = eng.last_scheduler
    assert sched.makespan() > 0
    held = [t for t in sched._tasks.values()
            if isinstance(t.value, torch.Tensor)]
    assert not held


@pytest.mark.parametrize("pages", [6, 7])
def test_admission_counts_the_pages_of_those_admitted_before(model, pages):
    """Two prompts of 4 pages each arrive together on a pool of 6 or 7:
    each fits alone, both do not.  The port admits the second when the
    first has finished (the reference admits both against the same free
    count and runs out of pages in their prefill), and each request's
    tokens are those of a pool that holds both."""
    rcfg, rp, cfg, pp = model
    trace = [(0.0, 12, 3), (0.0, 12, 3)]
    eng = _engine(ContinuousBatchingEngine, cfg, pp, max_len=24,
                  capacity_pages=pages)
    assert eng._footprint(12) == 4 and 4 + eng._growth(12) <= pages
    got = eng.serve(trace_stream(cfg, trace, seed=2))
    want = _engine(ContinuousBatchingEngine, cfg, pp, max_len=24,
                   capacity_pages=64).serve(trace_stream(cfg, trace, seed=2))
    assert got.pool_stats["peak_used"] == 4 < want.pool_stats["peak_used"]
    assert got.steps > want.steps and got.preemptions == 0
    for rid in want.tokens:
        np.testing.assert_array_equal(got.tokens[rid], want.tokens[rid])
    with pytest.raises(MemoryError, match="out of pages"):
        RS.ContinuousBatchingEngine(
            rcfg, rp, 24, cache_dtype=jnp.float32,
            capacity_pages=pages).serve(RS.trace_stream(rcfg, trace,
                                                        seed=2))
