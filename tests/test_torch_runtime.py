"""Parity of the port's distributed runtime (``repro_torch.runtime``: the
topology, the simulator, the descriptor-ring scheduler) with the
reference's.

Each case is a single-process case of ``tests/test_runtime.py`` or of
``tests/test_rings.py``, written once as a scenario over
:class:`torch_parity.Side` and run on both packages from a fresh state.
The scenario keeps the reference test's own asserts; ``on_both`` then holds
the port to the reference: the replayed ``SimReport``, the dispatch order,
every completion's ``(start_s, end_s)``, the per-link bytes, the
incremental makespan and the ``links`` / ``queues`` / ``rings`` /
``multicast`` / ``autotune`` / ``cfg_cache`` banks exactly, and the
outputs bitwise (pure relayouts) or within the f32 chain tolerance of
``tests/oracle.py`` (rtol 2e-5, atol 1e-5) where a float plugin runs.
The reference's cases that need serving or models (KV round trips,
prefetch, MoE, the depth-2 serving run) wait for ROADMAP §1 items 7-8.
"""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from torch_parity import (bits, on_both,  # noqa: E402,F401
                          reset_global_state, sched_record)

F32_CHAIN = dict(rtol=2e-5, atol=1e-5)


def _descs(S):
    C = S.C
    return (C.describe("MN", "MNM8N128", C.RMSNormPlugin()),
            C.describe("MNM8N128", "MN", C.Transpose()),
            C.describe("MN", "MN", C.Scale(3.0)),
            C.describe("MN", "MN", C.Cast(S.dtypes["bfloat16"])))


# -- topology ----------------------------------------------------------------
def _topology_presets(S):
    Topology = S.R.Topology
    ring = Topology.ring(4)
    assert len(ring.links) == 4 and ring.nodes == ("dev0", "dev1", "dev2",
                                                   "dev3")
    assert Topology.ring(4, bidirectional=True).links_between("dev1", "dev0")
    mesh = Topology.tpu_mesh((2, 2))
    assert len(mesh.nodes) == 4 and len(mesh.links) == 8
    hd = Topology.host_device(2)
    assert hd.link_names == ("h2d0", "d2h0", "h2d1", "d2h1")
    par = Topology.parallel(3, prefix="lane")
    assert par.link("lane2").src == "memA"
    with pytest.raises(KeyError):
        par.link("lane9")
    with pytest.raises(ValueError):
        par.add_link("memA", "memB", name="lane0")
    with pytest.raises(ValueError):
        Topology.ring(1)
    star = Topology.host_device(devices=3)
    return {t.name: (t.nodes, [(l.name, l.src, l.dst, l.bandwidth, l.latency,
                                l.width, l.burst_overhead, l.csr_write_cost)
                               for l in t.links])
            for t in (ring, mesh, hd, par, star,
                      Topology.ring(4, bidirectional=True))}


def test_topology_presets_and_lookup():
    on_both(_topology_presets)


def _mesh_grid(S):
    class _MeshLike:                     # a device mesh's duck type
        devices = np.empty((2, 4), dtype=object)

    topo = S.R.Topology.tpu_mesh(_MeshLike())
    assert len(topo.nodes) == 8
    assert len(topo.links_from("dev(0,0)")) == 2
    assert topo.links_between("dev(0,3)", "dev(0,0)")
    return (topo.name, topo.nodes, topo.link_names)


def test_tpu_mesh_accepts_a_device_grid():
    on_both(_mesh_grid)


def _cost_model(S):
    link = S.R.Topology.parallel(1).link("link0")
    assert link.transfer_time(0) == link.latency
    one_beat = link.transfer_time(1)
    assert one_beat == link.transfer_time(link.width)
    assert link.transfer_time(link.width + 1) > one_beat
    return [link.transfer_time(n, b, pipeline_depth=d, issue_overhead=o)
            for n in (0, 1, 64, 65, 1 << 20, 3 * 10 ** 6 + 7)
            for b in (None, 4, 512, 4096)
            for d in (1, 9) for o in (None, 1e-6)] + [
        link.utilization(1 << 20, 512), link.utilization(0)]


def test_link_cost_model_rounds_to_beats():
    on_both(_cost_model)


# -- simulator ---------------------------------------------------------------
def _fifo(S):
    SimTask, simulate = S.R.SimTask, S.R.simulate
    topo = S.R.Topology.parallel(2)
    kb64 = 64 * 1024
    tasks = [SimTask(id=0, resource="link0", nbytes=kb64),
             SimTask(id=1, resource="link0", nbytes=kb64),
             SimTask(id=2, resource="link1", nbytes=kb64)]
    rep = simulate(tasks, topo)
    s0, s1, s2 = (rep.span_of(i) for i in range(3))
    assert s1.start == s0.end and s1.stall > 0
    assert s2.start == 0.0 and s2.start < s0.end
    rep2 = simulate(tasks, topo)
    assert rep.spans == rep2.spans and rep.makespan == rep2.makespan
    return rep


def test_per_link_fifo_with_disjoint_link_concurrency():
    on_both(_fifo)


def _cross_deps(S):
    SimTask = S.R.SimTask
    topo = S.R.Topology.parallel(2)
    tasks = [SimTask(id=0, resource="link0", nbytes=1 << 20),
             SimTask(id=1, resource="link1", nbytes=1 << 20, deps=(0,))]
    rep = S.R.simulate(tasks, topo)
    assert rep.span_of(1).start == rep.span_of(0).end
    assert rep.span_of(1).stall == 0.0
    return rep


def test_simulator_dependencies_cross_links():
    on_both(_cross_deps)


def _bad_schedules(S):
    SimTask, simulate = S.R.SimTask, S.R.simulate
    topo = S.R.Topology.parallel(1)
    errors = []
    for tasks in ([SimTask(id=0, resource="link0", deps=(7,))],
                  [SimTask(id=0, resource="link0"),
                   SimTask(id=0, resource="link0")],
                  [SimTask(id=0, resource="link0", deps=(1,)),
                   SimTask(id=1, resource="link0")]):
        with pytest.raises(ValueError) as ei:
            simulate(tasks, topo)
        errors.append(str(ei.value))
    return errors


def test_simulator_rejects_bad_schedules():
    on_both(_bad_schedules)


def _queue_contracts(S):
    C = S.C
    # the reference's kv_roundtrip_queue(float32): RMSNorm + tile, then
    # transpose + untile
    q = C.XDMAQueue([C.describe("MN", "MNM8N128", C.RMSNormPlugin(eps=1e-6)),
                     C.describe(C.tiled_layout(8, 128), "MN", C.Transpose())],
                    name="kv_roundtrip")
    tasks = S.R.queue_sim_tasks(q, (64, 128), S.dtypes["float32"], "link0")
    assert [t.deps for t in tasks] == [(), (0,)]
    assert all(t.nbytes == 2 * 64 * 128 * 4 for t in tasks)
    return tasks


def test_queue_sim_tasks_follow_shape_contracts():
    on_both(_queue_contracts)


# -- scheduler: bit-identical to serial transfer -------------------------------
def _bit_identical(S):
    xdma = S.xdma
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(2))
    x = S.rand((256, 512))
    d_store, d_load, d_scale, d_cast = _descs(S)
    f1 = sched.submit(x, d_store, link="link0")
    f2 = sched.submit(f1, d_load, link="link0")
    f3 = sched.submit(x, d_scale, link="link1")
    f4 = sched.submit(f3, d_cast, link="link1", deps=(f2,))
    sched.flush()
    s1 = xdma.transfer(x, d_store)
    s2 = xdma.transfer(s1, d_load)
    s3 = xdma.transfer(x, d_scale)
    s4 = xdma.transfer(s3, d_cast)
    values = [f.result() for f in (f1, f2, f3, f4)]
    for got, want in zip(values, (s1, s2, s3, s4)):
        np.testing.assert_array_equal(bits(got), bits(want))
    return {"values": values, **sched_record(S, sched)}


def test_scheduler_bit_identical_to_serial_transfer():
    on_both(_bit_identical, values_tol=F32_CHAIN)


def _round_batching(S):
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(2))
    x = S.rand((64, 128))
    desc = S.C.describe("MN", "MNM8N128")
    f1 = sched.submit(x, desc, link="link0")
    f2 = sched.submit(x, desc, link="link1")
    sched.flush()
    assert sched._tasks[f1.task_id].round == sched._tasks[f2.task_id].round \
        == 0
    assert S.xdma.cache_stats().misses == 1
    np.testing.assert_array_equal(bits(f1.result()), bits(f2.result()))
    return {"values": [f1.result(), f2.result()],
            "round_cache": len(S.scheduler._ROUND_CACHE),
            "cache": (S.xdma.cache_stats().hits,
                      S.xdma.cache_stats().misses),
            **sched_record(S, sched)}


def test_scheduler_round_batching_reuses_cfg_cache():
    on_both(_round_batching)


def _round_batches_compiled(S):
    C = S.C
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(2))
    x = S.rand((128, 256))
    idx = np.arange(127, -1, -1)
    d0 = C.describe("MN", "MNM8N128", C.RMSNormPlugin(), C.Scale(2.0))
    d1 = C.describe("MN", "MN", C.GatherScatter(
        indices=idx if S.name == "ref" else S.asarray(idx)))
    f0 = sched.submit(x, d0, link="link0")
    f1 = sched.submit(x, d1, link="link1")
    sched.flush()
    assert sched._tasks[f0.task_id].round == sched._tasks[f1.task_id].round \
        == 0
    np.testing.assert_array_equal(bits(f0.result()),
                                  bits(S.xdma.transfer(x, d0)))
    np.testing.assert_array_equal(bits(f1.result()),
                                  bits(S.xdma.transfer(x, d1)))
    return {"values": [f0.result(), f1.result()],
            "round_cache": len(S.scheduler._ROUND_CACHE),
            **sched_record(S, sched)}


def test_scheduler_round_batches_compiled_fused_programs():
    on_both(_round_batches_compiled, values_tol=F32_CHAIN)


# -- the simulator replays the schedule the scheduler dispatched ----------------
def _parity_batch(S, sched):
    x = S.rand((256, 512))
    d_store, d_load, d_scale, _ = _descs(S)
    futs = []
    for _ in range(3):
        f1 = sched.submit(x, d_store)
        f2 = sched.submit(f1, d_load)
        futs += [f1, f2]
    futs.append(sched.submit(x, d_scale, deps=(futs[1],)))
    sched.flush()
    return futs


def _dispatch_order(sched, resource):
    ts = [t for t in sched._tasks.values()
          if t.resource == resource and t.done]
    assert all(t.round >= 0 for t in ts)
    return [t.id for t in sorted(ts, key=lambda t: t.round)]


def _sim_replay(S, n_links):
    topo = S.R.Topology.parallel(n_links)
    sched = S.R.DistributedScheduler(topo)
    futs = _parity_batch(S, sched)
    rep = S.R.simulate(sched.sim_tasks(), topo)
    for link in topo.link_names:
        sim_order = [s.task_id for s in rep.spans if s.resource == link]
        assert sim_order == _dispatch_order(sched, link), link
        fifo = [tid for tid in sorted(sched._tasks)
                if sched._tasks[tid].resource == link]
        assert sim_order == fifo, link
    return {"values": [f.result() for f in futs], **sched_record(S, sched)}


@pytest.mark.parametrize("n_links", [1, 2])
def test_sim_replay_matches_scheduler_dispatch_order(n_links):
    on_both(_sim_replay, n_links, values_tol=F32_CHAIN)


def _serialize_order(S, n_links):
    topo = S.R.Topology.parallel(n_links)
    sched = S.R.DistributedScheduler(topo)
    _parity_batch(S, sched)
    serial = S.R.serialize(sched.sim_tasks(), "link0", topo)
    rep = S.R.simulate(serial, topo)
    order = [s.task_id for s in rep.spans if s.resource == "link0"]
    want = [tid for tid in sorted(sched._tasks)
            if sched._tasks[tid].resource in topo]
    assert order == want
    if n_links == 1:
        assert order == _dispatch_order(sched, "link0")
    return {"serial": serial, "serial_report": rep, **sched_record(S, sched)}


@pytest.mark.parametrize("n_links", [1, 2])
def test_serialize_preserves_scheduler_submission_order(n_links):
    on_both(_serialize_order, n_links)


def _serialize_compute(S):
    SimTask = S.R.SimTask
    tasks = [SimTask(id=0, resource="link1", nbytes=1 << 20),
             SimTask(id=1, resource="engine0", nbytes=0, cost_s=0.0,
                     deps=(0,)),
             SimTask(id=2, resource="link1", nbytes=1 << 10, deps=(1,))]
    serial = S.R.serialize(tasks, "link0")
    assert [t.resource for t in serial] == ["link0", "engine0", "link0"]
    rep = S.R.simulate(serial, S.R.Topology.parallel(1))
    assert rep.span_of(1).start == rep.span_of(0).end
    return {"serial": serial, "report": rep}


def test_serialize_keeps_zero_cost_compute_off_the_link():
    on_both(_serialize_compute)


def _stall_rounds(S):
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(2))
    x = S.rand((256, 512))
    desc = S.C.describe("MN", "MNM8N128")
    f0 = sched.submit(x, desc, link="link0")
    sched.submit(x, desc, link="link0")
    sched.submit(x, desc, link="link1", deps=(f0,))
    sched.submit(x, desc, link="link1")
    sched.flush()
    bank = S.telemetry.bank("links")
    assert bank.get("stall_rounds:link1") == 1
    assert bank.get("stall_rounds:link0", 0) == 0
    rep = sched.report()
    assert rep.span_of(2).stall == 0.0 and rep.span_of(3).stall > 0.0
    assert rep.contention_stall == rep.span_of(1).stall + rep.span_of(3).stall
    return sched_record(S, sched)


def test_stall_rounds_counter_reconciles_with_sim_contention():
    on_both(_stall_rounds)


def _routing(S):
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(2))
    x = S.rand((8, 128))
    desc = S.C.describe("MN", "MN")
    f1, f2, f3 = (sched.submit(x, desc) for _ in range(3))
    assert [sched._tasks[f.task_id].resource for f in (f1, f2, f3)] == \
        ["link0", "link1", "link0"]
    with pytest.raises(KeyError):
        sched.submit(x, desc, link="nope")
    with pytest.raises(TypeError):
        sched.submit(x, "not-a-descriptor")
    with pytest.raises(ValueError):
        sched.submit_compute(lambda v: v, x, resource="link0")
    fut = sched.submit_compute(lambda a, b: a + b, f1, f2, cost_s=1e-6)
    got = fut.result()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(x) * 2)
    assert sched.pending == 0
    return {"values": [got], **sched_record(S, sched)}


def test_scheduler_routing_and_validation():
    on_both(_routing)


def _beat_serial(S):
    R = S.R
    topo = R.Topology.parallel(2)
    sched = R.DistributedScheduler(topo)
    x = S.rand((512, 512))
    desc = S.C.describe("MN", "MNM8N128")
    futs = [sched.submit(x, desc) for _ in range(6)]
    sched.flush()
    dist = sched.report()
    serial = R.simulate(R.serialize(sched.sim_tasks(), "link0"), topo)
    assert dist.makespan < serial.makespan
    assert dist.mean_link_utilization > serial.mean_link_utilization
    assert serial.link_utilization["link1"] == 0.0
    q = S.C.XDMAQueue([desc] * 6)
    q_rep = R.simulate(R.queue_sim_tasks(q, (512, 512), S.dtypes["float32"],
                                         "link0"), topo)
    assert dist.mean_link_utilization > q_rep.mean_link_utilization
    want = bits(S.xdma.transfer(x, desc))
    for f in futs:
        np.testing.assert_array_equal(bits(f.result()), want)
    return {"values": [f.result() for f in futs], "serial": serial,
            "queue": q_rep, **sched_record(S, sched)}


def test_distributed_makespan_and_utilization_beat_serial():
    on_both(_beat_serial)


# -- the descriptor rings (tests/test_rings.py) ----------------------------------
def _ring_pointers(S):
    DescriptorRing, WouldBlock = S.ring.DescriptorRing, S.ring.WouldBlock
    r = DescriptorRing("link0", 3)
    assert r.is_empty and not r.is_full and r.credits == 3 and len(r) == 0
    states = []
    tid = 0
    for _ in range(5):
        for _ in range(3):
            r.post(tid)
            tid += 1
        assert r.is_full and r.credits == 0 and not r.is_empty
        with pytest.raises(WouldBlock):
            r.post(tid)
        popped = [r.pop() for _ in range(3)]
        assert popped == [tid - 3, tid - 2, tid - 1]
        assert r.is_empty and r.credits == 3
        states.append((popped, r.occupancy, r.credits))
    with pytest.raises(IndexError):
        r.pop()
    r.post(99)
    assert r.head() == 99 and r.occupancy == 1 and r.credits == 2
    with pytest.raises(ValueError):
        DescriptorRing("bad", 0)
    return states, S.ring.DEFAULT_RING_DEPTH


def test_ring_guard_bit_pointers_full_empty_and_wraparound():
    on_both(_ring_pointers)


def _bad_policy(S):
    with pytest.raises(ValueError) as ei:
        S.R.DistributedScheduler(S.R.Topology.parallel(1), backpressure="spin")
    return str(ei.value)


def test_scheduler_validates_backpressure_policy():
    on_both(_bad_policy)


def _partial_drain(S):
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(1))
    x = S.rand((64, 128))
    desc = S.C.describe("MN", "MNM8N128")
    f1 = sched.submit(x, desc, link="link0")
    f2 = sched.submit(x, desc, link="link0")
    got = f1.result()
    assert f1.done() and not f2.done() and sched.pending == 1
    np.testing.assert_array_equal(bits(got), bits(S.xdma.transfer(x, desc)))
    mid = sched_record(S, sched)
    sched.flush()
    assert f2.done() and sched.pending == 0
    return {"values": [got, f2.result()], "mid": mid,
            **sched_record(S, sched)}


def test_future_result_drains_only_its_own_task():
    on_both(_partial_drain)


def _depth2_blocking(S):
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(2), ring_depth=2)
    x = S.rand((256, 512))
    d_store, d_load, _, _ = _descs(S)
    futs = []
    for link in ("link0", "link1"):
        for _ in range(4):
            f1 = sched.submit(x, d_store, link=link)
            futs.append(sched.submit(f1, d_load, link=link))
    sched.flush()
    ref = bits(S.xdma.transfer(S.xdma.transfer(x, d_store), d_load))
    for f in futs:
        np.testing.assert_array_equal(bits(f.result()), ref)
    assert sched.pending == 0 and len(sched.completions) == 16
    return {"values": [f.result() for f in futs], **sched_record(S, sched)}


def test_depth2_blocking_ring_is_bit_identical_and_never_deadlocks():
    on_both(_depth2_blocking, values_tol=F32_CHAIN)


def _ring_full_events(S):
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(1), ring_depth=2)
    x = S.rand((64, 128))
    desc = S.C.describe("MN", "MN")
    for _ in range(5):
        sched.submit(x, desc, link="link0")
    bank = S.telemetry.bank("rings")
    assert bank.get("full:link0") == 3
    assert bank.get("doorbells:link0") == 5
    assert bank.get("credits_hw:link0") == 2
    sched.flush()
    return sched_record(S, sched)


def test_blocking_submit_counts_ring_full_events():
    on_both(_ring_full_events)


def _error_policy(S):
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(1), ring_depth=2,
                                     backpressure="error")
    x = S.rand((64, 128))
    desc = S.C.describe("MN", "MNM8N128")
    f1 = sched.submit(x, desc, link="link0")
    f2 = sched.submit(x, desc, link="link0")
    with pytest.raises(S.ring.WouldBlock) as ei:
        sched.submit(x, desc, link="link0")
    assert ei.value.resource == "link0" and ei.value.depth == 2
    assert sched.pending == 2
    sched.step()
    f3 = sched.submit(x, desc, link="link0")
    sched.flush()
    want = bits(S.xdma.transfer(x, desc))
    for f in (f1, f2, f3):
        np.testing.assert_array_equal(bits(f.result()), want)
    return {"values": [f.result() for f in (f1, f2, f3)],
            "error": str(ei.value), **sched_record(S, sched)}


def test_error_policy_raises_wouldblock_then_drain_and_repost():
    on_both(_error_policy)


def _doorbell(S):
    R = S.R
    x = S.rand((256, 512))
    desc = S.C.describe("MN", "MNM8N128")

    def makespan_with(csr_cost):
        topo = R.Topology("t")
        topo.add_link("A", "B", name="link0", csr_write_cost=csr_cost)
        sched = R.DistributedScheduler(topo)
        for _ in range(4):
            sched.submit(x, desc, link="link0")
        sched.flush()
        return sched.report().makespan

    free, priced = makespan_with(0.0), makespan_with(20e-9)
    assert priced == pytest.approx(free + 4 * 20e-9, abs=1e-15)
    with R.capture() as tr:
        sched = R.DistributedScheduler(R.Topology.parallel(1))
        for _ in range(4):
            sched.submit(x, desc, link="link0")
        sched.flush()
    assert all(t.csr_writes == 1 for t in sched.sim_tasks())
    rep = tr.replay(R.Topology.parallel(1))
    assert rep.makespan == pytest.approx(free, rel=1e-12)
    return {"free": free, "priced": priced, "replay": rep,
            **sched_record(S, sched)}


def test_doorbell_csr_writes_priced_separately_from_transfer():
    on_both(_doorbell)


def _light_share(S, per_tenant):
    topo = S.R.Topology.parallel(1)
    sched = S.R.DistributedScheduler(topo)
    x = S.asarray(np.zeros((512, 512), np.float32))
    desc = S.C.describe("MN", "MN")
    heavy = "heavy" if per_tenant else ""
    light = "light" if per_tenant else ""
    futs = []
    for _ in range(40):
        sched.submit(x, desc, link="link0", tenant=heavy)
    for _ in range(4):
        futs.append(sched.submit(x, desc, link="link0", tenant=light))
    sched.flush()
    rep = sched.report()
    light_end = max(rep.span_of(f.task_id).end for f in futs)
    light_bytes = sum(sched._tasks[f.task_id].nbytes for f in futs)
    return (light_bytes / (light_end * topo.link("link0").bandwidth),
            sched_record(S, sched))


def _fairness(S):
    fair = 0.5
    tenant, rec_t = _light_share(S, per_tenant=True)
    shared, rec_s = _light_share(S, per_tenant=False)
    assert tenant >= 0.75 * fair and shared < 0.75 * fair
    assert tenant / shared > 3.0
    return {"tenant": tenant, "shared": shared, "rec_t": rec_t,
            "rec_s": rec_s}


def test_per_tenant_rings_bound_starvation_under_10x_overload():
    on_both(_fairness)


def _tenant_counters(S):
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(1))
    x = S.rand((64, 128))
    desc = S.C.describe("MN", "MN")
    for _ in range(6):
        sched.submit(x, desc, link="link0", tenant="a")
    for _ in range(2):
        sched.submit(x, desc, link="link0", tenant="b")
    sched.flush()
    bank = S.telemetry.bank("rings")
    assert bank.get("tenant_dispatch:a") == 6
    assert bank.get("tenant_dispatch:b") == 2
    order = [sched._tasks[tid].tenant for tid in sched._dispatched["link0"]]
    assert order == ["a", "b", "a", "b", "a", "a", "a", "a"]
    return {"summary": sched.summary(), **sched_record(S, sched)}


def test_tenant_dispatch_counters_track_shares():
    on_both(_tenant_counters)


def _single_tenant(S):
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(2))
    x = S.rand((64, 128))
    desc = S.C.describe("MN", "MNM8N128")
    futs = [sched.submit(x, desc) for _ in range(6)]
    sched.flush()
    assert [t.id for t in sched.sim_tasks()] == [f.task_id for f in futs]
    return sched_record(S, sched)


def test_single_tenant_dispatch_order_is_submission_order():
    on_both(_single_tenant)


def _incremental_makespan(S):
    sched = S.R.DistributedScheduler(S.R.Topology.host_device(2))
    x = S.rand((256, 512))
    store, load, _, _ = _descs(S)
    futs = []
    for link in ("h2d0", "h2d1"):
        f1 = sched.submit(x, store, link=link)
        futs.append(sched.submit(f1, load, link=link.replace("h2d", "d2h")))
    cf = sched.submit_compute(lambda a, b: a + b, futs[0], futs[1],
                              cost_s=3e-6)
    last = sched.submit(cf, store, link="h2d0", deps=(cf,))
    sched.flush()
    assert sched.makespan() == sched.report().makespan
    rep = sched.report()
    for c in sched.completions:
        span = rep.span_of(c.task_id)
        assert (span.start, span.end) == (c.start_s, c.end_s)
    return {"values": [f.result() for f in futs] + [last.result()],
            **sched_record(S, sched)}


def test_incremental_makespan_bit_equal_to_replay():
    on_both(_incremental_makespan, values_tol=F32_CHAIN)


def _makespan_pending(S):
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(1))
    x = S.rand((64, 128))
    desc = S.C.describe("MN", "MN")
    f1 = sched.submit(x, desc, link="link0")
    sched.submit(f1, desc, link="link0")
    f1.result()
    assert sched.pending == 1
    mid = (sched.makespan(), sched.report().makespan)
    assert mid[0] == mid[1]
    sched.flush()
    assert sched.makespan() == sched.report().makespan
    return {"mid": mid, **sched_record(S, sched)}


def test_makespan_falls_back_to_replay_while_pending():
    on_both(_makespan_pending)


def _ring_occupancy(S):
    R = S.R
    with R.capture() as tr:
        sched = R.DistributedScheduler(R.Topology.parallel(1), ring_depth=4)
        x = S.rand((64, 128))
        desc = S.C.describe("MN", "MN")
        for _ in range(3):
            sched.submit(x, desc, link="link0")
        sched.flush()
    occ = [e.ring_occupancy for e in tr.xdma_events()]
    assert occ == [1, 2, 3]
    with R.capture() as tr2:
        S.xdma.transfer(S.rand((64, 128)), S.C.describe("MN", "MN"))
    assert [e.ring_occupancy for e in tr2.xdma_events()] == [None]
    return {"events": tr.events, "events2": tr2.events,
            **sched_record(S, sched)}


def test_trace_events_carry_ring_occupancy():
    on_both(_ring_occupancy)


def _submit_to(S):
    C = S.C
    q = C.XDMAQueue([C.describe("MN", "MNM8N128", C.RMSNormPlugin()),
                     C.describe("MNM8N128", "MN", C.Transpose())],
                    name="kv_roundtrip")
    x = S.rand((256, 512))
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(2))
    fut = q.submit_to(sched, x)
    sched.flush()
    got, want = fut.result(), q.run(x)
    if S.name == "port":      # both dispatch the same lowering: bitwise
        np.testing.assert_array_equal(bits(got), bits(want))
    else:                     # the reference's run() is the XLA composition
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   **F32_CHAIN)
    assert len({t.resource for t in sched.sim_tasks()}) == 1
    with pytest.raises(ValueError):
        C.XDMAQueue(name="empty").submit_to(sched, x)
    return {"values": [got, want], **sched_record(S, sched)}


def test_queue_submit_to_matches_run():
    on_both(_submit_to, values_tol=F32_CHAIN)


def _submit_to_depth2(S):
    C = S.C
    q = C.XDMAQueue([C.describe("MN", "MNM8N128")] + [
        C.describe("MNM8N128", "MNM8N128") for _ in range(4)],
        name="deep_chain")
    x = S.rand((64, 128))
    sched = S.R.DistributedScheduler(S.R.Topology.parallel(1), ring_depth=2)
    fut = q.submit_to(sched, x, link="link0")
    np.testing.assert_array_equal(bits(fut.result()), bits(q.run(x)))
    sched.flush()
    return {"values": [fut.result()], **sched_record(S, sched)}


def test_queue_submit_to_depth2_backpressure_parity():
    on_both(_submit_to_depth2)


# -- the stored benchmark record, from the port's simulator ---------------------
def _bench_pr10():
    import json
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "BENCH_PR10.json")) as f:
        return json.load(f)


def _bench_module(name):
    """A module of the reference's ``benchmarks/`` loaded by its path."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        f"_reference_bench_{name}", os.path.join(root, "benchmarks",
                                                 f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sched_items(workload):
    """``benchmarks/sched.py``'s workloads on the port: (descriptor, index
    of the task producing its input or None)."""
    import torch
    import repro_torch.core as C
    if workload == "indep":
        return [(C.describe("MN", "MNM8N128"), None) for _ in range(8)]
    if workload == "pipeline":
        store = C.describe("MN", "MNM8N128", C.RMSNormPlugin())
        load = C.describe("MNM8N128", "MN", C.Transpose())
        items = []
        for _ in range(4):
            items.append((store, None))
            items.append((load, len(items) - 1))
        return items
    return [(C.describe("MN", "MNM16N128", C.Cast(torch.bfloat16)), None),
            (C.describe("MN", "MNM8N128"), None),
            (C.describe("MN", "MN", C.Scale(2.0)), None),
            (C.describe("MNM16N128", "MN", C.Transpose()), 0),
            (C.describe("MNM8N128", "MN", C.Transpose()), 1),
            (C.describe("MN", "MN", C.BiasAdd(1.0)), 2)]


def _sched_sim_tasks(items, topo):
    import math
    import torch
    from repro_torch.core.layouts import itemsize
    from repro_torch.runtime import SimTask
    links = topo.link_names
    tasks, shapes, dtypes = [], [], []
    for i, (desc, dep) in enumerate(items):
        in_shape = (512, 512) if dep is None else shapes[dep]
        in_dtype = torch.float32 if dep is None else dtypes[dep]
        out_shape = desc.out_logical_shape(in_shape)
        out_dtype = desc.out_dtype(in_dtype)
        nbytes = (math.prod(in_shape) * itemsize(in_dtype)
                  + math.prod(out_shape) * itemsize(out_dtype))
        tasks.append(SimTask(id=i, resource=links[i % len(links)],
                             nbytes=nbytes, deps=() if dep is None else (dep,),
                             label=desc.summary()))
        shapes.append(out_shape)
        dtypes.append(out_dtype)
    return tasks


def test_bench_pr10_contention_stalls_from_the_port():
    """Every key of ``contention_stalls_us`` in ``BENCH_PR10.json`` (the
    simulated stalls of ``benchmarks/sched.py``, in us), rebuilt with the
    port's simulator: equal to the stored floats (JSON keeps them exactly).
    The whole rows (makespan, mean utilization, stall) equal the
    reference's ``benchmarks.sched`` run now, and the stored rows within
    rel 1e-12 (two stored utilizations are one ulp from what the reference
    computes today)."""
    from repro_torch.runtime import Topology, serialize, simulate
    bench = _bench_pr10()
    stalls, rows = {}, {}
    for workload in ("indep", "pipeline", "mixed"):
        for k in (2, 4):
            topo = Topology.parallel(k)
            tasks = _sched_sim_tasks(_sched_items(workload), topo)
            dist = simulate(tasks, topo)
            serial = simulate(serialize(tasks, topo.link_names[0]), topo)
            tag = f"sched/{workload}/links{k}"
            for name, rep in (("serial", serial), ("dist", dist)):
                stalls[f"{tag}/{name}"] = rep.contention_stall * 1e6
                rows[f"{tag}/{name}"] = [f"{tag}/{name}", rep.makespan * 1e6,
                                         rep.mean_link_utilization,
                                         rep.contention_stall * 1e6]
            rows[f"{tag}/speedup"] = [f"{tag}/speedup", dist.makespan * 1e6,
                                      serial.makespan / dist.makespan]
    assert stalls == bench["contention_stalls_us"]
    assert stalls["sched/indep/links4/dist"] == 87.88607999999999
    ref_sched_bench = _bench_module("sched")
    ref_rows = {r[0]: list(r) for r in ref_sched_bench.run(csv=False, sim=True)
                if r[0] in rows}
    assert ref_rows == rows
    stored = {r[0]: r for r in bench["sections"]["sched"] if r[0] in rows}
    assert set(stored) == set(rows)
    for name, row in rows.items():
        assert stored[name][0] == name
        np.testing.assert_allclose(stored[name][1:], row[1:], rtol=1e-12,
                                   atol=0, err_msg=name)
