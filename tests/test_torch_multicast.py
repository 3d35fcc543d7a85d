"""Parity of the port's multicast plane (``Topology.multicast_tree``,
``DistributedScheduler.submit_multicast``, the multicast pricing and trace
tags) with the reference's.

Each case is a case of ``tests/test_multicast.py`` that needs no serving
or model module, written once over :class:`torch_parity.Side` and run on
both packages: the same trees (hops, serves, deliveries), the same
simulated makespans and ratios, the same per-link bytes and ``multicast``
counters, exactly; the delivered payloads bitwise.  The weight-broadcast,
distribute-weights and multi-device cases wait for ROADMAP §1 items 7-8.
"""
import pytest

pytest.importorskip("torch")

import json  # noqa: E402

import numpy as np  # noqa: E402

from torch_parity import (bits, on_both,  # noqa: E402,F401
                          reset_global_state, sched_record)

NBYTES = 1 << 20


def _mcast_desc(S, dsts):
    C = S.C
    return C.describe(C.Endpoint.local(C.MN), C.Endpoint.multicast(tuple(dsts)))


def _tree(t):
    return (t.kind, t.src, t.dsts, [(h.link, h.src, h.dst, h.parent, h.serves)
                                    for h in t.hops],
            t.unicast_hop_count, t.saved_hops, t.fork_count,
            t.shared_hop_count, [t.delivery(d) for d in t.dsts],
            t.bytes_saved(100), t.summary())


# -- tree synthesis ----------------------------------------------------------
def _ring_tree(S):
    tree = S.R.Topology.ring(4).multicast_tree("dev0", ["dev1", "dev2", "dev3"])
    assert [(h.src, h.dst) for h in tree.hops] == [
        ("dev0", "dev1"), ("dev1", "dev2"), ("dev2", "dev3")]
    assert [len(h.serves) for h in tree.hops] == [3, 2, 1]
    assert tree.unicast_hop_count == 6 and tree.saved_hops == 3
    assert tree.bytes_saved(100) == 300 and tree.delivery("dev2") == 1
    return _tree(tree)


def test_ring_tree_is_a_chain_with_nested_serves():
    on_both(_ring_tree)


def _mesh_and_star(S):
    Topology = S.R.Topology
    tree = Topology.tpu_mesh((2, 2)).multicast_tree(
        "dev(0,0)", ["dev(0,1)", "dev(1,0)", "dev(1,1)"])
    assert len(tree.hops) == 3 and tree.fork_count >= 1
    assert tree.saved_hops >= 1
    stree = Topology.host_device(devices=4).multicast_tree(
        "host", ["dev0", "dev1", "dev2", "dev3"])
    assert len(stree.hops) == 4 and stree.saved_hops == 0
    assert stree.fork_count == 1 and all(len(h.serves) == 1
                                         for h in stree.hops)
    return _tree(tree), _tree(stree)


def test_mesh_tree_forks_and_star_saves_nothing():
    on_both(_mesh_and_star)


def _chain_policy(S):
    mesh = S.R.Topology.tpu_mesh((2, 2))
    chain = mesh.multicast_tree("dev(0,0)", ["dev(0,1)", "dev(1,1)"],
                                policy="chain")
    assert chain.kind == "chain"
    assert chain.delivery("dev(1,1)") == len(chain.hops) - 1
    errors = []
    for dsts, policy in (([], "tree"), (["dev(0,0)"], "tree"),
                         (["nowhere"], "tree"), (["dev(0,1)"], "bogus")):
        with pytest.raises(ValueError) as ei:
            mesh.multicast_tree("dev(0,0)", dsts, policy=policy)
        errors.append(str(ei.value))
    return _tree(chain), errors


def test_chain_policy_and_validation_errors():
    on_both(_chain_policy)


# -- simulator pricing -------------------------------------------------------
def _cases(S):
    Topology = S.R.Topology
    return [(Topology.ring(4), "dev0", ["dev1", "dev2", "dev3"]),
            (Topology.tpu_mesh((2, 2)), "dev(0,0)",
             ["dev(0,1)", "dev(1,0)", "dev(1,1)"]),
            (Topology.host_device(devices=4), "host",
             ["dev0", "dev1", "dev2", "dev3"])]


def _strict_win(S):
    R = S.R
    out = []
    for topo, src, dsts in _cases(S):
        m_tasks, tree = R.multicast_sim_tasks(topo, src, dsts, NBYTES)
        u_tasks = R.unicast_sim_tasks(topo, src, dsts, NBYTES)
        m_rep, u_rep = R.simulate(m_tasks, topo), R.simulate(u_tasks, topo)
        ratio = u_rep.makespan / m_rep.makespan
        if tree.saved_hops >= 1:
            assert ratio > 1.0, (topo.name, ratio)
        else:
            assert ratio == pytest.approx(1.0, abs=1e-15), (topo.name, ratio)
        out.append((ratio, m_tasks, u_tasks, m_rep, u_rep, _tree(tree)))
    return out


def test_multicast_strictly_beats_unicasts_exactly_when_hops_shared():
    on_both(_strict_win)


def _designed_ratios(S):
    R = S.R
    ring, mesh = R.Topology.ring(4), R.Topology.tpu_mesh((2, 2))
    m, _ = R.multicast_sim_tasks(ring, "dev0", ["dev1", "dev2", "dev3"],
                                 NBYTES)
    u = R.unicast_sim_tasks(ring, "dev0", ["dev1", "dev2", "dev3"], NBYTES)
    r_ring = R.simulate(u, ring).makespan / R.simulate(m, ring).makespan
    assert r_ring == pytest.approx(5 / 3, rel=1e-12)
    dsts = ["dev(0,1)", "dev(1,0)", "dev(1,1)"]
    m, _ = R.multicast_sim_tasks(mesh, "dev(0,0)", dsts, NBYTES)
    u = R.unicast_sim_tasks(mesh, "dev(0,0)", dsts, NBYTES)
    r_mesh = R.simulate(u, mesh).makespan / R.simulate(m, mesh).makespan
    assert r_mesh == pytest.approx(3 / 2, rel=1e-12)
    return r_ring, r_mesh


def test_ring_and_mesh_ratios_are_the_designed_values():
    on_both(_designed_ratios)


def _wire_bytes(S):
    R = S.R
    ring = R.Topology.ring(4)
    m_tasks, _ = R.multicast_sim_tasks(ring, "dev0",
                                       ["dev1", "dev2", "dev3"], NBYTES)
    links = [t.resource for t in m_tasks]
    assert sorted(links) == sorted(set(links))
    assert all(t.nbytes == NBYTES for t in m_tasks)
    u_tasks = R.unicast_sim_tasks(ring, "dev0", ["dev1", "dev2", "dev3"],
                                  NBYTES)
    first = ring.links_between("dev0", "dev1")[0].name
    per_link = {}
    for t in u_tasks:
        per_link[t.resource] = per_link.get(t.resource, 0) + t.nbytes
    assert per_link[first] == 3 * NBYTES
    return m_tasks, u_tasks, per_link


def test_wire_bytes_once_per_tree_edge_not_per_destination():
    on_both(_wire_bytes)


# -- the scheduler fork ------------------------------------------------------
def _fork(S):
    x = S.rand((64, 256))
    sched = S.R.DistributedScheduler(S.R.Topology.ring(4))
    fut = sched.submit_multicast(x, _mcast_desc(S, ["dev1", "dev2", "dev3"]),
                                 src="dev0", label="bcast")
    sched.flush()
    assert fut.done() and fut.dsts == ("dev1", "dev2", "dev3")
    for got in fut.result():
        np.testing.assert_array_equal(bits(got), bits(x))
    assert len(fut.tree.hops) == 3
    hop_tasks = [sched._tasks[fut.future(d).task_id] for d in fut.dsts]
    assert all(t.csr_writes == 1 for t in hop_tasks)
    stats = S.telemetry.bank("multicast").as_dict()
    nbytes = 64 * 256 * 4
    assert stats["trees"] == 1 and stats["hops"] == 3
    assert stats["saved_hop_bytes"] == fut.tree.bytes_saved(nbytes)
    return {"values": list(fut.result()), "tree": _tree(fut.tree),
            "descs": fut.dst_descriptors(), **sched_record(S, sched)}


def test_submit_multicast_forks_delivers_bit_identical_payloads():
    on_both(_fork)


def _guards(S):
    C = S.C
    x = S.rand((32, 128))
    sched = S.R.DistributedScheduler(S.R.Topology.ring(4))
    errors = []
    for call, exc in (
            (lambda: sched.submit(x, _mcast_desc(S, ["dev1"]),
                                  link="dev0->dev1"), ValueError),
            (lambda: sched.submit_multicast(x, "not a descriptor",
                                            src="dev0"), TypeError),
            (lambda: sched.submit_multicast(x, C.describe("MN", "MN"),
                                            src="dev0"), ValueError),
            (lambda: sched.submit_multicast(x, C.describe(
                C.Endpoint.local(C.MN), C.Endpoint.multicast(("dev1",)),
                C.Scale(2.0)), src="dev0"), ValueError),
            # transfer() routes a node-addressed multicast to the scheduler
            (lambda: S.xdma.transfer(x, _mcast_desc(S, ["dev1"])),
             ValueError)):
        with pytest.raises(exc) as ei:
            call()
        errors.append(str(ei.value))
    return errors


def test_submit_multicast_guards_and_plain_submit_refuses_it():
    on_both(_guards)


def _per_dst_auto(S):
    C = S.C
    x = S.rand((256, 512))
    sched = S.R.DistributedScheduler(S.R.Topology.ring(4))
    desc = C.describe(C.Endpoint.local(C.MN),
                      C.Endpoint.multicast((("dev1", "MNM8N128"),
                                            ("dev2", "auto"))))
    fut = sched.submit_multicast(x, desc, src="dev0")
    sched.flush()
    by_dst = fut.dst_descriptors()
    assert by_dst["dev1"].dst_layout.name == "MNM8N128"
    assert not by_dst["dev2"].dst_layout.is_auto
    back = C.xdma.transfer(fut.result_at("dev1"), C.describe("MNM8N128", "MN"))
    np.testing.assert_array_equal(bits(back), bits(x))
    return {"values": list(fut.result()), "descs": by_dst,
            **sched_record(S, sched)}


def test_per_destination_auto_layout_resolves_against_delivery_link():
    on_both(_per_dst_auto)


# -- capture -> replay -------------------------------------------------------
def _presets(S):
    Topology = S.R.Topology
    return [(Topology.ring(4), "dev0", ["dev1", "dev2", "dev3"]),
            (Topology.tpu_mesh((2, 2)), "dev(0,0)",
             ["dev(0,1)", "dev(1,0)", "dev(1,1)"]),
            (Topology.host_device(devices=4), "host",
             ["dev1", "dev2", "dev3"])]


def _per_link_bytes(tasks):
    out = {}
    for t in tasks:
        out[t.resource] = out.get(t.resource, 0) + int(t.nbytes or 0)
    return out


def _replay_parity(S, idx):
    topo, src, dsts = _presets(S)[idx]
    x = S.rand((64, 256))
    with S.R.capture(name="mcast") as tr:
        sched = S.R.DistributedScheduler(topo)
        fut = sched.submit_multicast(x, _mcast_desc(S, dsts), src=src)
        sched.flush()
    assert fut.done()
    got = _per_link_bytes(tr.sim_tasks(topo))
    want = _per_link_bytes(sched.sim_tasks())
    assert got == want
    payload = 2 * 64 * 256 * 4
    assert all(v == payload for v in want.values())
    assert len(want) == len(fut.tree.hops)
    return {"events": tr.events, "replay": tr.replay(topo),
            "sw": tr.replay(topo, sw_agu=True), **sched_record(S, sched)}


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_capture_replay_byte_parity_on_every_fabric_preset(idx):
    on_both(_replay_parity, idx)


def _resynthesize(S):
    x = S.rand((64, 256))
    with S.R.capture(name="mcast") as tr:
        sched = S.R.DistributedScheduler(S.R.Topology.ring(4))
        sched.submit_multicast(x, _mcast_desc(S, ["dev1", "dev2", "dev3"]),
                               src="dev0")
        sched.flush()
    star = S.R.Topology.host_device(devices=4)
    rep = tr.replay(star)
    busy = {res for res, b in rep.link_busy.items() if b > 0}
    assert busy == {"d2h0", "h2d1", "h2d2", "h2d3"}
    assert rep.makespan > 0
    return {"report": rep, "tasks": tr.sim_tasks(star),
            "sw": tr.replay(star, sw_agu=True)}


def test_replay_on_a_different_fabric_resynthesizes_the_tree():
    on_both(_resynthesize)


def _chrome_forks(S):
    x = S.rand((64, 256))
    star = S.R.Topology.host_device(devices=4)
    with S.R.capture(name="mcast") as tr:
        sched = S.R.DistributedScheduler(star)
        sched.submit_multicast(x, _mcast_desc(S, ["dev1", "dev2", "dev3"]),
                               src="host")
        sched.flush()
    tagged = [e for e in tr.events if e.multicast_group is not None]
    assert len(tagged) == 3
    assert {e.multicast_hop for e in tagged} == {
        ("host", "dev1"), ("host", "dev2"), ("host", "dev3")}
    assert any(e.multicast_spec is not None for e in tagged)
    events = S.chrometrace.sim_report_events(tr.replay(star), trace=tr)
    forks = [e for e in events
             if e.get("args", {}).get("multicast_group") is not None]
    assert forks and all("hop" in e["args"] and "serves" in e["args"]
                         for e in forks)
    S.chrometrace.validate_events(events)
    return json.loads(S.chrometrace.to_json(events))


def test_trace_tags_and_chrometrace_fork_annotations():
    on_both(_chrome_forks)


# -- satellites --------------------------------------------------------------
def _fingerprint(S):
    Topology = S.R.Topology
    topo = Topology("t")
    topo.add_link("A", "B", name="l0", csr_write_cost=20e-9)
    fp = S.autotune.fabric_fingerprint(topo.link("l0"))
    assert len(fp) == 5 and fp[-1] == 20e-9
    topo2 = Topology("t")
    topo2.add_link("A", "B", name="l0", csr_write_cost=40e-9)
    assert fp != S.autotune.fabric_fingerprint(topo2.link("l0"))
    return fp, S.autotune.fabric_fingerprint(None)


def test_fabric_fingerprint_includes_csr_write_cost():
    on_both(_fingerprint)


def _snapshot(S):
    x = S.rand((32, 128))
    with S.telemetry.session(name="mcast"):
        sched = S.R.DistributedScheduler(S.R.Topology.ring(3))
        sched.submit_multicast(x, _mcast_desc(S, ["dev1", "dev2"]), src="dev0")
        sched.flush()
        snap = S.telemetry.snapshot()
    stats = snap["surfaces"]["multicast_stats"]
    assert stats["trees"] >= 1 and stats["hops"] >= 2
    return {k: snap["surfaces"][k] for k in (
        "multicast_stats", "scheduler_links", "scheduler_rings",
        "autotune_stats", "cache_stats")}


def test_snapshot_surfaces_multicast_stats():
    on_both(_snapshot)


# -- the stored benchmark record, from the port's simulator ---------------------
def test_bench_pr10_multicast_ratios_from_the_port():
    """Every key of ``multicast_vs_unicast_ratio`` in ``BENCH_PR10.json``
    (``benchmarks/multicast.py``: 1 MiB from a source to its nearest
    destinations, unicast over multicast makespan), rebuilt with the port's
    trees and simulator: equal to the stored floats, among them ring4 dst3
    1.6666666666666665 and mesh2x2 dst3 1.5."""
    import os
    from repro_torch.runtime import (Topology, multicast_sim_tasks, simulate,
                                     unicast_sim_tasks)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "BENCH_PR10.json")) as f:
        bench = json.load(f)
    ratios, rows = {}, []
    for tag, topo, src, sweep in (
            ("ring4", Topology.ring(4), "dev0", (2, 3)),
            ("mesh2x2", Topology.tpu_mesh((2, 2)), "dev(0,0)", (2, 3)),
            ("host_device", Topology.host_device(devices=4), "host", (2, 4))):
        pool = [n for n in topo.nodes if n != src]
        for n in sweep:
            m_tasks, _ = multicast_sim_tasks(topo, src, pool[:n], NBYTES)
            u_tasks = unicast_sim_tasks(topo, src, pool[:n], NBYTES)
            m = simulate(m_tasks, topo).makespan
            u = simulate(u_tasks, topo).makespan
            base = f"mcast/{tag}/dst{n}"
            ratios[f"{base}/ratio"] = u / m
            agg = n * NBYTES
            rows += [[f"{base}/multicast", m * 1e6, agg / m / 1e9],
                     [f"{base}/unicast", u * 1e6, agg / u / 1e9],
                     [f"{base}/ratio", m * 1e6, u / m]]
    assert ratios == bench["multicast_vs_unicast_ratio"]
    assert ratios["mcast/ring4/dst3/ratio"] == 1.6666666666666665
    assert ratios["mcast/mesh2x2/dst3/ratio"] == 1.5
    assert rows == bench["sections"]["multicast"]
