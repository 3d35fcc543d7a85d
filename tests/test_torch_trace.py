"""Parity of the port's movement ledger (``repro_torch.runtime.trace``:
``capture()`` / ``replay()``) and its Chrome trace export with the
reference's.

The single-process cases of ``tests/test_trace.py`` run on both packages
through :class:`torch_parity.Side`; the recorded events (endpoint, link,
``deps``, bytes, bursts, rows, depth, source, label), ``per_link_bytes``,
``by_endpoint`` and the replayed makespans with and without
``sw_agu=True`` must be the reference's exactly, and the chrometrace JSON of
the same replay equal.  Provenance is keyed by leaf identity on both sides;
two cases pin the port's edges where a torch tensor could differ from a
JAX array: a transfer whose lowering hands back its input, and a view of a
task's output.
"""
import pytest

pytest.importorskip("torch")

import json  # noqa: E402

import numpy as np  # noqa: E402

from torch_parity import (on_both,  # noqa: E402,F401
                          reset_global_state, sched_record)

F32_CHAIN = dict(rtol=2e-5, atol=1e-5)


def _events(tr):
    return [(e.id, e.kind, e.endpoint, e.link, e.deps, e.logical_shape,
             e.in_dtype, e.nbytes, e.wire_nbytes, e.burst_bytes, e.row_bytes,
             e.pipeline_depth, e.cost_s, e.label, e.source, e.ring_occupancy,
             e.multicast_group, e.multicast_hop, e.multicast_serves,
             e.multicast_spec, e.desc) for e in tr.events]


def _ledger(S, tr, topos):
    """Everything a trace answers, and its replays on ``topos``."""
    out = {"events": _events(tr), "per_link": tr.per_link_bytes(),
           "by_endpoint": tr.by_endpoint(), "total": tr.total_bytes,
           "summary": tr.summary()}
    for topo in topos:
        for sw in (False, True):
            rep = tr.replay(topo, sw_agu=sw)
            out[f"{topo.name}/{sw}"] = rep
            out[f"{topo.name}/{sw}/tasks"] = tr.sim_tasks(topo, sw_agu=sw)
            out[f"{topo.name}/{sw}/chrome"] = json.loads(
                S.chrometrace.to_json(S.chrometrace.trace_events(
                    tr, topo, sw_agu=sw)))
    return out


# -- ledger basics -----------------------------------------------------------
def _scoped(S):
    TR = S.trace
    x = S.rand((64, 256))
    desc = S.C.describe("MN", "MNM8N128")
    assert TR.current() is None
    with S.R.capture(name="t") as tr:
        assert TR.current() is tr
        y = S.xdma.transfer(x, desc)
    assert TR.current() is None
    n = len(tr.events)
    S.xdma.transfer(x, desc)
    assert len(tr.events) == n == 1
    ev = tr.events[0]
    assert ev.endpoint == "local" and ev.desc is desc
    assert ev.nbytes == 2 * 64 * 256 * 4
    assert ev.burst_bytes == 128 * 4 and ev.row_bytes == 256 * 4
    assert ev.pipeline_depth == 9
    return {"values": [y], **_ledger(S, tr, [S.R.Topology.parallel(1)])}


def test_capture_is_scoped_and_zero_cost_when_off():
    on_both(_scoped)


def _dataflow(S):
    C = S.C
    x = S.rand((128, 256))
    store = C.describe("MN", "MNM8N128", C.RMSNormPlugin())
    load = C.describe("MNM8N128", "MN", C.Transpose())
    with S.R.capture() as tr:
        y = S.xdma.transfer(x, store)
        z = S.xdma.transfer(y, load)
        q = C.XDMAQueue([store, load], name="rt")
        w = q.run(x)
    assert [e.deps for e in tr.events] == [(), (0,), (), (2,)]
    assert [e.source for e in tr.events] == ["transfer", "transfer",
                                             "queue", "queue"]
    assert tr.events[2].logical_shape == (128, 256)
    assert tr.events[3].logical_shape == (128, 256)
    return {"values": [y, z, w],
            **_ledger(S, tr, [S.R.Topology.parallel(2),
                              S.R.Topology.ring(4)])}


def test_capture_records_dataflow_deps_and_queue_chains():
    on_both(_dataflow, values_tol=F32_CHAIN)


def _determinism(S):
    C, R = S.C, S.R

    def workload(name):
        with R.capture(name=name) as tr:
            sched = R.DistributedScheduler(R.Topology.host_device(2))
            x = S.rand((256, 512))
            store = C.describe("MN", "MNM8N128", d_buf=5)
            load = C.describe("MNM8N128", "MN", C.Transpose(), d_buf=5)
            for lane in range(3):
                f = sched.submit(x, store, label=f"s{lane}")
                sched.submit(f, load, label=f"l{lane}")
            sched.flush()
        return tr, sched

    (t1, s1), (t2, _) = workload("a"), workload("b")
    assert len(t1.events) == len(t2.events)
    for a, b in zip(t1.events, t2.events):
        assert (a.endpoint, a.link, a.deps, a.nbytes, a.burst_bytes,
                a.row_bytes, a.pipeline_depth) == \
               (b.endpoint, b.link, b.deps, b.nbytes, b.burst_bytes,
                b.row_bytes, b.pipeline_depth)
    for topo in (R.Topology.host_device(2), R.Topology.ring(4)):
        r1, r2 = t1.replay(topo), t2.replay(topo)
        assert r1.makespan == r2.makespan and r1.spans == r2.spans
        assert t1.replay(topo).spans == r1.spans
    return {**_ledger(S, t1, [R.Topology.host_device(2), R.Topology.ring(4)]),
            **sched_record(S, s1)}


def test_capture_replay_determinism():
    on_both(_determinism)


def _lazy_flush(S):
    R = S.R
    with R.capture(name="a") as ta:
        sched = R.DistributedScheduler(R.Topology.parallel(2))
        x = S.rand((64, 128))
        f = sched.submit(x, S.C.describe("MN", "MN"))
    with R.capture(name="b") as tb:
        sched.flush()
        S.xdma.transfer(f.result(), S.C.describe("MN", "MN"))
    assert len(ta.events) == 1
    assert ta.events[0].nbytes == 2 * 64 * 128 * 4
    assert len(tb.events) == 1 and tb.events[0].deps == ()
    tb.replay(R.Topology.parallel(1))
    return {"a": _ledger(S, ta, [R.Topology.parallel(1)]),
            "b": _ledger(S, tb, [R.Topology.parallel(1)])}


def test_lazy_flush_does_not_leak_into_other_traces():
    on_both(_lazy_flush)


def _byte_parity(S):
    C, R = S.C, S.R
    with R.capture() as tr:
        sched = R.DistributedScheduler(R.Topology.parallel(3))
        x = S.rand((256, 512))
        descs = [C.describe("MN", "MNM8N128"),
                 C.describe("MN", "MN", C.Scale(2.0)),
                 C.describe("MN", "MN", C.Cast(S.dtypes["bfloat16"]))]
        for i in range(6):
            sched.submit(x, descs[i % 3])
        sched.flush()
    want = {}
    for t in sched.sim_tasks():
        if t.resource in sched.topology:
            want[t.resource] = want.get(t.resource, 0) + t.nbytes
    assert tr.per_link_bytes() == want
    assert tr.total_bytes == sum(want.values())
    assert sched.report().total_bytes == sum(want.values())
    # the links bank reconciles with the ledger byte for byte
    bank = S.telemetry.bank("links")
    assert {k[len("bytes:"):]: v for k, v in bank.as_dict().items()
            if k.startswith("bytes:")} == want
    return {**_ledger(S, tr, [R.Topology.parallel(3), R.Topology.ring(4)]),
            **sched_record(S, sched)}


def test_trace_vs_scheduler_report_per_link_byte_parity():
    on_both(_byte_parity)


def _sw_agu(S):
    C, R = S.C, S.R
    with R.capture() as tr:
        x = S.rand((512, 512))
        S.xdma.transfer(x, C.describe("MN", "MNM8N128"))
        S.xdma.transfer(x, C.describe("MN", "MN", C.Transpose()))
    topo = R.Topology.parallel(2)
    hw, sw = tr.replay(topo), tr.replay(topo, sw_agu=True)
    assert sw.makespan > hw.makespan
    assert all(t.issue_overhead_s is not None and t.pipeline_depth == 1
               for t in tr.sim_tasks(topo, sw_agu=True))
    return _ledger(S, tr, [topo, R.Topology.ring(4)])


def test_sw_agu_costing_strictly_slower_than_frontend():
    on_both(_sw_agu)


# -- payloads, codecs and the identity traps -----------------------------------
def _payloads(S):
    C, R = S.C, S.R
    x = S.rand((64, 256))
    xb = S.rand((64, 256), seed=1, dtype="bfloat16")
    with R.capture(name="payloads") as tr:
        q = S.xdma.transfer(x, C.describe("MN", "MNM32N128", C.Quantize()))
        c = S.xdma.transfer(x, C.describe("MN", "MNM8N128",
                                          C.Compress(block_rows=8)))
        d = S.xdma.transfer(x, C.describe("MN", "MN", C.Compress(block_rows=8),
                                          C.Decompress()))
        S.xdma.transfer(xb, C.describe("MN", "MNM16N128",
                                       C.Cast(S.dtypes["float32"])))
        sched = R.DistributedScheduler(R.Topology.host_device(2))
        f = sched.submit(x, C.describe("MN", "MN", C.Compress(block_rows=8)),
                         link="h2d0")
        g = sched.submit(f, C.describe("MN", "MNM8N128", C.Decompress()),
                         link="d2h0")
        sched.flush()
    return {"values": [q, c, d, g.result()],
            **_ledger(S, tr, [R.Topology.host_device(2)]),
            **sched_record(S, sched)}


def test_payload_carriers_and_codecs_record_the_same_events():
    on_both(_payloads)


def _identity_traps(S):
    C, R = S.C, S.R
    x = S.rand((64, 128))
    copy = C.describe("MN", "MN")                      # identity lowering
    pallas_copy = C.describe("MN", "MN", backend="pallas")
    with R.capture(name="identity") as tr:
        a = S.xdma.transfer(x, copy)                   # a new object
        b = S.xdma.transfer(a, C.describe("MN", "MNM8N128"))   # dep on a
        c = S.xdma.transfer(x, C.describe("MN", "MNM8N128"))   # x: no dep
        p = S.xdma.transfer(x, pallas_copy)            # pallas hands back x
        S.xdma.transfer(x, C.describe("MN", "MNM8N128"))       # x is p: dep
        S.xdma.transfer(p, copy)                                # dep on p
        view = b[1:3]                                  # a view of b: no dep
        S.xdma.transfer(view, C.describe("MNM8N128", "MN"))
        whole = b.reshape(b.shape)                     # same shape: no dep
        S.xdma.transfer(whole, C.describe("MNM8N128", "MN"))
        q = C.XDMAQueue([copy], name="q")
        S.xdma.transfer(q.run(x), copy)                # dep on the queue
        e = C.XDMAQueue([], name="empty")
        assert e.run(x) is x
    assert (a is x) is False
    return {"values": [a, b, c, p], "deps": [ev.deps for ev in tr.events],
            **_ledger(S, tr, [R.Topology.parallel(2)])}


def test_provenance_through_identity_lowerings_and_views():
    on_both(_identity_traps)


def _chrome(S):
    C, R = S.C, S.R
    x = S.rand((256, 512))
    with R.capture(name="chrome") as tr:
        sched = R.DistributedScheduler(R.Topology.host_device(2))
        f = sched.submit(x, C.describe("MN", "MNM8N128"), link="h2d0")
        g = sched.submit(f, C.describe("MNM8N128", "MN", C.Transpose()),
                         link="d2h0")
        sched.submit_compute(lambda v: v, g, cost_s=2e-6, label="ffn")
        sched.submit_multicast(x, C.describe(C.Endpoint.local(C.MN),
                                             C.Endpoint.multicast(
                                                 ("dev",))), src="host")
        sched.flush()
    out = {}
    for topo in (R.Topology.host_device(2), R.Topology.ring(4)):
        for sw in (False, True):
            events = S.chrometrace.trace_events(tr, topo, sw_agu=sw)
            assert S.chrometrace.validate_events(events) == len(events)
            out[f"{topo.name}/{sw}"] = json.loads(
                S.chrometrace.to_json(events))
    return out


def test_chrometrace_json_of_the_same_replay_is_equal():
    on_both(_chrome)


def test_payload_leaves_follow_the_pytree_order():
    """The port's ``_leaves`` flattens payloads in the order JAX's pytree
    flattening gives the reference's (provenance and byte counts read it)."""
    import jax
    import torch
    from repro.core import plugins as RP
    from repro_torch.core import plugins as PP
    from repro_torch.runtime.scheduler import _leaves, _nbytes
    from repro.runtime.scheduler import _nbytes as ref_nbytes

    def build(P, mk):
        return {"b": (P.QTensor(values=mk(1, "int8"), scales=mk(2)), None,
                      [mk(3), 7]),
                "a": P.CTensor(values=mk(4), mask=mk(5, "bool")),
                "c": [{"y": mk(6), "x": mk(7)}]}

    def ref_mk(v, dt="float32"):
        return jax.numpy.full((2, 3), v, dt)

    def port_mk(v, dt="float32"):
        return torch.full((2, 3), v, dtype=getattr(torch, dt))

    ref = build(RP, ref_mk)
    port = build(PP, port_mk)
    want = [np.asarray(leaf).tolist() if hasattr(leaf, "shape") else leaf
            for leaf in jax.tree_util.tree_leaves(ref)]
    got = [leaf.tolist() if isinstance(leaf, torch.Tensor) else leaf
           for leaf in _leaves(port)]
    assert got == want
    assert _nbytes(port) == ref_nbytes(ref)
