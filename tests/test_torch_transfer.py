"""Parity of the port's ``xdma.transfer`` (local movements) with the
reference's: the four backends, the CFG cache and its stats, the queue,
descriptor crossing (``from_spec``) and the telemetry plane.
"""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import oracle as O  # noqa: E402
from repro import core as RC  # noqa: E402
from repro.core import plugins as RP  # noqa: E402
from repro.core import xdma as rx  # noqa: E402
from repro.kernels import agu as ragu  # noqa: E402
import repro_torch.core as PC  # noqa: E402
from repro_torch.core import descriptor as PD  # noqa: E402
from repro_torch.core import xdma as px  # noqa: E402
from repro_torch.kernels import agu as pagu  # noqa: E402
from repro_torch.runtime import telemetry as ptm  # noqa: E402
from torch_parity import (assert_same_payload, bits, port_desc,  # noqa: E402,F401
                          reset_global_state, spec_of, to_f32, to_torch)

BACKENDS = ["auto", "fused", "pallas", "compiled"]


def _x(shape=(64, 256), seed=0, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[: shape[0] // 4] = 0.0
    return x.astype(dtype)


DESCS = {
    "store": lambda: RC.describe("MN", "MNM16N128"),
    "load_transpose": lambda: RC.describe("MNM8N128", "MN", RP.Transpose()),
    "prefill": lambda: RC.describe("MN", "MNM16N128", RP.RMSNormPlugin(
        weight=np.linspace(0.5, 1.5, 256).astype(jnp.bfloat16))),
    "cast_scale_bias": lambda: RC.describe("MN", "MNP64", RP.Cast(jnp.bfloat16),
                                           RP.Scale(1.5), RP.BiasAdd(0.25)),
    "gather": lambda: RC.describe("MN", "NM", RP.GatherScatter(
        indices=np.random.default_rng(2).permutation(64))),
    "compress": lambda: RC.describe("MN", "MNM8N128", RP.Compress(8)),
    "pre_post": lambda: RC.describe("MNM16N128", "MN", pre=(RP.Scale(2.0),),
                                    post=(RP.Compress(8), RP.Decompress())),
    "quantize": lambda: RC.describe("MN", "MNM32N128", RP.Quantize()),
}
EXACT = ("store", "load_transpose", "gather", "compress", "pre_post")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(DESCS))
def test_transfer_matches_reference_on_every_backend(name, backend):
    ref = dataclasses.replace(DESCS[name](), backend=backend)
    if backend == "compiled" and name == "quantize":
        with pytest.raises(ValueError, match="no-emit"):
            px.transfer(torch.zeros(64, 256), port_desc(ref))
        return
    xin = np.asarray(ref.src.layout.from_logical(jnp.asarray(_x())))
    want = rx.transfer(jnp.asarray(xin), ref)
    got = px.transfer(to_torch(xin), port_desc(ref))
    if name in EXACT:
        assert_same_payload(got, want, context=name)
    elif name == "quantize":
        # bitwise against the reference's jitted result: its "pallas"
        # backend runs the chain eagerly and divides (ROADMAP.md §3 item 2)
        if backend == "pallas":
            want = rx.transfer(jnp.asarray(xin),
                               dataclasses.replace(ref, backend="fused"))
        np.testing.assert_array_equal(bits(got.values), bits(want.values))
        np.testing.assert_array_equal(bits(got.scales), bits(want.scales))
    else:
        tol = O.chain_tolerance(ref)
        assert_same_payload(got, want, context=name, **tol)


@pytest.mark.parametrize("name", sorted(DESCS))
def test_transfer_matches_oracle(name):
    ref = DESCS[name]()
    xin = np.asarray(ref.src.layout.from_logical(jnp.asarray(_x(seed=4))))
    got = px.transfer(to_torch(xin), port_desc(ref))
    want = O.oracle_transfer(xin, ref)
    if isinstance(got, PC.QTensor):
        got = RP.QTensor(values=np.asarray(got.values),
                         scales=np.asarray(got.scales))
    elif isinstance(got, PC.CTensor):
        got = RP.CTensor(values=to_f32(got.values).astype(want.values.dtype),
                         mask=np.asarray(got.mask))
    else:
        got = to_f32(got).astype(np.asarray(want).dtype) \
            if got.dtype == torch.bfloat16 else got.numpy()
    O.assert_matches(got, want, context=name, **O.chain_tolerance(ref))


def test_pallas_backend_records_the_reference_stats():
    ragu.clear_agu_stats()
    pagu.clear_agu_stats()
    for name in sorted(DESCS):
        ref = dataclasses.replace(DESCS[name](), backend="pallas")
        xin = np.asarray(ref.src.layout.from_logical(jnp.asarray(_x())))
        rx.transfer(jnp.asarray(xin), ref)
        px.transfer(to_torch(xin), port_desc(ref))
    assert pagu.agu_stats() == ragu.agu_stats()
    assert pagu.agu_stats()["reasons"] == {"plugin-chain": 6}


def test_cache_stats_match_reference_after_the_same_calls():
    rx.clear_cache()
    px.clear_cache()
    refs = [DESCS[n]() for n in ("store", "load_transpose", "prefill")]
    ports = [port_desc(r) for r in refs]
    x = _x()
    for _ in range(3):
        for r, p in zip(refs, ports):
            xin = np.asarray(r.src.layout.from_logical(jnp.asarray(x)))
            rx.transfer(jnp.asarray(xin), r)
            px.transfer(to_torch(xin), p)
    # structurally equal descriptors share one CFG phase in both packages
    rx.transfer(jnp.asarray(x), RC.describe("MN", "MNM16N128"))
    px.transfer(to_torch(x), PC.describe("MN", "MNM16N128"))
    rs, ps = rx.cache_stats(), px.cache_stats()
    assert (ps.hits, ps.misses, ps.evictions, ps.size) == \
        (rs.hits, rs.misses, rs.evictions, rs.size) == (7, 3, 0, 3)


def test_cache_is_an_lru_with_capacity():
    px.clear_cache()
    cap = px.cache_capacity()
    try:
        px.set_cache_capacity(2)
        x = torch.zeros(32, 256)
        descs = [PC.describe("MN", lay) for lay in
                 ("MNM8N128", "MNM16N128", "MNM32N128")]
        for d in descs:
            px.transfer(x, d)
        assert px.cache_stats().evictions == 1 and px.cache_stats().size == 2
        px.transfer(x, descs[0])                  # evicted: a miss again
        assert px.cache_stats().misses == 4
        with pytest.raises(ValueError):
            px.set_cache_capacity(0)
    finally:
        px.set_cache_capacity(cap)
        px.clear_cache()


def test_queue_equals_the_transfers_in_turn():
    store = port_desc(DESCS["prefill"]())
    load = PC.describe("MNM16N128", "MN", PC.Transpose(), backend="compiled")
    q = px.XDMAQueue([store, load], name="prefill")
    x = to_torch(_x())
    want = px.transfer(px.transfer(x, store), load)
    np.testing.assert_array_equal(bits(q.run(x)), bits(want))
    step = q.run_task(q.run_task(x, 0), 1)
    np.testing.assert_array_equal(bits(step), bits(want))
    assert len(q) == 2 and q.is_local
    assert q.out_logical_shape((64, 256)) == (256, 64)
    assert q.out_dtype(torch.float32) == torch.float32
    assert "prefill" in q.summary()
    with pytest.raises(TypeError):
        q.submit("not a descriptor")


def test_queue_matches_the_reference_queue():
    refs = [DESCS["store"](), RC.describe("MNM16N128", "MNM8N128",
                                          RP.Scale(0.5))]
    x = _x()
    want = rx.XDMAQueue(refs).run(jnp.asarray(x))
    got = px.XDMAQueue([port_desc(r) for r in refs]).run(to_torch(x))
    assert_same_payload(got, want)


@pytest.mark.parametrize("endpoint", ["peer", "all_to_all", "reduce",
                                      "multicast_axis"])
def test_remote_movements_are_not_ported_yet(endpoint):
    ep = {"peer": lambda: PC.Endpoint.peer("x", [(0, 1), (1, 0)]),
          "all_to_all": lambda: PC.Endpoint.all_to_all("x"),
          "reduce": lambda: PC.Endpoint.reduce("x", 2),
          "multicast_axis": lambda: PC.Endpoint.multicast_axis(
              "x", [(0, 1), (1, 0)])}[endpoint]()
    desc = PC.XDMADescriptor(dst=ep)
    assert desc.movement == ("multicast" if endpoint.startswith("multicast")
                             else endpoint)
    # remote movements are ported now (ROADMAP §1 item 6): they lower to
    # collectives over a registered mesh axis (tests/test_torch_remote.py),
    # and outside one they raise, naming the axis
    with pytest.raises(LookupError, match="'x' is not registered"):
        px.transfer(torch.zeros(8, 128), desc)
    q = px.XDMAQueue([desc])
    assert len(q) == 1 and not q.is_local
    with pytest.raises(LookupError, match="'x' is not registered"):
        q.run(torch.zeros(8, 128))


def test_auto_layouts_are_not_ported_yet():
    # 'auto' layouts are ported now (ROADMAP §1 item 4): a transfer resolves
    # them through the cost-model autotuner to the reference's layouts, and
    # the output is the reference's, bitwise
    x = np.random.default_rng(3).standard_normal((64, 256)).astype(np.float32)
    for src, dst, plugins in (("MN", "auto", ()), ("auto", "MN", ()),
                              ("MN", "auto", ("transpose",))):
        ref_d = RC.describe(src, dst, *[RP.Transpose() for _ in plugins])
        port_d = PC.describe(src, dst, *[PC.Transpose() for _ in plugins])
        want = rx.transfer(jnp.asarray(x), ref_d)
        got = px.transfer(torch.from_numpy(x.copy()), port_d)
        assert_same_payload(got, want, context=f"{src}->{dst} {plugins}")
        ref_r = RC.autotune.resolve_descriptor(ref_d, (64, 256), jnp.float32)
        port_r = PC.autotune.resolve_descriptor(port_d, (64, 256),
                                                torch.float32)
        assert (port_r.src.layout.name, port_r.dst.layout.name) == \
            (ref_r.src.layout.name, ref_r.dst.layout.name)


@pytest.mark.parametrize("name", sorted(DESCS))
def test_from_spec_builds_the_reference_descriptor(name):
    ref = DESCS[name]()
    port = PD.from_spec(spec_of(ref))
    assert port.summary() == ref.summary()
    assert port.movement == ref.movement
    shape = (64, 256)
    assert port.out_logical_shape(shape) == ref.out_logical_shape(shape)
    assert str(port.out_dtype(torch.float32)).replace("torch.", "") == \
        np.dtype(ref.out_dtype(jnp.float32)).name
    assert port.burst_bytes(shape, "float32") == \
        ref.burst_bytes(shape, jnp.float32)
    for a, b in zip(port.plugins, ref.plugins):
        assert a.name == b.name
        for f in ("weight", "indices", "alpha", "bias"):
            if getattr(b, f, None) is not None and np.ndim(getattr(b, f)):
                assert np.array_equal(bits(getattr(a, f)), bits(getattr(b, f)))


def test_from_spec_layout_by_name_and_canonical_interning():
    desc = PD.from_spec({"src": {"layout": "MN"},
                         "dst": {"layout": {"name": "MNM8N128",
                                            "tile": (8, 128)}},
                         "pre": [{"name": "scale", "fields": {"alpha": 2.0}}],
                         "d_buf": 3})
    assert desc.dst.layout is PC.MNM8N128 and desc.d_buf == 3
    assert desc.plugins == (PC.Scale(2.0),)


def test_descriptor_contracts_match_reference():
    ref = RC.describe("MNM16N128", "MN", channels=4)
    port = port_desc(ref)
    pats_r, pats_p = ref.src_patterns((64, 256)), port.src_patterns((64, 256))
    assert [(p.bounds, p.base) for p in pats_p] == \
        [(p.bounds, p.base) for p in pats_r]
    with pytest.raises(ValueError):
        port.validate((30, 256))
    with pytest.raises(ValueError):
        PC.describe("MN", "MN", backend="xla")
    assert port_desc(DESCS["prefill"]()).cache_key()[0] == "id"


def test_telemetry_snapshot_and_spans():
    ptm.reset()
    px.clear_cache()
    with ptm.session(name="t") as tel:
        x = torch.zeros(32, 256)
        d = PC.describe("MN", "MNM8N128", backend="pallas")
        px.transfer(x, d)
        px.XDMAQueue([d]).run(x)
        snap = ptm.snapshot()
    assert snap["session"] == "t"
    assert snap["surfaces"]["agu_stats"]["kernel"] >= 2
    assert snap["surfaces"]["cache_stats"]["misses"] == 1
    assert [s.name for s in tel.spans] == ["xdma.transfer", "XDMAQueue.run"]
    assert ptm.snapshot() == {}


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    x = torch.zeros(32, 256)
    before = pagu.RELAYOUT.launches
    out = px.transfer(x, PC.describe("MN", "MNM8N128", backend="pallas"))
    assert tuple(out.shape) == (4, 2, 8, 128)
    assert pagu.RELAYOUT.launches == before      # no kernel on the CPU
    with pytest.raises(NotImplementedError, match="device"):
        pagu.relayout_kernel(x.to("meta"), PC.MN, PC.MNM8N128)
