"""Parity of the port's movement-plane consumers with the reference's:
``serving.transfer`` (KV store / load, round trips, fan-outs),
``serving.paged`` (``PagedKVPool``), ``data.pipeline`` (input staging) and
``checkpoint.manager``.

Each case is a single-process case of ``test_paged_serving.py``,
``test_serving.py``, ``test_checkpoint.py``, ``test_runtime.py``,
``test_multicast.py``, ``test_trace.py`` or ``test_api.py``, written once
as a scenario over :class:`torch_parity.Side` and run on both packages from
a fresh state (the port on the CPU, asked for with ``device="cpu"``).
``on_both`` holds the port to the reference: pool stats, scheduler reports,
completions and counter banks (``links``, ``cfg_cache``, ...) exactly;
moves, casts, masks and checkpoint bytes bitwise; the RMSNorm of the KV
store within the f32 chain tolerance of ``tests/oracle.py`` (rtol 2e-5,
atol 1e-5).  A checkpoint written by either package restores in the other
bitwise.
"""
import pytest

pytest.importorskip("torch")

import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_parity import (bits, on_both,  # noqa: E402,F401
                          reset_global_state, sched_record)

F32_CHAIN = dict(rtol=2e-5, atol=1e-5)


def _mods(S):
    pkg = "repro" if S.name == "ref" else "repro_torch"
    imp = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        T=imp("serving.transfer"), paged=imp("serving.paged"),
        pipe=imp("data.pipeline"), ckpt=imp("checkpoint.manager"),
        trace=imp("runtime.trace"), sim=imp("runtime.simulator"))


def _on(S):
    """The port's entry points run on the card unless asked: ask for the CPU."""
    return {} if S.name == "ref" else {"device": "cpu"}


def _arr(S, a):
    """A numpy array (0-d included) as the side's array."""
    if S.name == "ref":
        import jax.numpy as jnp
        return jnp.asarray(a)
    return torch.from_numpy(np.array(a))


# -- serving.paged: the page pool -------------------------------------------------
def _paginate(S):
    m = _mods(S).paged
    mat = S.rand((37, 16))
    pages = m.paginate(mat, 32)
    assert len(pages) == 2 and all(tuple(p.shape) == (32, 16) for p in pages)
    assert not np.asarray(pages[-1])[5:].any()     # the pad really is zero
    assert m.pages_for_rows(37, 32) == 2 and m.pages_for_rows(0, 32) == 0
    return {"values": list(pages) + [m.depaginate(pages, 37), mat],
            "empty": tuple(m.depaginate([], 0).shape)}


def test_paginate_depaginate_roundtrip():
    on_both(_paginate)


def _evict_restore(S):
    m = _mods(S).paged
    pool = m.PagedKVPool(4, 32, compress_block=8)
    sched = S.R.DistributedScheduler(S.R.Topology.host_device(2), name="t")
    pool.bind(sched)
    raw = np.random.default_rng(1).standard_normal((32, 16)).astype(np.float32)
    raw[8:16] = 0.0                       # a zero block Compress skips
    mat = _arr(S, raw)
    pid = pool.alloc(16, "float32")
    pool.store(pid, mat)
    sched.flush(); pool.commit()
    slot0 = pool.page(pid).slot
    stored = pool.page(pid).data
    pool.evict(pid)
    sched.flush(); pool.commit()
    assert pool.page(pid).location == "host" and pool.free_pages == 4
    evicted = pool.page(pid).data
    pool.restore(pid)
    sched.flush(); pool.commit()
    assert pool.page(pid).location == "dev" and pool.page(pid).slot == slot0
    back = pool.load(pid)
    sched.flush()
    np.testing.assert_array_equal(bits(back.result()), bits(raw))
    return {"values": [stored, evicted, back.result()], "stats": pool.stats,
            "slot": slot0, "summary": pool.summary(),
            "sched": sched_record(S, sched)}


def test_evict_restore_roundtrip_value_preserving_with_compress():
    on_both(_evict_restore)


def _defrag(S):
    m = _mods(S).paged
    pool = m.PagedKVPool(4, 32)
    sched = S.R.DistributedScheduler(S.R.Topology.host_device(1), name="t")
    pool.bind(sched)
    mats, pids = [], []
    for i in range(3):
        mat = S.rand((32, 8), seed=10 + i)
        pid = pool.alloc(8, "float32")
        pool.store(pid, mat)
        mats.append(mat)
        pids.append(pid)
    sched.flush(); pool.commit()
    pool.free(pids[0])
    assert pool.fragmentation() == 1
    assert pool.defrag() == 1
    sched.flush(); pool.commit()
    assert pool.fragmentation() == 0
    assert {pool.page(p).slot for p in pids[1:]} == {0, 1}
    outs = []
    for pid, mat in zip(pids[1:], mats[1:]):
        f = pool.load(pid)
        sched.flush()
        np.testing.assert_array_equal(bits(f.result()), bits(mat))
        outs.append(f.result())
    return {"values": outs, "stats": pool.stats,
            "slots": {p: pool.page(p).slot for p in pids[1:]},
            "sched": sched_record(S, sched)}


def test_pool_defrag_compacts_and_preserves_values():
    on_both(_defrag)


def _pool_guards(S):
    m = _mods(S).paged
    pool = m.PagedKVPool(1, 32)
    errors = []
    for fn in (lambda: pool.store(0, None),
               lambda: m.PagedKVPool(0),
               lambda: m.PagedKVPool(2, 30, compress_block=8)):
        with pytest.raises((KeyError, ValueError)) as e:
            fn()
        errors.append(type(e.value).__name__)
    pid = pool.alloc(8, "float32")
    with pytest.raises(MemoryError):
        pool.alloc(8, "float32")
    with pytest.raises(RuntimeError, match="bind"):
        pool.store(pid, S.rand((32, 8)))
    return {"errors": errors, "topology": m.default_serving_topology().link_names}


def test_pool_guards_and_default_topology():
    on_both(_pool_guards)


# -- serving.transfer: KV store and load --------------------------------------------
def _kv_store_load(S):
    T = _mods(S).T
    kv = S.rand((2, 64, 4, 128))
    tiled = T.kv_prefill_store(kv)
    assert tuple(tiled.shape) == (2, 8, 4, 8, 128)
    back = T.kv_load_transposed(tiled)
    assert tuple(back.shape) == (2, 512, 64)
    w = S.rand((512,), seed=5)
    weighted = T.kv_prefill_store(kv, norm_weight=w)
    return {"values": [tiled, back, weighted]}


def test_kv_prefill_store_and_load_roundtrip():
    on_both(_kv_store_load, values_tol=F32_CHAIN)


def _kv_queue(S):
    T = _mods(S).T
    kv = S.rand((2, 64, 4, 32))
    mat = kv.reshape(2, 64, 128)
    q = T.kv_roundtrip_queue(S.dtypes["float32"])
    out = q.run(mat)
    want = T.kv_load_transposed(T.kv_prefill_store(kv))
    np.testing.assert_array_equal(bits(out), bits(want))
    tasks = S.R.queue_sim_tasks(q, (64, 128), S.dtypes["float32"], "link0")
    assert [t.deps for t in tasks] == [(), (0,)]
    assert all(t.nbytes == 2 * 64 * 128 * 4 for t in tasks)
    return {"values": [out], "tasks": tasks, "summary": q.summary()}


def test_kv_roundtrip_queue_matches_store_then_load():
    on_both(_kv_queue, values_tol=F32_CHAIN)


def _kv_overlapped(S):
    M = _mods(S)
    kvs = [S.rand((2, 64, 4, 32), seed=s) for s in range(3)]
    outs, sched = M.T.kv_roundtrips_overlapped(kvs)
    for kv, out in zip(kvs, outs):
        want = M.T.kv_load_transposed(M.T.kv_prefill_store(kv))
        np.testing.assert_array_equal(bits(out), bits(want))
    rep = sched.report()
    spans = {t.label + f"#{t.id}": rep.span_of(t.id) for t in sched.sim_tasks()}
    stores = sorted((s for n, s in spans.items() if n.startswith("kv_store")),
                    key=lambda s: s.start)
    loads = sorted((s for n, s in spans.items() if n.startswith("kv_load")),
                   key=lambda s: s.start)
    assert stores[1].start < loads[0].end      # shard 1's store overlaps
    serial = M.sim.simulate(M.sim.serialize(sched.sim_tasks(), "h2d0"),
                            sched.topology).makespan
    assert rep.makespan < serial
    return {"values": outs, "sched": sched_record(S, sched), "serial": serial}


def test_kv_roundtrips_overlapped_parity_and_pipelining():
    on_both(_kv_overlapped, values_tol=F32_CHAIN)


def _kv_cache_roundtrip(S):
    T = _mods(S).T
    sched = S.R.DistributedScheduler(S.R.Topology.host_device(2), name="kv")
    leaves = [S.rand((2, 64, 4, 32), seed=1), S.rand((24, 40), seed=2),
              S.rand((2, 32, 2, 64), seed=3, dtype="bfloat16")]
    futs = [T.kv_cache_roundtrip(leaf, scheduler=sched, lane=i,
                                 label=f"kv{i}")
            for i, leaf in enumerate(leaves)]
    sched.flush()
    for leaf, f in zip(leaves, futs):
        mat = leaf if leaf.ndim == 2 else leaf.reshape(
            -1, leaf.shape[-2] * leaf.shape[-1])
        np.testing.assert_array_equal(bits(f.result()), bits(mat))
    return {"values": [f.result() for f in futs],
            "descs": [T.kv_plane_descs(64, 128, "float32"),
                      T.kv_plane_descs(24, 40, "float32")],
            "sched": sched_record(S, sched)}


def test_kv_cache_roundtrip_through_the_scheduler():
    on_both(_kv_cache_roundtrip)


def _fanouts(S):
    T = _mods(S).T
    params = {"w": S.rand((64, 128)), "emb": S.rand((2, 16, 128), seed=4),
              "step": S.asarray(np.asarray(3, np.int32))}
    sched = S.R.DistributedScheduler(S.R.Topology.host_device(devices=3))
    out = T.replica_weight_broadcast(params, scheduler=sched)
    assert set(out) == {"dev0", "dev1", "dev2"}
    for p in out.values():
        np.testing.assert_array_equal(bits(p["w"]), bits(params["w"]))
        np.testing.assert_array_equal(bits(p["emb"]), bits(params["emb"]))
        assert p["step"] is params["step"]     # counters stay off-plane
    pages = S.rand((4, 16, 128), seed=2)
    fut = T.prefix_cache_fanout(pages, scheduler=sched, dsts=["dev1", "dev2"])
    resolved = fut.dst_descriptors()
    assert all(not d.dst_layout.is_auto for d in resolved.values())
    np.testing.assert_array_equal(bits(fut.result_at("dev2")),
                                  bits(pages.reshape(-1, 128)))
    return {"values": [out["dev1"]["w"], out["dev2"]["emb"],
                       fut.result_at("dev1"), fut.result_at("dev2")],
            "resolved": resolved, "sched": sched_record(S, sched)}


def test_serving_weight_broadcast_and_prefix_fanout():
    on_both(_fanouts)


# -- data.pipeline: input staging ---------------------------------------------------
def _staging(S):
    pipe = _mods(S).pipe
    batch = {"tokens": np.arange(12, dtype=np.int32).reshape(3, 4),
             "embeds": np.ones((3, 4, 8), np.float32)}
    out = pipe.stage_batch(batch, S.dtypes["bfloat16"], **_on(S))
    assert str(out["tokens"].dtype).endswith("int32")
    assert str(out["embeds"].dtype).endswith("bfloat16")
    ds = pipe.SyntheticLM(vocab=64, seq_len=8, global_batch=4, family="vlm",
                          d_model=16)
    batches = [ds.batch_at(i) for i in range(4)]
    assert [sorted(b) for b in batches] == [["embeds", "labels",
                                             "positions"]] * 4
    sched = S.R.DistributedScheduler(S.R.Topology.host_device(2),
                                     name="staging")
    staged = list(pipe.prefetch_staged(iter(batches), S.dtypes["bfloat16"],
                                       depth=2, scheduler=sched, **_on(S)))
    assert len(staged) == len(batches)
    values = [out["tokens"], out["embeds"]]
    for got, b in zip(staged, batches):
        want = pipe.stage_batch(b, S.dtypes["bfloat16"], **_on(S))
        assert set(got) == set(want)
        for k in sorted(want):
            np.testing.assert_array_equal(bits(got[k]), bits(want[k]))
            values.append(got[k])
    audio = pipe.SyntheticLM(vocab=64, seq_len=4, global_batch=2, seed=3,
                             family="audio", d_model=8, encoder_seq=6)
    it = pipe.make_batch_iterator(audio, start_step=2)
    first = next(it)
    assert all(np.array_equal(first[k], audio.batch_at(2)[k]) for k in first)
    return {"values": values, "raw": [audio.batch_at(5)] + batches,
            "sched": sched_record(S, sched)}


def test_stage_batch_and_prefetch_staged():
    on_both(_staging)


def _staging_capture(S):
    M = _mods(S)
    ds = M.pipe.SyntheticLM(vocab=64, seq_len=8, global_batch=4, family="vlm",
                            d_model=16)
    batches = [ds.batch_at(i) for i in range(3)]
    with M.trace.capture(name="staging") as tr:
        staged = list(M.pipe.prefetch_staged(iter(batches),
                                             S.dtypes["bfloat16"], depth=2,
                                             **_on(S)))
    assert len(staged) == 3
    evs = tr.xdma_events()
    assert len(evs) == 3                       # one embeds staging a batch
    assert all(e.source == "scheduler" and e.link.startswith("h2d")
               for e in evs)
    with M.trace.capture() as tq:
        M.pipe.stage_batch(batches[0], S.dtypes["bfloat16"], **_on(S))
    assert [e.source for e in tq.xdma_events()] == ["queue"]
    return {"events": [(e.endpoint, e.link, e.nbytes, e.label, e.source)
                       for e in evs + tq.xdma_events()],
            "per_link": tr.per_link_bytes()}


def test_pipeline_staging_lands_in_ambient_capture():
    on_both(_staging_capture)


# -- checkpoint.manager ----------------------------------------------------------------
def _tree(S, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": _arr(S, rng.standard_normal((8, 16)).astype(np.float32)),
                   "b": S.rand((16,), seed=seed + 100, dtype="bfloat16")},
        "opt": {"mu": {"w": _arr(S, np.ones((8, 16), np.float32)),
                       "b": _arr(S, np.zeros((16,), np.float32))},
                "count": _arr(S, np.asarray(7, np.int32))},
        "step": _arr(S, np.asarray(42 + seed, np.int32)),
    }


def _template(S, tree):
    if S.name == "ref":
        import jax
        return jax.eval_shape(lambda: tree)
    return tree


def _leaves(S, tree):
    if S.name == "ref":
        import jax
        return jax.tree.leaves(tree)
    from repro_torch import _pytree
    return _pytree.leaves(tree)


def _on_disk(directory):
    """A checkpoint's files as plain data: every array's dtype, shape and
    bytes, and the ``meta.json`` document."""
    with np.load(os.path.join(directory, "arrays.npz")) as z:
        arrays = {k: (z[k].dtype.name, z[k].shape, z[k].tobytes())
                  for k in z.files}
    with open(os.path.join(directory, "meta.json")) as f:
        meta = f.read()
    return {"arrays": arrays, "order": list(arrays), "meta": meta}


def _ckpt_roundtrip(S, tmp):
    ck = _mods(S).ckpt
    root = os.path.join(tmp, S.name)
    t = _tree(S)
    ck.save_pytree(t, os.path.join(root, "c"))
    back = ck.restore_pytree(_template(S, t), os.path.join(root, "c"),
                              **_on(S))
    assert str(back["params"]["b"].dtype).endswith("bfloat16")
    for a, b in zip(_leaves(S, t), _leaves(S, back)):
        np.testing.assert_array_equal(bits(a), bits(b))
    m = ck.CheckpointManager(os.path.join(root, "m"), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, _tree(S, s))
    assert m.steps() == [3, 4] and m.latest_step() == 4
    restored = m.restore(4, _template(S, _tree(S, 4)), **_on(S))
    a = ck.CheckpointManager(os.path.join(root, "a"), keep=3)
    a.save(10, _tree(S, 10), blocking=False)
    a.wait()
    assert a.latest_step() == 10
    async_back = a.restore(10, _template(S, _tree(S, 10)), **_on(S))
    for want, got in ((_tree(S, 4), restored), (_tree(S, 10), async_back)):
        for x, y in zip(_leaves(S, want), _leaves(S, got)):
            np.testing.assert_array_equal(bits(x), bits(y))
    bad = {**_tree(S), "params": {"w": _arr(S, np.zeros((4, 4), np.float32)),
                                  "b": _tree(S)["params"]["b"]}}
    with pytest.raises(ValueError):
        m.restore(4, _template(S, bad), **_on(S))
    os.makedirs(os.path.join(root, "crash", "tmp.99"))
    assert ck.CheckpointManager(os.path.join(root, "crash")).steps() == []
    return {"values": _leaves(S, back) + _leaves(S, restored)
            + _leaves(S, async_back),
            "files": [_on_disk(os.path.join(root, "c")),
                      _on_disk(os.path.join(root, "m", "step_0000000004")),
                      _on_disk(os.path.join(root, "a", "step_0000000010"))]}


def test_checkpoint_roundtrip_retention_async_and_guards(tmp_path):
    on_both(_ckpt_roundtrip, str(tmp_path))


def _layout_staging(S, tmp):
    ck, L = _mods(S).ckpt, S.L
    root = os.path.join(tmp, S.name)
    t = {"w": _arr(S, np.arange(64 * 48, dtype=np.float32).reshape(64, 48)),
         "b": _arr(S, np.arange(48, dtype=np.float32)),
         "e": S.rand((16, 128), dtype="bfloat16"),
         "odd": _arr(S, np.ones((31, 7), np.float32))}
    m = ck.CheckpointManager(os.path.join(root, "auto"), stage_layout="auto")
    m.save(1, t)
    step1 = os.path.join(root, "auto", "step_0000000001")
    specs = ck.read_layout_specs(step1)
    assert "w" in specs and specs["w"].tile is not None
    assert "odd" not in specs
    back = m.restore(1, _template(S, t), **_on(S))
    plain = ck.CheckpointManager(os.path.join(root, "auto")).restore(
        1, _template(S, t), **_on(S))
    host = ck.restore_pytree(_template(S, t), step1, **_on(S))
    for k in t:
        for got in (back, plain, host):
            np.testing.assert_array_equal(bits(got[k]), bits(t[k]))
            assert str(got[k].dtype) == str(t[k].dtype)
    # a down-cast snapshot restores through the inverse Cast
    lin = np.linspace(0.0, 1.0, 64 * 128, dtype=np.float32).reshape(64, 128)
    d = ck.CheckpointManager(os.path.join(root, "down"),
                             stage_dtype=S.dtypes["bfloat16"],
                             stage_layout="auto")
    d.save(1, {"w": _arr(S, lin)})
    down = d.restore(1, _template(S, {"w": _arr(S, lin)}), **_on(S))
    assert str(down["w"].dtype).endswith("float32")
    np.testing.assert_allclose(np.asarray(down["w"]), lin, rtol=1e-2,
                               atol=1e-2)
    # an explicit layout where it fits, plain where it does not
    e = ck.CheckpointManager(os.path.join(root, "explicit"),
                             stage_layout=L.MNM8N128)
    te = {"w": _arr(S, np.arange(32 * 128, dtype=np.float32).reshape(32, 128)),
          "odd": _arr(S, np.ones((10, 10), np.float32))}
    e.save(1, te)
    especs = ck.read_layout_specs(os.path.join(root, "explicit",
                                               "step_0000000001"))
    assert especs["w"] is L.MNM8N128 and "odd" not in especs
    explicit = e.restore(1, _template(S, te), **_on(S))
    for k in te:
        np.testing.assert_array_equal(bits(explicit[k]), bits(te[k]))
    return {"values": [back[k] for k in sorted(t)] + [down["w"]]
            + [explicit[k] for k in sorted(te)],
            "specs": {k: (v.name, v.tile) for k, v in specs.items()},
            "files": [_on_disk(step1),
                      _on_disk(os.path.join(root, "down", "step_0000000001")),
                      _on_disk(os.path.join(root, "explicit",
                                            "step_0000000001"))]}


def test_checkpoint_layout_staging_auto_downcast_and_explicit(tmp_path):
    on_both(_layout_staging, str(tmp_path))


def _ckpt_trace(S, tmp):
    M = _mods(S)
    root = os.path.join(tmp, S.name)
    tree = {"w": S.rand((32, 64)), "b": _arr(S, np.zeros((64,), np.float32)),
            "step": _arr(S, np.asarray(3, np.int32))}
    m = M.ckpt.CheckpointManager(os.path.join(root, "a"), keep=2)
    with M.trace.capture(name="ckpt") as tr:
        m.save(1, tree)
        back = m.restore(1, _template(S, tree), **_on(S))
    np.testing.assert_array_equal(bits(back["w"]), bits(tree["w"]))
    assert len(tr.xdma_events()) == 2
    assert all(e.endpoint == "local" for e in tr.xdma_events())
    w = np.random.default_rng(0).standard_normal((32, 64)).astype(np.float32)
    w[:16] = 0.0
    c = M.ckpt.CheckpointManager(os.path.join(root, "c"), keep=2,
                                 stage_dtype=S.dtypes["bfloat16"],
                                 wire_compress_blocks=8)
    with M.trace.capture() as tc:
        c.save(1, {"w": _arr(S, w)})
    ev = tc.xdma_events()[0]
    assert any(p.name == "compress_blocksparse" for p in ev.desc.pre)
    assert ev.wire_nbytes is not None and ev.wire_nbytes < 32 * 64 * 2
    cback = c.restore(1, _template(S, {"w": _arr(S, w)}), **_on(S))
    assert str(cback["w"].dtype).endswith("float32")
    return {"values": [back["w"], cback["w"]],
            "events": [(e.endpoint, e.nbytes, e.wire_nbytes, e.label)
                       for e in tr.xdma_events() + tc.xdma_events()]}


def test_checkpoint_staging_recorded_with_cast_and_compress(tmp_path):
    on_both(_ckpt_trace, str(tmp_path))


# -- checkpoints cross between the packages --------------------------------------------
def _cross_tree(S):
    return {"layer": {"qkv": S.rand((64, 256), seed=1, dtype="bfloat16"),
                      "o": S.rand((64, 128), seed=2, dtype="bfloat16"),
                      "norm": S.rand((128,), seed=3, dtype="bfloat16")},
            "f32": S.rand((32, 128), seed=4),
            "odd": S.rand((10, 7), seed=5),
            "step": _arr(S, np.asarray(9, np.int32))}


@pytest.mark.parametrize("stage_layout", [None, "auto"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer,
                                                stage_layout):
    from torch_parity import Side
    w, r = Side(writer), Side("port" if writer == "ref" else "ref")
    ckw, ckr = _mods(w).ckpt, _mods(r).ckpt
    ckw.CheckpointManager(str(tmp_path), stage_layout=stage_layout).save(
        5, _cross_tree(w))
    step = str(tmp_path / "step_0000000005")
    meta = json.load(open(os.path.join(step, "meta.json")))
    assert sorted(meta["bf16"]) == ["layer/norm", "layer/o", "layer/qkv"]
    assert ("layouts" in meta) == (stage_layout == "auto")
    want = _cross_tree(r)
    for reader in (ckr.CheckpointManager(str(tmp_path)).restore(
                       5, _template(r, want), **_on(r)),
                   ckr.restore_pytree(_template(r, want), step, **_on(r))):
        for a, b in zip(_leaves(r, want), _leaves(r, reader)):
            assert str(a.dtype) == str(b.dtype)
            np.testing.assert_array_equal(bits(a), bits(b))


def test_port_and_reference_write_the_same_files(tmp_path):
    from torch_parity import Side
    files = {}
    for name in ("ref", "port"):
        S = Side(name)
        root = str(tmp_path / name)
        _mods(S).ckpt.CheckpointManager(root, stage_layout="auto").save(
            5, _cross_tree(S))
        files[name] = _on_disk(os.path.join(root, "step_0000000005"))
    assert files["port"] == files["ref"]


def test_port_restore_lands_on_the_card_by_default(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    t = {"w": torch.zeros(8, 16)}
    CheckpointManager(str(tmp_path)).save(1, t)
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|cuda"):
        CheckpointManager(str(tmp_path)).restore(1, t)


def test_port_staging_lands_on_the_card_by_default():
    from repro_torch.data.pipeline import stage_batch
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|cuda"):
        stage_batch({"x": np.ones((2, 4), np.float32)}, torch.bfloat16)


def test_port_restore_pytree_lands_on_the_card_by_default(tmp_path):
    from repro_torch.checkpoint import restore_pytree, save_pytree
    t = {"w": torch.zeros(8, 16)}
    save_pytree(t, str(tmp_path))
    assert restore_pytree(t, str(tmp_path), "cpu")["w"].device.type == "cpu"
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|cuda"):
        restore_pytree(t, str(tmp_path))


def test_payload_carriers_flatten_in_the_reference_order():
    """A tree holding QTensor / CTensor payloads: the checkpoint's leaf names
    and the scheduler's payload bytes equal the reference's."""
    import jax.numpy as jnp
    from repro.checkpoint import manager as RM
    from repro.core import plugins as RP
    from repro.runtime import scheduler as RS
    from repro_torch import _pytree
    from repro_torch.core import plugins as PP
    from repro_torch.runtime import scheduler as PS
    rng = np.random.default_rng(3)
    vals = rng.integers(-127, 128, (4, 8)).astype(np.int8)
    scales = rng.standard_normal((4, 1)).astype(np.float32)
    dense = rng.standard_normal((2, 8, 16)).astype(np.float32)
    mask = np.array([[True, False], [False, True]])

    def tree(P, arr):
        return {"q": [P.QTensor(arr(vals), arr(scales)), None],
                "c": (P.CTensor(arr(dense), arr(mask)), arr(scales))}

    want = RM._flatten_with_paths(tree(RP, jnp.asarray))
    got_tree = tree(PP, torch.from_numpy)
    got = {_pytree.path_key(p): leaf
           for p, leaf in _pytree.flatten_with_paths(got_tree)}
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert PS._nbytes(got_tree) == RS._nbytes(tree(RP, jnp.asarray))
    back = _pytree.unflatten(got_tree, _pytree.leaves(got_tree))
    assert isinstance(back["q"][0], PP.QTensor)
    assert isinstance(back["c"][0], PP.CTensor) and back["q"][1] is None
    assert torch.equal(back["c"][0].mask, got_tree["c"][0].mask)
