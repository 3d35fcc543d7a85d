"""Parity of the port's cost-model layout autotuner
(``repro_torch.core.autotune``), its ``"auto"`` spelling and the page
geometry (``descriptor.page_layout`` / ``page_descriptor``) with the
reference's.

The cases of ``tests/test_autotune.py`` run on both packages through
:class:`torch_parity.Side`; every pick, cost, search count and cache key
must be the reference's exactly (a tie goes to the first candidate, so the
candidate order is part of the contract), and every ``auto`` transfer's
output bitwise.  A sweep of shapes x {f32, bf16, int8} x {default, wide,
narrow link} and the page geometries of the serving pool
(``repro.serving.paged``: 32-row pages, and the rows and widths its tests
use) hold the same, and so do the KV plane's store/load pairs
(``serving.transfer.kv_plane_descs``).
"""
import pytest

pytest.importorskip("torch")

import math  # noqa: E402

import numpy as np  # noqa: E402
from conftest import given, settings, st  # noqa: E402

from torch_parity import (bits, on_both,  # noqa: E402,F401
                          reset_global_state, sched_record)


def _result(r):
    return (None if r.layout is None else r.layout.name, r.cost,
            r.default_cost, r.scored, r.pruned)


# -- the interning tiled_layout constructor -----------------------------------
def _interning(S):
    L = S.L
    assert L.tiled_layout(8, 128) is L.MNM8N128
    assert L.tiled_layout(16, 128) is L.MNM16N128
    assert L.tiled_layout(32, 128) is L.MNM32N128
    assert L.tiled_layout(8, 8) is L.MNM8N8
    assert L.tiled_layout(8, 128, grid_colmajor=True) is L.NMM8N128
    assert L.tiled_layout(4, 8, 128) is L.KV4M8N128
    a = L.tiled_layout(8, 48)
    assert a is L.tiled_layout(8, 48) and a.name == "MNM8N48"
    assert L.tiled_layout(1, 8, 48) is a
    return [L.tiled_layout(*t, **kw).name for t, kw in (
        ((8, 48), {}), ((16, 24), {"grid_colmajor": True}),
        ((8, 16), {"tile_transposed": True}), ((2, 8, 48), {}),
        ((8, 40), {"pad_last": 8}))]


def test_tiled_layout_interns_named_layouts():
    on_both(_interning)


def _generated_names(S):
    L = S.L
    return [(lay.name, lay.tile, lay.perm, lay.pad) for lay in (
        L.tiled_layout(8, 48), L.tiled_layout(1, 8, 48),
        L.tiled_layout(4, 16, 64), L.tiled_layout(8, 128, grid_colmajor=True,
                                                  tile_transposed=True))]


def test_tiled_layout_generated_names_self_intern():
    on_both(_generated_names)


# -- the relayout sweep: tuned picks match or beat every hand pick ------------
SWEEP_SHAPE = (512, 512)
SWEEP_CASES = ["tile", "untile", "tiled_transpose", "mn_transpose"]


def _movements(S, name):
    at, L = S.autotune, S.L
    return {"tile": (at.Movement(L.MN, "dst"),),
            "untile": (at.Movement(L.MN, "src"),),
            "tiled_transpose": (at.Movement(L.MNM8N128, "dst",
                                            transpose=True),),
            "mn_transpose": (at.Movement(L.MN, "dst", transpose=True),)}[name]


def _sweep(S, name):
    at, f32 = S.autotune, S.dtypes["float32"]
    movements = _movements(S, name)
    hand = S.L.layout_for_dtype(f32)
    result = at.autotune(SWEEP_SHAPE, f32, movements=movements)
    hand_cost = at.layout_cost(hand, SWEEP_SHAPE, f32, movements,
                               at.DEFAULT_LINK)
    assert result.layout is not None and result.cost <= hand_cost
    return _result(result), hand_cost, at.autotune_stats()


@pytest.mark.parametrize("name", SWEEP_CASES)
def test_autotuned_matches_or_beats_hand_pick(name):
    on_both(_sweep, name)


def _strict_tile(S):
    at, L, f32 = S.autotune, S.L, S.dtypes["float32"]
    movements = (at.Movement(L.MN, "dst"),)
    result = at.autotune(SWEEP_SHAPE, f32, movements=movements)
    hand_cost = at.layout_cost(L.MNM8N128, SWEEP_SHAPE, f32, movements,
                               at.DEFAULT_LINK)
    assert result.cost < hand_cost
    return _result(result), hand_cost


def test_autotuned_strictly_beats_hand_tile_store():
    on_both(_strict_tile)


def _rank3(S):
    at, L, f32 = S.autotune, S.L, S.dtypes["float32"]
    shape = (6, 48, 48)
    result = at.autotune(shape, f32, tiled_only=True)
    assert result.layout is not None
    with pytest.raises((KeyError, ValueError)):
        L.by_name(result.layout.name)
    named = [L.MNM8N128, L.MNM16N128, L.MNM32N128, L.MNM8N8, L.NMM8N128,
             L.KV4M8N128]
    movements = (at.Movement(L.MN, "dst"),)
    costs = [at.layout_cost(lay, shape, f32, movements, at.DEFAULT_LINK)
             for lay in named]
    feasible = [c for c in costs if math.isfinite(c)]
    assert feasible and result.cost < min(feasible)
    return _result(result), costs


def test_rank3_tiled_search_beats_every_named_layout():
    on_both(_rank3)


def _beam(S):
    at = S.autotune
    result = at.autotune((512, 512), S.dtypes["float32"], tiled_only=True,
                         budget=24)
    assert result.pruned > 0 and result.scored <= 24 + at.BEAM_WIDTH
    return _result(result), at.autotune_stats()


def test_beam_search_prunes_large_lattices():
    on_both(_beam)


def _width_flip(S):
    at, L, f32 = S.autotune, S.L, S.dtypes["float32"]
    Link = S.topology.Link
    cands = (L.tiled_layout(8, 16), L.tiled_layout(8, 24))
    wide = Link("wide", "a", "b", width=96, burst_overhead=0.0)
    narrow = Link("narrow", "a", "b", width=64, burst_overhead=0.0)
    pick_w = at.best_layout((64, 48), f32, candidates=cands, link=wide)
    pick_n = at.best_layout((64, 48), f32, candidates=cands, link=narrow)
    assert pick_w.name == "MNM8N24" and pick_n.name == "MNM8N16"
    return pick_w.name, pick_n.name, sorted(at._CACHE, key=repr)


def test_fabric_width_flips_the_pick():
    on_both(_width_flip)


# -- determinism + the memo ---------------------------------------------------
def _same_key(S):
    at, f32 = S.autotune, S.dtypes["float32"]
    before = at.autotune_stats()
    r1 = at.autotune((64, 48), f32)
    r2 = at.autotune((64, 48), f32)
    after = at.autotune_stats()
    assert r1 is r2
    assert after["cache_hits"] == before["cache_hits"] + 1
    assert after["searches"] == before["searches"] + 1
    return _result(r1), after, list(at._CACHE)


def test_same_key_same_pick_and_cache_hit():
    on_both(_same_key)


def _clear_cache(S):
    at, f32 = S.autotune, S.dtypes["float32"]
    at.autotune((64, 48), f32)
    x = S.asarray(np.ones((8, 8), np.float32))
    y = S.xdma.transfer(x, S.C.describe(S.L.MN, "auto"))
    assert len(at._CACHE) > 0 and len(at._RESOLVED) > 0
    sizes = (len(at._CACHE), len(at._RESOLVED))
    S.xdma.clear_cache()
    assert len(at._CACHE) == 0 and len(at._RESOLVED) == 0
    return {"values": [y], "sizes": sizes}


def test_clear_cache_drops_autotune_memos():
    on_both(_clear_cache)


def _stats_surface(S):
    tm = S.telemetry
    with tm.session(name="s"):
        S.autotune.autotune((64, 48), S.dtypes["float32"])
        snap = tm.snapshot()
    stats = snap["surfaces"]["autotune_stats"]
    assert stats["searches"] >= 1 and stats["candidates_scored"] >= 1
    return stats, snap["counters"]["autotune"]


def test_autotune_stats_surface_in_snapshot():
    on_both(_stats_surface)


# -- page_layout: the historical strict-max-burst rule, and the reference ------
def _page_layout_historical(L, rows, cols, dtype_name):
    native = L.layout_for_dtype(dtype_name)
    candidates = [native] + [l for l in (L.MNM8N128, L.MNM16N128,
                                         L.MNM32N128, L.MNM8N8)
                             if l is not native]
    best, best_burst = L.MN, None
    for cand in candidates:
        tm, tn = cand.tile
        if rows % tm or cols % tn:
            continue
        burst = L.relayout_pair(L.MN, cand, (rows, cols)).burst_length()
        if best_burst is None or burst > best_burst:
            best, best_burst = cand, burst
    return best


def _page_layouts(S, dtype_name):
    page_layout = S.descriptor.page_layout
    out = []
    for rows in (8, 16, 31, 32, 48, 64, 96, 128, 256):
        for cols in (7, 8, 16, 64, 128, 256):
            got = page_layout(rows, cols, dtype_name)
            want = _page_layout_historical(S.L, rows, cols, dtype_name)
            assert got is want, (rows, cols, dtype_name, got.name, want.name)
            out.append(got.name)
    return out


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "int8"])
def test_page_layout_bit_identical_to_historical_rule(dtype_name):
    on_both(_page_layouts, dtype_name)


def _kv_plane_pairs(S, dtype_name):
    import importlib
    pkg = "repro" if S.name == "ref" else "repro_torch"
    kv_plane_descs = importlib.import_module(
        f"{pkg}.serving.transfer").kv_plane_descs
    L = S.L
    out = []
    for rows, d in [(64, 512), (64, 48), (31, 512), (64, 100), (32, 1024),
                    (16, 128)]:
        store, load = kv_plane_descs(rows, d, dtype_name)
        tiled = L.layout_for_dtype(dtype_name)
        tm, tn = tiled.tile
        if rows % tm == 0 and d % tn == 0:      # the historical rule
            assert store.dst.layout is tiled and load.src.layout is tiled
        else:
            assert store.dst.layout is L.MN and load.src.layout is L.MN
        out.append([d.summary() for d in (store, load)])
    return out


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_kv_plane_descs_match_historical_alignment_rule(dtype_name):
    on_both(_kv_plane_pairs, dtype_name)


# the serving pool's page geometries: DEFAULT_PAGE_ROWS = 32 and the row
# counts and cache widths (kv heads x head dim) its tests and engines use
PAGE_ROWS = (8, 16, 24, 31, 32, 48, 64, 96, 128, 256)
PAGE_COLS = (7, 8, 16, 48, 64, 100, 128, 256, 512, 1024, 3072)
PAGE_DTYPES = ("float32", "bfloat16", "float16", "int8")


def _page_descriptors(S):
    page_descriptor = S.descriptor.page_descriptor
    out = []
    for dtype_name in PAGE_DTYPES:
        for rows in PAGE_ROWS:
            for cols in PAGE_COLS:
                for direction in ("store", "load", "copy"):
                    for wire in (0, 8):
                        if wire and rows % wire:
                            with pytest.raises(ValueError):
                                page_descriptor(rows, cols, dtype_name,
                                                direction=direction,
                                                wire_compress_rows=wire)
                            continue
                        d = page_descriptor(rows, cols, dtype_name,
                                            direction=direction,
                                            wire_compress_rows=wire)
                        assert d is page_descriptor(
                            rows, cols, dtype_name, direction=direction,
                            wire_compress_rows=wire)       # lru-cached
                        out.append((d.summary(), d.src.layout.name,
                                    d.dst.layout.name, d.d_buf,
                                    [(p.name, getattr(p, "block_rows", None))
                                     for p in d.plugins]))
    with pytest.raises(ValueError):
        page_descriptor(32, 128, "float32", direction="sideways")
    return out, S.autotune.autotune_stats()


def test_page_descriptor_over_the_serving_page_geometries():
    on_both(_page_descriptors)


# -- a sweep: the same picks and costs, float for float ------------------------
SHAPES = [(64, 48), (512, 512), (96, 384), (256, 136), (6, 48, 48),
          (4, 32, 256), (128, 1024)]
DTYPES = ["float32", "bfloat16", "int8"]


def _links(S):
    Link = S.topology.Link
    return [None, Link("wide", "a", "b", bandwidth=400e9, width=128,
                       burst_overhead=10e-9),
            Link("narrow", "a", "b", bandwidth=25e9, width=32, latency=4e-6,
                 burst_overhead=200e-9)]


def _search_sweep(S, dtype_name):
    at, L = S.autotune, S.L
    dtype = S.dtypes[dtype_name]
    out = []
    for shape in SHAPES:
        for link in _links(S):
            for movements in ((), (at.Movement(L.MN, "src"),),
                              (at.Movement(L.MN, "dst", transpose=True),),
                              (at.Movement(L.MNM8N128, "dst", weight=0.5),
                               at.Movement(L.MN, "src", weight=2.0))):
                for tiled_only in (False, True):
                    r = at.autotune(shape, dtype, movements=movements,
                                    link=link, tiled_only=tiled_only)
                    out.append(_result(r))
            out.append(_result(at.autotune(shape, dtype, link=link,
                                           budget=12)))
        out.append([c.name for c in at.candidate_layouts(shape, dtype)])
    return out, list(at._CACHE), at.autotune_stats()


@pytest.mark.parametrize("dtype_name", DTYPES)
def test_search_sweep_same_picks_and_costs(dtype_name):
    on_both(_search_sweep, dtype_name)


# -- the `auto` spelling: value-exact resolution ------------------------------
def _arange(S):
    return S.asarray(np.arange(64 * 48, dtype=np.float32).reshape(64, 48))


def _auto_dst(S):
    C = S.C
    x = _arange(S)
    d = C.describe(S.L.MN, "auto")
    assert d.has_auto and d.dst.layout.is_auto
    y = S.xdma.transfer(x, d)
    np.testing.assert_array_equal(bits(y), bits(x))
    return {"values": [y], "resolved": list(S.autotune._RESOLVED.values())}


def test_transfer_with_auto_dst_is_value_exact():
    on_both(_auto_dst)


def _auto_src(S):
    C = S.C
    x = _arange(S)
    y = S.xdma.transfer(x, C.describe("auto", S.L.MN, C.Transpose()))
    np.testing.assert_array_equal(bits(y), bits(np.asarray(x).T.copy()))
    r = S.autotune.resolve_descriptor(C.describe("auto", S.L.MN), (64, 48),
                                      S.dtypes["float32"])
    assert r.src.layout is S.L.MN
    return {"values": [y], "resolved": r}


def test_auto_src_resolves_to_mn_never_reinterprets():
    on_both(_auto_src)


def _auto_transposed_store(S):
    C = S.C
    x = _arange(S)
    desc = C.describe(S.L.MN, "auto", C.Transpose())
    resolved = S.autotune.resolve_descriptor(desc, (64, 48),
                                             S.dtypes["float32"])
    y = S.xdma.transfer(x, desc)
    back = resolved.dst.layout.to_logical(y)
    np.testing.assert_array_equal(bits(back), bits(np.asarray(x).T.copy()))
    return {"values": [y, back], "resolved": resolved}


def test_auto_dst_transposed_store_keeps_logical_values():
    on_both(_auto_transposed_store)


def _queue_auto(S):
    C = S.C
    x = _arange(S)
    q = C.XDMAQueue([C.describe(S.L.MN, "auto"),
                     C.describe("auto", S.L.MN, C.Transpose())], name="auto-q")
    out = q.run(x)
    np.testing.assert_array_equal(bits(out), bits(np.asarray(x).T.copy()))
    first = q.run_task(x, 0)
    np.testing.assert_array_equal(bits(first), bits(x))
    return {"values": [out, first],
            "resolved": list(S.autotune._RESOLVED.values())}


def test_queue_resolves_auto_per_task():
    on_both(_queue_auto)


def _memoized(S):
    at, f32 = S.autotune, S.dtypes["float32"]
    d = S.C.describe(S.L.MN, "auto")
    r1 = at.resolve_descriptor(d, (64, 48), f32)
    r2 = at.resolve_descriptor(d, (64, 48), f32)
    r3 = at.resolve_descriptor(d, (48, 64), f32)
    assert r1 is r2 and r3 is not r1
    return r1, r3, at.autotune_stats()


def test_resolution_is_memoized_per_shape_and_fabric():
    on_both(_memoized)


def _sched_link(S):
    at = S.autotune
    topo = S.R.Topology(name="flip")
    topo.add_link("a", "b", name="wide", width=96)
    sched = S.R.DistributedScheduler(topo)
    x = _arange(S)
    f = sched.submit(x, S.C.describe(S.L.MN, "auto"), link="wide")
    f2 = sched.submit(f, S.C.describe("auto", S.L.MN), link="wide")
    sched.flush()
    np.testing.assert_array_equal(bits(f2.result()), bits(x))
    assert not sched._tasks[f.task_id].desc.has_auto
    assert not sched._tasks[f2.task_id].desc.has_auto
    assert at.fabric_fingerprint(topo.link("wide")) in {k[2] for k in
                                                        at._CACHE}
    return {"values": [f.result(), f2.result()],
            "descs": [sched._tasks[t].desc for t in sorted(sched._tasks)],
            "keys": list(at._CACHE), **sched_record(S, sched)}


def test_scheduler_threads_routed_link_into_autotune():
    on_both(_sched_link)


# -- property: the tuned pick never loses to the MN default, on both ----------
@st.composite
def autotune_case(draw):
    dtype_name, granule = draw(st.sampled_from(
        [("float32", 8), ("bfloat16", 16), ("int8", 32)]))
    m = draw(st.integers(1, 8)) * granule
    n = draw(st.integers(1, 6)) * 8
    width = draw(st.sampled_from([32, 64, 96, 128]))
    overhead = draw(st.sampled_from([0.0, 5e-8]))
    transpose = draw(st.booleans())
    return dtype_name, (m, n), width, overhead, transpose


def _property(S, case):
    dtype_name, shape, width, overhead, transpose = case
    at, L = S.autotune, S.L
    link = S.topology.Link("prop", "a", "b", width=width,
                           burst_overhead=overhead)
    movements = (at.Movement(L.MN, "dst", transpose),)
    result = at.autotune(shape, S.dtypes[dtype_name], movements=movements,
                         link=link)
    assert result.layout is not None and result.cost <= result.default_cost
    return _result(result)


@given(autotune_case())
@settings(max_examples=25, deadline=None)
def test_autotuned_cost_never_worse_than_default(case):
    on_both(_property, case)


# -- the stored benchmark record, from the port's autotuner ---------------------
def test_bench_pr10_autotune_ratios_from_the_port():
    """Every key of ``autotune_vs_handpicked_ratio`` in ``BENCH_PR10.json``
    (``benchmarks/autotune.py``: hand-picked over autotuned cost on the
    default fabric), rebuilt with the port's autotuner: equal to the stored
    floats, among them ``rank3_tiled`` 7.510942036011476; the section's rows
    (the picks' names and costs) too."""
    import json
    import os
    import torch
    from repro_torch.core import autotune as at
    from repro_torch.core import layouts as L
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "BENCH_PR10.json")) as f:
        bench = json.load(f)
    f32, link = torch.float32, at.DEFAULT_LINK
    rows = []

    def emit(case, shape, hand_name, hand_cost, auto_name, auto_cost):
        nbytes = math.prod(shape) * 4
        rows.append([f"autotune/{case}/hand:{hand_name}", hand_cost * 1e6,
                     nbytes / hand_cost / 1e9])
        rows.append([f"autotune/{case}/auto:{auto_name}", auto_cost * 1e6,
                     nbytes / auto_cost / 1e9])
        rows.append([f"autotune/{case}/ratio", auto_cost * 1e6,
                     hand_cost / auto_cost])

    for case, movements, hand in (
            ("tile", (at.Movement(L.MN, "dst"),), L.MNM8N128),
            ("untile", (at.Movement(L.MN, "src"),), L.MNM8N128),
            ("ttrans", (at.Movement(L.MNM8N128, "dst", transpose=True),),
             L.MNM8N128),
            ("mntrans", (at.Movement(L.MN, "dst", transpose=True),), L.MN)):
        hand_cost = at.layout_cost(hand, (512, 512), f32, movements, link)
        r = at.autotune((512, 512), f32, movements=movements)
        emit(case, (512, 512), hand.name, hand_cost, r.layout.name, r.cost)
    movements = (at.Movement(L.MN, "dst"),)
    named = [(lay, at.layout_cost(lay, (6, 48, 48), f32, movements, link))
             for lay in (L.MNM8N128, L.MNM16N128, L.MNM32N128, L.MNM8N8,
                         L.NMM8N128, L.KV4M8N128)]
    hand, hand_cost = min([(lay, c) for lay, c in named if math.isfinite(c)],
                          key=lambda lc: lc[1])
    r = at.autotune((6, 48, 48), f32, tiled_only=True)
    emit("rank3_tiled", (6, 48, 48), hand.name, hand_cost, r.layout.name,
         r.cost)
    ratios = {r[0]: r[2] for r in rows if r[0].endswith("/ratio")}
    assert ratios == bench["autotune_vs_handpicked_ratio"]
    assert ratios["autotune/rank3_tiled/ratio"] == 7.510942036011476
    assert rows == bench["sections"]["autotune"]
