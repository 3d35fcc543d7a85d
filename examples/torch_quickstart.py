"""Quickstart on the PyTorch port: the XDMA core in fifteen moves.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
      [--trace quickstart.trace.json]

The twin of ``examples/quickstart.py``, move for move, through
``repro_torch``'s public API.  It runs on the card by default: the
transfers launch the hand-written CUDA kernels (kernel 1, the AGU relayout,
in move 4 and on the serving planes and page pool of moves 10-12; kernel 2,
the streamed plugin datapath, in the RMSNorm stores of moves 6-8 and 13;
kernel 3, the block datapath, in the transposed loads of moves 7-8 and the
Compress / Decompress of move 9).
``--device cpu`` runs the kernels' plain PyTorch versions instead.

Moves 1-7 cover the descriptor/transfer core (DESIGN.md §2-§3); move 8 is
the distributed runtime (§6); move 9 the plugin compiler's compressed store
(§7); move 10 the movement plane (§9): a serving decode step captured and
replayed under hardware-Frontend vs software-AGU costing; move 11
continuous-batching serving (§10) on a Poisson stream; move 12 the
telemetry plane (§11) and its Chrome trace export; move 13 descriptor rings
(§12) with ``WouldBlock`` backpressure; move 14 the layout autotuner (§13);
move 15 the multicast plane (§14).

Every makespan, speedup, byte count and counter printed is the cost
model's or a counter's, so it depends on shapes and bytes only and equals
the reference's.  A parity line is bitwise, except where the chain does
float arithmetic (RMSNorm): there it holds the chain tolerance of
``tests/oracle.py`` (rtol 2e-5, atol 1e-5 for f32), since kernel 2 sums a
row in another order than ``torch.mean``; the record keeps the max abs
error beside the flag.
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch import core as C  # noqa: E402
from repro_torch.core import autotune, plugin_compiler, xdma  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime import (DistributedScheduler, Topology,  # noqa: E402
                                 WouldBlock, capture, chrometrace,
                                 multicast_sim_tasks, serialize, simulate,
                                 telemetry, unicast_sim_tasks)
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 ServingEngine, poisson_stream)

F32_TOL = dict(rtol=2e-5, atol=1e-5)     # tests/oracle.py, an f32 stream


def device_of(name):
    """The device the CLI was asked for; never a silent fall to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "kernels' plain versions")
    return dev


def parity(got, want, tol=None):
    """(flag, max abs err): bitwise without ``tol``, else within it."""
    if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        return False, float("inf")
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    if tol is None:
        return bool(torch.equal(got, want)), err
    return bool(torch.allclose(got, want, **tol)), err


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def decode_config():
    """Move 10's model: phi4-mini's smoke config in f32 with 2 KV heads of
    128 (the reference's ``dataclasses.replace`` overrides)."""
    return dataclasses.replace(configs.smoke_config("phi4_mini_3p8b"),
                               dtype=torch.float32, n_kv_heads=2,
                               head_dim=128)


def serve_config():
    """Move 11's model: qwen3's smoke config in f32."""
    return dataclasses.replace(configs.smoke_config("qwen3_1p7b"),
                               dtype=torch.float32)


def run(device="cuda", *, params=None, prompt=None, serve_params=None,
        trace_path="quickstart.trace.json", seed=0):
    """The fifteen moves on ``device``; returns the record ``lines`` prints.

    ``params`` / ``serve_params`` are moves 10 and 11's model weights
    (``None``: ``lm.init_params(cfg, seed)``), ``prompt`` move 10's (2, 8)
    prompt tokens (``None``: drawn from ``seed + 1``).  Move 12 writes its
    Chrome trace to ``trace_path``."""
    dev = torch.device(device)
    rec = {"device": str(dev)}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((256, 512)).astype(
        np.float32)).to(dev)

    # 1. describe a task: row-major -> MXU-tiled, RMSNorm applied in flight
    desc = C.describe("MN", "MNM8N128", C.RMSNormPlugin(), d_buf=9)
    rec["descriptor"] = desc.summary()

    # 2. the descriptor IS the hardware address-generator config (Table II)
    pat = desc.src_pattern(tuple(x.shape))
    rec["pattern"] = (pat.dim, tuple(pat.bounds), tuple(pat.strides))

    # 3. run it: the plain chain, one stream in logical order
    tiled = C.xdma_copy(x, desc)
    rec["tiled_shape"] = tuple(tiled.shape)

    # 4. the same task through kernel 1 (the AGU relayout)
    tiled_k = C.xdma_copy_pallas(x, C.describe("MN", "MNM8N128", d_buf=9))
    rec["kernel_eq_plain"] = parity(
        tiled_k, C.xdma_copy(x, C.describe("MN", "MNM8N128")))

    # 5. load it back transposed (the paper's KV-cache Load workload)
    back = C.xdma_copy(tiled, C.describe("MNM8N128", "MN", C.Transpose()))
    rec["loaded_shape"] = tuple(back.shape)

    # 6. the unified entry point, the CFG phase cached per descriptor
    y = xdma.transfer(x, desc)                   # lowered once: a miss
    y = xdma.transfer(x, desc)                   # pure Data phase: a hit
    rec["transfer_parity"] = parity(y, tiled, F32_TOL)
    rec["cache_stats"] = repr(xdma.cache_stats())

    # 7. the Controller's in-order task queue: store + load
    queue = C.XDMAQueue([C.describe("MN", "MNM8N128", C.RMSNormPlugin()),
                         C.describe("MNM8N128", "MN", C.Transpose())],
                        name="kv_roundtrip")
    rec["queue_summary"] = queue.summary()
    queue_out = queue.run(x)
    rec["queue_out"] = (tuple(queue_out.shape),
                        dtype_name(queue.out_dtype(torch.float32)))

    # 8. the distributed runtime: per-link FIFOs + futures on 2 links
    sched = DistributedScheduler(Topology.parallel(2), name="quickstart")
    store = C.describe("MN", "MNM8N128", C.RMSNormPlugin())
    load = C.describe("MNM8N128", "MN", C.Transpose())
    for link in ("link0", "link1"):              # two async store->load chains
        f_store = sched.submit(x, store, link=link)
        f_load = sched.submit(f_store, load, link=link)
    got = f_load.result()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    rec["async_parity"] = parity(got, queue.run(x), F32_TOL)
    report = sched.report()
    rec["sched_report"] = report.summary()
    serial = simulate(serialize(sched.sim_tasks(), "link0"), sched.topology)
    rec["speedup_2link"] = serial.makespan / report.makespan

    # 9. the plugin compiler: a block-sparse compressed store (kernel 3)
    sparse = x.clone()
    sparse[:128] = 0.0                           # half the row blocks zero
    fused_store = C.describe("MN", "MNM8N128", C.Compress(block_rows=8))
    ct = xdma.transfer(sparse, fused_store)      # -> CTensor(values, mask)
    dense_bytes = sparse.numel() * sparse.element_size()
    wire = C.Compress(block_rows=8)(sparse).wire_nbytes()
    rec["compressed"] = (float(ct.occupancy()), dense_bytes, wire,
                         plugin_compiler.cfg_stats())
    roundtrip = C.XDMAQueue([fused_store,
                             C.describe("MNM8N128", "MN", C.Decompress())],
                            name="compressed_roundtrip")
    rec["compressed_exact"] = parity(roundtrip.run(sparse), sparse)

    # 10. the movement plane: capture a decode step, replay it anywhere
    cfg = decode_config()
    if params is None:
        params = lm.init_params(cfg, seed, device=dev)
    if prompt is None:
        prompt = torch.randint(0, cfg.vocab, (2, 8), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(
                                   seed + 1))
    prompt = {"tokens": torch.as_tensor(prompt).to(dev)}
    eng = ServingEngine(cfg, params, max_len=32, cache_dtype=torch.float32,
                        device=dev)
    with capture(name="decode") as trace:
        rec["decode_tokens"] = eng.generate(prompt, 2).cpu().tolist()
    rec["trace_summary"] = trace.summary()
    fabric = Topology.host_device(2)
    hw, sw_cost = trace.replay(fabric), trace.replay(fabric, sw_agu=True)
    rec["decode_replay"] = (fabric.name, hw.makespan, sw_cost.makespan)

    # 11. continuous batching on a Poisson stream over the paged-KV pool;
    #     time is the scheduler's simulated timeline, so deterministic
    cfg_lm = serve_config()
    if serve_params is None:
        serve_params = lm.init_params(cfg_lm, seed, device=dev)
    serve_eng = ContinuousBatchingEngine(
        cfg_lm, serve_params, max_len=24, max_batch=4,
        cache_dtype=torch.float32, device=dev)
    stream = poisson_stream(cfg_lm, 6, 8e4, prompt_lens=(4, 8),
                            max_new=(2, 4), seed=0)
    with capture(name="serve") as serve_trace:
        serve_report = serve_eng.serve(stream)
    rec["serve_summary"] = serve_report.summary()
    rec["serve_tokens"] = {rid: list(map(int, t)) for rid, t in
                           sorted(serve_report.tokens.items())}
    rec["page_movements"] = (len(serve_trace.labelled("page:")),
                             serve_report.pool_stats["movements"])

    # 12. the telemetry plane: one snapshot, and a Chrome trace export
    telemetry.reset("links")
    with telemetry.session(name="quickstart") as tel, \
            capture(name="decode-telemetry") as tl_trace:
        eng.generate(prompt, 2)                  # the move-10 decode, observed
        snap = telemetry.snapshot()              # one call, every surface
    counted = {k.removeprefix("bytes:"): v
               for k, v in snap["surfaces"]["scheduler_links"].items()
               if k.startswith("bytes:") and v}
    rec["telemetry"] = (counted, tl_trace.per_link_bytes())
    events = (chrometrace.trace_events(tl_trace, fabric)
              + chrometrace.telemetry_events(tel))
    chrometrace.export(events, trace_path)
    rec["trace_export"] = (trace_path, len(events))

    # 13. descriptor rings: a ring-full WouldBlock drained with step()
    telemetry.reset("rings")
    ring_sched = DistributedScheduler(Topology.parallel(1), name="rings",
                                      ring_depth=2, backpressure="error")
    posted, retried = [], 0
    for _ in range(5):                           # 5 posts through 2 credits
        while True:
            try:
                posted.append(ring_sched.submit(x, store, link="link0"))
                break
            except WouldBlock:                   # ring full: no credits
                ring_sched.step()                # retire the head -> credit
                retried += 1
    ring_sched.flush()
    rings = telemetry.bank("rings")
    rec["rings"] = (retried, rings.get("full:link0"),
                    rings.get("doorbells:link0"),
                    rings.get("credits_hw:link0"))
    rec["ring_makespan"] = (ring_sched.makespan(),
                            ring_sched.report().makespan,
                            len(ring_sched.completions))
    rec["ring_outputs"] = parity(posted[-1].result(), posted[0].result())

    # 14. the layout autotuner: "auto" resolved against the link cost model
    auto_desc = C.describe("MN", "auto")
    resolved = autotune.resolve_descriptor(auto_desc, tuple(x.shape), x.dtype)
    picked = resolved.dst.layout
    burst_auto = C.relayout_pair(C.MN, picked, tuple(x.shape)).burst_length()
    burst_hand = C.relayout_pair(C.MN, C.MNM8N128,
                                 tuple(x.shape)).burst_length()
    y_auto = xdma.transfer(x, auto_desc)         # same pick, end to end
    stats = autotune.autotune_stats()
    rec["autotune"] = (tuple(x.shape), picked.name, burst_auto, burst_hand)
    rec["autotune_stats"] = (stats["searches"], stats["candidates_scored"],
                             stats["cache_hits"])
    rec["autotune_roundtrip"] = parity(picked.to_logical(y_auto), x)

    # 15. the multicast plane: one weight shard to 4 replicas as one tree
    ring = Topology.ring(5)                      # dev0 = source, 4 replicas
    mc_sched = DistributedScheduler(ring, name="bcast")
    shard = torch.from_numpy(rng.standard_normal((256, 512)).astype(
        np.float32)).to(dev)
    bcast = C.describe(C.Endpoint.local(C.MN),
                       C.Endpoint.multicast(("dev1", "dev2", "dev3", "dev4")))
    with capture(name="bcast") as mc_trace:
        fut = mc_sched.submit_multicast(shard, bcast, src="dev0",
                                        label="shard")
        mc_sched.flush()
    rec["multicast"] = (repr(fut), fut.tree.summary())
    rec["multicast_exact"] = all(bool(torch.equal(got, shard))
                                 for got in fut.result())
    rec["multicast_hops"] = [
        (e.multicast_hop[0], e.multicast_hop[1], e.multicast_serves)
        for e in mc_trace.events if e.multicast_group is not None]
    nbytes = shard.numel() * shard.element_size()
    dsts = list(fut.dsts)
    m = simulate(multicast_sim_tasks(ring, "dev0", dsts, nbytes)[0], ring)
    u = simulate(unicast_sim_tasks(ring, "dev0", dsts, nbytes), ring)
    rec["multicast_makespans"] = (ring.name, m.makespan, u.makespan,
                                  fut.tree.saved_hops)
    return rec


def failures(rec) -> list:
    """The record's checks that do not hold: parity flags, the ring's
    retries against its full events, the incremental makespan against the
    replay, the telemetry against the ledger, the page ledger against the
    pool, the multicast copies."""
    bad = [k for k in ("kernel_eq_plain", "transfer_parity", "async_parity",
                       "compressed_exact", "ring_outputs",
                       "autotune_roundtrip") if not rec[k][0]]
    retried, full, _, _ = rec["rings"]
    if retried != full:
        bad.append("rings: WouldBlock retries != full events")
    inc, replayed, _ = rec["ring_makespan"]
    if inc != replayed:
        bad.append("ring_makespan: incremental != replay")
    counted, ledger = rec["telemetry"]
    if counted != ledger:
        bad.append("telemetry: per-link bytes != ledger")
    in_ledger, in_pool = rec["page_movements"]
    if in_ledger != in_pool:
        bad.append("page_movements: ledger != pool")
    if not rec["multicast_exact"]:
        bad.append("multicast_exact")
    return bad


def lines(rec) -> list:
    """The record as ``examples/quickstart.py`` words it, line for line
    (move 4 names the kernel where the reference names Pallas)."""
    out = [f"descriptor: {rec['descriptor']}"]
    dim, bounds, strides = rec["pattern"]
    out.append(f"src address generator: Dim={dim} Ext={bounds} "
               f"strides={strides}")
    out.append(f"physical tiled shape: {rec['tiled_shape']}")
    out.append(f"kernel==plain: {rec['kernel_eq_plain'][0]}")
    out.append(f"loaded K^T shape: {rec['loaded_shape']}")
    out.append(f"transfer parity: {rec['transfer_parity'][0]} | "
               f"{rec['cache_stats']}")
    out.extend(rec["queue_summary"].splitlines())
    shape, dt = rec["queue_out"]
    out.append(f"queue out: {shape} dtype contract: {dt}")
    out.append(f"async parity: {rec['async_parity'][0]}")
    out.extend(rec["sched_report"].splitlines())
    out.append(f"2-link speedup over one in-order FIFO: "
               f"{rec['speedup_2link']:.2f}x")
    occ, dense, wire, stats = rec["compressed"]
    out.append(f"compressed store: occupancy={occ:.2f} wire bytes {dense} -> "
               f"{wire} ({dense / wire:.1f}x), stats={stats}")
    out.append(f"compressed roundtrip exact: {rec['compressed_exact'][0]}")
    out.extend(rec["trace_summary"].splitlines())
    name, hw, sw = rec["decode_replay"]
    out.append(f"decode timeline on {name}: frontend {hw * 1e6:.1f}us vs "
               f"sw-AGU {sw * 1e6:.1f}us -> {sw / hw:.1f}x app speedup "
               f"(paper Fig. 11)")
    out.extend(rec["serve_summary"].splitlines())
    moved, pool = rec["page_movements"]
    out.append(f"page movements in the ledger: {moved} (pool counted {pool})")
    counted, ledger = rec["telemetry"]
    out.append(f"telemetry: per-link bytes {counted} == ledger {ledger}")
    path, n_events = rec["trace_export"]
    out.append(f"wrote {path} ({n_events} events) — load it in Perfetto")
    retried, full, doorbells, hw_credits = rec["rings"]
    out.append(f"ring-full backpressure: {retried} WouldBlock retries, "
               f"{full} full events, {doorbells} doorbells, credit "
               f"high-water {hw_credits}/2")
    inc, replayed, n_done = rec["ring_makespan"]
    out.append(f"incremental makespan == replay: {inc == replayed} "
               f"({inc * 1e6:.1f}us, {n_done} completions)")
    shape, picked, b_auto, b_hand = rec["autotune"]
    out.append(f"autotuned store layout for {shape}: {picked} (burst "
               f"{b_auto} elems vs {b_hand} through MNM8N128)")
    searches, scored, hits = rec["autotune_stats"]
    out.append(f"autotuner: {searches} searches, {scored} candidates scored, "
               f"{hits} cache hits — same key never searches twice")
    fut, tree = rec["multicast"]
    out.append(f"multicast: {fut} | {tree}")
    out.append("tree in the trace: " + "; ".join(
        f"{a}->{b} (serves {n})" for a, b, n in rec["multicast_hops"]))
    name, m, u, saved = rec["multicast_makespans"]
    out.append(f"tree vs 4 unicasts on {name}: {m * 1e6:.1f}us vs "
               f"{u * 1e6:.1f}us -> {u / m:.2f}x (saved {saved} hop "
               f"re-walks)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels) or cpu (their "
                         "plain versions)")
    ap.add_argument("--trace", default="quickstart.trace.json",
                    help="where move 12 writes its Chrome trace")
    args = ap.parse_args(argv)
    rec = run(device_of(args.device), trace_path=args.trace)
    print("\n".join(lines(rec)), flush=True)
    bad = failures(rec)
    if bad:
        raise SystemExit(f"quickstart: checks failed: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
