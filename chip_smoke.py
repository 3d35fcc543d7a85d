"""Drive the PyTorch port's kernel paths on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all started together), then drives the port through
its public entry points at the sizes its users call real, and holds every
kernel against its plain PyTorch version on the same inputs:

* the local ``xdma.transfer`` datapath (kernels 1-3): the paper's Fig. 4
  relayouts at 4096 x 4096 f32, and the Table III Prefill store and Load at
  the full width of phi4-mini-3.8B (d_model 3072) over an 8192-token
  prefill in bf16;
* ``ops.rmsnorm_relayout`` (kernel 4) on the same Prefill store;
* ``ops.quantize_tiled`` (kernel 5) on one phi4-mini MLP gradient leaf,
  3072 x 8192 (the int8 wire codec);
* ``flash_attention_gqa`` (kernel 6) on a phi4-mini prefill (S 4096, 24
  query / 8 kv heads, hd 128, causal) and a gemma3-27B local layer (32 / 16
  heads, window 1024), in bf16;
* the paper's Fig. 4 (phase 9): kernel 1 beside the three software setups
  of ``core.baselines`` on the same bytes at 4096 x 4096 f32 (the
  transposing pair at 512 x 512), all four bitwise equal, each setup's GPU
  wall time and link utilization logged;
* the distributed Controller (phase 10): one task graph through
  ``DistributedScheduler`` (two tenants' Prefill store -> load chains,
  kernel-1 relayouts, an ``auto`` store, a multicast), held to serial
  transfers, to its replayed makespan and to its ``links`` counters, and
  timed against the same transfers issued serially;
* trace capture and replay (phase 11) of that graph: the ledger's per-link
  bytes equal the counters, a software-AGU replay is slower than the
  Frontend's, and the Chrome trace goes to ``chiprun_out/``.
* the collectives (phase 12): a world of 4 ranks, on the one card over gloo
  (NCCL where there is a card a rank; ``sharding.run_spmd``; the ranks
  load the kernels built here): the int8
  reduce codec and its error feedback on a phi4-mini gradient leaf (3072 x
  8192 f32) against float64 and bitwise against the port's CPU run of the
  same four inputs, the plain reduce, a phi4-mini KV shard (8192 tokens x 8
  kv heads x 128, bf16) around the ring through a transposing src side
  (kernel 3) and a Cast -> Scale dst side (kernel 2), and an MoE dispatch
  all-to-all at mixtral-8x7b width (4 x 2048 tokens x 4096, bf16), plain
  and with the int8 codec; each rank logs its times and host-hop bytes;
* the movement-plane consumers (phase 13): the KV store and load and 8
  round trips through the scheduler, a page pool of 4096 tokens through
  store, load, evict, restore and defrag (stats equal to its CPU run),
  checkpoints of one phi4-mini decoder layer (plain, ``auto`` layout,
  down-cast, async; restored onto the card and onto the CPU) and staging of
  three qwen2-vl-7b input batches;
* the serving path (phase 14): full-width phi4-mini (32 layers, f32 master
  weights from the port's seeded initializer) served by ``ServingEngine``,
  B 4 x 1024-token prompts, 16 greedy steps, its bf16 KV cache through the
  scheduler's plane every step (kernel 1 each way): tokens and final cache
  bitwise the planeless loop's, decode logits against the forward's, one
  decoder layer in f32 against its CPU run, and the seven non-MoE smoke
  archs' tokens against their CPU runs;
* continuous batching (phase 15) on the same model: four 32-token prompts
  arriving together, bitwise ``ServingEngine.generate``'s tokens, then a
  stream of eight requests (16, 32 and 48 prompt tokens) through
  ``ContinuousBatchingEngine`` and ``StaticBatchEngine`` over a page pool
  of 75 % of the stream's peak: preemption forced, every restored page
  bitwise its evicted buffer, tokens equal each request's fixed-batch run
  where the top-2 margin clears the tie rule (kernel 1 stores and loads
  pages, kernel 3 runs the evict / restore wire codec);
* an MoE model served (phase 16): qwen3-moe-30b-a3b at full width, 8 of
  its 48 layers, through ``ServingEngine`` (tokens and cache bitwise the
  planeless loop's), one MoE layer in f32 against its CPU run (router
  probabilities, expert ids, output), the three MoE smoke configs' tokens
  against their CPU runs;
* MoE expert-parallel dispatch (phase 17): 4 ranks on the card, one
  qwen3-moe layer's experts split 32 a rank: the EP path against the local
  path, the int8 wire, the scheduled chunked dispatch, the ring
  all-gather.

Each phase resets the kernels' launch counts just before it drives the path
and reads them just after; a kernel of the path that did not launch, a
result that disagrees, or a kernel that does not build or launch fails the
run with a non-zero exit.  Phases 2-4 also assert the launches by code
path: kernel 1's ``direct`` and ``staged`` copies, kernel 2's two main-path
launches on its ``rows`` path (a small NM chain on its generic path), and
kernel 3's six main-path transfers all on its rank-2 path (a small rank-3
chain on its generic path).  Phase 12 checks the launches in every rank
(kernels 2 and 3), phase 13 in its process (kernels 1, 2 and 3), phase 14
kernel 1 on the serving plane, phase 15 kernels 1 and 3 on the page pool,
phase 16 kernel 1 on the MoE model's plane.  Phase 4 also drives the chains kernels 2
and 3 once refused (integer streams, nine streamed ops, logical rank 5),
and phase 8 kernel 6 at head dims 8, 80, 192, 256, 320 and 512 (the last
two on its chunked path, timed) and with bf16 q and f32 k / v.  Phase 3 also times the Prefill store at
gemma3-27B width (d_model 5376).  Phase 7 holds kernel 5 on NaN, inf and
-inf rows too.  Phase 8 asserts that both bf16 model layers took kernel 6's
tensor-core path (``mma``) and its small f32 checks the FMA path (``fma``).

The line before the last is one JSON object with each kernel's launches,
error and times (CUDA events, median of several runs, GPU time only);
the last line is ``{"ok": true, "device": {...}}``.  Per-pair times go to
``chiprun_out/chip_smoke_times.json``, the compiler's output (registers and
spills of every kernel) to ``chiprun_out/build_log.txt``; a tensor-core
instance of kernel 6 or a rows-path instance of kernel 2 that spills fails
the run.  Without a CUDA device it exits non-zero and prints no result.
"""
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
SEED = 0
ROW_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


# -- timing: GPU time of one call, the host's enqueue hidden behind a sleep --
def gpu_ms(fn, reps=7, warmup=2, sleep_cycles=2_000_000):
    """Median device time of one call: the card sleeps ``sleep_cycles``
    while the host enqueues the call, so host time longer than that sleep
    is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)   # keeps the card busy while we enqueue
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bits(t):
    size = t.element_size()
    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32, 8: torch.int64}[size])


def assert_bitwise(got, want, what):
    check(tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype,
          f"{what}: {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(torch.equal(bits(got), bits(want)), f"{what}: not bitwise equal")


def max_abs_err(got, want):
    return float((got.float() - want.float()).abs().max())


def tolerance(chain, in_dtype):
    """tests/oracle.py's chain_tolerance, read for the stream: one ulp of a
    half-precision stream (a Cast to it, or a bf16/f16 input) -> rtol 2e-2,
    atol 1e-2; float32 streams -> rtol 2e-5, atol 1e-5."""
    from repro_torch.core import plugins as P
    half = in_dtype.itemsize < 4 or any(
        isinstance(p, P.Cast) and p.dtype.itemsize < 4 for p in chain)
    return dict(rtol=2e-2, atol=1e-2) if half else dict(rtol=2e-5, atol=1e-5)


def assert_close(got, want, tol, what):
    check(tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype,
          f"{what}: {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite")
    ok = torch.allclose(got.float(), want.float(), **tol)
    check(ok, f"{what}: outside {tol}, max abs err {max_abs_err(got, want)}")


def on_cpu_one_thread(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with one intra-op CPU thread: the CPU
    references of kernel 6.  On a busy host a process's first multithreaded
    batched f32 matmul on the CPU has been seen to return one batch
    element about 5e-5 off a float64 reference, and on one thread not
    (``scripts/cpu_reference_check.py`` counts it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args, **kwargs)
    finally:
        torch.set_num_threads(threads)


def attention_f64(q, k, v, *, causal, window=None):
    """Softmax attention in float64 on the CPU, (B, S, H, hd) with kv heads
    read by group, or (BH, S, hd): the yardstick the f32 checks log their
    own error against."""
    gqa = q.dim() == 4
    q, k, v = (t.cpu().double() for t in (q, k, v))
    if gqa:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        k, v = (t.repeat_interleave(q.shape[1] // k.shape[1], dim=1)
                for t in (k, v))
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    qp = torch.arange(q.shape[-2])[:, None]
    kp = torch.arange(k.shape[-2])[None, :]
    live = torch.ones_like(s, dtype=torch.bool)
    if causal:
        live &= kp <= qp
    if window is not None:
        live &= kp > qp - window
    o = torch.softmax(s.masked_fill(~live, float("-inf")), -1) @ v
    return o.transpose(1, 2) if gqa else o


def ptxas_entries(text):
    """(mangled name, registers, bytes of stack frame, bytes of spill
    traffic) of each entry function in an ``nvcc -Xptxas -v`` log."""
    found = []
    for entry in re.split(r"Compiling entry function", text)[1:]:
        name = re.match(r"\s*'(\w+)'", entry)
        regs = re.search(r"Used (\d+) registers", entry)
        if name and regs:
            stack = sum(int(b) for b in re.findall(r"(\d+) bytes stack", entry))
            spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill", entry))
            found.append((name.group(1), int(regs.group(1)), stack, spill))
    return found


def demangled(names):
    """``names`` as ``c++filt`` reads them, or as they are where it does not
    run."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
    except OSError:
        return list(names)
    read = out.stdout.splitlines()
    return read if out.returncode == 0 and len(read) == len(names) else \
        list(names)


# -- phase 12: the collectives, one process a rank -----------------------------
RANKS = 4
GRAD_SHAPE = (3072, 8192)        # phi4-mini MLP gradient leaf, f32: 96 MiB
KV_SHAPE = (1, 8192, 8, 128)     # phi4-mini KV shard, bf16: 16 MiB
MOE_SHAPE = (4 * 2048, 4096)     # mixtral-8x7b dispatch buffer, bf16: 64 MiB
# -- phase 13: one phi4-mini decoder layer's weights (bf16: 201 MB), a pool
# of 128 pages of 32 tokens of the KV shard, qwen2-vl-7b input batches
LAYER = {"qkv": (3072, 5120), "o": (3072, 3072), "gate_up": (3072, 16384),
         "down": (8192, 3072)}
D_MODEL = 3072
POOL_PAGES = 128
VLM = dict(vocab=152064, seq_len=4096, global_batch=4, d_model=3584)


def rank_inputs(r, dev):
    """Rank ``r``'s gradient leaf, KV shard and MoE dispatch buffer, drawn on
    the card from its own seed, so any rank can draw any rank's."""
    gen = torch.Generator(device=dev).manual_seed(1000 + r)
    g = torch.randn(GRAD_SHAPE, generator=gen, device=dev)
    kv = torch.randn(KV_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
    moe = torch.randn(MOE_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
    return g, kv, moe


def wall_ms_synced(fn, reps=3):
    """Median wall time of ``fn`` with the card synchronized before and
    after (a collective's time is its slowest rank's)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase12_rank(mesh, card):
    """One rank of phase 12: the reduce codec, the plain reduce, the KV
    tunnel (kernel-3 and kernel-2 sides) and the MoE all-to-all, on the
    card; held to float64, to the rolled plain results and to the port's
    plain CPU run of the same four inputs over the same group."""
    from repro_torch import core as C
    from repro_torch import sharding as S
    from repro_torch.core import remote, xdma
    from repro_torch.core.descriptor import Endpoint
    from repro_torch.kernels import _build
    from repro_torch.runtime import telemetry
    from repro_torch.serving.transfer import cross_stage_transfer

    torch.set_num_threads(2)             # four ranks share the host's cores
    dev, n, r = mesh.device, mesh.world_size, S.axis_index("x")
    tag = f"[collectives rank {r}]"
    ring = tuple((i, (i + 1) % n) for i in range(n))
    g, kv, moe = rank_inputs(r, dev)
    codec = C.reduce_descriptor("x", n, compressed=True)
    plain = C.reduce_descriptor("x", n)
    peer_cast = C.describe(Endpoint.local(C.MN), Endpoint.peer("x", ring),
                           post=(C.Cast(torch.float32), C.Scale(0.125)))
    a2a = C.describe(Endpoint.local(C.MN), Endpoint.all_to_all("x", 0, 0))
    a2a_codec = C.describe(Endpoint.local(C.MN), Endpoint.all_to_all("x", 0, 0),
                           pre=(C.Quantize(),),
                           post=(C.Dequantize(torch.bfloat16),))
    mat = kv.reshape(KV_SHAPE[1], -1)
    ops = {
        "reduce codec": lambda: xdma.transfer(g, codec),
        "feedback": lambda: C.compressed_psum_with_feedback(
            g, torch.zeros_like(g), "x", n),
        "reduce plain": lambda: xdma.transfer(g, plain),
        "kv tunnel, transpose (kernel-3 src side)":
            lambda: cross_stage_transfer(kv, "x", ring, transpose=True),
        "kv tunnel, Cast -> Scale (kernel-2 dst side)":
            lambda: xdma.transfer(mat, peer_cast),
        "moe all_to_all": lambda: xdma.transfer(moe, a2a),
        "moe all_to_all int8": lambda: xdma.transfer(moe, a2a_codec),
    }
    _build.reset_launches()
    telemetry.reset("wire")
    out = {k: f() for k, f in ops.items()}
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in _build.KERNELS}
    wire = remote.wire_stats()
    check(counts["streamed_datapath"] > 0 and counts["block_datapath"] > 0,
          f"{tag} the side kernels did not launch: {counts}")
    want_backend = S.pick_backend(n, "cuda")[0]
    check(mesh.backend == want_backend,
          f"{tag} backend {mesh.backend}, not {want_backend}")
    # gloo on CUDA tensors crosses through the host; NCCL never does
    hop = wire.get("host_hop_bytes", 0)
    check(hop > 0 if mesh.backend == "gloo" else hop == 0,
          f"{tag} {hop} host-hop bytes under {mesh.backend}")
    # float64 sums of the four ranks' leaves, the rolled plain results
    exact = sum(rank_inputs(j, dev)[0].double() for j in range(n))
    _, prev_kv, _ = rank_inputs((r - 1) % n, dev)
    scale = float(exact.abs().max())
    red = out["reduce codec"]
    rel = float((red.double() - exact).abs().max()) / scale
    check(rel < 0.02, f"{tag} reduce codec {rel} off float64 (bound 0.02)")
    fb_red, fb_err = out["feedback"]
    rel_fb = float((fb_red.double() - exact).abs().max()) / scale
    check(rel_fb < 0.02 and float(fb_err.abs().max()) < float(g.abs().max()),
          f"{tag} error feedback {rel_fb}")
    assert_close(out["reduce plain"].double(), exact,
                 dict(rtol=1e-5, atol=1e-5), f"{tag} plain reduce vs float64")
    assert_bitwise(out["kv tunnel, transpose (kernel-3 src side)"],
                   prev_kv.reshape(1, KV_SHAPE[1], -1).transpose(-1, -2),
                   f"{tag} kv tunnel transpose vs rolled plain")
    assert_bitwise(out["kv tunnel, Cast -> Scale (kernel-2 dst side)"],
                   prev_kv.reshape(KV_SHAPE[1], -1).float() * 0.125,
                   f"{tag} kv tunnel Cast -> Scale vs rolled plain")
    chunk = MOE_SHAPE[0] // n
    for j in range(n):
        src = rank_inputs(j, dev)[2][r * chunk:(r + 1) * chunk]
        assert_bitwise(out["moe all_to_all"][j * chunk:(j + 1) * chunk], src,
                       f"{tag} moe all_to_all block from rank {j}")
    # the port's plain CPU run of the same four inputs, over the same ranks
    # (a gloo group of its own where the mesh runs NCCL, which takes no CPU
    # tensors)
    import contextlib
    import torch.distributed as dist
    cpu_axis = contextlib.nullcontext()
    if mesh.backend != "gloo":
        cpu_axis = S.axis_scope([S.MeshAxis(
            "x", n, r, dist.new_group(list(range(n)), backend="gloo"),
            "gloo")])
    with cpu_axis:
        cpu = {"reduce codec": xdma.transfer(g.cpu(), codec),
               "feedback": C.compressed_psum_with_feedback(
                   g.cpu(), torch.zeros(GRAD_SHAPE), "x", n),
               "moe all_to_all int8": xdma.transfer(moe.cpu(), a2a_codec),
               "moe all_to_all": xdma.transfer(moe.cpu(), a2a)}
    for k, want in cpu.items():
        got = out[k] if k != "feedback" else out[k][0]
        want = want if k != "feedback" else want[0]
        assert_bitwise(got.cpu(), want, f"{tag} {k}: card vs CPU run")
    assert_bitwise(out["feedback"][1].cpu(), cpu["feedback"][1],
                   f"{tag} feedback residual: card vs CPU run")
    del cpu, exact
    times, hops = {}, {}
    for k, f in ops.items():
        telemetry.reset("wire")
        times[k] = wall_ms_synced(f)
        hops[k] = remote.wire_stats().get("host_hop_bytes", 0) // 3
    # the host hop alone: the gradient leaf to the host and back
    hop_ms = wall_ms_synced(lambda: g.cpu().to(dev))
    # the side kernels' device time, rank 0 alone on the card
    side_ms = {}
    if r == 0:
        from repro_torch.core import plugin_compiler
        src_side = plugin_compiler.compile_side(C.MN, (C.Transpose(),),
                                                side="src")
        dst_side = plugin_compiler.compile_side(
            C.MN, peer_cast.post, side="dst")
        flat = kv.reshape(1, KV_SHAPE[1], -1)
        side_ms = {"kernel-3 src side (transpose)": gpu_ms(
                       lambda: src_side(flat)),
                   "kernel-2 dst side (Cast -> Scale)": gpu_ms(
                       lambda: dst_side(mat))}
    dist.barrier()
    for k in ops:
        log(f"{tag} {k}: {times[k]:.3f} ms wall (median of 3), host hop "
            f"{hops[k]} bytes a call, on {card}")
    log(f"{tag} launches {counts}; reduce codec {rel:.5f} of max off "
        f"float64; wire {wire}")
    return {"times": times, "hops": hops, "hop_ms": hop_ms, "rel": rel,
            "side_ms": side_ms,
            "counts": counts, "wire": wire, "backend": mesh.backend_note}


def phase13(dev, gen, card, drive, wall_ms):
    """Phase 13: the movement-plane consumers on ``dev``: the KV store and
    load and 8 round trips through the scheduler, a page pool of 4096
    tokens through every page op, checkpoints of one decoder layer (plain,
    auto layout, down-cast, async) and input staging of qwen2-vl batches.
    Every output is held to its plain version (the pool also to its CPU
    run); returns the times."""
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import layouts as L
    from repro_torch.data.pipeline import SyntheticLM, prefetch_staged, \
        stage_batch
    from repro_torch.kernels import agu, datapath
    from repro_torch.runtime import DistributedScheduler, Topology
    from repro_torch.serving import PagedKVPool, paginate
    from repro_torch.serving import transfer as KV

    kv = torch.randn(KV_SHAPE, generator=gen, device=dev).to(torch.bfloat16)
    shards = [torch.randn(KV_SHAPE, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(8)]
    # the pool holds the shard's first POOL_PAGES * 32 tokens
    pool_mat = kv.reshape(KV_SHAPE[1], -1)[:POOL_PAGES * 32].clone()
    pool_mat.view(POOL_PAGES, 32, -1)[::4, 8:16] = 0   # blocks Compress skips
    weights = {k: (torch.randn(shp, generator=gen, device=dev) * 0.02).to(
        torch.bfloat16) for k, shp in LAYER.items()}
    weights["input_norm"] = torch.ones(D_MODEL, device=dev,
                                       dtype=torch.bfloat16)
    master = {k: torch.randn(shp, generator=gen, device=dev) * 0.02
              for k, shp in LAYER.items()}
    ds = SyntheticLM(seed=SEED, family="vlm", **VLM)
    batches = [ds.batch_at(i) for i in range(3)]
    ckpt_root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")

    def pool_run(mat, device):
        """Store, load, evict, restore and defrag the pages on ``device``;
        -> (loaded pages, pages after the round trip, stats)."""
        pool = PagedKVPool(POOL_PAGES, 32, compress_block=8,
                           name=f"kv@{device}")
        sched = DistributedScheduler(Topology.host_device(2), name="pool")
        pool.bind(sched)
        pages = paginate(mat, 32)
        pids = [pool.alloc(mat.shape[1], "bfloat16") for _ in pages]
        for pid, page in zip(pids, pages):
            pool.store(pid, page)
        sched.flush(); pool.commit()
        loads = [pool.load(pid) for pid in pids]
        sched.flush()
        loaded = [f.result() for f in loads]
        for pid in pids[::4]:
            pool.evict(pid)
        sched.flush(); pool.commit()
        for pid in pids[1::4]:
            pool.free(pid)
        for pid in pids[::4]:
            pool.restore(pid)
        sched.flush(); pool.commit()
        pool.defrag()
        sched.flush(); pool.commit()
        kept = [pid for i, pid in enumerate(pids) if i % 4 != 1]
        back = [pool.load(pid) for pid in kept]
        sched.flush()
        return loaded, [f.result() for f in back], pool.stats

    def consumers():
        tiled = KV.kv_prefill_store(kv)
        loaded = KV.kv_load_transposed(tiled)
        outs, sched = KV.kv_roundtrips_overlapped(
            shards, scheduler=DistributedScheduler(Topology.host_device(2)))
        pool_out = pool_run(pool_mat, dev)
        ck = {}
        for name, kw, tree in (("plain", {}, weights),
                               ("auto", {"stage_layout": "auto"}, weights),
                               ("down-cast", {"stage_dtype": torch.bfloat16},
                                master)):
            m = CheckpointManager(os.path.join(ckpt_root, name), keep=1, **kw)
            m.save(1, tree)
            ck[name] = m.restore(1, tree, device=dev)
        a = CheckpointManager(os.path.join(ckpt_root, "async"), keep=1)
        a.save(2, weights, blocking=False)
        ck["async"] = a.restore(2, weights, device=dev)
        staged = list(prefetch_staged(iter(batches), torch.bfloat16, depth=2,
                                      device=dev))
        return tiled, loaded, outs, sched, pool_out, ck, staged

    (tiled, loaded, kv_outs, kv_sched, (pages_loaded, pages_back, pool_stats),
     ck, staged), counts = drive("consumers", [agu.RELAYOUT, datapath.STREAMED,
                                              datapath.BLOCK], consumers)
    # the KV store and load against their plain versions
    store_d = KV._store_desc("bfloat16", 9, 1e-6)
    want_tiled = datapath.plain(kv.reshape(1, KV_SHAPE[1], -1),
                                store_d.plugins, L.MN, store_d.dst.layout)
    assert_close(tiled, want_tiled, tolerance(store_d.plugins, kv.dtype),
                 "consumers kv store (RMSNorm) vs plain")
    load_d = KV._load_desc(16, 128, 9)
    assert_bitwise(loaded, datapath.plain(tiled, load_d.plugins,
                                          load_d.src.layout, L.MN),
                   "consumers kv load (transpose) vs plain")
    for i, (shard, got) in enumerate(zip(shards, kv_outs)):
        assert_bitwise(got, KV.kv_load_transposed(KV.kv_prefill_store(shard)),
                       f"consumers kv round trip {i} vs serial")
    rep = kv_sched.report()
    log(f"[consumers] kv store within tolerance, load bitwise; 8 round trips "
        f"on host_device(2): makespan {rep.makespan * 1e6:.3f} us (model)")
    # the pool: round trips bitwise, stats equal to the CPU run's
    pages = paginate(pool_mat, 32)
    for i, (got, want) in enumerate(zip(pages_loaded, pages)):
        assert_bitwise(got, want, f"consumers pool load {i}")
    kept = [p for i, p in enumerate(pages) if i % 4 != 1]
    for i, (got, want) in enumerate(zip(pages_back, kept)):
        assert_bitwise(got, want, f"consumers pool page {i} after evict, "
                       f"restore and defrag")
    cpu_loaded, cpu_back, cpu_stats = pool_run(pool_mat.cpu(), "cpu")
    check(pool_stats == cpu_stats, f"consumers pool stats {pool_stats} != "
          f"the CPU run's {cpu_stats}")
    for got, want in zip(pages_back, cpu_back):
        assert_bitwise(got.cpu(), want, "consumers pool: card vs CPU run")
    log(f"[consumers] pool: {POOL_PAGES} pages bitwise through store, load, "
        f"evict, restore and defrag; stats {pool_stats} == the CPU run's")
    # the checkpoints: bitwise onto the card, and onto the CPU
    for name, tree in ck.items():
        src = master if name == "down-cast" else weights
        for k, w in src.items():
            want = w.to(torch.bfloat16).float() if name == "down-cast" else w
            check(tree[k].device.type == dev.type, f"consumers ckpt {name} "
                  f"{k} not on {dev}")
            assert_bitwise(tree[k], want, f"consumers ckpt {name} {k}")
    for name in ("plain", "auto"):
        back = CheckpointManager(os.path.join(ckpt_root, name)).restore(
            1, weights, device="cpu")
        for k, w in weights.items():
            assert_bitwise(back[k], w.cpu(), f"consumers ckpt {name} {k} "
                           f"restored on the CPU")
    log(f"[consumers] checkpoints (plain, auto layout, down-cast, async) "
        f"bitwise onto the card and onto the CPU")
    # input staging: bitwise equal to stage_batch, on the card
    # and to its plain version: floats cast to bf16, integer ids unchanged
    for i, (got, b) in enumerate(zip(staged, batches)):
        want = stage_batch(b, torch.bfloat16, device=dev)
        check(sorted(got) == sorted(b), f"consumers staging keys {sorted(got)}")
        for k in want:
            check(got[k].device.type == dev.type,
                  f"consumers staging {k} not on {dev}")
            assert_bitwise(got[k], want[k], f"consumers staging batch {i} {k}")
            plain = torch.from_numpy(np.ascontiguousarray(b[k])).to(dev)
            if plain.is_floating_point():
                plain = plain.to(torch.bfloat16)
            assert_bitwise(got[k], plain,
                           f"consumers staging batch {i} {k} vs plain")
    log(f"[consumers] 3 qwen2-vl batches staged to bf16 on the card, bitwise "
        f"stage_batch; launches {counts}")
    # times (GPU wall time of one call, the host included)
    cons = {
        "kv store (RMSNorm, 1x8192x1024 bf16)":
            wall_ms(lambda: KV.kv_prefill_store(kv), 5),
        "kv load (transpose)": wall_ms(lambda: KV.kv_load_transposed(tiled), 5),
        "8 kv round trips through the scheduler": wall_ms(
            lambda: KV.kv_roundtrips_overlapped(shards, scheduler=(
                DistributedScheduler(Topology.host_device(2)))), 3),
        f"pool: {POOL_PAGES} pages through every op": wall_ms(
            lambda: pool_run(pool_mat, dev), 3),
        "stage one qwen2-vl batch (235 MB f32 -> bf16)": wall_ms(
            lambda: stage_batch(batches[0], torch.bfloat16, device=dev), 3),
    }
    for k, path in (("checkpoint save, plain (201 MB bf16)", "plain"),
                    ("checkpoint save, auto layout", "auto")):
        kw = {"stage_layout": "auto"} if path == "auto" else {}
        m = CheckpointManager(os.path.join(ckpt_root, path + "-t"), keep=1,
                              **kw)
        cons[k] = wall_ms(lambda: m.save(1, weights), 3)
        cons[k.replace("save", "restore")] = wall_ms(
            lambda: m.restore(1, weights, device=dev), 3)
    for k, ms in cons.items():
        log(f"[consumers] {k}: {ms:.3f} ms (GPU wall time) on {card}")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    del kv, shards, tiled, loaded, kv_outs, pages_loaded, pages_back, ck
    del staged, weights, master, batches
    return cons


# -- phase 14: the serving path, full phi4-mini through ServingEngine ----------
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, SERVE_MAX_LEN = 4, 1024, 16, 2048
LAYER_TOKENS = 512
DECODE_LOGIT_TOL = 2e-3        # x max|logit|: tests/test_models.py:62


def device_busy_ms(prof):
    """Device time of the kernels a torch.profiler window recorded (one
    stream, so their sum is the busy time); 0 when it saw none."""
    total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        total += t
    return total / 1e3


def phase14(dev, gen, card, drive):
    """Phase 14: the serving path on the card.  Full-width phi4-mini (32
    layers) from the port's seeded initializer served by ``ServingEngine``;
    its tokens and final cache bitwise those of the planeless loop, kernel
    1 launched on the plane, decode logits against the forward's; one
    decoder layer in f32 against its CPU run; the seven non-MoE smoke archs
    against their CPU runs.  Returns the times."""
    import dataclasses
    from repro_torch import _pytree, configs
    from repro_torch.kernels import agu
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine

    cfg = configs.get_config("phi4_mini_3p8b")
    t_phase = time.perf_counter()

    def log14(msg):
        log(f"[serving {time.perf_counter() - t_phase:.1f} s] {msg}")

    t0 = time.perf_counter()
    params = lm.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    nparam = sum(t.numel() for t in _pytree.leaves(params))
    log14(f"phi4-mini {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}: {nparam} f32 parameters "
        f"({nparam * 4 / 1e9:.2f} GB) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = ServingEngine(cfg, params, max_len=SERVE_MAX_LEN)
    prompts = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=dev)
    batch = {"tokens": prompts}

    def serve():
        return eng.generate(batch, SERVE_STEPS)

    toks, counts = drive("serving", [agu.RELAYOUT], serve)
    cache = eng.last_cache
    log14(f"kernel 1 on the plane by path {agu.RELAYOUT.paths}; "
        f"launches {counts}")
    leaves = _pytree.leaves(cache)
    plane_bytes = 4 * sum(t.numel() * t.element_size() for t in leaves
                          if t.dim() >= 2 and t.is_floating_point())
    # 1. the plane is value-preserving: the tokens and the final cache are
    # bitwise those of the planeless loop (prefill, then greedy decode
    # steps, no movement), whose logits check 3 reads
    c = lm.init_cache(cfg, SERVE_BATCH, SERVE_MAX_LEN, device=dev)
    logits, c = lm.prefill(cfg, params, batch, c)
    dec, toks0 = [], []
    for i in range(SERVE_STEPS):
        dec.append(logits[:, -1])
        toks0.append(torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None])
        logits, c = lm.decode_step(cfg, params, toks0[-1], c)
    toks0 = torch.cat(toks0, 1)
    assert_bitwise(toks, toks0, "serving tokens, plane vs planeless")
    for a, b in zip(leaves, _pytree.leaves(c)):
        assert_bitwise(a, b, "serving final cache, plane vs planeless")
    check(int(cache["pos"]) == SERVE_PROMPT + SERVE_STEPS,
          f"serving: cache position {int(cache['pos'])}")
    log14(f"tokens and final cache bitwise the planeless loop's "
          f"({len(leaves)} leaves); first row {toks[0].tolist()}")
    del c, logits
    # 3. decode logits against the forward's at the same positions: in
    # f32, as the reference's own checks run it (tests/test_models.py:62,
    # tests/test_serving.py:26), within 2e-3 of max|logit|, greedy tokens
    # equal to the forward's argmax where the top-2 margin clears that.
    # The served bf16 run's deviation is logged beside it.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    c = lm.init_cache(cfg32, SERVE_BATCH, SERVE_MAX_LEN, torch.float32,
                      device=dev)
    logits, c = lm.prefill(cfg32, params, batch, c)
    dec32, toks32 = [], []
    for i in range(SERVE_STEPS):
        dec32.append(logits[:, -1])
        toks32.append(torch.argmax(logits[:, -1], -1)[:, None])
        logits, c = lm.decode_step(cfg32, params, toks32[-1], c)
    del c, logits
    dec32, toks32 = torch.stack(dec32, 1), torch.cat(toks32, 1)

    def forward_at(model_cfg, gen_toks):
        # the whole sequence (1040 tokens: the reference's chunking splits
        # it into two 520-token chunks; 1039 is prime and would make
        # 1-token ones)
        seq = torch.cat([prompts, gen_toks.to(prompts.dtype)], 1)
        full, _ = lm.forward(model_cfg, params, {"tokens": seq})
        return full[:, SERVE_PROMPT - 1:SERVE_PROMPT - 1 + SERVE_STEPS].float()

    fwd32 = forward_at(cfg32, toks32)
    scale = float(fwd32.abs().max())
    err = float((dec32 - fwd32).abs().max())
    check(err <= DECODE_LOGIT_TOL * scale,
          f"serving: f32 decode logits {err} off the forward's, over "
          f"{DECODE_LOGIT_TOL} x max|logit| {scale}")
    top2 = fwd32.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > DECODE_LOGIT_TOL * scale
    same = dec32.argmax(-1) == fwd32.argmax(-1)
    check(bool(same[clear].all()),
          "serving: greedy tokens differ from the forward's argmax where "
          "the margin exceeds the tolerance")
    del dec32, fwd32
    fwd = forward_at(cfg, toks)
    dec = torch.stack(dec, 1).float()
    bf_err = float((dec - fwd).abs().max())
    bf_scale = float(fwd.abs().max())
    log14(f"decode vs forward logits, f32: max abs err {err} "
          f"({err / scale:.2e} of max|logit| {scale}; tolerance "
          f"{DECODE_LOGIT_TOL}); argmax equal at all {int(clear.sum())} of "
          f"{clear.numel()} positions whose top-2 margin clears it; the "
          f"served bf16 run: max abs err {bf_err} ({bf_err / bf_scale:.4f} of "
          f"max|logit| {bf_scale}), {int((dec.argmax(-1) == fwd.argmax(-1)).sum())}"
          f" of {clear.numel()} argmax equal; f32 and bf16 greedy tokens "
          f"agree on {int((toks32 == toks).sum())} of {toks.numel()}")
    del dec, fwd
    # times: prefill, a decode step with and without the plane, the plane
    cache_p = lm.init_cache(cfg, SERVE_BATCH, SERVE_MAX_LEN, device=dev)
    prefill_ms = gpu_ms(lambda: lm.prefill(cfg, params, batch, cache_p),
                        reps=3, warmup=1)
    tok1 = toks[:, :1]
    step_ms = gpu_ms(lambda: lm.decode_step(cfg, params, tok1, cache),
                     reps=5, warmup=1)
    sched = eng._new_scheduler()
    plane = lambda c: eng._cache_through_plane(sched, c, "t")  # noqa: E731
    step_plane_ms = gpu_ms(
        lambda: plane(lm.decode_step(cfg, params, tok1, cache)[1]), reps=5,
        warmup=1)
    plane_ms = gpu_ms(lambda: plane(cache), reps=5, warmup=1)
    plane_bound = bound_ms(plane_bytes)

    def plane_library(c):
        """The plane's relayouts as one PyTorch call each: every cache leaf
        as its (rows, KV x hd) matrix to MNM16N128 and back."""
        outs = []
        for t in _pytree.leaves(c):
            if t.dim() >= 2 and t.is_floating_point():
                m = t.reshape(-1, t.shape[-2] * t.shape[-1])
                R, C = m.shape
                tiled = m.view(R // 16, 16, C // 128, 128).permute(
                    0, 2, 1, 3).contiguous()
                outs.append(tiled.permute(0, 2, 1, 3).contiguous().view(
                    t.shape))
        return outs
    for t, u in zip([t for t in leaves if t.dim() >= 2
                     and t.is_floating_point()], plane_library(cache)):
        assert_bitwise(u, t, "serving plane library yardstick")
    plane_lib_ms = gpu_ms(lambda: plane_library(cache), reps=5, warmup=1)
    from repro_torch.core import layouts as L

    def plane_plain(c):
        """The plane's relayouts by kernel 1's plain version."""
        outs = []
        for t in _pytree.leaves(c):
            if t.dim() >= 2 and t.is_floating_point():
                m = t.reshape(-1, t.shape[-2] * t.shape[-1])
                tiled = agu.relayout_plain(m, L.MN, L.MNM16N128, False)
                outs.append(agu.relayout_plain(tiled, L.MNM16N128, L.MN,
                                               False))
        return outs
    plane_plain_ms = gpu_ms(lambda: plane_plain(cache), reps=3, warmup=1)
    # the card's idle share over one generate call
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(batch, SERVE_STEPS)
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(prof)
    idle = f"{1 - busy / gen_ms:.1%}" if busy > 0 else "not measured"
    times = {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
             "decode_step_with_plane_ms": step_plane_ms,
             "plane_ms": plane_ms, "plane_bound_ms": plane_bound,
             "plane_library_ms": plane_lib_ms,
             "plane_plain_ms": plane_plain_ms,
             "plane_bytes": plane_bytes, "generate_wall_ms": gen_ms,
             "generate_device_ms": busy}
    log14(f"B{SERVE_BATCH} x {SERVE_PROMPT} tokens, {SERVE_STEPS} "
        f"steps: prefill {prefill_ms:.3f} ms; a decode step "
        f"{step_ms:.3f} ms without the plane, {step_plane_ms:.3f} ms with "
        f"it; the plane alone {plane_ms:.3f} ms of device time for "
        f"{plane_bytes / 2 ** 30:.2f} GiB (bound {plane_bound:.3f} ms, "
        f"{plane_bound / plane_ms:.1%} of it; the same relayouts as "
        f"permute().contiguous() {plane_lib_ms:.3f} ms, by kernel 1's plain "
        f"version {plane_plain_ms:.3f} ms); generate "
        f"{gen_ms:.1f} ms wall, "
        f"{busy:.1f} ms of device time, the card idle {idle} (GPU times: "
        f"CUDA events; device busy: torch.profiler) on {card}")
    del cache, cache_p, eng, toks, toks0, leaves
    # 4. one decoder layer at full width in f32, card vs CPU (one thread)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    layer = lm.period_slice(params["blocks"], 0)[0]
    x = torch.randn(1, LAYER_TOKENS, cfg.d_model, generator=gen, device=dev)
    pos = torch.arange(LAYER_TOKENS, device=dev)[None]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, _, _ = lm._apply_slot(cfg32, cfg.period[0], layer, x, pos)
        got = got.cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    layer_cpu = _pytree.tree_map_with_path(lambda p, t: t.cpu(), layer)
    want, _, _ = on_cpu_one_thread(lm._apply_slot, cfg32, cfg.period[0],
                                   layer_cpu, x.cpu(), pos.cpu())
    lscale = float(want.abs().max())
    lerr = max_abs_err(got, want)
    check(lerr <= 1e-5 * lscale,
          f"serving: f32 layer on the card {lerr} off its CPU run (max|out| "
          f"{lscale})")
    log14(f"one phi4-mini layer, 1 x {LAYER_TOKENS} tokens f32 (TF32 "
        f"off): max abs err {lerr} against its CPU run ({lerr / lscale:.2e} "
        f"of max|out|, tolerance 1e-5)")
    del layer, layer_cpu, got, want, x
    torch.cuda.empty_cache()
    # 5. the seven non-MoE smoke archs: the card's tokens are the CPU's
    smoke = {}
    for arch in configs.ARCHS:
        scfg = dataclasses.replace(configs.smoke_config(arch),
                                   dtype=torch.float32)
        if any(s.moe for s in scfg.period + scfg.tail):
            continue
        sp = lm.init_params(scfg, SEED, device="cpu")
        g = torch.Generator().manual_seed(SEED)
        b = {}
        if scfg.family == "vlm":
            b["embeds"] = torch.randn(2, 8, scfg.d_model, generator=g)
            p3 = torch.arange(8)[None].expand(2, 8)
            b["positions"] = torch.stack([p3, p3, p3])
        else:
            b["tokens"] = torch.randint(0, scfg.vocab, (2, 8), generator=g)
        if scfg.family == "audio":
            b["audio_embeds"] = torch.randn(2, scfg.encoder_seq,
                                            scfg.d_model, generator=g)
        want = on_cpu_one_thread(lambda: ServingEngine(
            scfg, sp, max_len=32, cache_dtype=torch.float32,
            device="cpu").generate(dict(b), 6))
        sp_dev = _pytree.tree_map_with_path(lambda p, t: t.to(dev), sp)
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            got = ServingEngine(scfg, sp_dev, max_len=32,
                                cache_dtype=torch.float32).generate(
                                    dict(b), 6).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        assert_bitwise(got, want, f"serving {arch} smoke tokens, card vs CPU")
        smoke[arch] = got[0].tolist()
    log14(f"{len(smoke)} smoke archs (f32): the card's tokens are "
        f"the CPU's: {smoke}")
    return times, cfg, params


# -- phase 15: continuous batching at full phi4-mini width ----------------------
CB_PAGE_ROWS, CB_MAX_BATCH, CB_MAX_LEN = 32, 4, 64
CB_ALIGNED = dict(n=4, prompt=32, max_new=8)      # (a): arriving together
CB_STREAM = dict(n=8, prompts=(16, 32, 48), max_new=6)   # (b): under load
CB_MARGIN = 2e-3               # x max|logit|: phase 14's tie rule


def greedy_with_logits(cfg, params, tokens, n, max_len, cache_dtype):
    """The planeless loop (prefill, then greedy decode steps), which
    ``ServingEngine.generate`` equals bitwise: (tokens (B, n), the logits
    each token was picked from (B, n, V) in f32)."""
    from repro_torch.models import lm
    c = lm.init_cache(cfg, tokens.shape[0], max_len, cache_dtype,
                      device=tokens.device)
    logits, c = lm.prefill(cfg, params, {"tokens": tokens}, c)
    toks, lgs = [], []
    for i in range(n):
        lgs.append(logits[:, -1].float())
        toks.append(torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None])
        if i + 1 < n:
            logits, c = lm.decode_step(cfg, params, toks[-1], c)
    return torch.cat(toks, 1), torch.stack(lgs, 1)


def phase15(dev, gen, card, drive, cfg, params):
    """Phase 15: continuous batching on the card at phi4-mini width (the
    phase-14 parameters).  (a) four 32-token prompts arriving together,
    bitwise ``ServingEngine.generate``; (b) eight requests of 16, 32 and 48
    prompt tokens at a fixed gap through ``ContinuousBatchingEngine`` and
    ``StaticBatchEngine`` with a pool of 75 % of the stream's peak pages:
    every request completes, the continuous engine preempts, evicted pages
    come back bitwise, tokens equal each request's own fixed-batch run where the
    top-2 margin clears the tie rule.  Kernels 1 and 3 must launch (kernel
    3 on the continuous engine's preemptions).  Returns the times."""
    from repro_torch.kernels import agu, datapath
    from repro_torch.serving import (ContinuousBatchingEngine, PagedKVPool,
                                     ServingEngine, StaticBatchEngine,
                                     trace_stream, uniform_stream)
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()

    def log15(msg):
        log(f"[continuous {time.perf_counter() - t_phase:.1f} s] {msg}")

    class CheckedPool(PagedKVPool):
        """The engine's pool, holding every restored page to the at-rest
        buffer it had before its eviction, bitwise."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.before, self.restoring, self.checked = {}, [], 0

        def evict(self, pid, **kw):
            self.before[pid] = self._pages[pid].data
            return super().evict(pid, **kw)

        def restore(self, pid, **kw):
            self.restoring.append(pid)
            return super().restore(pid, **kw)

        def commit(self):
            landed = super().commit()
            for pid in self.restoring:
                assert_bitwise(self._pages[pid].data, self.before.pop(pid),
                               f"continuous: page {pid} after its restore")
                self.checked += 1
            self.restoring.clear()
            return landed

    bf16 = torch.bfloat16
    kw = dict(max_len=CB_MAX_LEN, max_batch=CB_MAX_BATCH, cache_dtype=bf16,
              page_rows=CB_PAGE_ROWS)
    # (a) prompts arriving together: the fixed-batch engine's tokens
    a = CB_ALIGNED
    reqs = uniform_stream(cfg, a["n"], 0.0, prompt_len=a["prompt"],
                          max_new=a["max_new"], seed=SEED)
    probe = ContinuousBatchingEngine(cfg, params, **kw)
    pages_a = sum(probe._footprint(r.total_len) for r in reqs)
    eng_a = ContinuousBatchingEngine(cfg, params, capacity_pages=pages_a,
                                     **kw)
    t0 = time.perf_counter()
    rep_a, counts = drive("continuous (a)", [agu.RELAYOUT],
                          lambda: eng_a.serve(reqs))
    wall_a = (time.perf_counter() - t0) * 1e3
    toks = torch.from_numpy(np.stack([r.tokens for r in reqs])).to(dev)
    fixed = ServingEngine(cfg, params, max_len=CB_MAX_LEN,
                          cache_dtype=bf16).generate({"tokens": toks},
                                                     a["max_new"]).cpu()
    check(rep_a.n_requests == a["n"] and rep_a.preemptions == 0,
          f"continuous (a): {rep_a.summary()}")
    for r in reqs:
        assert_bitwise(torch.from_numpy(rep_a.tokens[r.rid]), fixed[r.rid],
                       f"continuous (a) request {r.rid} vs ServingEngine")
    step_s = rep_a.elapsed_s / rep_a.steps
    log15(f"(a) {a['n']} x {a['prompt']}-token prompts arriving together, "
          f"{a['max_new']} tokens each: tokens bitwise ServingEngine."
          f"generate's; {rep_a.steps} steps, {wall_a / rep_a.steps:.1f} ms "
          f"wall a step, simulated makespan {rep_a.elapsed_s * 1e6:.3f} us "
          f"({step_s * 1e6:.3f} us a step); pool {rep_a.pool_stats}; "
          f"launches {counts}")
    # (b) a stream under load: a fixed gap of half a simulated step, the
    # three prompt lengths in turn (uniform_stream draws one length), a
    # pool of 75 % of the pages the four largest requests hold at their end
    b = CB_STREAM
    trace = [(i * step_s / 2, b["prompts"][i % len(b["prompts"])],
              b["max_new"]) for i in range(b["n"])]
    stream = trace_stream(cfg, trace, seed=SEED)
    peak = sum(sorted(probe._footprint(r.total_len - 1)
                      for r in stream)[-CB_MAX_BATCH:])
    cap = int(0.75 * peak)
    times = {"aligned_wall_ms_per_step": wall_a / rep_a.steps,
             "aligned_makespan_s": rep_a.elapsed_s}
    reports = {}
    # the continuous engine must preempt (kernel 3 runs the evict / restore
    # codec); the static gang admits only when empty, so at this gap its
    # gangs may fit the pool, and its preemptions are logged
    for name, cls, kernels in (
            ("continuous", ContinuousBatchingEngine,
             [agu.RELAYOUT, datapath.BLOCK]),
            ("static", StaticBatchEngine, [agu.RELAYOUT])):
        pool = CheckedPool(cap, CB_PAGE_ROWS)
        eng = cls(cfg, params, pool=pool, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rep, counts = drive(f"{name} (b)", kernels,
                                lambda: eng.serve(stream))
            wall = (time.perf_counter() - t0) * 1e3
        busy = device_busy_ms(prof)
        idle = f"{1 - busy / wall:.1%}" if busy > 0 else "not measured"
        st = rep.pool_stats
        check(rep.n_requests == b["n"],
              f"{name} (b): {rep.n_requests} of {b['n']} requests completed")
        check(rep.preemptions >= 1 or name == "static", f"{name} (b): no "
              f"preemption with a pool of {cap} pages: {rep.summary()}")
        check(st["restores"] == st["evictions"] and pool.checked
              == st["restores"], f"{name} (b): restores {st['restores']}, "
              f"evictions {st['evictions']}, checked {pool.checked}")
        moves = {k: st[k] / rep.steps for k in ("stores", "loads",
                                                  "evictions", "restores",
                                                  "defrag_moves")}
        log15(f"(b) {name}: {rep.summary()}; {rep.steps} steps, "
              f"{wall / rep.steps:.1f} ms wall a step ({wall:.0f} ms), "
              f"simulated makespan {rep.elapsed_s * 1e6:.3f} us; page "
              f"movements a step {moves}; every restored page bitwise its "
              f"evicted buffer ({pool.checked}); pool of {cap} pages "
              f"(peak bound {peak}); the card idle {idle} over serve "
              f"({busy:.1f} ms of device time); launches {counts} on {card}")
        times[name] = {"wall_ms_per_step": wall / rep.steps, "wall_ms": wall,
                       "steps": rep.steps, "makespan_s": rep.elapsed_s,
                       "preemptions": rep.preemptions, "pool": st,
                       "moves_per_step": moves, "device_ms": busy}
        reports[name] = rep
    # each request against its own fixed-batch run (the planeless loop,
    # which ServingEngine equals bitwise), up to the first position where
    # the fixed run's top-2 margin is within the tie rule
    excluded, compared = 0, 0
    for r in stream:
        ft, fl = greedy_with_logits(cfg, params, torch.from_numpy(
            r.tokens[None].astype(np.int32)).to(dev), r.max_new,
            CB_MAX_LEN, bf16)
        ft, fl = ft[0].cpu(), fl[0].cpu()
        top2 = fl.topk(2, -1).values
        tie = (top2[:, 0] - top2[:, 1]) <= CB_MARGIN * float(fl.abs().max())
        for name, rep in reports.items():
            got = torch.from_numpy(rep.tokens[r.rid])
            for i in range(r.max_new):
                if tie[i]:
                    excluded += 1
                    if got[i] != ft[i]:
                        break            # a tie went the other way: stop
                    continue
                check(got[i] == ft[i], f"continuous (b) {name} request "
                      f"{r.rid} token {i}: {int(got[i])} vs the fixed "
                      f"batch's {int(ft[i])}, margin clear")
                compared += 1
    log15(f"(b) tokens equal each request's fixed-batch run at {compared} "
          f"positions; {excluded} positions within the tie rule "
          f"({CB_MARGIN} x max|logit|) excluded; continuous makespan "
          f"{reports['continuous'].elapsed_s * 1e6:.3f} us vs static "
          f"{reports['static'].elapsed_s * 1e6:.3f} us (simulated)")
    times.update(tie_excluded=excluded, compared=compared,
                 phase_s=time.perf_counter() - t_phase)
    return times


# -- phase 16: an MoE model served at full width --------------------------------
MOE_PERIODS = 8                # of qwen3-moe-30b-a3b's 48 (80 GB card)
MOE_BATCH, MOE_PROMPT, MOE_STEPS = 4, 256, 8
MOE_MAX_LEN = MOE_PROMPT + MOE_STEPS + 8


def phase16(dev, gen, card, drive):
    """Phase 16: qwen3-moe-30b-a3b at full width (d_model 2048, 128 experts
    top-8), cut to 8 of its 48 layers, served by ``ServingEngine`` (B 4 x
    256 prompt tokens, 8 greedy steps, the bf16 cache through the plane):
    tokens and cache bitwise the planeless loop's; one MoE decoder layer in
    f32 against its one-thread CPU run (router probabilities, expert ids,
    output); the three MoE smoke configs' tokens against their CPU runs.
    Returns the times."""
    import dataclasses
    from repro_torch import _pytree, configs
    from repro_torch.kernels import agu
    from repro_torch.layers import moe as MOE
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()

    def log16(msg):
        log(f"[moe serving {time.perf_counter() - t_phase:.1f} s] {msg}")

    full = configs.get_config("qwen3_moe_30b_a3b")
    cfg = dataclasses.replace(full, n_periods=MOE_PERIODS)
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    nparam = sum(t.numel() for t in _pytree.leaves(params))
    log16(f"qwen3-moe {cfg.n_layers} of {full.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, vocab "
          f"{cfg.vocab}: {nparam} f32 parameters ({nparam * 4 / 1e9:.2f} GB) "
          f"made on the card in {time.perf_counter() - t_phase:.1f} s")
    eng = ServingEngine(cfg, params, max_len=MOE_MAX_LEN)
    prompts = torch.randint(0, cfg.vocab, (MOE_BATCH, MOE_PROMPT),
                            generator=gen, device=dev)
    batch = {"tokens": prompts}
    toks, counts = drive("moe serving", [agu.RELAYOUT],
                         lambda: eng.generate(batch, MOE_STEPS))
    cache = eng.last_cache
    # the plane is value-preserving: tokens and cache bitwise the loop's
    c = lm.init_cache(cfg, MOE_BATCH, MOE_MAX_LEN, device=dev)
    logits, c = lm.prefill(cfg, params, batch, c)
    toks0 = []
    for _ in range(MOE_STEPS):
        toks0.append(torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None])
        logits, c = lm.decode_step(cfg, params, toks0[-1], c)
    assert_bitwise(toks, torch.cat(toks0, 1), "moe serving tokens, plane vs "
                   "planeless")
    leaves = _pytree.leaves(cache)
    for x_, y_ in zip(leaves, _pytree.leaves(c)):
        assert_bitwise(x_, y_, "moe serving final cache, plane vs planeless")
    log16(f"B{MOE_BATCH} x {MOE_PROMPT} tokens, {MOE_STEPS} steps: tokens and "
          f"final cache bitwise the planeless loop's; first row "
          f"{toks[0].tolist()}; launches {counts}")
    del c, logits
    plane_bytes = 4 * sum(t.numel() * t.element_size() for t in leaves
                          if t.dim() >= 2 and t.is_floating_point())
    cache_p = lm.init_cache(cfg, MOE_BATCH, MOE_MAX_LEN, device=dev)
    prefill_ms = gpu_ms(lambda: lm.prefill(cfg, params, batch, cache_p),
                        reps=3, warmup=1)
    tok1 = toks[:, :1]
    step_ms = gpu_ms(lambda: lm.decode_step(cfg, params, tok1, cache),
                     reps=5, warmup=1)
    sched = eng._new_scheduler()
    plane_ms = gpu_ms(lambda: eng._cache_through_plane(sched, cache, "t"),
                      reps=5, warmup=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(batch, MOE_STEPS)
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy_ms(prof)
    idle = f"{1 - busy / gen_ms:.1%}" if busy > 0 else "not measured"
    times = {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
             "plane_ms": plane_ms, "plane_bound_ms": bound_ms(plane_bytes),
             "plane_bytes": plane_bytes, "generate_wall_ms": gen_ms,
             "generate_device_ms": busy,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log16(f"prefill {prefill_ms:.3f} ms; a decode step {step_ms:.3f} ms; the "
          f"plane {plane_ms:.4f} ms of device time for {plane_bytes} bytes "
          f"(bound {times['plane_bound_ms']:.4f} ms); generate {gen_ms:.1f} "
          f"ms wall, {busy:.1f} ms of device time, the card idle {idle}; "
          f"peak {times['peak_gb']:.1f} GB on {card}")
    del cache, cache_p, eng, toks, toks0, leaves
    # one MoE decoder layer at full width in f32 (TF32 off), card vs CPU
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    spec = cfg.period[0]
    layer = lm.period_slice(params["blocks"], 0)[0]
    x = torch.randn(1, LAYER_TOKENS, cfg.d_model, generator=gen, device=dev)
    pos = torch.arange(LAYER_TOKENS, device=dev)[None]

    def run_layer(p, xx, pp):
        """The layer's output, the MoE sublayer's input and residual, and
        its routing, by spies on lm._ffn and moe._route."""
        rec = {}
        ffn, route = lm._ffn, MOE._route

        def spy_ffn(c_, s_, p_, x_, mesh):
            rec["x_mid"] = x_
            return ffn(c_, s_, p_, x_, mesh)

        def spy_route(c_, w, tokens):
            out = route(c_, w, tokens)
            rec["tokens"], rec["route"] = tokens, out
            return out
        lm._ffn, MOE._route = spy_ffn, spy_route
        try:
            out, _, _ = lm._apply_slot(cfg32, spec, p, xx, pp)
        finally:
            lm._ffn, MOE._route = ffn, route
        return out, rec

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, rec_g = run_layer(layer, x, pos)
        probs_g = torch.softmax(rec_g["tokens"] @ layer["ffn"]["router"], -1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    layer_cpu = _pytree.tree_map_with_path(lambda p, t: t.cpu(), layer)
    want, rec_c = on_cpu_one_thread(run_layer, layer_cpu, x.cpu(), pos.cpu())
    probs_c = on_cpu_one_thread(lambda: torch.softmax(
        rec_c["tokens"] @ layer_cpu["ffn"]["router"], -1))
    perr = max_abs_err(probs_g.cpu(), probs_c)
    check(perr <= 1e-5, f"moe layer: router probabilities {perr} off the "
          f"CPU's")
    eidx_g, eidx_c = rec_g["route"][1].cpu(), rec_c["route"][1]
    flips = (eidx_g != eidx_c).any(-1).nonzero().flatten().tolist()
    if flips:
        # a near-tie (the k-th and (k+1)-th probabilities within 1e-5) may
        # pick another expert on the card: the CPU runs the dispatch onwards
        # from the card's routing instead
        top = probs_c.topk(cfg.top_k + 1, -1).values
        gap = (top[:, -2] - top[:, -1])[flips]
        check(bool((gap < 1e-5).all()), f"moe layer: tokens {flips} routed "
              f"apart with k-th gaps {gap.tolist()}")
        gates_g = rec_g["route"][0].cpu()

        def cpu_from_card_routing():
            t = rec_c["tokens"]
            T, d = t.shape
            buf, slot, keep, order, _ = MOE._dispatch(
                cfg32, t, eidx_g, gates_g, MOE._capacity(cfg32, T))
            out = MOE._expert_ffn(cfg32, layer_cpu["ffn"], buf)
            y = MOE._combine(cfg32, out, slot, keep, order, gates_g, T, d)
            return rec_c["x_mid"] + y.reshape(rec_c["x_mid"].shape)
        want = on_cpu_one_thread(cpu_from_card_routing)
        log16(f"moe layer: tokens {flips} took other experts on the card "
              f"(k-th gaps {gap.tolist()}, under 1e-5); the CPU reference "
              f"runs the dispatch from the card's routing")
    lscale = float(want.abs().max())
    lerr = max_abs_err(got.cpu(), want)
    check(lerr <= 1e-5 * lscale, f"moe layer: f32 layer on the card {lerr} "
          f"off its CPU run (max|out| {lscale})")
    log16(f"one qwen3-moe layer, 1 x {LAYER_TOKENS} tokens f32 (TF32 off): "
          f"router probabilities within {perr} of the CPU's, expert ids "
          f"equal at {LAYER_TOKENS - len(flips)} of {LAYER_TOKENS} tokens, "
          f"output max abs err {lerr} ({lerr / lscale:.2e} of max|out|, "
          f"tolerance 1e-5)")
    times.update(layer_err=lerr / lscale, router_err=perr, flips=len(flips))
    del params, layer, layer_cpu, got, want, x, rec_g, rec_c
    torch.cuda.empty_cache()
    # the three MoE smoke configs: the card's tokens are the CPU's
    smoke = {}
    for arch in configs.ARCHS:
        scfg = dataclasses.replace(configs.smoke_config(arch),
                                   dtype=torch.float32)
        if not any(s.moe for s in scfg.period + scfg.tail):
            continue
        sp = lm.init_params(scfg, SEED, device="cpu")
        b = {"tokens": torch.randint(0, scfg.vocab, (2, 8),
                                     generator=torch.Generator().manual_seed(
                                         SEED))}
        want = on_cpu_one_thread(lambda: ServingEngine(
            scfg, sp, max_len=32, cache_dtype=torch.float32,
            device="cpu").generate(dict(b), 6))
        sp_dev = _pytree.tree_map_with_path(lambda p, t: t.to(dev), sp)
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            got = ServingEngine(scfg, sp_dev, max_len=32,
                                cache_dtype=torch.float32).generate(
                                    dict(b), 6).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        assert_bitwise(got, want, f"moe serving {arch} smoke tokens, card vs "
                       f"CPU")
        smoke[arch] = got[0].tolist()
    log16(f"{len(smoke)} MoE smoke archs (f32): the card's tokens are the "
          f"CPU's: {smoke}")
    times["phase_s"] = time.perf_counter() - t_phase
    return times


# -- phase 17: MoE expert-parallel dispatch on 4 ranks --------------------------
EP_X = (2, 512, 2048)          # (B, S, d_model) of qwen3-moe, f32


def phase17_rank(mesh, card):
    """One rank of phase 17: one qwen3-moe layer's MoE at full width (this
    rank's 32 of 128 experts; every rank draws the whole layer from one
    seed and reads its shard), x (2, 512, 2048) f32 replicated: the EP path
    against the local path, the int8 wire, the scheduled chunked dispatch at
    capacity factor 1.0 against the unscheduled one, and the ring all-gather
    against a gather of the shards.  The path moves its buffers with
    empty-chain collectives and the int8 codec's composition (no side of it
    fuses, as in the reference), so it launches no datapath kernel: the
    launches on the int8 wire are logged, the side-fusion reasons held."""
    import dataclasses
    from repro_torch import configs
    from repro_torch import sharding as S
    from repro_torch.core import plugin_compiler
    from repro_torch.kernels import _build
    from repro_torch.layers import moe as MOE
    from repro_torch.layers._init import Init
    from repro_torch.runtime import DistributedScheduler, Topology

    torch.set_num_threads(2)             # four ranks share the host's cores
    dev, n, r = mesh.device, mesh.world_size, S.axis_index("model")
    tag = f"[moe ep rank {r}]"
    cfg = configs.get_config("qwen3_moe_30b_a3b")
    # capacity factor 8: no token drops on either path, as the reference's
    # EP test sets it (each rank routes its own sequence slice)
    cfg = dataclasses.replace(cfg, dtype=torch.float32,
                              capacity_factor=8.0).with_axes(
        S.Axes(batch=(), model="model", model_size=n, batch_size=1))
    local = cfg.with_axes(S.CPU_AXES)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = MOE.init_moe(Init(gen, dev), cfg)
    x = torch.randn(EP_X, generator=gen, device=dev)
    y_local, _ = MOE.moe_apply(local, p, x)
    scale = float(y_local.abs().max())
    out = {}
    y_ep, _ = MOE.moe_apply(cfg, p, x, mesh=mesh)
    out["ep_rel"] = float((y_ep - y_local).abs().max()) / scale
    check(out["ep_rel"] < 5e-4, f"{tag} EP vs local {out['ep_rel']}")
    int8 = dataclasses.replace(cfg, moe_wire_int8=True)
    torch.cuda.synchronize()
    _build.reset_launches()
    plugin_compiler.clear_stats()
    y_q, _ = MOE.moe_apply(int8, p, x, mesh=mesh)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in _build.KERNELS}
    # the int8 wire's Quantize / Dequantize have no emit form, so neither
    # side fuses into a datapath kernel (the reference's side-fusion policy,
    # its cfg_stats reasons): the codec runs as the plugins' composition
    wire = plugin_compiler.cfg_stats()
    check(wire["fused"] == 0 and set(wire["reasons"]) == {
        "no-emit:quantize_int8", "no-emit:dequantize_int8"},
          f"{tag} the int8 wire's sides: {wire}")
    out["int8_rel"] = float((y_q - y_local).abs().max()) / scale
    check(out["int8_rel"] < 0.05, f"{tag} int8 wire vs local "
          f"{out['int8_rel']}")
    tight = dataclasses.replace(cfg, capacity_factor=1.0)
    y_t, _ = MOE.moe_apply(tight, p, x, mesh=mesh)
    sched = DistributedScheduler(Topology.parallel(2, prefix="a2a"),
                                 name="moe")
    y_ts, _ = MOE.moe_apply(tight, p, x, mesh=mesh, scheduler=sched)
    torch.testing.assert_close(y_ts, y_t, rtol=1e-5, atol=1e-6)
    out["sched_err"] = float((y_ts - y_t).abs().max())
    shards = torch.randn((n,) + (EP_X[0], EP_X[1] // n, EP_X[2]),
                         generator=gen, device=dev)
    ring = MOE._ring_all_gather(shards[r], "model", n)
    assert_bitwise(ring, torch.cat(list(shards), 1),
                   f"{tag} ring all-gather vs the shards")
    times = {
        "ep_ms": wall_ms_synced(lambda: MOE.moe_apply(cfg, p, x, mesh=mesh)),
        "int8_ms": wall_ms_synced(lambda: MOE.moe_apply(int8, p, x,
                                                        mesh=mesh)),
        "sched_ms": wall_ms_synced(lambda: MOE.moe_apply(
            tight, p, x, mesh=mesh, scheduler=DistributedScheduler(
                Topology.parallel(2, prefix="a2a"), name="moe"))),
        "local_ms": wall_ms_synced(lambda: MOE.moe_apply(local, p, x))}
    log(f"{tag} EP vs local {out['ep_rel']:.2e}, int8 wire {out['int8_rel']:.4f}"
        f" (bounds 5e-4, 0.05), scheduled vs unscheduled at capacity 1.0 max "
        f"abs {out['sched_err']}, ring all-gather bitwise; launches on the "
        f"int8 wire {counts}, its sides {wire}; wall ms a call {times} on "
        f"{card}")
    return {"out": out, "counts": counts, "wire_sides": wire, "times": times,
            "backend": mesh.backend_note}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import layouts as L
    from repro_torch.core import plugins as P
    from repro_torch.core import plugin_compiler
    from repro_torch.core import xdma
    from repro_torch.core.descriptor import Endpoint, describe
    from repro_torch.kernels import _build, agu, datapath, ops
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_rmsnorm_relayout as FN
    from repro_torch.kernels import quant as FQ

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    log(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(card)

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f} s: {[p.name for p in libs]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "build_log.txt"), "w") as f:
        for src, text in sorted(_build.BUILD_LOG.items()):
            f.write(f"== {src}\n{text}\n")
    for src, text in sorted(_build.BUILD_LOG.items()):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", text))
        log(f"[ptxas] {src}: at most {max(regs, default=0)} registers a "
            f"thread, {spills} bytes of spill traffic over its kernels")
    # kernel 6 instance by instance: "flash_mma_kernel<__nv_bfloat16, 128,
    # true>" (true: the head dim is the instance width); every tensor-core
    # instance (2 dtypes x 4 widths x full or not) must be found and must
    # not spill
    mma_spills = {}
    for mangled, regs, _, spill in ptxas_entries(
            _build.BUILD_LOG.get("flash_attention.cu", "")):
        name = re.search(r"\d(flash_mma_kernel|flash_kernel|"
                         r"flash_chunked_kernel)I"
                         r"(6__half|13__nv_bfloat16|f)Li(\d+)E(Lb([01])E)?",
                         mangled)
        if name:
            dtype = {"f": "float"}.get(name.group(2),
                                       name.group(2).lstrip("0123456789"))
            full = ("" if name.group(5) is None
                    else ", " + ("true" if name.group(5) == "1" else "false"))
            inst = f"{name.group(1)}<{dtype}, {name.group(3)}{full}>"
            log(f"[ptxas] {inst}: {regs} registers, {spill} bytes of spill "
                f"traffic")
            if name.group(1) == "flash_mma_kernel":
                mma_spills[inst] = spill
    want_inst = {f"flash_mma_kernel<{t}, {hd}, {full}>"
                 for t in ("__half", "__nv_bfloat16")
                 for hd in (16, 32, 64, 128) for full in ("true", "false")}
    check(set(mma_spills) == want_inst,
          f"kernel6: the build log of flash_attention.cu names tensor-core "
          f"instances {sorted(mma_spills)}, not {sorted(want_inst)} (a "
          f"library built without its log: remove build/kernels)")
    check(not any(mma_spills.values()),
          f"kernel6: tensor-core instances spill: {mma_spills}")
    # kernel 2 instance by instance: 9 dtype pairs on the rows path (none may
    # spill), 9 x 2 (staged, re-read) on the generic
    rows_inst = 0
    k2 = ptxas_entries(_build.BUILD_LOG.get("streamed_datapath.cu", ""))
    for (mangled, regs, stack, spill), name in zip(
            k2, demangled([e[0] for e in k2])):
        short = re.search(r"streamed_\w+_kernel(<[^>]*>)?", name).group(0)
        log(f"[ptxas] {short}: {regs} registers, {stack} bytes of stack, "
            f"{spill} bytes of spill traffic")
        if "streamed_rows_kernel" in mangled:
            rows_inst += 1
            check(spill == 0, f"kernel2: rows instance {short} spills")
    check(rows_inst == 9,
          f"kernel2: the build log of streamed_datapath.cu names {rows_inst} "
          f"rows-path instances, not 9 (a library built without its log: "
          f"remove build/kernels)")

    rows = {}          # kernel name -> JSON row
    pair_times = []

    def log_case(kernel, r):
        log(f"[{kernel}] {r['pair']} {r['dtype']}: {r['ms']:.4f} ms "
            f"(plain {r['plain_ms']:.4f}, bound {r['bound_ms']:.4f}, "
            f"{r['bound_ms'] / r['ms']:.1%} of the bound) on {card}")

    def drive(phase, kernels, body):
        """Run `body` as a main-path phase: counts at 0 before, read after."""
        _build.reset_launches()
        out = body()
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in _build.KERNELS}
        for k in kernels:
            check(counts[k.name] > 0,
                  f"{phase}: kernel {k.name} was not launched on the path")
        log(f"[{phase}] launches {counts}")
        return out, counts

    # -- phase 2: kernel 1, the AGU relayout (Fig. 4 at 4096^2 f32) ---------
    # (src, dst, transpose, path): "direct" where both layouts are innermost
    # along the same logical axis, "staged" through shared memory otherwise
    paths = [("MN", "MNM8N128", False, "direct"),
             ("MN", "MNM16N128", False, "direct"),
             ("MN", "MNM32N128", False, "direct"),
             ("MNM8N128", "MN", False, "direct"),
             ("MNM16N128", "MN", False, "direct"),
             ("MNM32N128", "MN", False, "direct"),
             ("MNM8N128", "MNM8N128", True, "staged"),
             ("MNM16N128", "MNM16N128", True, "staged"),
             ("MNM32N128", "MNM32N128", True, "staged"),
             ("MN", "MN", True, "staged"),
             ("MNM8N128", "MNM16N128", False, "direct"),
             ("MN", "NM", False, "staged"), ("NM", "MNM8N128", False, "staged"),
             ("MN", "MNP64", False, "direct"),
             ("MNP64", "MNM16N128", False, "direct"),
             ("NMM8N128", "MN", False, "direct")]
    pairs = [p[:3] for p in paths]
    x32 = torch.randn(4096, 4096, generator=gen, device=dev)
    xb = torch.randn(8192, 3072, generator=gen, device=dev).to(torch.bfloat16)
    cases = [(s, d, t, x32) for s, d, t in pairs] + \
        [("MN", "MNM16N128", False, xb)]
    inputs = []
    for s, d, t, x in cases:
        src, dst = L.by_name(s), L.by_name(d)
        desc = describe(s, d, *([P.Transpose()] if t else []),
                        backend="pallas")
        inputs.append((src, dst, t, src.from_logical(x), desc))
    agu.clear_agu_stats()

    def k1_path():
        return [xdma.transfer(xin, desc) for _, _, _, xin, desc in inputs]

    outs, counts = drive("kernel1", [agu.RELAYOUT], k1_path)
    stats = agu.agu_stats()
    check(stats["fallback"] == 0, f"kernel1: fallbacks {stats['reasons']}")
    check(counts["agu_relayout"] == len(inputs),
          f"kernel1: {counts['agu_relayout']} launches for {len(inputs)} calls")
    want_paths = {}
    for p in [p[3] for p in paths] + ["direct"]:       # + the bf16 store
        want_paths[p] = want_paths.get(p, 0) + 1
    check(agu.RELAYOUT.paths == want_paths,
          f"kernel1: paths {agu.RELAYOUT.paths}, expected {want_paths}")
    log(f"[kernel1] launches by path {agu.RELAYOUT.paths}")
    k1_err = 0.0
    for (src, dst, t, xin, desc), got in zip(inputs, outs):
        want = agu.relayout_plain(xin, src, dst, t)
        assert_bitwise(got, want, f"kernel1 {desc.summary()}")
        k1_err = max(k1_err, max_abs_err(got, want))
    small = torch.randn(128, 256, generator=gen, device=dev)
    for s, d, t in pairs:
        src, dst = L.by_name(s), L.by_name(d)
        xin = src.from_logical(small)
        assert_bitwise(agu.relayout_kernel(xin, src, dst, t).cpu(),
                       agu.relayout_plain(xin.cpu(), src, dst, t),
                       f"kernel1 small {s}->{d} vs CPU")
    log(f"[kernel1] {len(inputs)} relayouts bitwise equal to the plain "
        f"version; agu_stats {stats}")
    for (src, dst, t, xin, desc), got in zip(inputs, outs):
        ms = gpu_ms(lambda: agu.relayout_kernel(xin, src, dst, t))
        plain = gpu_ms(lambda: agu.relayout_plain(xin, src, dst, t))
        pair_times.append({"pair": desc.summary(), "dtype": str(xin.dtype),
                           "ms": ms, "plain_ms": plain,
                           "bound_ms": bound_ms(nbytes(xin, got))})
    # the JSON row: the Fig. 4 tile store MN -> MNM8N128 at 4096^2 f32
    src, dst, t, xin, desc = inputs[0]
    gm, gn = 4096 // 8, 4096 // 128
    lib = lambda: xin.view(gm, 8, gn, 128).permute(0, 2, 1, 3).contiguous()
    assert_bitwise(lib(), outs[0], "kernel1 library yardstick")
    rows["agu_relayout"] = {
        "name": "agu_relayout", "route": "cuda",
        "source": "src/repro_torch/csrc/agu_relayout.cu",
        "replaces": agu.RELAYOUT.replaces,
        "launches": counts["agu_relayout"], "max_abs_err": k1_err,
        "ms": pair_times[0]["ms"], "plain_ms": pair_times[0]["plain_ms"],
        "bound_ms": pair_times[0]["bound_ms"], "bound_by": "bytes",
        "library_ms": gpu_ms(lib),
        "shape": "MN->MNM8N128 4096x4096 float32"}
    for r in pair_times:
        log_case("kernel1", r)
    del outs, inputs

    # -- phase 3: kernel 2, the Prefill store at phi4-mini width -------------
    w = torch.randn(3072, generator=gen, device=dev).to(torch.bfloat16)
    store = describe("MN", "MNM16N128", P.RMSNormPlugin(weight=w))
    cast_chain = (P.Cast(torch.bfloat16), P.Scale(1.5), P.BiasAdd(0.25))
    cast = describe("MN", "MNM16N128", *cast_chain)
    xf = torch.randn(8192, 3072, generator=gen, device=dev)
    plugin_compiler.clear_stats()

    def k2_path():
        return xdma.transfer(xb, store), xdma.transfer(xf, cast)

    (y_store, y_cast), counts = drive("kernel2", [datapath.STREAMED], k2_path)
    check(datapath.STREAMED.paths == {"rows": 2},
          f"kernel2: paths {datapath.STREAMED.paths}, expected both main-path "
          f"launches on the rows path")
    check(plugin_compiler.cfg_stats()["fused"] == 2,
          f"kernel2: cfg_stats {plugin_compiler.cfg_stats()}")
    want_store = datapath.plain(xb, store.plugins, L.MN, L.MNM16N128)
    want_cast = datapath.plain(xf, cast.plugins, L.MN, L.MNM16N128)
    tol_store = tolerance(store.plugins, xb.dtype)
    tol_cast = tolerance(cast.plugins, xf.dtype)
    assert_close(y_store, want_store, tol_store, "kernel2 rmsnorm store")
    assert_close(y_cast, want_cast, tol_cast, "kernel2 cast/scale/bias")
    k2_err = max_abs_err(y_store, want_store)
    log(f"[kernel2] launches by path {datapath.STREAMED.paths}; rmsnorm store "
        f"within {tol_store} (max abs err {k2_err}, "
        f"{int((bits(y_store) != bits(want_store)).sum())} of "
        f"{y_store.numel()} elements differ in bits); cast->scale->bias "
        f"within {tol_cast} (max abs err {max_abs_err(y_cast, want_cast)}, "
        f"{int((bits(y_cast) != bits(want_cast)).sum())} of {y_cast.numel()} "
        f"elements differ in bits); cfg_stats {plugin_compiler.cfg_stats()}")
    # the same store at gemma3-27B width (d_model 5376: 672 packs a row)
    wg = torch.randn(5376, generator=gen, device=dev).to(torch.bfloat16)
    xg = torch.randn(8192, 5376, generator=gen, device=dev).to(torch.bfloat16)
    gstore = describe("MN", "MNM16N128", P.RMSNormPlugin(weight=wg))
    _build.reset_launches()
    y_g = xdma.transfer(xg, gstore)
    check(datapath.STREAMED.paths == {"rows": 1},
          f"kernel2: the gemma3-width store took {datapath.STREAMED.paths}")
    want_g = datapath.plain(xg, gstore.plugins, L.MN, L.MNM16N128)
    assert_close(y_g, want_g, tol_store, "kernel2 gemma3-width store")
    log(f"[kernel2] gemma3-width store within {tol_store} (max abs err "
        f"{max_abs_err(y_g, want_g)}, {int((bits(y_g) != bits(want_g)).sum())}"
        f" of {y_g.numel()} elements differ in bits)")
    del want_g
    # a chain whose source runs along the rows takes the generic path
    sm = L.NM.from_logical(torch.randn(64, 256, generator=gen, device=dev))
    fn = plugin_compiler.compile_local(describe(
        "NM", "MNM8N128", *cast_chain, P.RMSNormPlugin()))
    _build.reset_launches()
    small = fn(sm)
    check(datapath.STREAMED.paths == {"generic": 1},
          f"kernel2: the small NM chain took {datapath.STREAMED.paths}")
    assert_close(small.cpu(), fn(sm.cpu()), tolerance(cast_chain, sm.dtype),
                 "kernel2 small NM chain (generic) vs CPU")
    sm = torch.randn(64, 256, generator=gen, device=dev)
    fn = plugin_compiler.compile_local(describe("MN", "MNM8N128", *cast_chain))
    assert_close(fn(sm).cpu(), fn(sm.cpu()), tolerance(cast_chain, sm.dtype),
                 "kernel2 small vs CPU")
    run_store = plugin_compiler.compile_local(store)
    run_cast = plugin_compiler.compile_local(cast)
    run_g = plugin_compiler.compile_local(gstore)
    rows["streamed_datapath"] = {
        "name": "streamed_datapath", "route": "cuda",
        "source": "src/repro_torch/csrc/streamed_datapath.cu",
        "replaces": datapath.STREAMED.replaces,
        "launches": counts["streamed_datapath"], "max_abs_err": k2_err,
        "ms": gpu_ms(lambda: run_store(xb)),
        "plain_ms": gpu_ms(lambda: datapath.plain(
            xb, store.plugins, L.MN, L.MNM16N128)),
        "bound_ms": bound_ms(nbytes(xb, w, y_store)), "bound_by": "bytes",
        "library_ms": None,
        "shape": "MN->MNM16N128 RMSNorm(weight) 8192x3072 bfloat16"}
    for what, f, x, y, d, consts in (
            ("cast->scale->bias, second main-path launch", run_cast, xf,
             y_cast, cast, ()),
            ("gemma3-27B width", run_g, xg, y_g, gstore, (wg,))):
        pair_times.append({
            "pair": f"streamed {what}: {d.summary()} "
                    f"{'x'.join(map(str, x.shape))}",
            "dtype": str(x.dtype), "ms": gpu_ms(lambda: f(x)),
            "plain_ms": gpu_ms(lambda: datapath.plain(
                x, d.plugins, L.MN, L.MNM16N128)),
            "bound_ms": bound_ms(nbytes(x, *consts, y))})
        log_case("kernel2", pair_times[-1])
    k4_g = gpu_ms(lambda: ops.rmsnorm_relayout(xg, wg, (16, 128)))
    log(f"[kernel4] the gemma3-width store (8192x5376 bf16) on kernel 4: "
        f"{k4_g:.4f} ms, kernel 2 {pair_times[-1]['ms']:.4f} ms on {card}")
    del y_cast, want_cast, xf, xg, y_g

    # -- phase 4: kernel 3, the block datapath -------------------------------
    xt = L.MNM16N128.from_logical(xb)
    load = describe("MNM16N128", "MN", P.Transpose(), backend="compiled")
    perm = torch.randperm(8192, generator=gen, device=dev)
    gather = describe("MN", "MN", P.GatherScatter(indices=perm))
    keep_blocks = torch.rand(1024, generator=gen, device=dev) < 0.5
    xs = xb * keep_blocks.repeat_interleave(8)[:, None].to(xb.dtype)
    compress = describe("MN", "MNM16N128", P.Compress(block_rows=8))
    roundtrip = describe("MN", "MN", P.Compress(block_rows=8), P.Decompress())
    rsum = describe("MN", "MN", P.ReduceStage("sum"))
    rmax = describe("MN", "MN", P.ReduceStage("max"))

    def k3_path():
        return (xdma.transfer(xt, load), xdma.transfer(xb, gather),
                xdma.transfer(xs, compress), xdma.transfer(xs, roundtrip),
                xdma.transfer(xb, rsum), xdma.transfer(xb, rmax))

    (y_load, y_gather, y_comp, y_round, y_sum, y_max), counts = drive(
        "kernel3", [datapath.BLOCK], k3_path)
    # one launch each, plus a mask pass for each Compress: all rank-2
    check(datapath.BLOCK.paths == {"rank2": 8},
          f"kernel3: paths {datapath.BLOCK.paths}, expected 8 rank-2 launches")
    log(f"[kernel3] launches by path {datapath.BLOCK.paths}")
    plain = lambda x, d: datapath.plain(x, d.plugins, d.src.layout,
                                              d.dst.layout)
    want_load = plain(xt, load)
    assert_bitwise(y_load, want_load, "kernel3 load (transpose)")
    assert_bitwise(y_gather, plain(xb, gather), "kernel3 gather")
    want_comp = plain(xs, compress)
    assert_bitwise(y_comp.values, want_comp.values, "kernel3 compress values")
    assert_bitwise(y_comp.mask, want_comp.mask, "kernel3 compress mask")
    check(torch.equal(want_comp.mask, keep_blocks),
          "kernel3 compress mask marks exactly the kept blocks")
    assert_bitwise(y_round, xs, "kernel3 compress->decompress round trip")
    tol_sum = tolerance(rsum.plugins, xb.dtype)
    assert_close(y_sum, plain(xb, rsum), tol_sum, "kernel3 reduce sum")
    assert_bitwise(y_max, plain(xb, rmax), "kernel3 reduce max")
    log(f"[kernel3] load, gather, compress (values+mask), round trip and "
        f"max bitwise; sum within {tol_sum} (max abs err "
        f"{max_abs_err(y_sum, plain(xb, rsum))}); occupancy "
        f"{float(y_comp.mask.float().mean()):.3f}")
    sm = torch.randn(2, 64, 256, generator=gen, device=dev)
    fn = plugin_compiler.compile_local(describe(
        "MN", "MN", P.Transpose(), P.Scale(2.0), P.ReduceStage("max"),
        P.RMSNormPlugin()))
    _build.reset_launches()
    small = fn(sm)
    check(datapath.BLOCK.paths == {"generic": 2},
          f"kernel3: the rank-3 chain's paths {datapath.BLOCK.paths}, "
          f"expected its statistics and output passes on the generic path")
    assert_close(small.cpu(), fn(sm.cpu()), tolerance((), sm.dtype),
                 "kernel3 small rank-3 chain vs CPU")
    # the chains kernels 2 and 3 once refused (ROADMAP §3, fault 1): an
    # int8 gather, an int32 transpose, nine Scales into MNM8N128 (kernel 2
    # in two launches), a Scale at logical rank 5, integer arithmetic (int8
    # Scale, BiasAdd, ReduceStage sum widening to int32), an int32 -> f32
    # cast after a transpose
    ints = lambda shape, lo, hi, dt: torch.randint(   # noqa: E731
        lo, hi, shape, generator=gen, device=dev, dtype=torch.int64).to(dt)
    fault1 = [
        ("gather int8", describe("MN", "MN", P.GatherScatter(
            indices=torch.randperm(64, generator=gen, device=dev)),
            backend="compiled"), ints((64, 128), -128, 128, torch.int8)),
        ("transpose int32", describe("MN", "MNM8N128", P.Transpose(),
                                     backend="compiled"),
         ints((128, 256), -2 ** 31, 2 ** 31, torch.int32)),
        ("nine scales", describe("MN", "MNM8N128", *(
            P.Scale(1.0 + k / 64) for k in range(9)), backend="compiled"),
         torch.randn(64, 256, generator=gen, device=dev)),
        ("scale rank 5", describe("MN", "MN", P.Scale(2.5),
                                  backend="compiled"),
         torch.randn(2, 2, 2, 8, 128, generator=gen, device=dev)),
        ("int8 scale, bias, sum", describe(
            "MN", "MN", P.Scale(3), P.BiasAdd(-7), P.ReduceStage("sum"),
            backend="compiled"), ints((64, 128), -128, 128, torch.int8)),
        ("int32 transpose, cast f32, scale", describe(
            "MN", "MNM8N128", P.Transpose(), P.Cast(torch.float32),
            P.Scale(0.5), backend="compiled"),
         ints((128, 256), -1000, 1000, torch.int32))]
    f1_out, f1_counts = drive(
        "fault1", [datapath.BLOCK, datapath.STREAMED],
        lambda: [xdma.transfer(x, d) for _, d, x in fault1])
    for (what, d, x), got in zip(fault1, f1_out):
        want = plain(x, d)
        if got.dtype.is_floating_point:
            assert_close(got, want, tolerance(d.plugins, x.dtype),
                         f"fault1 {what}")
        else:
            assert_bitwise(got, want, f"fault1 {what}")
    log(f"[fault1] {len(fault1)} chains the kernels once refused: integer "
        f"results bitwise, float within the chain tolerance; launches "
        f"{f1_counts}, kernel 3 by path {datapath.BLOCK.paths}, kernel 2 by "
        f"path {datapath.STREAMED.paths}")
    del f1_out
    run_load = plugin_compiler.compile_local(load)
    run_load(xt)
    lib = lambda: xt.permute(1, 3, 0, 2).reshape(3072, 8192)
    assert_bitwise(lib(), y_load, "kernel3 library yardstick")
    rows["block_datapath"] = {
        "name": "block_datapath", "route": "cuda",
        "source": "src/repro_torch/csrc/block_datapath.cu",
        "replaces": datapath.BLOCK.replaces,
        "launches": counts["block_datapath"],
        "max_abs_err": max_abs_err(y_load, want_load),
        "ms": gpu_ms(lambda: run_load(xt)),
        "plain_ms": gpu_ms(lambda: plain(xt, load)),
        "bound_ms": bound_ms(nbytes(xt, y_load)), "bound_by": "bytes",
        "library_ms": gpu_ms(lib),
        "shape": "MNM16N128->MN + Transpose 8192x3072 bfloat16"}
    r = rows["block_datapath"]
    log_case("kernel3", {"pair": "load " + load.summary(),
                         "dtype": str(xt.dtype), **r})
    for name, d, x in (("gather", gather, xb), ("compress", compress, xs),
                       ("roundtrip", roundtrip, xs), ("sum", rsum, xb),
                       ("max", rmax, xb)):
        f = plugin_compiler.compile_local(d)
        f(x)
        out = f(x)
        out_t = out.values if isinstance(out, P.CTensor) else out
        pair_times.append({"pair": d.summary(), "dtype": str(x.dtype),
                           "ms": gpu_ms(lambda: f(x)),
                           "plain_ms": gpu_ms(lambda: plain(x, d)),
                           "bound_ms": bound_ms(nbytes(x, out_t))})
        log_case("kernel3", pair_times[-1])
    del y_gather, y_comp, y_round, y_sum, y_max

    # -- phase 5: the queue ----------------------------------------------------
    queue = xdma.XDMAQueue([store, load], name="prefill")

    def q_path():
        return queue.run(xb), xdma.transfer(xdma.transfer(xb, store), load)

    (q_out, t_out), counts = drive(
        "queue", [datapath.STREAMED, datapath.BLOCK], q_path)
    assert_bitwise(q_out, t_out, "queue vs transfers in turn")
    hits = xdma.cache_stats().hits
    xdma.transfer(xdma.transfer(xb, store), load)
    check(xdma.cache_stats().hits >= hits + 2,
          f"queue: cache_stats {xdma.cache_stats()}")
    log(f"[queue] store->load equals the two transfers; {xdma.cache_stats()}")

    del q_out, t_out, y_load, want_load, xt

    # -- phase 6: kernel 4, ops.rmsnorm_relayout at phi4-mini width ----------
    x4 = torch.randn(8192, 3072, generator=gen, device=dev)
    w4 = torch.randn(3072, generator=gen, device=dev)
    bf16_tol, f32_tol = dict(rtol=2e-2, atol=1e-2), dict(rtol=1e-5, atol=1e-5)

    def k4_path():
        return (ops.rmsnorm_relayout(xb, w, (16, 128)),
                ops.rmsnorm_relayout(x4, w4, (8, 128)))

    (y4, y4f), counts = drive("kernel4", [FN.NORM], k4_path)
    want4 = FN.rmsnorm_relayout_plain(xb, w, (16, 128))
    assert_close(y4, want4, bf16_tol, "kernel4 bf16 (16, 128) with weight")
    assert_close(y4f, FN.rmsnorm_relayout_plain(x4, w4, (8, 128)), f32_tol,
                 "kernel4 f32 (8, 128) with weight")
    for shape, tile, dt in (((40, 384), (16, 128), torch.bfloat16),
                            ((48, 120), (16, 40), torch.float32)):
        sm = torch.randn(*shape, generator=gen, device=dev).to(dt)
        assert_close(ops.rmsnorm_relayout(sm, None, tile).cpu(),
                     FN.rmsnorm_relayout_plain(sm.cpu(), None, tile),
                     bf16_tol if dt == torch.bfloat16 else f32_tol,
                     f"kernel4 small {shape} {tile} vs CPU")
    k4_err = max_abs_err(y4, want4)
    log(f"[kernel4] bf16 within {bf16_tol} (max abs err {k4_err}, "
        f"{int((bits(y4) != bits(want4)).sum())} of {y4.numel()} elements "
        f"differ in bits); f32 within {f32_tol} (max abs err "
        f"{max_abs_err(y4f, FN.rmsnorm_relayout_plain(x4, w4, (8, 128)))})")
    rows["rmsnorm_relayout"] = {
        "name": "rmsnorm_relayout", "route": "cuda",
        "source": "src/repro_torch/csrc/rmsnorm_relayout.cu",
        "replaces": FN.NORM.replaces,
        "launches": counts["rmsnorm_relayout"], "max_abs_err": k4_err,
        "ms": gpu_ms(lambda: ops.rmsnorm_relayout(xb, w, (16, 128))),
        "plain_ms": gpu_ms(lambda: FN.rmsnorm_relayout_plain(
            xb, w, (16, 128))),
        "bound_ms": bound_ms(nbytes(xb, w, y4)), "bound_by": "bytes",
        "library_ms": None,
        "library": "none: no one PyTorch call does norm + tiling",
        "shape": "MN->MNM16N128 RMSNorm(weight) 8192x3072 bfloat16"}
    pair_times.append({
        "pair": "rmsnorm_relayout MN->MNM8N128 8192x3072",
        "dtype": "torch.float32",
        "ms": gpu_ms(lambda: ops.rmsnorm_relayout(x4, w4, (8, 128))),
        "plain_ms": gpu_ms(lambda: FN.rmsnorm_relayout_plain(
            x4, w4, (8, 128))),
        "bound_ms": bound_ms(nbytes(x4, w4, y4f))})
    del x4, y4, y4f, want4

    # -- phase 7: kernel 5, ops.quantize_tiled on a phi4-mini gradient leaf --
    x5 = torch.randn(3072, 8192, generator=gen, device=dev) * \
        torch.rand(3072, 1, generator=gen, device=dev) * 4
    x5[7] = 0.0                                   # an all-zero row
    ties = torch.tensor([127.0, 2.5, -0.5, 1.5, -2.5, 0.5, -1.5, 3.5],
                        device=dev)
    x5[8] = ties.repeat(8192 // len(ties))        # amax 127: exact .5 ties
    x5b = x5.to(torch.bfloat16)

    def k5_path():
        return ops.quantize_tiled(x5), ops.quantize_tiled(x5b)

    ((v5, s5), (v5b, s5b)), counts = drive("kernel5", [FQ.QUANT], k5_path)
    for (v, sc), x, what in (((v5, s5), x5, "f32"), ((v5b, s5b), x5b, "bf16")):
        pv, ps = FQ.quantize_tiled_plain(x)
        assert_bitwise(v, pv, f"kernel5 {what} values")
        assert_bitwise(sc, ps, f"kernel5 {what} scales")
        logical = v.permute(0, 2, 1, 3).reshape(3072, 8192)
        check(sc[7].item() == 1.0 and not bool(logical[7].any()),
              f"kernel5 {what}: the zero row has scale 1 and zero values")
        check(sc[8].item() == 1.0 and logical[8, :8].tolist() ==
              [127, 2, 0, 2, -2, 0, -2, 4], f"kernel5 {what}: ties row "
              f"{logical[8, :8].tolist()}")
    # non-finite rows: NaN -> scale 1.0 and 0 for the NaN element; +-inf ->
    # scale inf and all zeros (the reference's max propagates NaN)
    xn = x5[:64].clone()
    xn[3, 5], xn[4, 7], xn[5, 9] = float("nan"), float("inf"), float("-inf")
    for x, what in ((xn, "f32"), (xn.to(torch.bfloat16), "bf16")):
        got_v, got_s = ops.quantize_tiled(x)
        pv, ps = FQ.quantize_tiled_plain(x)
        assert_bitwise(got_v, pv, f"kernel5 {what} non-finite rows values")
        assert_bitwise(got_s, ps, f"kernel5 {what} non-finite rows scales")
        logical = got_v.permute(0, 2, 1, 3).reshape(64, 8192)
        check(got_s[3:6, 0].tolist() == [1.0, float("inf"), float("inf")]
              and logical[3, 5].item() == 0 and not bool(logical[4:6].any()),
              f"kernel5 {what}: non-finite rows {got_s[3:6, 0].tolist()}")
    log("[kernel5] NaN, inf and -inf rows bitwise equal to the plain version: "
        "scales 1.0, inf, inf; NaN and inf elements 0")
    sm = torch.randn(40, 384, generator=gen, device=dev) * 3
    got_v, got_s = ops.quantize_tiled(sm)
    want_v, want_s = FQ.quantize_tiled_plain(sm.cpu())
    assert_bitwise(got_v.cpu(), want_v, "kernel5 small values vs CPU")
    assert_bitwise(got_s.cpu(), want_s, "kernel5 small scales vs CPU")
    log("[kernel5] f32 and bf16 values and scales bitwise equal to the plain "
        "version; zero row and ties row as the reference rounds them")
    rows["quantize_tiled"] = {
        "name": "quantize_tiled", "route": "cuda",
        "source": "src/repro_torch/csrc/quantize_tiled.cu",
        "replaces": FQ.QUANT.replaces,
        "launches": counts["quantize_tiled"],
        "max_abs_err": max_abs_err(v5, FQ.quantize_tiled_plain(x5)[0]),
        "ms": gpu_ms(lambda: ops.quantize_tiled(x5)),
        "plain_ms": gpu_ms(lambda: FQ.quantize_tiled_plain(x5)),
        "bound_ms": bound_ms(nbytes(x5, v5, s5)), "bound_by": "bytes",
        "library_ms": None,
        "library": "none: no one PyTorch call takes per-row amax scales, "
                   "rounds to int8 and tiles",
        "shape": "int8 MNM32N128 + f32 scales, 3072x8192 float32"}
    pair_times.append({
        "pair": "quantize_tiled MNM32N128 3072x8192", "dtype": "torch.bfloat16",
        "ms": gpu_ms(lambda: ops.quantize_tiled(x5b)),
        "plain_ms": gpu_ms(lambda: FQ.quantize_tiled_plain(x5b)),
        "bound_ms": bound_ms(nbytes(x5b, v5b, s5b))})
    del x5, x5b, v5, s5, v5b, s5b

    # -- phase 8: kernel 6, flash_attention_gqa on two model layers ----------
    # (name, B, S, H, KV, hd, window): phi4-mini-3.8B prefill attention;
    # gemma3-27B local (sliding-window) layer
    attn_cases = [("phi4-mini prefill", 1, 4096, 24, 8, 128, None),
                  ("gemma3-27B local", 1, 4096, 32, 16, 128, 1024)]
    attn_in = []
    for name, B, S, H, KV, hd, window in attn_cases:
        qkv = [torch.randn(B, S, h, hd, generator=gen, device=dev).to(
            torch.bfloat16) for h in (H, KV, KV)]
        attn_in.append((name, window, qkv))

    def k6_path():
        return [FA.flash_attention_gqa(*qkv, causal=True, window=window)
                for _, window, qkv in attn_in]

    outs6, counts = drive("kernel6", [FA.FLASH], k6_path)
    check(FA.FLASH.paths == {"mma": len(attn_in)},
          f"kernel6: the bf16 model layers took paths {FA.FLASH.paths}, "
          f"not the tensor-core path (mma) each")
    # unit-variance inputs at hd 128 give nearly flat softmax rows, and
    # outputs of about 0.02 at late positions: atol stays well under them
    attn_tol = dict(rtol=2e-2, atol=2e-3)
    f32_checks = (("kernel6 small f32 GQA vs CPU", FA.flash_attention_gqa,
                   FA.flash_attention_gqa_plain, (2, 96, 64), (4, 2, 2),
                   dict(causal=True, window=24)),
                  ("kernel6 small f32 vs CPU", FA.flash_attention,
                   FA.flash_attention_plain, (3, 200, 32), (None,) * 3,
                   dict(causal=False)))
    for what, kernel, plain, (n, S, hd), heads, kw in f32_checks:
        sm = [torch.randn(*((n, S, h, hd) if h else (n, S, hd)),
                          generator=gen, device=dev) for h in heads]
        got = kernel(*sm, **kw).cpu()
        want = on_cpu_one_thread(plain, *(t.cpu() for t in sm), **kw)
        exact = on_cpu_one_thread(attention_f64, *sm, **kw)
        log(f"[kernel6] {what}: max abs err {max_abs_err(got, want)}; "
            f"against float64, kernel {max_abs_err(got, exact)}, "
            f"CPU plain {max_abs_err(want, exact)}")
        assert_close(got, want, dict(rtol=2e-5, atol=2e-5), what)
    check(FA.FLASH.paths.get("fma") == 2,
          f"kernel6: the f32 checks took paths {FA.FLASH.paths}, not fma")
    sm = [torch.randn(2, 200, h, 32, generator=gen, device=dev).half()
          for h in (4, 2, 2)]
    assert_close(FA.flash_attention_gqa(*sm, window=70).cpu(),
                 on_cpu_one_thread(FA.flash_attention_gqa_plain,
                                   *(t.cpu() for t in sm), window=70),
                 attn_tol, "kernel6 small f16 GQA vs CPU")
    check(FA.FLASH.paths["mma"] == len(attn_in) + 1,
          f"kernel6: the f16 check took paths {FA.FLASH.paths}, not mma")
    log(f"[kernel6] paths: model layers {{'mma': {len(attn_in)}}}, small "
        f"checks f32 on fma, f16 on mma; all within tolerance")
    # head dims between the instance widths (hd 8: the qwen2 smoke width;
    # 80; 192 takes the FMA path in bf16) and mixed dtypes (cast up to
    # their promotion, the result in q's dtype), GQA with a window
    hd_cases = (("hd 8 bf16", 8, torch.bfloat16, torch.bfloat16, "mma"),
                ("hd 80 bf16", 80, torch.bfloat16, torch.bfloat16, "mma"),
                ("hd 192 bf16", 192, torch.bfloat16, torch.bfloat16, "fma"),
                ("bf16 q, f32 k/v", 64, torch.bfloat16, torch.float32, "fma"))
    for what, hd, q_dt, kv_dt, path in hd_cases:
        sm = [torch.randn(2, 160, h, hd, generator=gen, device=dev) / s_
              for h, s_ in ((4, 4), (2, 4), (2, 1))]
        sm = [sm[0].to(q_dt), sm[1].to(kv_dt), sm[2].to(kv_dt)]
        before = dict(FA.FLASH.paths)
        got = FA.flash_attention_gqa(*sm, causal=True, window=64)
        torch.cuda.synchronize()
        check(FA.FLASH.paths.get(path, 0) == before.get(path, 0) + 1,
              f"kernel6 {what}: paths {FA.FLASH.paths}, expected one {path}")
        want = on_cpu_one_thread(FA.flash_attention_gqa_plain,
                                 *(t.cpu() for t in sm), causal=True,
                                 window=64)
        check(got.dtype == q_dt, f"kernel6 {what}: output {got.dtype}")
        assert_close(got.cpu(), want, attn_tol, f"kernel6 {what} vs CPU")
        log(f"[kernel6] {what} ({path}): max abs err "
            f"{max_abs_err(got.cpu(), want)} within {attn_tol}")
    # the widest instance, timed: hd 256 (FMA path in bf16), S 2048, 8 heads
    wide = [torch.randn(1, 2048, 8, 256, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3)]
    wide_out = FA.flash_attention_gqa(*wide, causal=True)
    assert_close(wide_out, FA.flash_attention_gqa_plain(*wide, causal=True),
                 attn_tol, "kernel6 hd 256 bf16")
    wt = [t.transpose(1, 2).contiguous() for t in wide]
    wflops = 4 * 8 * 256 * (2048 * 2049 // 2)
    wide_ms = gpu_ms(lambda: FA.flash_attention_gqa(*wide, causal=True),
                     reps=5)
    wide_plain = gpu_ms(lambda: FA.flash_attention_gqa_plain(*wide,
                                                             causal=True),
                        reps=3, warmup=1)
    wide_lib = gpu_ms(lambda: F.scaled_dot_product_attention(
        *wt, is_causal=True), reps=5)
    log(f"[kernel6] hd 256 bf16 (fma path) B1 S2048 H8: {wide_ms:.4f} ms, "
        f"plain {wide_plain:.4f} ms, SDPA {wide_lib:.4f} ms, bound "
        f"{max(wflops / BF16_FLOPS, nbytes(*wide, wide_out) / HBM_BYTES_PER_S) * 1e3:.4f}"
        f" ms ({wflops / wide_ms / 1e9:.1f} TFLOP/s) on {card}")
    pair_times.append({"pair": "flash_attention_gqa hd256 B1 S2048 H8 KV8 "
                               "causal (fma path)", "dtype": "torch.bfloat16",
                       "ms": wide_ms, "plain_ms": wide_plain,
                       "library_ms": wide_lib, "flops": wflops})
    del wide, wt, wide_out
    # head dims above 256 (the chunked path): B1 S2048 H8, causal and with
    # a window, f32 and bf16, against the plain version; bf16 causal timed
    # beside its bound, the plain version and SDPA
    for hd in (320, 512):
        for dt in (torch.float32, torch.bfloat16):
            for window in (None, 512):
                qkv = [(torch.randn(1, 2048, 8, hd, generator=gen, device=dev)
                        / s_).to(dt) for s_ in (4, 4, 1)]
                before = FA.FLASH.paths.get("chunked", 0)
                got = FA.flash_attention_gqa(*qkv, causal=True, window=window)
                torch.cuda.synchronize()
                check(FA.FLASH.paths.get("chunked", 0) == before + 1,
                      f"kernel6 hd {hd}: paths {FA.FLASH.paths}, expected one "
                      f"chunked")
                want = FA.flash_attention_gqa_plain(*qkv, causal=True,
                                                    window=window)
                tol = (dict(rtol=2e-5, atol=2e-5) if dt == torch.float32
                       else attn_tol)
                what = f"kernel6 hd {hd} {dt} window {window}"
                assert_close(got, want, tol, what)
                log(f"[kernel6] {what} (chunked): max abs err "
                    f"{max_abs_err(got, want)} within {tol}")
                if dt == torch.bfloat16 and window is None:
                    timed = qkv
        qkv = timed
        flops = 4 * 8 * hd * (2048 * 2049 // 2)
        qt = [t.transpose(1, 2).contiguous() for t in qkv]
        ms = gpu_ms(lambda: FA.flash_attention_gqa(*qkv, causal=True),
                    reps=5)
        plain = gpu_ms(lambda: FA.flash_attention_gqa_plain(*qkv,
                                                            causal=True),
                       reps=3, warmup=1)
        lib = gpu_ms(lambda: F.scaled_dot_product_attention(
            *qt, is_causal=True), reps=5)
        bound = max(flops / BF16_FLOPS,
                    nbytes(*qkv, got) / HBM_BYTES_PER_S) * 1e3
        log(f"[kernel6] hd {hd} bf16 (chunked path) B1 S2048 H8 causal: "
            f"{ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound "
            f"{bound:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
            f"{bound / ms:.1%} of the bound) on {card}")
        pair_times.append({"pair": f"flash_attention_gqa hd{hd} B1 S2048 H8 "
                                   f"KV8 causal (chunked path)",
                           "dtype": "torch.bfloat16", "ms": ms,
                           "plain_ms": plain, "library_ms": lib,
                           "bound_ms": bound, "flops": flops})
        del qkv, qt, got, want, timed
    def margin(got, want):
        """max |got - want|, that over the RMS of ``want``, the RMS, and the
        least atol that passes at rtol 2e-2: how much of the tolerance the
        comparison uses."""
        err = (got.float() - want.float()).abs()
        rms = want.float().pow(2).mean().sqrt().item()
        need = (err - 2e-2 * want.float().abs()).max().item()
        return (f"max abs err {err.max().item()}, "
                f"{err.max().item() / rms:.4f} of the output's RMS "
                f"({rms:.5f}); atol needed at rtol 2e-2: {need:.6f}")

    for (name, window, qkv), out in zip(attn_in, outs6):
        B, S, H, hd = qkv[0].shape
        want = FA.flash_attention_gqa_plain(*qkv, causal=True, window=window)
        assert_close(out, want, attn_tol, f"kernel6 {name}")
        log(f"[kernel6] {name}: {margin(out, want)}")
        # q scaled by 3: peaked scores, outputs of about 0.2-1, so a dropped,
        # repeated or mis-masked key block moves them far past the tolerance.
        # Where two heavy keys cancel, one bf16 ulp of their P moves the
        # output by a few thousandths, and SDPA differs from the plain
        # version by as much there: hence atol 4e-3 (the run logs the atol
        # each check needs)
        peak_tol = dict(rtol=2e-2, atol=4e-3)
        qs = (qkv[0].float() * 3).to(qkv[0].dtype)
        got_s = FA.flash_attention_gqa(qs, *qkv[1:], causal=True,
                                       window=window)
        want_s = FA.flash_attention_gqa_plain(qs, *qkv[1:], causal=True,
                                              window=window)
        assert_close(got_s, want_s, peak_tol, f"kernel6 {name}, q x 3")
        log(f"[kernel6] {name}, q x 3: {margin(got_s, want_s)}")
        del qs, got_s, want_s
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in qkv)
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
            pairs = S * (S + 1) // 2
        else:
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)
            lib = lambda: F.scaled_dot_product_attention(   # noqa: E731
                qt, kt, vt, attn_mask=mask, enable_gqa=True)
            pairs = int(mask.sum())
        got_lib = lib().transpose(1, 2)
        assert_close(got_lib, want, attn_tol,
                     f"kernel6 {name} library yardstick")
        log(f"[kernel6] {name} library yardstick: {margin(got_lib, want)}")
        del got_lib
        flops = 4 * B * H * hd * pairs
        r = {"pair": f"flash_attention_gqa {name} B{B} S{S} H{H} "
                     f"KV{qkv[1].shape[2]} hd{hd} window {window}",
             "dtype": "torch.bfloat16", "max_abs_err": max_abs_err(out, want),
             "ms": gpu_ms(lambda: FA.flash_attention_gqa(
                 *qkv, causal=True, window=window), reps=5),
             "plain_ms": gpu_ms(lambda: FA.flash_attention_gqa_plain(
                 *qkv, causal=True, window=window), reps=3, warmup=1),
             "library_ms": gpu_ms(lib),
             "flops": flops,
             "bound_ms": max(flops / BF16_FLOPS,
                             nbytes(*qkv, out) / HBM_BYTES_PER_S) * 1e3}
        pair_times.append(r)
        log(f"[kernel6] {name}: within {attn_tol} of the plain version "
            f"(max abs err {r['max_abs_err']}); {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} ({flops / r['ms'] / 1e9:.1f} TFLOP/s)")
        del want
    r = pair_times[-2]                            # the phi4-mini prefill
    rows["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": FA.FLASH.replaces, "launches": counts["flash_attention"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "operations", "library_ms": r["library_ms"],
        "shape": r["pair"] + " bfloat16 causal"}

    # -- phase 9: the paper's Fig. 4 on the card -----------------------------
    # Kernel 1 (xdma.transfer, backend "pallas") beside the three software
    # setups of core.baselines on the same bytes: (1) a host loop issuing
    # one device copy per contiguous run, (2) one strided block copy per
    # tile, (3) a burst copy then a separate transform pass.
    from repro_torch.core import baselines as BL
    fig4_setups = (("kernel1", xdma.transfer),
                   ("sw_loop_1d_dma", BL.sw_loop_1d_dma),
                   ("sw_loop_2d_dma", BL.sw_loop_2d_dma),
                   ("copy_then_transform", BL.copy_then_transform))
    # (src, dst, transpose, n): the transposing pair's setup (1) moves one
    # element a copy (16.7 M copies at 4096^2), so it runs at 512^2
    fig4_pairs = [("MN", "MNM8N128", False, 4096),
                  ("MNM8N128", "MN", False, 4096),
                  ("MN", "MNM16N128", False, 4096),
                  ("MNM16N128", "MNM16N128", True, 512)]
    fig4_in = []
    for s, d, t, n in fig4_pairs:
        x = x32 if n == 4096 else x32[:n, :n].contiguous()
        desc = describe(s, d, *([P.Transpose()] if t else []),
                        backend="pallas")
        fig4_in.append((s, d, t, n, L.by_name(s).from_logical(x), desc))

    def fig4_path():
        return [{name: f(xin, desc) for name, f in fig4_setups}
                for _, _, _, _, xin, desc in fig4_in]

    fig4_outs, counts = drive("fig4", [agu.RELAYOUT], fig4_path)
    check(counts["agu_relayout"] == len(fig4_pairs),
          f"fig4: {counts['agu_relayout']} kernel-1 launches for "
          f"{len(fig4_pairs)} pairs")

    def wall_ms(fn, reps):
        """GPU wall time of one call: CUDA events around the whole call, the
        host loop included (the card waits for the work it issues)."""
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    fig4_rows = []
    for (s, d, t, n, xin, desc), outs in zip(fig4_in, fig4_outs):
        for name, _ in fig4_setups[1:]:
            assert_bitwise(outs[name], outs["kernel1"],
                           f"fig4 {desc.summary()} {n}x{n}: {name} vs kernel 1")
        moved = 2 * n * n * 4                     # one read, one write
        pair_rows = {}
        for name, f in fig4_setups:
            # after the warm-up of the drive above: setup (1) is timed once
            # (a second or more a call), the others take the median of 5
            calls = 1 if name == "sw_loop_1d_dma" else 5
            ms = wall_ms(lambda: f(xin, desc), calls)
            pair_rows[name] = {"ms": ms, "util": moved / (ms * 1e-3)
                               / HBM_BYTES_PER_S, "timed_calls": calls}
        # kernel 1's device time, its host dispatch hidden behind a sleep
        k1_device = gpu_ms(lambda: xdma.transfer(xin, desc))
        for name, r in pair_rows.items():
            reps = r["timed_calls"]
            r["kernel1_factor"] = pair_rows["kernel1"]["util"] / r["util"]
            r["kernel1_device_ms"] = k1_device
            r["kernel1_device_factor"] = r["ms"] / k1_device
            row = {"pair": f"{s}->{d}{' + Transpose' if t else ''}",
                   "size": f"{n}x{n} float32", "setup": name, **r}
            if name == "sw_loop_1d_dma":
                row["copies"] = math.prod(L.relayout_pair(
                    L.by_name(s), L.by_name(d), (n, n),
                    transpose=t).runs()[1])
            if name == "sw_loop_2d_dma":
                lay = L.by_name(d) if L.by_name(d).is_tiled else L.by_name(s)
                row["copies"] = (n // lay.tile[0]) * (n // lay.tile[1])
            fig4_rows.append(row)
            log(f"[fig4] {row['pair']} {row['size']} {name}: "
                f"{r['ms']:.4f} ms ({'one call' if reps == 1 else 'median of 5'}"
                f"), utilization "
                f"{r['util']:.4%}, kernel 1 {r['kernel1_factor']:.2f}x its "
                f"utilization ({r['kernel1_device_factor']:.2f}x on kernel "
                f"1's device time {k1_device:.4f} ms)"
                + (f", {row['copies']} copies" if "copies" in row else "")
                + f" on {card}")
    del fig4_outs, fig4_in

    # -- phase 10: the distributed Controller over the Prefill path ----------
    # One task graph through DistributedScheduler on host_device(devices=4)
    # plus one wider host link: two tenants' store->load chains (kernels 2
    # and 3, phi4-mini width) through one ring pair, kernel-1 relayouts of
    # 4096^2 f32 on other links (one future-fed, one behind a deps= edge), a
    # describe("MN", "auto") store resolved against links of two widths, and
    # a tile store multicast from the host to three devices.
    from repro_torch.runtime import (DistributedScheduler, Topology, capture,
                                     telemetry)
    from repro_torch.runtime import chrometrace
    from repro_torch.runtime import scheduler as SCH

    def controller_topology():
        topo = Topology.host_device(devices=4)
        topo.add_link("host", "dev3", name="h2d3w", width=96)
        return topo

    tile_k1 = describe("MN", "MNM8N128", backend="pallas")
    untile_k1 = describe("MNM8N128", "MN", backend="pallas")
    tile16_k1 = describe("MN", "MNM16N128", backend="pallas")
    auto_store = describe("MN", L.AUTO)
    mcast = describe(Endpoint.local(L.MN), Endpoint.multicast(
        tuple((f"dev{i}", "MNM8N128") for i in (1, 2, 3))))

    def controller_graph(sched):
        """-> {name: future}: the phase-10 task graph, posted and drained."""
        futs = {}
        for tenant in ("a", "b"):
            futs[f"prefill/{tenant}"] = xdma.XDMAQueue(
                [store, load], name=f"prefill-{tenant}").submit_to(
                    sched, xb, link="h2d0", tenant=tenant)
        futs["tile"] = sched.submit(x32, tile_k1, link="h2d1")
        futs["untile"] = sched.submit(futs["tile"], untile_k1, link="d2h1")
        futs["tile16"] = sched.submit(x32, tile16_k1, link="h2d2",
                                      deps=(futs["prefill/a"],))
        futs["auto@h2d3"] = sched.submit(x32, auto_store, link="h2d3")
        futs["auto@h2d3w"] = sched.submit(x32, auto_store, link="h2d3w")
        mc = sched.submit_multicast(x32, mcast, src="host", label="tiles")
        for dst in mc.dsts:
            futs[f"mcast/{dst}"] = mc.future(dst)
        sched.flush()
        return futs

    def serial_graph():
        """The same transfers, issued one after another through transfer()."""
        s = xdma.transfer(xb, store)
        loaded = xdma.transfer(s, load)
        xdma.transfer(xdma.transfer(xb, store), load)
        tiled = xdma.transfer(x32, tile_k1)
        xdma.transfer(tiled, untile_k1)
        xdma.transfer(x32, tile16_k1)
        xdma.transfer(x32, auto_store)
        xdma.transfer(x32, auto_store)
        for _ in range(3):
            xdma.transfer(x32, describe("MN", "MNM8N128"))
        return loaded

    telemetry.reset()
    sched = DistributedScheduler(controller_topology(), name="controller")
    futs, counts = drive("scheduler", [agu.RELAYOUT, datapath.STREAMED,
                                       datapath.BLOCK],
                         lambda: controller_graph(sched))
    # every output equals a serial transfer of its resolved descriptor, its
    # input the serial result of its producer
    serial = {}
    for name, fut in futs.items():
        task = sched._tasks[fut.task_id]
        if name.startswith("prefill/"):
            want = xdma.transfer(xdma.transfer(xb, store), load)
        else:
            src = task.inputs[0]
            x_in = (serial[next(k for k, f in futs.items()
                                if f.task_id == src.task_id)]
                    if isinstance(src, SCH.XDMAFuture) else src)
            want = xdma.transfer(x_in, task.desc)
        serial[name] = want
        assert_bitwise(fut.result(), want, f"scheduler {name} vs serial")
        check(not task.desc.has_auto, f"scheduler {name}: auto unresolved")
    resolved = {name: sched._tasks[futs[name].task_id].desc.dst.layout.name
                for name in ("auto@h2d3", "auto@h2d3w")}
    rep = sched.report()
    check(sched.makespan() == rep.makespan,
          f"scheduler: incremental makespan {sched.makespan()} != replay "
          f"{rep.makespan}")
    per_link = {}
    for t in sched.sim_tasks():
        if t.resource in sched.topology:
            per_link[t.resource] = per_link.get(t.resource, 0) + t.nbytes
    bank = {k[len("bytes:"):]: v for k, v in
            telemetry.bank("links").as_dict().items() if k.startswith("bytes:")}
    check(bank == per_link, f"scheduler: links bank {bank} != report "
          f"{per_link}")
    rounds = sched._rounds
    cfg_before = (xdma.cache_stats().hits, xdma.cache_stats().misses)
    round_keys = list(SCH._ROUND_CACHE)
    again = DistributedScheduler(controller_topology(), name="again")
    controller_graph(again)
    torch.cuda.synchronize()
    cfg_after = (xdma.cache_stats().hits, xdma.cache_stats().misses)
    check(cfg_after[1] == cfg_before[1] and cfg_after[0] > cfg_before[0],
          f"scheduler: the second graph missed the CFG cache "
          f"({cfg_before} -> {cfg_after})")
    check(set(SCH._ROUND_CACHE) == set(round_keys) and len(round_keys) > 0,
          "scheduler: the second graph did not reuse the round cache")
    log(f"[scheduler] {len(futs)} outputs bitwise equal to serial transfers; "
        f"{len(sched._tasks)} tasks in {rounds} rounds, makespan "
        f"{rep.makespan * 1e6:.3f} us (model) == incremental; per-link "
        f"bytes {per_link}; auto store resolved {resolved}; second graph: "
        f"CFG cache {cfg_before} -> {cfg_after}, {len(round_keys)} round(s) "
        f"reused; launches {counts}")
    sched_ms = wall_ms(lambda: controller_graph(
        DistributedScheduler(controller_topology())), 5)
    serial_ms = wall_ms(serial_graph, 5)
    # the same two with the host's enqueue hidden behind a long sleep of the
    # card (about 22 ms): the device's own time, and so its idle share
    sched_dev = gpu_ms(lambda: controller_graph(
        DistributedScheduler(controller_topology())), reps=5, warmup=1,
        sleep_cycles=40_000_000)
    serial_dev = gpu_ms(serial_graph, reps=5, warmup=1,
                        sleep_cycles=40_000_000)
    log(f"[scheduler] the graph through the scheduler {sched_ms:.4f} ms, the "
        f"same transfers issued serially {serial_ms:.4f} ms (GPU wall time, "
        f"median of 5; information only); device time {sched_dev:.4f} / "
        f"{serial_dev:.4f} ms, so the card idles "
        f"{1 - sched_dev / sched_ms:.1%} / {1 - serial_dev / serial_ms:.1%} "
        f"of the wall time, on {card}")
    del futs, serial, again

    # -- phase 11: capture and replay ------------------------------------------
    telemetry.reset("links")

    def traced():
        with capture(name="controller") as tr:
            s = DistributedScheduler(controller_topology(), name="traced")
            controller_graph(s)
            xdma.transfer(xb, store)
        return tr, s

    (tr, tsched), counts = drive("trace", [agu.RELAYOUT, datapath.STREAMED,
                                           datapath.BLOCK], traced)
    bank = {k[len("bytes:"):]: v for k, v in
            telemetry.bank("links").as_dict().items() if k.startswith("bytes:")}
    check(tr.per_link_bytes() == bank,
          f"trace: per_link_bytes {tr.per_link_bytes()} != links bank {bank}")
    replays = {}
    for topo in (Topology.ring(4), Topology.parallel(1)):
        hw, sw = tr.replay(topo), tr.replay(topo, sw_agu=True)
        check(sw.makespan > hw.makespan,
              f"trace: software-AGU replay on {topo.name} "
              f"({sw.makespan}) not slower than the Frontend's ({hw.makespan})")
        replays[topo.name] = {"frontend_us": hw.makespan * 1e6,
                              "sw_agu_us": sw.makespan * 1e6,
                              "ratio": sw.makespan / hw.makespan}
    path = os.path.join(ROOT, "chiprun_out", "controller.trace.json")
    chrometrace.export(chrometrace.trace_events(tr, Topology.ring(4)), path)
    with open(path) as f:
        loaded = json.load(f)
    n_events = chrometrace.validate_events(loaded["traceEvents"])
    log(f"[trace] {len(tr.events)} events ({tr.by_endpoint()}), per-link "
        f"bytes equal to the links bank; replays (model us) {replays}; "
        f"chrome trace {os.path.relpath(path, ROOT)} ({n_events} events) "
        f"loads back; launches {counts}")
    del tr, tsched

    # -- phase 12: the collectives, 4 ranks on the one card ---------------------
    # A world of 4 processes: gloo on one card (NCCL needs a card a rank),
    # NCCL where there are 4; the kernels were built above, so the ranks
    # load the built libraries.
    import tempfile
    from repro_torch import sharding as S
    backend, note = S.pick_backend(RANKS, "cuda")
    log(f"[collectives] backend: {note}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-spmd-") as work:
        ranks = S.run_spmd(phase12_rank, (RANKS,), ("x",), args=(card,),
                           device="cuda", workdir=work)
    coll_s = time.perf_counter() - t0
    coll = {k: statistics.median(rk["times"][k] for rk in ranks)
            for k in ranks[0]["times"]}
    for k, ms in coll.items():
        log(f"[collectives] {k}: {ms:.3f} ms wall (median over ranks), host "
            f"hop {ranks[0]['hops'][k]} bytes a call a rank, on {card}")
    for k, ms in ranks[0]["side_ms"].items():
        log(f"[collectives] {k} alone: {ms:.4f} ms of device time (rank 0 "
            f"alone on the card) on {card}")
    log(f"[collectives] the gradient leaf (96 MiB) to the host and back "
        f"alone: {statistics.median(rk['hop_ms'] for rk in ranks):.3f} ms on "
        f"{card}; phase {coll_s:.1f} s with 4 process starts; launches by "
        f"rank {[rk['counts'] for rk in ranks]}")

    # -- phase 13: the movement-plane consumers, one process -------------------
    cons = phase13(dev, gen, card, drive, wall_ms)

    # -- phase 14: the serving path, full phi4-mini through ServingEngine ------
    serving, cfg14, params14 = phase14(dev, gen, card, drive)

    # -- phase 15: continuous batching on the phase-14 model ---------------------
    continuous = phase15(dev, gen, card, drive, cfg14, params14)
    del params14
    torch.cuda.empty_cache()

    # -- phase 16: an MoE model served at full width -----------------------------
    moe_serving = phase16(dev, gen, card, drive)

    # -- phase 17: MoE expert-parallel dispatch, 4 ranks on the one card ---------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-moe-") as work:
        ep = S.run_spmd(phase17_rank, (RANKS,), ("model",), args=(card,),
                        device="cuda", workdir=work)
    ep_s = time.perf_counter() - t0
    moe_ep = {k: statistics.median(rk["times"][k] for rk in ep)
              for k in ep[0]["times"]}
    log(f"[moe ep] 4 ranks ({ep[0]['backend']}): wall ms a call (median over "
        f"ranks) {moe_ep}; EP vs local {[rk['out']['ep_rel'] for rk in ep]}, "
        f"int8 wire {[rk['out']['int8_rel'] for rk in ep]}; launches on the "
        f"int8 wire by rank {[rk['counts'] for rk in ep]}; phase {ep_s:.1f} s "
        f"with 4 process starts on {card}")

    order = ["agu_relayout", "streamed_datapath", "block_datapath",
             "rmsnorm_relayout", "quantize_tiled", "flash_attention"]
    for name in order:
        r = rows[name]
        log(f"[times] {name} ({r['shape']}): {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of the "
            f"bound) on {card}")
    r2, r4 = rows["streamed_datapath"], rows["rmsnorm_relayout"]
    log(f"[times] the Prefill store on kernel 2 (xdma.transfer) {r2['ms']:.4f} "
        f"ms, on kernel 4 (ops.rmsnorm_relayout) {r4['ms']:.4f} ms: kernel 2 "
        f"takes {r2['ms'] / r4['ms']:.3f}x kernel 4's time on {card}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_times.json"),
              "w") as f:
        json.dump({"card": card, "kernels": [rows[n] for n in order],
                   "cases": pair_times, "fig4": fig4_rows,
                   "scheduler": {"graph_ms": sched_ms, "serial_ms": serial_ms,
                                 "graph_device_ms": sched_dev,
                                 "serial_device_ms": serial_dev,
                                 "rounds": rounds, "per_link_bytes": per_link,
                                 "auto_resolved": resolved},
                   "trace_replays_model_us": replays,
                   "collectives": {"backend": ranks[0]["backend"],
                                   "ms": coll, "ranks": ranks,
                                   "phase_s": coll_s},
                   "consumers_ms": cons, "serving": serving,
                   "continuous": continuous, "moe_serving": moe_serving,
                   "moe_ep": {"ms": moe_ep, "ranks": ep, "phase_s": ep_s}},
                  f, indent=1)
    log(json.dumps({"kernels": [{k: rows[n][k] for k in ROW_KEYS}
                                for n in order]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
