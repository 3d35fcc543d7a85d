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
* ``flash_attention_gqa`` (kernel 6, its ``wgmma`` path: TMA and Hopper's
  warpgroup tensor cores) on a phi4-mini prefill (S 4096, 24 query / 8 kv
  heads, hd 128, causal) and a gemma3-27B local layer (32 / 16 heads,
  window 1024), in bf16, each timed beside its ``mma`` path (PR 17's
  ``mma.sync`` design) through the C entry point, in turns;
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
* continuous batching (phase 15) on the same model cut to its first 8
  layers: four 32-token prompts arriving together, bitwise
  ``ServingEngine.generate``'s tokens, then a stream of eight requests
  (16, 32 and 48 prompt tokens) through
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
  path, the int8 wire and its backward (one f32 a row on the wire, the
  gradients held to the plain version that moves the whole cotangent),
  the scheduled chunked dispatch, the ring all-gather;
* training (phase 18): the full qwen3-1.7b configuration (28 layers, bf16
  compute on f32 master parameters, f32 AdamW moments, block remat) takes 4 steps of B 4 x 4096
  tokens in 2 microbatches (one data rank's share of train_4k), the loss
  falling; (a) one full-width period in f32 with the embedding and head,
  its loss and every gradient leaf against its CPU run; (b) one f32 step of
  each smoke config against its CPU run; (c) a 2-layer cut trained,
  checkpointed through the plane (MNM8N128 at rest, the Compress wire;
  kernel 3's save and kernel 1's restore of the staged leaves held to the
  plain chain and the plain relayout, and timed), restored bitwise, resumed bitwise the uninterrupted run under
  deterministic algorithms, then served; step 2's allocator peak is held
  (in phase 22 (d)) to the dry run's count of the same step on meta;
* data-parallel training (phase 19): 4 ranks on the card, the full
  qwen2-0.5b in f32, one step with the plain reduce and one with the int8
  codec (a reduce descriptor per gradient leaf), the ranks' states equal,
  the step held to the single-process step, then the new weights
  broadcast to three replicas through the plane, bitwise;
* the sharded trainer (phase 20): (a) 4 ranks on the card as a (2, 2)
  ("data", "model") mesh, qwen3-1.7b at full width cut to 2 layers in f32,
  tensor-parallel (head-parallel attention, column / row-parallel MLP,
  vocab-parallel embedding, head and loss) and FSDP (the embedding and
  every matrix of a layer sharded over the data axis), 2 steps of B 4 x 512
  in 2 microbatches held to the single-process step, with ms a step
  (slowest rank), each rank's peak memory beside the whole state, and the
  collective bytes a step by op and axis; (c)-(f) in another (2, 2) world
  of 4 ranks, f32, 2 steps each of B 4 x 512 (whisper 448): (c)
  qwen3-moe-30b-a3b at full width cut to 1 of 48 layers, its MoE layer
  (the expert-parallel path, 64 experts a rank, the sequence split) first
  held to the single-process emulation of its slice-wise routing, then
  trained, every block moving; (d) jamba-1.5-large cut to one dense Mamba
  slot, (e) xlstm-125m cut to one period (4 of its 12 layers) and (f)
  whisper-small cut to 4 + 4 of its 12 + 12 layers (1500 encoder frames),
  each held to the single-process step ((e) by its one step: see
  ``FIRST_STEP_HELD``), with ms a step, peak memory a rank and collective
  bytes; (b) ``launch/train.py --ranks 4
  --smoke`` for 3 steps with a checkpoint at step 2, resumed from it
  bitwise, its whole-leaf checkpoint restored on the card bitwise;
* sharded serving (phase 21): 4 gloo ranks on the card as a (2, 2)
  ("data", "model") mesh or a (1, 4) view of it, f32, TF32 off: (a)
  qwen2-0.5b cut to 12 of its 24 layers on (1, 4), B 4 x 512 prompts, 4
  steps (the
  sequence-parallel prefill, the cache split by sequence); (b) phi4-mini
  at full width cut to 4 of 32 layers on (2, 2) with the XDMA cache (KV
  heads split, the batch over the data axis), then
  ``ContinuousBatchingEngine`` with 4 requests on a pool that evicts and
  restores the youngest requests' pages (kernel 3); (c) whisper-small
  whole and xlstm-125m cut to one period on (1, 4) (the cross and
  recurrent caches).  Each
  part's logits, teacher-forced with the single-process tokens, within
  twice the gap one ulp on every weight opens in the single-process run
  of the single-process port on the card; ``ServingEngine(mesh=)``'s and
  the continuous engine's tokens equal its tokens under the tie rule;
  kernel 1 moves each rank's cache blocks through the plane (and the
  pool's pages), its round trip bitwise;
* the production mesh's last regimes (phase 22): 4 gloo ranks as a (2,
  2, 1) ("pod", "data", "model") mesh: (a) qwen3-1.7b cut to 2 layers
  trained and (b) served with the batch over ("pod", "data"); on a (2, 2)
  view with ``seq="data"``, gemma3-27b at full width cut to 8 of 62
  layers in bf16: (c) one decode on a seeded 524288-slot context-parallel
  cache, (e) ``ContinuousBatchingEngine`` serving 6 requests of 512-4096
  prompt tokens (staggered arrivals) on a context-parallel bf16 cache of
  32768 slots, a pool that evicts and restores a request on every rank
  (kernels 1 and 3), tokens and logits against each request's
  single-process run; each part against the single-process port under
  the one-ulp rule; (d) the dry run's records (``launch/dryrun.py`` on
  meta, processes started after the build): ``train_4k`` on 2 x 16 x 16,
  ``long_500k`` on 16 x 16 and phase 18's step on one card, every field
  counted (bytes moved, argument, output, temp and peak), that step's
  counted peak within 3 % + 256 MiB of the card's;
* the examples phase: the port's twins of the reference's four example
  scripts (``examples/torch_*.py``) through the ``run`` their command lines
  call: the quickstart's fifteen moves (kernels 1, 2 and 3; every parity
  true, the ring's retries and incremental makespan, the telemetry against
  the ledger, the multicast copies exact), the KV-cache loop (kernel 3
  stores and loads its rank-3 K; its decoded tokens the CPU's),
  compressed_dp in a world of 8 gloo ranks on the card (bitwise its CPU
  run), and train_lm ``--full-100m`` (the full qwen2-0.5b, B 8 x 64, 4
  steps, the loss falling over them, the restart from step 3 bitwise the
  uninterrupted run, its serving plane on kernel 1).

Each phase's seconds go on a line of their own as it ends (``[phase
seconds]``).  Each phase resets the kernels' launch counts just before it
drives the path
and reads them just after; a kernel of the path that did not launch, a
result that disagrees, or a kernel that does not build or launch fails the
run with a non-zero exit.  Phases 2-4 also assert the launches by code
path: kernel 1's ``direct`` and ``staged`` copies, kernel 2's two main-path
launches on its ``rows`` path (a small NM chain on its generic path), and
kernel 3's six main-path transfers all on its rank-2 path (a small rank-3
chain with a stage after its ReduceStage on its generic path, and the
checkpoint's down-cast wire, a cast between dtypes, there too; phase 12's
KV tunnel transpose and phase 18's stacked leaves on the rank-2 path, their
leading axes a batch).  Phase 12 checks the launches in every rank
(kernels 2 and 3), phase 13 in its process (kernels 1, 2 and 3), phase 14
kernel 1 on the serving plane, phase 15 kernels 1 and 3 on the page pool,
phase 16 kernel 1 on the MoE model's plane, phase 18 kernels 1 and 3 on
the training checkpoint (phase 19's path has none: the reduce lowers to
collectives, and the broadcast's MN -> MN hops are kernel 1's identity
plan, a copy; nor has phase 20's: plain torch and ``torch.distributed``,
and the launcher's checkpoint staged MN -> MN, whose restore phase 20
counts), phase 21 kernel 1 in every rank on the plane and (b)'s pool and
kernel 3 on (b)'s evictions and restores.  Phase 4 also drives the chains kernels 2
and 3 once refused (integer streams, nine streamed ops, logical rank 5),
the streams and ranks kernel 3 once refused at the main path's shape
(8192 x 3072: a float8_e4m3fn and a bool Transpose, a uint32 ReduceStage
sum, a Scale at logical rank 9, each launch counted on its path, the
float8 Transpose timed) and every chain of
``tests/test_torch_stream_dtypes.py`` over bool, uint8, uint16, uint32
and both float8s, all bitwise their plain versions (float64 refused with
its reason), and phase 8 kernel 6 at head dims 8, 80, 192, 256, 320 and 512 (256 on
its wgmma path beside its FMA path, 320 and 512 on its chunked path,
timed), with bf16 q and f32 k / v, and the wgmma path's edges (f16, Sq !=
Sk, ragged S 1000, a window of 0) and a view TMA cannot address (one mma
launch).  Phase 3 also times the Prefill store at
gemma3-27B width (d_model 5376).  Phase 7 holds kernel 5 on NaN, inf and
-inf rows too.  Phase 8 asserts that both bf16 model layers took kernel 6's
wgmma path and its small f32 checks the FMA path (``fma``).

The line before the last is one JSON object with each kernel's launches,
error and times (CUDA events, median of several runs, GPU time only);
the last line is ``{"ok": true, "device": {...}}``.  Per-pair times go to
``chiprun_out/chip_smoke_times.json``, the compiler's output (registers and
spills of every kernel) to ``chiprun_out/build_log.txt``; a tensor-core
instance of kernel 6, a rows-path instance of kernel 2 or a generic-path
instance of kernel 3 that spills fails the run, as does a wgmma instance of
kernel 6 whose products ptxas serialized or whose SASS lacks HGMMA.  Without a CUDA device it
exits non-zero and prints no result.
"""
import concurrent.futures
import contextlib
import ctypes
import gc
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
# cuBLAS reads its workspace setting when it starts; phase 18 turns on
# deterministic algorithms, which need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
SEED = 0
K3_RANK2_SPILL_BYTES = 2170    # kernel 3's rank-2 instances, ptxas (sm_90a)
ROW_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


_T0 = time.perf_counter()


def log(*args):
    """A line of the run's log, after the seconds since the process
    started (the phases' share of the time limit)."""
    print(f"[{time.perf_counter() - _T0:.1f} s]", *args, flush=True)


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


# -- phase 4 (streams): the streams and ranks kernel 3 once refused -------------
STREAM_DTYPES = (torch.bool, torch.uint8, torch.uint16, torch.uint32,
                 torch.float8_e4m3fn, torch.float8_e5m2)


def stream_input(shape, dtype, gen, dev):
    """Seeded values of ``dtype``: bools, every word of an unsigned integer
    (its int32 / int16 / uint8 bits), a float8 from a normal of scale 4."""
    if dtype == torch.bool:
        return torch.rand(shape, generator=gen, device=dev) < 0.5
    if dtype.is_floating_point:
        return (4 * torch.randn(shape, generator=gen, device=dev)).to(dtype)
    signed = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[dtype.itemsize]
    lo, hi = (0, 256) if signed == torch.uint8 else (
        -2 ** (8 * dtype.itemsize - 1), 2 ** (8 * dtype.itemsize - 1))
    return torch.randint(lo, hi, shape, generator=gen, device=dev,
                         dtype=torch.int64).to(signed).view(dtype)


def stream_chains(P, dtype):
    """tests/test_torch_stream_dtypes.py's chains over ``dtype`` (48 rows:
    a float8 sum in two padded windows; on a float8 stream also the sum
    that ends its launch): (name, descriptor spelling)."""
    scale = 1.5 if dtype.is_floating_point else 3
    fill = torch.cat([torch.arange(47, -1, -2), torch.tensor([60, -49, -1])])
    chains = [("transpose", ("MN", "MN", P.Transpose())),
              ("gather_fill", ("MN", "MN", P.GatherScatter(indices=fill))),
              ("reduce_sum", ("MN", "MN", P.ReduceStage("sum"))),
              ("reduce_max", ("MN", "MN", P.ReduceStage("max"))),
              ("compress_roundtrip", ("MN", "MN", P.Compress(block_rows=8),
                                      P.Decompress())),
              ("cast_to_f32", ("MN", "MN", P.Cast(torch.float32))),
              ("cast_from_f32", ("MN", "MN", P.Cast(dtype))),
              ("scale", ("MN", "MN", P.Scale(scale))),
              ("tiled_store", ("MN", "MNM8N128"))]
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        chains.append(("sum_scale_compress", (
            "MN", "MN", P.ReduceStage("sum"), P.Scale(0.5),
            P.Compress(block_rows=1))))
    return chains


def phase4_streams(dev, gen, card, drive, pair_times):
    """Kernel 3 on the streams the reference's datapath takes that it once
    refused: at the main path's shape (8192 x 3072) a float8_e4m3fn and a
    bool Transpose (word copies on the rank-2 path), a uint32 ReduceStage
    sum (wrapping modulo 2^32, the generic path's int64 carrier) and a
    Scale at logical rank 9 (its seven leading axes folded to one); then
    every chain of tests/test_torch_stream_dtypes.py over bool, uint8,
    uint16, uint32 and both float8s at (48, 128), and its rank-9 and
    rank-10 cases.  Each is bitwise its plain version, each main-path case
    must launch kernel 3, and float64 is refused, naming the reason.  The
    float8 Transpose is timed beside ``transpose(-1, -2).contiguous()``
    and its bound, the uint32 sum beside an int32 ``sum`` (the same bits)
    and its bound; f32 values at float8's edges cast to both float8s, and
    a Scale on those float8 streams, are bitwise their plain versions
    (``plugins.to_float8``: the reference's rounding past the range and of
    NaN)."""
    from repro_torch.core import plugin_compiler
    from repro_torch.core import plugins as P
    from repro_torch.core import xdma
    from repro_torch.core.descriptor import describe
    from repro_torch.kernels import datapath

    def plain(x, d):
        return datapath.plain(x, d.plugins, d.src.layout, d.dst.layout)

    rank9 = (2, 2, 2, 2, 2, 2, 2, 64, 3072)     # 8192 x 3072 in rank 9
    cases = [
        ("transpose float8_e4m3fn", describe("MN", "MN", P.Transpose(),
                                             backend="compiled"),
         (8192, 3072), torch.float8_e4m3fn, {"rank2": 1}),
        ("transpose bool", describe("MN", "MN", P.Transpose(),
                                    backend="compiled"),
         (8192, 3072), torch.bool, {"rank2": 1}),
        ("reduce sum uint32", describe("MN", "MN", P.ReduceStage("sum"),
                                       backend="compiled"),
         (8192, 3072), torch.uint32, {"generic": 1}),
        ("scale rank 9 f32", describe("MN", "MN", P.Scale(2.5),
                                      backend="compiled"),
         rank9, torch.float32, {"rank2": 1})]
    xs = []
    for what, d, shape, dtype, _ in cases:
        if dtype == torch.float32:
            xs.append(torch.randn(shape, generator=gen, device=dev))
        else:
            xs.append(stream_input(shape, dtype, gen, dev))
    got = []
    for (what, d, shape, dtype, paths), x in zip(cases, xs):
        out, counts = drive(f"streams {what}", [datapath.BLOCK],
                            lambda: xdma.transfer(x, d))
        check(datapath.BLOCK.paths == paths,
              f"streams {what}: kernel 3 paths {datapath.BLOCK.paths}, "
              f"expected {paths}")
        assert_bitwise(out, plain(x, d), f"streams {what}")
        got.append(counts["block_datapath"])
    log(f"[streams] main-path shape: {[c[0] for c in cases]} bitwise their "
        f"plain versions, kernel 3 launches {got}")
    # the float8 Transpose timed beside the library call and its bound
    x8 = xs[0]
    run8 = plugin_compiler.compile_local(cases[0][1])
    y8 = run8(x8)
    lib8 = lambda: x8.transpose(-1, -2).contiguous()  # noqa: E731
    assert_bitwise(lib8(), y8, "streams float8 transpose library yardstick")
    pair_times.append({
        "pair": "float8 transpose (rank-2 word copy): MN->MN + Transpose "
                "8192x3072", "dtype": "float8_e4m3fn",
        "paths": {"rank2": 1}, "ms": gpu_ms(lambda: run8(x8)),
        "plain_ms": gpu_ms(lambda: plain(x8, cases[0][1])),
        "library_ms": gpu_ms(lib8), "bound_ms": bound_ms(nbytes(x8, y8))})
    r = pair_times[-1]
    log(f"[streams] float8 transpose 8192x3072: {r['ms']:.4f} ms (plain "
        f"{r['plain_ms']:.4f}, library (transpose(-1, -2).contiguous()) "
        f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f}, "
        f"{r['bound_ms'] / r['ms']:.1%} of the bound) on {card}")
    # the uint32 sum (the generic path's int64 carrier) against its bound
    # and one library call: an int32 sum is the same bits modulo 2^32
    xu, du = xs[2], cases[2][1]
    run_u = plugin_compiler.compile_local(du)
    y_u = run_u(xu)
    lib_u = lambda: xu.view(torch.int32).sum(  # noqa: E731
        -2, keepdim=True, dtype=torch.int32).view(torch.uint32)
    assert_bitwise(lib_u(), y_u, "streams uint32 sum library yardstick")
    pair_times.append({
        "pair": "uint32 sum (generic): MN->MN + ReduceStage(sum) 8192x3072",
        "dtype": "uint32", "paths": {"generic": 1},
        "ms": gpu_ms(lambda: run_u(xu)),
        "plain_ms": gpu_ms(lambda: plain(xu, du)),
        "library_ms": gpu_ms(lib_u), "bound_ms": bound_ms(nbytes(xu, y_u))})
    r = pair_times[-1]
    log(f"[streams] uint32 sum 8192x3072: {r['ms']:.4f} ms (plain "
        f"{r['plain_ms']:.4f}, library (int32 view .sum(dtype=int32)) "
        f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f}, "
        f"{r['bound_ms'] / r['ms']:.1%} of the bound) on {card}")
    del xs, got, x8, y8, xu, y_u
    # every chain of the CPU tests over each stream, and the ranks above 8
    small = []
    for dtype in STREAM_DTYPES:
        for name, spell in stream_chains(P, dtype):
            d = describe(*spell, backend="compiled")
            if name == "cast_from_f32":
                x = 4 * torch.randn(48, 128, generator=gen, device=dev)
                if not dtype.is_floating_point and dtype != torch.bool:
                    # inside the unsigned range: XLA's conversion past it
                    # is implementation-defined
                    x = 250 * torch.rand(48, 128, generator=gen, device=dev)
                x[::3] = 0
            else:
                x = stream_input((48, 128), dtype, gen, dev)
                if name == "compress_roundtrip":
                    x[8:16] = 0
                    x[32:40] = 0
            small.append((f"{name} {str(dtype)[6:]}", d, x))
    lead = (2, 1, 2, 1, 2, 1, 2)
    for what, chain, shape in (
            ("transpose rank 9", (P.Transpose(),), lead + (8, 16)),
            ("lead gather rank 9", (P.GatherScatter(
                indices=torch.tensor([1, 0, 5]), axis=0),), lead + (8, 16)),
            ("scale rank 10", (P.Scale(2.5),), lead + (1, 8, 16)),
            ("reduce max rank 10", (P.ReduceStage("max", keepdims=False),),
             lead + (1, 8, 16))):
        small.append((what, describe("MN", "MN", *chain, backend="compiled"),
                      torch.randn(shape, generator=gen, device=dev)))
    # f32 at float8's edges (tests/test_torch_stream_dtypes.py's EDGES): the
    # saturation band, past the range, the infinities, NaN of both signs,
    # subnormals; cast to each float8, and a Scale on the float8 stream
    edges = torch.tensor(
        [448, -448, 449, 464, -464, 465, -465, 479, 480, 57344, 61439, 61440,
         -61440, 1e9, math.inf, -math.inf, math.nan, 2.0 ** -9, 2.0 ** -10,
         3 * 2.0 ** -10, 2.0 ** -17, 3 * 2.0 ** -18, -2.0 ** -16],
        dtype=torch.float32)
    neg_nan = torch.tensor([0xFFC00000 - 2 ** 32], dtype=torch.int32)
    edges = torch.cat([edges, neg_nan.view(torch.float32), 4 * torch.randn(
        8, generator=torch.Generator().manual_seed(SEED))]).reshape(2, 16)
    for f8 in (torch.float8_e4m3fn, torch.float8_e5m2):
        name = str(f8)[6:]
        small.append((f"edges cast to {name}", describe(
            "MN", "MN", P.Cast(f8), backend="compiled"), edges.to(dev)))
        small.append((f"edges scale {name}", describe(
            "MN", "MN", P.Scale(1.5), backend="compiled"),
            P.to_float8(edges, f8, cast=True).to(dev)))
    xb = torch.randn(16, 32, generator=gen, device=dev)   # zeros, NaN
    xb[::3] = 0
    xb[1, ::5] = float("nan")
    small.append(("bool after a float cast", describe(
        "MN", "MN", P.Cast(torch.bool), P.Scale(2.0), P.ReduceStage("sum"),
        backend="compiled"), xb))
    outs, counts = drive("streams small", [datapath.BLOCK],
                         lambda: [xdma.transfer(x, d) for _, d, x in small])
    for (what, d, x), out in zip(small, outs):
        want = plain(x, d)
        if isinstance(want, P.CTensor):
            assert_bitwise(out.mask, want.mask, f"streams {what} mask")
            out, want = out.values, want.values
        assert_bitwise(out, want, f"streams {what}")
    refused = ""
    try:
        xdma.transfer(torch.zeros(16, 32, dtype=torch.float64, device=dev),
                      describe("MN", "MN", P.Transpose(), backend="compiled"))
    except NotImplementedError as e:
        refused = str(e)
    check("no float64 stream" in refused,
          f"streams: float64 is not refused with its reason: {refused!r}")
    log(f"[streams] {len(small)} chains over {len(STREAM_DTYPES)} streams "
        f"and ranks 9-10 bitwise their plain versions; launches {counts}, "
        f"kernel 3 by path {datapath.BLOCK.paths}; float64 refused: "
        f"{refused}")


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
    # the side kernels' device time, rank 0 alone on the card: the tunnel's
    # (1, 8192, 1024) bf16 transpose on kernel 3's rank-2 path (its leading
    # axis a batch) beside its bound and one PyTorch call
    side_ms = {}
    if r == 0:
        from repro_torch.core import plugin_compiler
        from repro_torch.kernels import datapath
        src_side = plugin_compiler.compile_side(C.MN, (C.Transpose(),),
                                                side="src")
        dst_side = plugin_compiler.compile_side(
            C.MN, peer_cast.post, side="dst")
        flat = kv.reshape(1, KV_SHAPE[1], -1)
        _build.reset_launches()
        got = src_side(flat)
        torch.cuda.synchronize()
        paths = dict(datapath.BLOCK.paths)
        check(paths == {"rank2": 1}, f"{tag} the kernel-3 src side took "
              f"{paths}, expected the rank-2 path")
        lib = lambda: flat.transpose(-1, -2).contiguous()  # noqa: E731
        assert_bitwise(got, datapath.plain(flat, (C.Transpose(),), C.MN,
                                           C.MN), f"{tag} kernel-3 src side "
                       "vs the plain version")
        assert_bitwise(lib(), got, f"{tag} kernel-3 src side library "
                       "yardstick")
        side_ms = {"kernel-3 src side (transpose)": {
                       "ms": gpu_ms(lambda: src_side(flat)),
                       "plain_ms": gpu_ms(lambda: datapath.plain(
                           flat, (C.Transpose(),), C.MN, C.MN)),
                       "library_ms": gpu_ms(lib),
                       "bound_ms": bound_ms(nbytes(flat, got)),
                       "shape": f"{tuple(flat.shape)} {flat.dtype}",
                       "paths": paths},
                   "kernel-2 dst side (Cast -> Scale)": {
                       "ms": gpu_ms(lambda: dst_side(mat))}}
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


def device_ms_by_name(prof):
    """{name: device ms} of what a torch.profiler window recorded."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t:
            out[e.key] = out.get(e.key, 0.0) + t / 1e3
    return out


def device_busy_ms(prof):
    """Device time of the kernels a torch.profiler window recorded (one
    stream, so their sum is the busy time); 0 when it saw none."""
    return sum(device_ms_by_name(prof).values())


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
CB_PERIODS = 8                 # of phi4-mini's 32 layers (the time limit)
CB_ALIGNED = dict(n=4, prompt=32, max_new=4)      # (a): arriving together
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
    phase-14 parameters, cut to their first ``CB_PERIODS`` layers: the
    engines' page movements, and so their host time, grow with the layers;
    the checks do not).  (a) four 32-token prompts arriving together,
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

    import dataclasses
    from repro_torch import _pytree

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(cfg, n_periods=CB_PERIODS)
    params = dict(params, blocks=_pytree.tree_map_with_path(
        lambda _, a: a[:CB_PERIODS], params["blocks"]))

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
    # one page store alone (a 32 x 128 bf16 page, MN -> the page tiling):
    # kernel 1's device time a launch beside the page's bound
    from repro_torch.core import xdma
    from repro_torch.core.descriptor import page_descriptor
    store = page_descriptor(32, 128, "bfloat16", direction="store")
    page = torch.randn(32, 128, generator=gen, device=dev).to(torch.bfloat16)
    assert_bitwise(xdma.transfer(page, store),
                   store.dst_layout.from_logical(page), "page store")
    tm, tn = store.dst_layout.tile
    lib = lambda: page.view(32 // tm, tm, 128 // tn, tn).permute(  # noqa: E731
        0, 2, 1, 3).contiguous()
    assert_bitwise(lib(), xdma.transfer(page, store),
                   "page store library yardstick")
    times["page_store"] = {
        "kernel_ms": gpu_ms(lambda: agu.relayout_kernel(
            page, store.src_layout, store.dst_layout)),
        "transfer_ms": gpu_ms(lambda: xdma.transfer(page, store)),
        "plain_ms": gpu_ms(lambda: agu.relayout_plain(
            page, store.src_layout, store.dst_layout, False)),
        "library_ms": gpu_ms(lib),
        "bound_ms": bound_ms(2 * nbytes(page)),
        "layout": store.dst_layout.name}
    log15(f"one page store (32 x 128 bf16, MN -> "
          f"{store.dst_layout.name}): kernel 1 "
          f"{times['page_store']['kernel_ms']:.4f} ms of device time a "
          f"launch, through xdma.transfer "
          f"{times['page_store']['transfer_ms']:.4f} ms, plain "
          f"{times['page_store']['plain_ms']:.4f} ms, library "
          f"(permute.contiguous) {times['page_store']['library_ms']:.4f} ms, "
          f"bound {times['page_store']['bound_ms']:.7f} ms on {card}")
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


@contextlib.contextmanager
def plain_wire_backward(MOE):
    """Within it, the MoE dispatch's backward on the int8 wire moves the
    whole cotangent back and takes ``moe._quantize_vjp`` on the source side:
    the plain version the kernel path is held to."""
    from repro_torch.core import xdma
    kernel_backward = MOE._PlaneA2A.backward

    def backward(ctx, g):
        if not ctx.wire:
            return kernel_backward(ctx, g)
        x, _ = ctx.saved_tensors
        g = xdma.transfer(g.contiguous(), ctx.back)
        return MOE._quantize_vjp(x, g), None, None

    MOE._PlaneA2A.backward = staticmethod(backward)
    try:
        yield
    finally:
        MOE._PlaneA2A.backward = staticmethod(kernel_backward)


def int8_wire_backward(cfg, p, x, mesh, tag):
    """The int8 wire's backward at the layer's full width: the gradients of
    x and of the experts (the whole tree, this rank's experts nonzero) for
    a seeded cotangent, bitwise the plain version's (the whole cotangent
    moved back, then ``moe._quantize_vjp``: ``plain_wire_backward``); its
    all-to-all bytes, the ``wire``
    bank's, one f32 a row: the plain version's (d_model f32 a row) over
    d_model.  (The forward's count holds the ring all-gather's hops too.)"""
    from repro_torch.core import remote
    from repro_torch.layers import moe as MOE
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    xg = x.detach().clone().requires_grad_()
    gen = torch.Generator(device=x.device).manual_seed(SEED + 17)
    dy = torch.randn(x.shape, generator=gen, device=x.device)

    def moved():
        return remote.wire_stats().get("bytes:all_to_all", 0)

    def grads(plain):
        w0 = moved()
        y, aux = MOE.moe_apply(cfg, leaves, xg, mesh=mesh)
        w1 = moved()
        with (plain_wire_backward(MOE) if plain
              else contextlib.nullcontext()):
            g = torch.autograd.grad([y, aux], [xg] + list(leaves.values()),
                                    [dy, torch.ones_like(aux)])
        torch.cuda.synchronize()
        return g, w1 - w0, moved() - w1

    # deterministic algorithms: the dispatch's scatter-add sums a token's
    # top-k gradients with atomics otherwise, in a different order each run
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got, fwd, bwd = grads(False)
        want, fwd_p, bwd_p = grads(True)
    finally:
        torch.use_deterministic_algorithms(False)
    d = cfg.d_model
    check(bwd > 0 and bwd * d == bwd_p,
          f"{tag} int8 wire backward moves {bwd} bytes, not one f32 a row "
          f"(the plain version's {bwd_p} over d_model {d})")
    # the same products summed in the same row order: bitwise
    errs = {name: float((g - w).abs().max())
            for name, g, w in zip(["x"] + list(leaves), got, want)}
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{tag} int8 wire backward: gradients not bitwise the plain "
          f"version's (max abs differences {errs})")
    return {"fwd_bytes": fwd, "bwd_bytes": bwd, "plain_bwd_bytes": bwd_p,
            "errs": errs, "bitwise": True}


def phase17_rank(mesh, card):
    """One rank of phase 17: one qwen3-moe layer's MoE at full width (this
    rank's 32 of 128 experts; every rank draws the whole layer from one
    seed and reads its shard), x (2, 512, 2048) f32 replicated: the EP path
    against the local path, the int8 wire, the scheduled chunked dispatch at
    capacity factor 1.0 against the unscheduled one, and the ring all-gather
    against a gather of the shards; the int8 wire's backward
    (``int8_wire_backward``).  The path moves its buffers with
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
    # its backward: one f32 a row on the wire, the plain version's gradients
    out["int8_bwd"] = int8_wire_backward(int8, p, x, mesh, tag)
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
        f" (bounds 5e-4, 0.05), the int8 wire's backward {out['int8_bwd']}, "
        f"scheduled vs unscheduled at capacity 1.0 max "
        f"abs {out['sched_err']}, ring all-gather bitwise; launches on the "
        f"int8 wire {counts}, its sides {wire}; wall ms a call {times} on "
        f"{card}")
    return {"out": out, "counts": counts, "wire_sides": wire, "times": times,
            "backend": mesh.backend_note}


# -- phase 18: training at full qwen3-1.7b width on the card --------------------
TRAIN_ARCH = "qwen3_1p7b"
# one data-parallel rank's share of train_4k (256 x 4096, 8 microbatches,
# over 16 data ranks: configs/base.py)
TRAIN_B, TRAIN_S, TRAIN_MICRO, TRAIN_STEPS = 4, 4096, 2, 4
TRAIN_PARAMS = 1_720_574_976   # the reference's count_params (total)
GRAD_TOKENS = 512              # (a): one period in f32, B 1 x 512
RESUME_PERIODS = 2             # (c): 2 of the 28 layers
RESUME_B, RESUME_S = 4, 1024


def no_tf32():
    """TF32 off for an f32 comparison with the CPU; returns the undo."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def undo():
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return undo


def to_device(tree, dev):
    from repro_torch import _pytree
    return _pytree.tree_map_with_path(lambda _, t: t.to(dev), tree)


def batch_on(batch, dev):
    """A batch of numpy arrays or tensors, on ``dev``."""
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def phase18(dev, gen, card, drive):
    """Phase 18: training on the card.  The full qwen3-1.7b configuration
    (28 layers, bf16 compute on f32 masters, f32 AdamW moments, block
    remat) takes
    TRAIN_STEPS steps of B 4 x 4096 tokens in 2 microbatches on one
    repeated synthetic batch; then (a) one full-width period in f32 with
    the embedding and head, its loss and every gradient leaf against its
    CPU run, (b) one f32 step of each smoke config against its CPU run,
    (c) train, checkpoint (kernel 1 and kernel 3 on the staging), restore,
    resume bitwise the uninterrupted run, and serve, at 2 of the 28
    layers.  Returns the times."""
    import dataclasses
    import tempfile

    from repro_torch import _pytree, configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import agu, datapath
    from repro_torch.launch import dryrun
    from repro_torch.optim.adamw import AdamWConfig, cosine_schedule
    from repro_torch.serving import ServingEngine
    from repro_torch.train import step as T

    t_phase = time.perf_counter()

    def log18(msg):
        log(f"[training {time.perf_counter() - t_phase:.1f} s] {msg}")

    cfg = configs.get_config(TRAIN_ARCH)
    check(cfg.remat == "block" and cfg.dtype == torch.bfloat16,
          f"training: {cfg.name} remat {cfg.remat}, dtype {cfg.dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the bytes live before the cell: the dry run's count of its step's
    # peak (phase 22 (d), on meta) holds the state, the batch and the step
    base = torch.cuda.memory_allocated()
    state = T.init_state(cfg, SEED, device=dev)
    nparam = sum(t.numel() for t in _pytree.leaves(state["params"]))
    check(nparam == TRAIN_PARAMS,
          f"training: {nparam} parameters, not {TRAIN_PARAMS}")
    check({t.dtype for t in _pytree.leaves(state["params"])}
          == {torch.float32}, "training: the master parameters are not f32")
    shape = ShapeConfig("train_4k/16", TRAIN_S, TRAIN_B, "train",
                        TRAIN_MICRO)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B,
                     seed=SEED)
    batch = batch_on(ds.batch_at(0), dev)
    step = T.make_train_step(cfg, shape, AdamWConfig(warmup_steps=1))
    log18(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads, vocab {cfg.vocab}: "
          f"{nparam} f32 master parameters (bf16 compute) and f32 moments "
          f"made on the card; "
          f"B {TRAIN_B} x {TRAIN_S} tokens in {TRAIN_MICRO} microbatches")
    from torch.profiler import ProfilerActivity, profile
    losses, gnorms, wall = [], [], []
    by_name = {}                   # device ms by kernel, the last step
    first_peak = 0
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        if i == 1:
            # step 2's peak alone, the allocator warm (step 1 also made the
            # cuBLAS workspace)
            first_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        # the last step under the profiler (its trace takes seconds to read
        # back), the others timed bare
        prof = (profile(activities=[ProfilerActivity.CUDA])
                if i == TRAIN_STEPS - 1 else None)
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        if prof is not None:
            prof.__exit__(None, None, None)
            for k, v in device_ms_by_name(prof).items():
                by_name[k] = by_name.get(k, 0.0) + v
        if i == 1:
            step_peak = torch.cuda.max_memory_allocated() - base
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        log18(f"step {i + 1}: loss {losses[-1]:.4f}, grad norm "
              f"{gnorms[-1]:.4f}, lr {float(m['lr']):.3e}, {wall[-1]:.1f} ms")
    peak = max(first_peak, torch.cuda.max_memory_allocated())
    check(all(math.isfinite(v) for v in losses + gnorms),
          f"training: non-finite loss or grad norm {losses} {gnorms}")
    check(losses[-1] < losses[0],
          f"training: the loss did not fall over {TRAIN_STEPS} steps: "
          f"{losses}")
    check(int(state["step"]) == TRAIN_STEPS, "training: step counter")
    step_ms = statistics.median(wall[1:-1])
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = f"{1 - busy / wall[-1]:.1%}" if busy > 0 else "not measured"
    mf = dryrun.model_flops(cfg, shape, nparam, nparam)
    share = mf / (step_ms / 1e3) / BF16_FLOPS
    times = {"step_ms": step_ms, "first_step_ms": wall[0], "steps_ms": wall,
             "tokens_per_s": TRAIN_B * TRAIN_S / (step_ms / 1e3),
             "peak_bytes": peak, "step_peak_bytes": step_peak,
             "base_bytes": base, "device_busy_ms": busy,
             "idle_share": idle, "model_flops": mf,
             "model_flops_share": share, "losses": losses,
             "grad_norms": gnorms, "top_kernels_ms": top}
    log18(f"full {cfg.name}: {step_ms:.1f} ms a step (GPU wall, median of "
          f"steps 2-{TRAIN_STEPS - 1}; the first {wall[0]:.1f} ms), "
          f"{times['tokens_per_s']:.0f} tokens/s, peak "
          f"{peak / 1e9:.2f} GB allocated, the card idle {idle} over step "
          f"{TRAIN_STEPS} ({wall[-1]:.1f} ms under torch.profiler, "
          f"{busy:.1f} ms of device time), model_flops {mf:.4e} a step = "
          f"{share:.1%} of 989 TFLOP/s bf16; losses {losses}; step 2's "
          f"peak {step_peak} bytes above the {base} live before the state "
          f"was made (held to the dry run's count in phase 22 (d)) on "
          f"{card}")
    log18(f"device time by kernel in step {TRAIN_STEPS} (the ten largest, "
          "ms): "
          + "; ".join(f"{k[:80]} {v:.1f} ({v / busy:.1%})"
                      for k, v in top) if busy > 0 else
          "device time by kernel: not measured")
    del state, batch, step, m
    torch.cuda.empty_cache()

    # (a) one full-width period in f32, with the embedding and the head
    from repro_torch.models import lm
    cfg1 = dataclasses.replace(cfg, n_periods=1, dtype=torch.float32)
    p_cpu = lm.init_params(cfg1, SEED, device="cpu")
    g = torch.Generator().manual_seed(SEED)
    b_cpu = {"tokens": torch.randint(0, cfg.vocab, (1, GRAD_TOKENS),
                                     generator=g),
             "labels": torch.randint(0, cfg.vocab, (1, GRAD_TOKENS),
                                     generator=g)}
    undo = no_tf32()
    try:
        loss_d, _, grads_d = T._value_and_grad(cfg1, to_device(p_cpu, dev),
                                               batch_on(b_cpu, dev))
        grads_d = [None if x is None else x.cpu() for x in grads_d]
    finally:
        undo()
    loss_c, _, grads_c = on_cpu_one_thread(T._value_and_grad, cfg1, p_cpu,
                                           b_cpu)
    rel = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    check(rel <= 1e-5, f"training (a): loss {float(loss_d)} on the card, "
          f"{float(loss_c)} on the CPU")
    worst = 0.0
    for (path, _), gd, gc in zip(_pytree.flatten_with_paths(p_cpu), grads_d,
                                 grads_c):
        tol = 1e-4 * float(gc.abs().max()) + 1e-7
        err = max_abs_err(gd, gc)
        check(err <= tol, f"training (a): gradient {_pytree.path_key(path)} "
              f"{err} off its CPU run (bound {tol})")
        worst = max(worst, err / tol)
    log18(f"(a) one {cfg.name} period in f32 with embedding and head, 1 x "
          f"{GRAD_TOKENS} tokens (TF32 off): loss {float(loss_d)} vs CPU "
          f"{float(loss_c)} ({rel:.2e} relative, bound 1e-5); "
          f"{len(grads_c)} gradient leaves, the worst at {worst:.3f} of its "
          f"bound 1e-4 x max|g| + 1e-7")
    del p_cpu, grads_d, grads_c
    torch.cuda.empty_cache()

    # (b) one f32 step of each smoke config, card against CPU
    lr1 = float(cosine_schedule(AdamWConfig(), 1))
    smoke = {}
    for arch in configs.ARCHS:
        scfg = dataclasses.replace(configs.smoke_config(arch),
                                   dtype=torch.float32)
        s_cpu = T.init_state(scfg, SEED, device="cpu")
        sg = torch.Generator().manual_seed(SEED)
        sb = {}
        if scfg.family == "vlm":
            sb["embeds"] = torch.randn(4, 16, scfg.d_model, generator=sg)
            p3 = torch.arange(16)[None].expand(4, 16)
            sb["positions"] = torch.stack([p3, p3, p3])
        else:
            sb["tokens"] = torch.randint(0, scfg.vocab, (4, 16), generator=sg)
        if scfg.family == "audio":
            sb["audio_embeds"] = torch.randn(4, scfg.encoder_seq,
                                             scfg.d_model, generator=sg)
        sb["labels"] = torch.randint(0, scfg.vocab, (4, 16), generator=sg)
        sstep = T.make_train_step(scfg, ShapeConfig("smoke", 16, 4, "train",
                                                    2))
        want, wm = on_cpu_one_thread(sstep, s_cpu, sb)
        undo = no_tf32()
        try:
            got, gm = sstep(to_device(s_cpu, dev), batch_on(sb, dev))
        finally:
            undo()
        lrel = abs(float(gm["loss"]) - float(wm["loss"])) / abs(
            float(wm["loss"]))
        check(lrel <= 1e-5, f"training (b) {arch}: loss {float(gm['loss'])} "
              f"on the card, {float(wm['loss'])} on the CPU")
        pw = 0.0
        for a, c in zip(_pytree.leaves(got["params"]),
                        _pytree.leaves(want["params"])):
            bound = 2 * lr1 + 1e-5 * c.abs()
            over = float(((a.cpu() - c).abs() / bound).max())
            check(over <= 1.0, f"training (b) {arch}: a parameter "
                  f"{over:.3f} x its bound 2 lr(1) + 1e-5 |p| off the CPU's")
            pw = max(pw, over)
        smoke[arch] = (lrel, pw)
    log18(f"(b) one f32 step of the {len(smoke)} smoke configs, card vs CPU "
          f"(loss relative error, worst parameter as a share of its bound): "
          f"{smoke}")

    # (c) train, checkpoint, crash, restore, resume bitwise, serve
    cfg2 = dataclasses.replace(cfg, n_periods=RESUME_PERIODS)
    state0 = T.init_state(cfg2, SEED, device=dev)
    ds2 = SyntheticLM(vocab=cfg.vocab, seq_len=RESUME_S,
                      global_batch=RESUME_B, seed=SEED + 1)
    batches = [batch_on(ds2.batch_at(i), dev) for i in range(6)]
    step2 = T.make_train_step(cfg2, ShapeConfig("resume", RESUME_S, RESUME_B,
                                                "train", 2),
                              AdamWConfig(warmup_steps=1))
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-") as ck:
            mgr = CheckpointManager(ck, keep=2, stage_layout="MNM8N128",
                                    wire_compress_blocks=8)

            def train_save_restore():
                s = state0
                for i in range(4):
                    s, _ = step2(s, batches[i])
                    if (i + 1) % 2 == 0:
                        mgr.save(i + 1, s, blocking=False)
                mgr.wait()
                return s, mgr.restore(4, s, device=dev)

            (s4, restored), counts = drive(
                "training checkpoint", [agu.RELAYOUT, datapath.BLOCK],
                train_save_restore)
            paths = (dict(agu.RELAYOUT.paths), dict(datapath.BLOCK.paths))
            check(mgr.latest_step() == 4, "training (c): latest checkpoint")
        for a, b in zip(_pytree.leaves(restored), _pytree.leaves(s4)):
            assert_bitwise(a, b, "training (c): restored vs saved state")
        uninterrupted, resumed = s4, restored
        for i in range(4, 6):
            uninterrupted, _ = step2(uninterrupted, batches[i])
            resumed, m2 = step2(resumed, batches[i])
        for a, b in zip(_pytree.leaves(resumed),
                        _pytree.leaves(uninterrupted)):
            assert_bitwise(a, b, "training (c): resumed vs uninterrupted")
    finally:
        torch.use_deterministic_algorithms(False)
    check(int(resumed["step"]) == 6 and math.isfinite(float(m2["loss"])),
          "training (c): resumed step counter or loss")
    ckpt_kernels = checkpoint_kernels(s4, mgr, card, log18)
    del restored, uninterrupted, s4
    eng = ServingEngine(cfg2, resumed["params"], max_len=64, device=dev)
    toks = eng.generate({"tokens": batches[0]["tokens"][:2, :16]}, 4)
    check(tuple(toks.shape) == (2, 4) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, f"training (c): served {toks}")
    nparam2 = sum(t.numel() for t in _pytree.leaves(state0["params"]))
    log18(f"(c) {cfg.name} at {RESUME_PERIODS} of {cfg.n_layers} layers "
          f"({nparam2} parameters): 4 steps of B {RESUME_B} x {RESUME_S} "
          f"saved every 2 through the plane (MNM8N128 at rest, Compress "
          f"wire), restored bitwise, 2 more steps bitwise the uninterrupted "
          f"run (deterministic algorithms), served {toks.tolist()}; "
          f"checkpoint launches {counts} (kernel 1 by path {paths[0]}, "
          f"kernel 3 {paths[1]})")
    times["checkpoint_kernels"] = ckpt_kernels
    times["phase_s"] = time.perf_counter() - t_phase
    return times


def checkpoint_kernels(state, mgr, card, log18):
    """Phase 18 (c)'s kernels against their plain versions, on the leaves
    the checkpoint staged, outside the counted path: the embedding's save
    (MN -> the at-rest MNM8N128 through the Compress wire, kernel 3's rank-2
    path) against the plain chain and the plain relayout, its restore
    (kernel 1, MNM8N128 -> MN) against the plain relayout, and a stacked
    leaf's save (kernel 3's rank-2 path, its leading axis a batch) against
    the plain chain; each
    timed a launch beside its bound.  Returns the times."""
    from repro_torch import _pytree
    from repro_torch.core import layouts as L
    from repro_torch.core import plugin_compiler
    from repro_torch.kernels import _build, agu, datapath

    out = {}
    emb = state["params"]["embed"]["embed"]
    lay = mgr._at_rest_layout(emb)
    check(lay is not None and lay.name == "MNM8N128",
          f"training (c): the embedding's at-rest layout {lay}")
    M, N = emb.shape
    stacked = max((t for t in _pytree.leaves(state["params"])
                   if t.dim() == 3 and t.shape[-2] % 8 == 0),
                  key=lambda t: t.numel())
    plain = lambda x, d: datapath.plain(x, d.pre + d.post,  # noqa: E731
                                        d.src.layout, d.dst.layout)
    cases = [("save", emb, lay, "rank2",
              lambda: emb.view(M // 8, 8, N // 128, 128).permute(
                  0, 2, 1, 3).contiguous()),
             ("save stacked", stacked, None, "rank2", stacked.clone)]
    for what, x, at_rest, path, lib in cases:
        desc = mgr.stage_descriptor(x, None, at_rest)
        _build.reset_launches()
        got = mgr._stage(x, None, at_rest)
        torch.cuda.synchronize()
        check(set(datapath.BLOCK.paths) == {path}
              and agu.RELAYOUT.launches == 0,
              f"training (c) {what}: kernel 3 paths {datapath.BLOCK.paths}, "
              f"kernel 1 {agu.RELAYOUT.launches}; expected the {path} path")
        kpaths = dict(datapath.BLOCK.paths)
        assert_bitwise(got, plain(x, desc), f"training (c) {what} vs the "
                       "plain chain")
        if at_rest is not None:
            assert_bitwise(got, agu.relayout_plain(x, L.MN, at_rest, False),
                           f"training (c) {what} vs the plain relayout")
        assert_bitwise(lib(), got, f"training (c) {what} library yardstick")
        run = plugin_compiler.compile_local(desc)
        out[what] = {"kernel": "block_datapath", "paths": kpaths,
                     "shape": f"{tuple(x.shape)} {x.dtype}",
                     "ms": gpu_ms(lambda: run(x)),
                     "plain_ms": gpu_ms(lambda: plain(x, desc)),
                     "library_ms": gpu_ms(lib),
                     "bound_ms": bound_ms(nbytes(x, got))}
        del got
    at = mgr._stage(emb, None, lay)
    _build.reset_launches()
    back = agu.relayout_kernel(at, lay, L.MN)
    torch.cuda.synchronize()
    check(agu.RELAYOUT.paths == {"direct": 1},
          f"training (c) restore: kernel 1 paths {agu.RELAYOUT.paths}")
    assert_bitwise(back, agu.relayout_plain(at, lay, L.MN, False),
                   "training (c) restore vs the plain relayout")
    assert_bitwise(back, emb, "training (c) restore vs the saved leaf")
    lib = lambda: at.view(M // 8, N // 128, 8, 128).permute(  # noqa: E731
        0, 2, 1, 3).reshape(M, N)
    assert_bitwise(lib(), back, "training (c) restore library yardstick")
    out["restore"] = {"kernel": "agu_relayout", "paths": {"direct": 1},
                      "shape": f"{tuple(emb.shape)} {emb.dtype}",
                      "ms": gpu_ms(lambda: agu.relayout_kernel(at, lay, L.MN)),
                      "plain_ms": gpu_ms(lambda: agu.relayout_plain(
                          at, lay, L.MN, False)),
                      "library_ms": gpu_ms(lib),
                      "bound_ms": bound_ms(nbytes(at, back))}
    del at, back
    for what, r in out.items():
        log18(f"(c) the checkpoint's {r['kernel']} on the {what} "
              f"({r['shape']}, paths {r['paths']}): bitwise the plain "
              f"version; {r['ms']:.4f} ms a call, plain {r['plain_ms']:.4f}, "
              f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_ms'] / r['ms']:.1%} of the bound) on {card}")
    return out


# -- phase 19: data-parallel training, 4 ranks on the one card ------------------
DP_ARCH = "qwen2_0p5b"
DP_PARAMS = 494_032_768        # the reference's count_params (total)
DP_B, DP_S = 4, 1024           # global batch: one sequence a rank


def fingerprint(tree):
    """Per-leaf (int64 sum of the bits, int64 sum of every third element's
    bits): equal trees have equal fingerprints, as ranks compare them.
    The sums read the leaves in place (no copy of a leaf)."""
    from repro_torch import _pytree
    out = []
    for t in _pytree.leaves(tree):
        b = bits(t).reshape(-1)
        out.append((int(b.sum(dtype=torch.int64)),
                    int(b[1::3].sum(dtype=torch.int64))))
    return out


def phase19_rank(mesh, card):
    """One rank of phase 19: the full qwen2-0.5b configuration in f32, the
    same state in every rank (one seed), the global batch of B 4 x 1024
    tokens, one sequence a rank.  One DP step with the plain reduce, one
    with the int8 codec, each leaf's all-reduce a reduce descriptor over
    gloo; the ranks' new states must agree bitwise.  Rank 0 then holds the
    plain step to the single-process step on the card and broadcasts the
    new parameters over a ring(4) fabric, each replica a buffer of its own
    and bitwise the source.  No datapath kernel is on this path: the
    reduce lowers to the collectives (the int8 codec's Quantize /
    Dequantize have no emit form) and every broadcast hop is MN -> MN,
    kernel 1's identity plan, a copy, in both packages."""
    import dataclasses

    from repro_torch import _pytree, configs
    from repro_torch import sharding as S
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import remote
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _build, agu
    from repro_torch.runtime import DistributedScheduler, Topology, telemetry
    from repro_torch.runtime.trace import capture
    from repro_torch.train import step as T
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    torch.set_num_threads(2)             # four ranks share the host's cores
    dev, n, r = mesh.device, mesh.world_size, S.axis_index("dp")
    tag = f"[dp training rank {r}]"
    cfg = dataclasses.replace(configs.get_config(DP_ARCH),
                              dtype=torch.float32)
    state = T.init_state(cfg, SEED, device=dev)
    nparam = sum(t.numel() for t in _pytree.leaves(state["params"]))
    check(nparam == DP_PARAMS, f"{tag} {nparam} parameters")
    raw = SyntheticLM(vocab=cfg.vocab, seq_len=DP_S, global_batch=DP_B,
                      seed=SEED).batch_at(0)
    batch = batch_on(raw, dev)
    shape = ShapeConfig("dp", DP_S, DP_B, "train", 1)
    undo = no_tf32()
    out, keep = {}, {}
    try:
        for name, compressed in (("plain", False), ("compressed", True)):
            step = T.make_dp_train_step(cfg, shape, mesh=mesh, axis="dp",
                                        compressed=compressed)
            telemetry.reset("wire")
            torch.cuda.synchronize()
            dist.barrier()                  # the ranks start the step together
            with capture(name=name) as tr, \
                    profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                new, m = step(state, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            busy = device_busy_ms(prof)
            wire = remote.wire_stats()
            red = [e for e in tr.xdma_events() if e.endpoint == "reduce"]
            check(len(red) == len(_pytree.leaves(state["params"])) + 1,
                  f"{tag} {name}: {len(red)} reduce events")
            if compressed:
                mats = [e for e in red if e.logical_shape
                        and len(e.logical_shape) >= 2]
                check(mats and all(e.wire_nbytes and e.wire_nbytes < e.nbytes
                                   for e in mats),
                      f"{tag} compressed: a matrix leaf's wire is not below "
                      "its payload")
            out[name] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "ms": ms, "busy_ms": busy,
                # the ledger counts a reduce twice (reduce-scatter and
                # all-gather), on its wire and in its payload
                "wire_bytes": sum(e.wire_nbytes or e.nbytes for e in red),
                "ledger_bytes": sum(e.nbytes for e in red),
                "host_hop_bytes": wire.get("host_hop_bytes", 0),
                "fingerprint": fingerprint(new)}
            if r == 0 and not compressed:   # on the host: four ranks
                keep[name] = to_device(new["params"], "cpu")  # share the card
            del new
        check(abs(out["compressed"]["loss"] - out["plain"]["loss"]) < 1e-5,
              f"{tag} compressed loss {out['compressed']['loss']} vs plain "
              f"{out['plain']['loss']}")
        del state["opt"]
        torch.cuda.empty_cache()
        if r == 0:
            # the single-process step over the same global batch
            ref_state = T.init_state(cfg, SEED, device=dev)
            ref, rm = T.make_train_step(cfg, shape)(ref_state, batch)
            del ref_state
            out["ref_loss"] = float(rm["loss"])
            check(abs(out["plain"]["loss"] - out["ref_loss"]) < 1e-5,
                  f"{tag} DP loss {out['plain']['loss']} vs single-process "
                  f"{out['ref_loss']}")
            out["ref_param_err"] = max(
                max_abs_err(a, b.cpu()) for a, b in zip(
                    _pytree.leaves(keep["plain"]),
                    _pytree.leaves(ref["params"])))
            check(out["ref_param_err"] < 1e-4,
                  f"{tag} DP parameters {out['ref_param_err']} off the "
                  "single-process step's (bound 1e-4)")
            del ref
            torch.cuda.empty_cache()
            # the new parameters to three replicas through the plane
            source = to_device(keep.pop("plain"), dev)
            torch.cuda.synchronize()
            _build.reset_launches()
            sched = DistributedScheduler(Topology.ring(4), name="dp_bcast")
            t0 = time.perf_counter()
            reps = T.dp_param_broadcast(source, scheduler=sched)
            torch.cuda.synchronize()
            out["bcast_ms"] = (time.perf_counter() - t0) * 1e3
            # every hop is MN -> MN: kernel 1's identity plan, a copy of the
            # buffer (as the reference lowers it), so no kernel launches
            out["bcast_counts"] = {k.name: k.launches for k in _build.KERNELS}
            check(len(reps) == 3, f"{tag} {len(reps)} replicas")
            for rep in reps:
                for a, b in zip(_pytree.leaves(rep), _pytree.leaves(source)):
                    assert_bitwise(a, b, f"{tag} broadcast replica")
                    check(a.dim() < 2 or a.data_ptr() != b.data_ptr(),
                          f"{tag} a broadcast replica aliases the source")
            out["bcast_bytes"] = sum(t.numel() * t.element_size()
                                     for t in _pytree.leaves(source)
                                     if t.dim() >= 2)
            del reps, sched, source
    finally:
        undo()
    log(f"{tag} plain {out['plain']['ms']:.1f} ms, compressed "
        f"{out['compressed']['ms']:.1f} ms a step; losses "
        f"{out['plain']['loss']} / {out['compressed']['loss']} on {card}")
    out["backend"] = mesh.backend_note
    return out


def phase19(card):
    """Phase 19: ``phase19_rank`` in a world of 4 processes on the card
    (gloo; NCCL where there is a card a rank); the ranks' states must agree
    bitwise after each step.  Returns the times."""
    import tempfile
    from repro_torch import sharding as S

    # four ranks of about 15 GB each share the card with this process:
    # release what the earlier phases left (reference cycles included)
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[dp training] this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; "
        f"{free / 1e9:.1f} of {total / 1e9:.1f} GB of the card free")
    # the ranks' allocators grow segments in place rather than caching
    # blocks they cannot reuse (set for the spawned ranks alone: this
    # process's allocator started long ago)
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip-smoke-dp-") as work:
            dp = S.run_spmd(phase19_rank, (RANKS,), ("dp",), args=(card,),
                            device="cuda", workdir=work)
    finally:
        if saved is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved
    dp_s = time.perf_counter() - t0
    for name in ("plain", "compressed"):
        prints = [rk[name]["fingerprint"] for rk in dp]
        check(all(p == prints[0] for p in prints),
              f"dp training: the ranks' states after the {name} step differ")
    dp_times = {}
    for name in ("plain", "compressed"):
        wall = max(rk[name]["ms"] for rk in dp)
        # each rank's profiler sees its own kernels; the four processes
        # time-share the card, so their kernel times overlap and do not add
        # up to the card's busy time, which is not measured here
        shares = [rk[name]["busy_ms"] / rk[name]["ms"] for rk in dp]
        dp_times[name] = {
            "step_ms": wall, "rank_busy_share": shares,
            "idle_share": "not measured (4 processes share the card)",
            "wire_bytes": dp[0][name]["wire_bytes"],
            "ledger_bytes": dp[0][name]["ledger_bytes"],
            "host_hop_bytes": dp[0][name]["host_hop_bytes"],
            "loss": dp[0][name]["loss"]}
        log(f"[dp training] {name}: {wall:.1f} ms a step (slowest rank), "
            f"the ledger's reduce events {dp_times[name]['wire_bytes']} "
            f"wire bytes for {dp_times[name]['ledger_bytes']} payload bytes "
            f"a rank (both phases of each reduce), "
            f"host hop {dp_times[name]['host_hop_bytes']} bytes a rank; "
            f"each rank's own kernels busy "
            f"{[f'{x:.1%}' for x in shares]} of its step (torch.profiler; "
            f"the card's idle share not measured: the ranks' kernels "
            f"overlap in time) on {card}")
    r0 = dp[0]
    log(f"[dp training] 4 ranks ({dp[0]['backend']}) on "
        f"{DP_ARCH} f32, B {DP_B} x {DP_S}: loss {r0['plain']['loss']} "
        f"(single-process {r0['ref_loss']}), parameters {r0['ref_param_err']} "
        f"off the single-process step (bound 1e-4), compressed loss "
        f"{r0['compressed']['loss']}; the ranks' states agree bitwise; the "
        f"broadcast of {r0['bcast_bytes']} bytes to 3 replicas "
        f"{r0['bcast_ms']:.1f} ms wall, bitwise, launches "
        f"{r0['bcast_counts']}; phase {dp_s:.1f} s with 4 process starts on "
        f"{card}")
    dp_times.update(ref_loss=r0["ref_loss"],
                    ref_param_err=r0["ref_param_err"],
                    bcast_ms=r0["bcast_ms"], bcast_bytes=r0["bcast_bytes"],
                    bcast_counts=r0["bcast_counts"], phase_s=dp_s)
    return dp_times


TP_ARCH = "qwen3_1p7b"
TP_PERIODS = 2                 # 2 of the 28 layers
TP_MESH = (2, 2)               # ("data", "model"): head-parallel at model 2
TP_B, TP_S, TP_MICRO, TP_STEPS = 4, 512, 2, 2
LAUNCH_KW = dict(steps=3, batch=4, seq=64, smoke=True, ckpt_every=2,
                 microbatches=1, lr=3e-4, resume=True, seed=SEED)


@contextlib.contextmanager
def expandable_segments():
    """The ranks a world spawns allocate in expandable segments (four
    processes share the card's memory; fragments of one are lost to the
    others)."""
    saved = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = saved


def phase20_config():
    """qwen3-1.7b at full width, 2 of its 28 layers, in f32."""
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(TP_ARCH),
                               n_periods=TP_PERIODS, dtype=torch.float32)


def tree_bytes(tree):
    from repro_torch import _pytree
    return sum(t.numel() * t.element_size() for t in _pytree.leaves(tree))


def phase20_rank(mesh, card, ckpt_dir):
    """One rank of phase 20 (a): the sharded step (``make_train_step`` with
    ``mesh=``) on a (2, 2) ("data", "model") mesh, qwen3-1.7b at full
    width cut to 2 layers, f32 with TF32 off, AdamW with no warmup (every
    weight moves about 3e-4 a step): the whole parameters drawn on the card
    one weight at a time and kept on the host, this rank's blocks put on
    the card; 2 steps of B 4 x 512 in 2 microbatches.  Each rank reads its
    peak memory in the init, the steps and a resume (the state gathered
    onto the host, rank 0 writing the whole-leaf checkpoint, every rank at
    once restoring its blocks through ``launch.train.restore_sharded``, as
    the launcher does, bitwise its live blocks), its step times and its
    collective ledger;
    rank 0 then runs the single-process step on the same seed and batches
    and holds the sharded run to it."""
    import dataclasses

    from repro_torch import _pytree
    from repro_torch import sharding as S
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as LT
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import telemetry
    from repro_torch.train import step as T
    import torch.distributed as dist

    torch.set_num_threads(2)             # four ranks share the host's cores
    dev, r = mesh.device, mesh.rank
    tag = f"[sharded training rank {r}]"
    shape = ShapeConfig("tp", TP_S, TP_B, "train", TP_MICRO)
    opt_cfg = AdamWConfig(warmup_steps=0)
    plain_cfg = phase20_config()
    cfg = dataclasses.replace(plain_cfg.with_axes(M.axes_for(mesh, shape)),
                              fsdp=True)
    specs, shapes = M.state_specs(cfg, mesh)
    fsdp = sorted(_pytree.path_key(path) for (path, _), sp in zip(
        _pytree.flatten_with_paths(shapes["params"]),
        M.spec_leaves(specs["params"], shapes["params"])) if "data" in sp)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=TP_S, global_batch=TP_B,
                     seed=SEED)
    batches = [batch_on(ds.batch_at(i), dev) for i in range(TP_STEPS)]
    undo = no_tf32()
    out = {"fsdp": fsdp, "backend": mesh.backend_note}
    try:
        torch.cuda.reset_peak_memory_stats()
        state = T.init_state(cfg, SEED, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        out["init_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["local_state_bytes"] = tree_bytes(state)
        out["state_bytes"] = tree_bytes(shapes)
        out["max_leaf_bytes"] = max(t.numel() * t.element_size()
                                    for t in _pytree.leaves(shapes))
        # the card holds this rank's blocks and, while drawing, one whole
        # weight: never the whole state
        check(out["init_peak_bytes"] <= out["local_state_bytes"]
              + out["max_leaf_bytes"],
              f"{tag} init peak {out['init_peak_bytes']} bytes")
        step = T.make_train_step(cfg, shape, opt_cfg, mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        telemetry.reset("collectives")
        out["ms"], out["losses"], out["grad_norms"] = [], [], []
        for b in batches:
            dist.barrier()                 # the ranks start each step together
            t0 = time.perf_counter()
            state, m = step(state, b)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["ledger"] = S.collective_stats()

        # the resume: the checkpoint written whole, restored by blocks
        t0 = time.perf_counter()
        whole = M.gather_tree(state, specs, mesh, device="cpu")
        mgr = CheckpointManager(ckpt_dir)
        if r == 0:
            mgr.save(TP_STEPS, whole, blocking=True)
        else:
            del whole
        live = to_device(state, "cpu")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()                  # the checkpoint is written
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        resumed = LT.restore_sharded(mgr, TP_STEPS, cfg, mesh)
        torch.cuda.synchronize()
        out["resume_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        for a, b in zip(_pytree.leaves(resumed), _pytree.leaves(live)):
            assert_bitwise(a.cpu(), b, f"{tag} the resumed state")
        del resumed
        dist.barrier()
        out["resume_s"] = time.perf_counter() - t0
        check(out["resume_peak_bytes"] <= out["local_state_bytes"]
              + out["max_leaf_bytes"],
              f"{tag} resume peak {out['resume_peak_bytes']} bytes")
        del live
        if r != 0:
            return out
        # rank 0: the single-process step on the same seed and batches (the
        # other ranks have left the card)
        ref_state = T.init_state(plain_cfg, SEED, device=dev)
        start = ref_state["params"]
        ref_step = T.make_train_step(plain_cfg, shape, opt_cfg)
        out["ref_losses"], out["ref_grad_norms"] = [], []
        for b in batches:
            ref_state, rm = ref_step(ref_state, b)
            out["ref_losses"].append(float(rm["loss"]))
            out["ref_grad_norms"].append(float(rm["grad_norm"]))
        pairs = list(zip(_pytree.leaves(whole["params"]),
                         _pytree.leaves(ref_state["params"]),
                         _pytree.leaves(start)))
        out["param_err"] = max(max_abs_err(a.to(dev), b) for a, b, _ in pairs)
        out["min_move"] = min(max_abs_err(b, p0) for _, b, p0 in pairs)
        out["grad_norm_err"] = max(
            abs(a - b) / b for a, b in zip(out["grad_norms"],
                                           out["ref_grad_norms"]))
        for a, b in zip(out["losses"], out["ref_losses"]):
            # the tied head puts the loss near 1777, where an f32 ulp is
            # 1.2e-4; the two programs sum in different orders: 8 ulps
            check(abs(a - b) <= 1e-3,
                  f"{tag} sharded loss {a} vs single-process {b}")
        # Adam's update does not see a gradient's scale; the norm does
        check(out["grad_norm_err"] <= 1e-5,
              f"{tag} gradient norms {out['grad_norms']} vs single-process "
              f"{out['ref_grad_norms']}")
        # the bound below means something only if every leaf moved further
        check(out["min_move"] > 3e-4,
              f"{tag} a leaf moved only {out['min_move']} in the steps")
        check(out["param_err"] < 1e-4,
              f"{tag} gathered parameters {out['param_err']} off the "
              "single-process step's (bound 1e-4)")
    finally:
        undo()
    log(f"{tag} losses {out['losses']} (single-process "
        f"{out['ref_losses']}), gradient norms {out['grad_norms']} "
        f"(single-process {out['ref_grad_norms']}), parameters "
        f"{out['param_err']} off (each leaf moved at least "
        f"{out['min_move']}) on {card}")
    return out


# (c)-(f): the other slots under the sharded trainer, one (2, 2) world
SLOT_B, SLOT_S, WHISPER_S, SLOT_STEPS = 4, 512, 448, 2
# AdamW with no warmup, and an eps at which the first update is not
# lr * sign(g) for a gradient within its rounding of zero: at the default
# 1e-8 jamba's Mamba put elements up to 1.3e-4 apart between the sharded and
# the single-process step (the bound is 1e-4).  At 1e-5 an element's update
# moves at most lr / eps = 30 times its gradient's error, and an element
# whose gradient is above 1e-5 moves by about lr (at 1e-4 a Mamba leaf moved
# only 1.8e-4 in the two steps, under the 3e-4 that makes the bound bite)
SLOT_OPT = dict(warmup_steps=0, eps=1e-5)
# xlstm-125m's tied head puts its logits near 300: one f32 ulp on every
# weight moves its gradient by up to 8e-4 of a leaf's scale at 64 tokens
# and 5.5e-2 at 512, and the sharded gradient is 2.5e-4 and 2.2e-4 off the
# single-process one (scripts/sharded_grad_gap.py, CPU).
# Adam's update then parts the elements whose gradient lies within that of
# zero by up to 2 lr: the second step's gradient norm came 1.1 % apart on
# the card, its loss 9.8e-4.  (e) is held by its first step instead: the
# sharded gradient no further from the single-process one, leaf by leaf as
# a share of its scale, than twice what one ulp on every weight moves the
# single-process gradient (measured in the same run), the first gradient
# norm within 1e-4 and the first loss within 1e-3; it takes that step alone
FIRST_STEP_HELD = ("xlstm",)
MOE_DAUX = 0.5                 # the MoE layer check's aux cotangent
MOE_BOUND = 1e-4               # its bound, of each tensor's largest value


def phase20_slot_configs():
    """(c)-(f)'s configs at full width, in f32: qwen3-moe-30b-a3b cut to 1
    of its 48 layers; jamba-1.5-large cut to one dense Mamba slot (2.08 B
    parameters, a 25.0 GB state: its MoE slots left out, one holds 9.7 B
    parameters and (c) covers MoE at full width; its attention slot left
    out too, which (a) covers at full width: with it, 2.84 B parameters and
    a 34.0 GB state, the single-process step it is held to holds the old
    and the new state and the gradients at once, about 91 GB, and the four
    ranks' steps ran the card out of memory); xlstm-125m cut to one period
    (3 mLSTM and 1 sLSTM layer of its 12) and whisper-small to 4 + 4 of
    its 12 + 12 layers (with phase 22 the run needs the time these cuts
    save)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.configs.base import MAMBA, LayerSpec
    f32 = torch.float32
    return {
        "moe": dataclasses.replace(configs.get_config("qwen3_moe_30b_a3b"),
                                   n_periods=1, dtype=f32),
        "mamba": dataclasses.replace(
            configs.get_config("jamba_1p5_large_398b"),
            period=(LayerSpec(MAMBA),), n_periods=1, dtype=f32),
        "xlstm": dataclasses.replace(configs.get_config("xlstm_125m"),
                                     n_periods=1, dtype=f32),
        "whisper": dataclasses.replace(configs.get_config("whisper_small"),
                                       n_periods=4, encoder_layers=4,
                                       dtype=f32)}


def moe_layer_check(mesh, cfg, plain_cfg, tag):
    """(c)'s MoE layer alone, one layer's weights drawn from the seed: the
    sharded layer (this rank's data rows, its model-axis blocks of the
    weights: the expert-parallel path with the sequence split) against
    the single-process emulation of the reference's sharded semantics, on
    rank 0: the port's local layer applied to each (data block, sequence
    slice) with its own capacity, the aux the mean over the slices.  Output,
    aux, input gradient and every weight gradient (the aux's cotangent
    ``MOE_DAUX``) within ``MOE_BOUND`` of each tensor's largest value."""
    from repro_torch import _pytree
    from repro_torch import sharding as S
    from repro_torch.launch import mesh as M
    from repro_torch.layers import moe as MOE
    from repro_torch.layers._init import Init
    import torch.distributed as dist

    dev, r = mesh.device, mesh.rank
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    p = {"ffn": MOE.init_moe(Init(gen, dev), plain_cfg)}
    x = torch.randn((SLOT_B, SLOT_S, cfg.d_model), generator=gen,
                    device=dev)
    dy = torch.randn(x.shape, generator=gen, device=dev)
    dp, n = S.axis_size("data"), S.axis_size("model")
    specs = M.fit_specs(mesh, M.infer_param_specs(p, cfg.axes), p)
    local = M.shard_tree(p, specs, mesh)
    leaves = [t.requires_grad_() for t in _pytree.leaves(local)]
    local = _pytree.unflatten(local, leaves)
    rows = SLOT_B // dp
    i = S.axis_index("data")
    xr = x[i * rows:(i + 1) * rows].clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, aux = MOE.moe_apply(cfg, local["ffn"], xr, mesh=mesh)
    got = torch.autograd.grad([y, aux], [xr] + leaves,
                              [dy[i * rows:(i + 1) * rows],
                               torch.tensor(MOE_DAUX / dp, device=dev)])
    torch.cuda.synchronize()
    layer_ms = (time.perf_counter() - t0) * 1e3
    y, aux = S.all_gather(y.detach(), "data", 0), aux.detach()
    dx = S.all_gather(got[0], "data", 0)
    grads = [S.all_reduce(g, "data") for g in _pytree.leaves(M.gather_tree(
        _pytree.unflatten(local, list(got[1:])), specs, mesh))]
    out = {"layer_ms": layer_ms}
    if r == 0:
        # every (data block, sequence slice) on its own, as the mesh routes
        pw = {k: v.detach().clone().requires_grad_()
              for k, v in p["ffn"].items()}
        xw = x.clone().requires_grad_()
        Sl = SLOT_S // n
        ys, auxs = [], []
        for b in range(dp):
            row = []
            for s in range(n):
                ye, ae = MOE.moe_apply(
                    plain_cfg, pw, xw[b * rows:(b + 1) * rows, s * Sl:(s + 1) * Sl])
                row.append(ye)
                auxs.append(ae)
            ys.append(torch.cat(row, 1))
        ye, ae = torch.cat(ys, 0), torch.stack(auxs).mean()
        want = torch.autograd.grad(
            [ye, ae], [xw] + [pw[k] for k in sorted(pw)],
            [dy, torch.tensor(MOE_DAUX, device=dev)])
        ye, ae = ye.detach(), ae.detach()
        errs = {"y": max_abs_err(y, ye) / float(ye.abs().max()),
                "aux": abs(float(aux) - float(ae)) / abs(float(ae)),
                "dx": max_abs_err(dx, want[0]) / float(want[0].abs().max())}
        for k, g, w in zip(sorted(pw), grads, want[1:]):
            errs[k] = max_abs_err(g, w) / float(w.abs().max())
        out["errs"] = errs
        for k, e in errs.items():
            check(e <= MOE_BOUND, f"{tag} the MoE layer's {k} is {e} of its "
                  f"scale off the slice-wise emulation (bound {MOE_BOUND})")
    del p, local, leaves, got, grads
    dist.barrier()
    return out


def slot_case(mesh, card, name, plain_cfg):
    """One of (c)-(f) in this rank: the sharded step (``make_train_step``
    with ``mesh=``), 2 steps of B 4 (448 decoder tokens for whisper, 512
    otherwise; 1 for a case held by its first step) in one microbatch,
    AdamW ``SLOT_OPT``, TF32 off; its times,
    peak memory and collective ledger.  (c) checks its MoE layer first and
    that every block of every leaf moved; (d)-(f) hold rank 0's gathered
    parameters, losses and gradient norms to the single-process step (on
    the card once the other ranks have freed theirs) with (a)'s bounds."""
    import dataclasses

    from repro_torch import _pytree
    from repro_torch import sharding as S
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import remote
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import mesh as M
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import telemetry
    from repro_torch.train import step as T
    import torch.distributed as dist

    dev, r = mesh.device, mesh.rank
    tag = f"[sharded {name} rank {r}]"
    seq = WHISPER_S if name == "whisper" else SLOT_S
    shape = ShapeConfig(name, seq, SLOT_B, "train", 1)
    opt_cfg = AdamWConfig(**SLOT_OPT)
    cfg = dataclasses.replace(plain_cfg.with_axes(M.axes_for(mesh, shape)),
                              fsdp=True)
    specs, shapes = M.state_specs(cfg, mesh)
    out = {"fsdp": sorted(_pytree.path_key(path) for (path, _), sp in zip(
        _pytree.flatten_with_paths(shapes["params"]),
        M.spec_leaves(specs["params"], shapes["params"])) if "data" in sp),
        "state_bytes": tree_bytes(shapes)}
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=SLOT_B,
                     seed=SEED, family=cfg.family, d_model=cfg.d_model,
                     encoder_seq=cfg.encoder_seq)
    # a case held by its first step takes that step alone
    n_steps = 1 if name in FIRST_STEP_HELD else SLOT_STEPS
    batches = [batch_on(ds.batch_at(i), dev) for i in range(n_steps)]
    if name == "moe":
        out.update(moe_layer_check(mesh, cfg, plain_cfg, tag))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = T.init_state(cfg, SEED, device=dev, mesh=mesh)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["init_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["local_state_bytes"] = tree_bytes(state)
    start = [t.cpu() for t in _pytree.leaves(state["params"])]
    grads0 = None
    if name in FIRST_STEP_HELD:          # the first step's gradient, whole
        _, _, g = T._value_and_grad(cfg, state["params"],
                                    T._data_block(batches[0], "data"),
                                    mesh=mesh)
        grads0 = _pytree.leaves(M.gather_tree(
            _pytree.unflatten(state["params"], g), specs["params"], mesh,
            device="cpu"))
        del g
    step = T.make_train_step(cfg, shape, opt_cfg, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    telemetry.reset("collectives")
    telemetry.reset("wire")
    out["ms"], out["losses"], out["grad_norms"] = [], [], []
    for b in batches:
        dist.barrier()                   # the ranks start each step together
        t0 = time.perf_counter()
        state, m = step(state, b)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["ledger"] = S.collective_stats()
    out["wire"] = remote.wire_stats()    # the MoE plane's transfers
    check(all(math.isfinite(v) for v in out["losses"]),
          f"{tag} losses {out['losses']}")
    # every block of every leaf moved (a rank's block of a leaf is its own)
    moved = [max_abs_err(t.cpu(), s) for t, s in zip(
        _pytree.leaves(state["params"]), start)]
    out["min_block_move"] = min(moved)
    check(out["min_block_move"] > 0, f"{tag} a block did not move")
    log(f"{tag} {out['ms']} ms a step, losses {out['losses']}, peak "
        f"{out['peak_bytes'] / 1e9:.3f} GB, on {card}")
    whole = (None if name == "moe" or grads0 is not None else M.gather_tree(
        state["params"], specs["params"], mesh, device="cpu"))
    del state, start
    gc.collect()
    torch.cuda.empty_cache()
    if name == "moe" or r != 0:
        dist.barrier()
        return out
    # rank 0: the single-process step on the same seed and batches, alone
    # on the card (the other ranks wait at the barrier, their state freed)
    try:
        ref_state = T.init_state(plain_cfg, SEED, device=dev)
        start = [t.cpu() for t in _pytree.leaves(ref_state["params"])]
        if grads0 is not None:
            params = ref_state["params"]
            _, _, g = T._value_and_grad(plain_cfg, params, batches[0])
            up = _pytree.unflatten(params, [
                torch.nextafter(p, torch.full_like(p, math.inf))
                for p in _pytree.leaves(params)])
            _, _, gu = T._value_and_grad(plain_cfg, up, batches[0])

            def gap(a, b):               # of b's scale, floor 1e-6
                return max_abs_err(a, b) / (float(b.abs().max()) + 1e-3)
            out["grad_err"] = max(gap(a.to(dev), b)
                                  for a, b in zip(grads0, g))
            out["ulp_err"] = max(gap(u, b) for u, b in zip(gu, g))
            del g, gu, up
        ref_step = T.make_train_step(plain_cfg, shape, opt_cfg)
        out["ref_losses"], out["ref_grad_norms"] = [], []
        # a case held by its first step runs one single-process step
        for b in batches[:1] if grads0 is not None else batches:
            ref_state, rm = ref_step(ref_state, b)
            out["ref_losses"].append(float(rm["loss"]))
            out["ref_grad_norms"].append(float(rm["grad_norm"]))
        out["grad_norm_err"] = max(
            abs(a - b) / b for a, b in zip(out["grad_norms"],
                                           out["ref_grad_norms"]))
        if grads0 is None:
            names = [_pytree.path_key(path) for path, _ in
                     _pytree.flatten_with_paths(ref_state["params"])]
            pairs = list(zip(_pytree.leaves(whole),
                             _pytree.leaves(ref_state["params"]), start))
            out["param_err"] = max(max_abs_err(a.to(dev), b)
                                   for a, b, _ in pairs)
            moves = {k: max_abs_err(b.cpu(), p0)
                     for k, (_, b, p0) in zip(names, pairs)}
            # sLSTM's input-gate bias has no gradient: a constant shift of
            # a channel's log input gate scales its c and n alike, and
            # h = o c / n
            out["still"] = sorted(k for k in moves
                                  if k.endswith("slstm/b_i"))
            out["min_move"] = min(v for k, v in moves.items()
                                  if k not in out["still"])
            del pairs
        del ref_state, whole
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    for a, b in zip(out["losses"], out["ref_losses"]):
        check(abs(a - b) <= 1e-3,
              f"{tag} sharded loss {a} vs single-process {b}")
    if grads0 is not None:
        check(out["grad_norm_err"] <= 1e-4, f"{tag} first gradient norm "
              f"{out['grad_norm_err']} relative off the single-process "
              "step's")
        check(out["grad_err"] <= 2 * out["ulp_err"],
              f"{tag} a first-step gradient leaf {out['grad_err']} of its "
              f"scale off the single-process one, one ulp on every weight "
              f"{out['ulp_err']}")
        return out
    check(out["grad_norm_err"] <= 1e-5,
          f"{tag} gradient norms {out['grad_norms']} vs single-process "
          f"{out['ref_grad_norms']}")
    check(out["min_move"] > 3e-4,
          f"{tag} a leaf moved only {out['min_move']} in the steps")
    check(out["param_err"] < 1e-4,
          f"{tag} gathered parameters {out['param_err']} off the "
          "single-process step's (bound 1e-4)")
    return out


def phase20_slots_rank(mesh, card):
    """One rank of phase 20 (c)-(f), in turn, TF32 off for the sharded
    steps too (the single-process step they are held to runs without it).
    """
    torch.set_num_threads(2)             # four ranks share the host's cores
    undo = no_tf32()
    try:
        return {name: slot_case(mesh, card, name, cfg)
                for name, cfg in phase20_slot_configs().items()}
    finally:
        undo()


def phase20_slots(card):
    """Phase 20 (c)-(f): ``phase20_slots_rank`` in a world of 4 gloo ranks
    on the card, each case logged with its step times, its checks, its
    peak memory a rank and its collective bytes a step; returns the cases'
    numbers and the world's seconds."""
    import tempfile

    from repro_torch import sharding as S

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with expandable_segments(), \
            tempfile.TemporaryDirectory(prefix="chip-smoke-slots-") as work:
        slots = S.run_spmd(phase20_slots_rank, TP_MESH, ("data", "model"),
                           args=(card,), device="cuda", workdir=work)
    slots_s = time.perf_counter() - t0
    slot_times = {}
    for name in phase20_slot_configs():
        cases = [rk[name] for rk in slots]
        c0 = cases[0]
        for rk in cases[1:]:
            check(rk["losses"] == c0["losses"],
                  f"sharded {name}: the ranks' losses differ")
        steps = len(c0["ms"])
        ms = [max(rk["ms"][i] for rk in cases) for i in range(steps)]
        per_step = {k: v // steps for k, v in c0["ledger"].items()}
        by_op = {k[len("bytes:"):]: v for k, v in per_step.items()
                 if k.startswith("bytes:")}
        wire = {k: v // steps for k, v in c0["wire"].items()
                if k.startswith(("bytes:", "host_hop"))}
        held = (f"MoE layer vs the slice-wise emulation {c0['errs']} of "
                f"scale (bound {MOE_BOUND}), the layer's forward and "
                f"backward {[rk['layer_ms'] for rk in cases]} ms by rank"
                if name == "moe" else
                f"single-process losses {c0['ref_losses']} (bound 1e-3), "
                f"gradient norms {c0['grad_norms']} vs "
                f"{c0['ref_grad_norms']} ({c0['grad_norm_err']} relative, "
                f"bound 1e-5), parameters {c0['param_err']} off (bound "
                f"1e-4; each leaf moved at least {c0['min_move']}, but "
                f"{c0['still']}, which has no gradient)"
                if "grad_err" not in c0 else
                f"the single-process first step's loss {c0['ref_losses']} "
                f"(bound 1e-3) and gradient norm {c0['ref_grad_norms']} "
                f"against {c0['grad_norms']} ({c0['grad_norm_err']} "
                f"relative, bound 1e-4), its gradient leaves "
                f"{c0['grad_err']} of their scale off (bound twice one "
                f"ulp's {c0['ulp_err']}; one step: FIRST_STEP_HELD)")
        log(f"[sharded training] ({name}) {c0['state_bytes'] / 1e9:.3f} GB "
            f"f32 state, mesh {TP_MESH}: {ms} ms a step (slowest rank); "
            f"losses {c0['losses']}; {held}; FSDP shards "
            f"{len(c0['fsdp'])} leaves; peak allocated a rank in the init "
            f"{[rk['init_peak_bytes'] / 1e9 for rk in cases]} GB, in the "
            f"steps {[rk['peak_bytes'] / 1e9 for rk in cases]} GB (blocks "
            f"{[rk['local_state_bytes'] / 1e9 for rk in cases]} GB); rank "
            f"0's collective bytes a step by op and axis {by_op}, host hop "
            f"{per_step.get('host_hop_bytes', 0)} bytes a step, the plane's "
            f"wire a step {wire}; init {c0['init_s']:.1f} s on {card}")
        slot_times[name] = {
            "step_ms": ms, "rank_ms": [rk["ms"] for rk in cases],
            "losses": c0["losses"], "grad_norms": c0["grad_norms"],
            "state_bytes": c0["state_bytes"],
            "local_state_bytes": [rk["local_state_bytes"] for rk in cases],
            "init_peak_bytes": [rk["init_peak_bytes"] for rk in cases],
            "peak_bytes": [rk["peak_bytes"] for rk in cases],
            "bytes_per_step": by_op,
            "host_hop_bytes_per_step": per_step.get("host_hop_bytes", 0),
            "wire_per_step": wire,
            "fsdp": c0["fsdp"], "init_s": c0["init_s"],
            **{k: c0[k] for k in ("errs", "layer_ms", "ref_losses",
                                  "ref_grad_norms", "grad_norm_err",
                                  "param_err", "min_move", "still",
                                  "grad_err", "ulp_err")
                                  if k in c0}}
    log(f"[sharded training] (c)-(f) {slots_s:.1f} s with 4 process starts "
        f"on {card}")
    return slot_times, slots_s


def phase20(card, slots):
    """Phase 20: the sharded trainer.  (a) ``phase20_rank`` in a world of 4
    gloo ranks on the card; (c)-(f) ``slots``, ``phase20_slots``'s result
    (its world runs while the kernels build); (b) ``launch/train.py
    --ranks 4 --smoke`` (the
    reference's (1, 4) mesh) for 3 steps with a checkpoint at step 2, then
    resumed from it: the resumed loss bitwise the uninterrupted run's, the
    whole-leaf checkpoint restored on this process's card bitwise the
    launcher's final state."""
    import shutil
    import tempfile

    from repro_torch import _pytree, configs
    from repro_torch import sharding as S
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as LT

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with expandable_segments(), \
            tempfile.TemporaryDirectory(prefix="chip-smoke-tp-") as work:
        tp = S.run_spmd(phase20_rank, TP_MESH, ("data", "model"),
                        args=(card, os.path.join(work, "ckpt")),
                        device="cuda", workdir=work)
    tp_s = time.perf_counter() - t0
    for rk in tp[1:]:
        check(rk["losses"] == tp[0]["losses"],
              "sharded training: the ranks' losses differ")
    r0 = tp[0]
    want = {"embed/embed", "blocks/0/ffn/w_gate", "blocks/0/ffn/w_up",
            "blocks/0/ffn/w_down", "blocks/0/attn/wq", "blocks/0/attn/wk",
            "blocks/0/attn/wv", "blocks/0/attn/wo"}
    check(want <= set(r0["fsdp"]),
          f"sharded training: FSDP shards {r0['fsdp']}, not {sorted(want)}")
    step_ms = [max(rk["ms"][i] for rk in tp) for i in range(TP_STEPS)]
    per_step = {k: v // TP_STEPS for k, v in r0["ledger"].items()}
    by_op = {k[len("bytes:"):]: v for k, v in per_step.items()
             if k.startswith("bytes:")}
    log(f"[sharded training] {TP_ARCH} full width, {TP_PERIODS} of 28 "
        f"layers, f32, mesh {TP_MESH} ({r0['backend']}), B {TP_B} x {TP_S} "
        f"in {TP_MICRO} microbatches: {step_ms} ms a step (slowest rank; "
        f"the first includes warm-up); losses {r0['losses']} vs "
        f"single-process {r0['ref_losses']} (bound 1e-3); gradient norms "
        f"{r0['grad_norms']} vs {r0['ref_grad_norms']} ({r0['grad_norm_err']}"
        f" relative, bound 1e-5); parameters {r0['param_err']} off (bound "
        f"1e-4; each leaf moved at least {r0['min_move']}); whole state "
        f"{r0['state_bytes'] / 1e9:.3f} GB (its largest leaf "
        f"{r0['max_leaf_bytes'] / 1e9:.3f} GB), each rank's blocks "
        f"{[rk['local_state_bytes'] / 1e9 for rk in tp]} GB, peak allocated "
        f"in the init {[rk['init_peak_bytes'] / 1e9 for rk in tp]} GB, in "
        f"the steps {[rk['peak_bytes'] / 1e9 for rk in tp]} GB, in the "
        f"resume {[rk['resume_peak_bytes'] / 1e9 for rk in tp]} GB (the "
        f"checkpoint written and restored in {r0['resume_s']:.1f} s, "
        f"bitwise); "
        f"rank 0's collective bytes a step by op and axis {by_op}, host hop "
        f"{per_step.get('host_hop_bytes', 0)} bytes a step; phase (a) "
        f"{tp_s:.1f} s with 4 process starts on {card}")

    slot_times, slots_s = slots

    # (b) the launcher: uninterrupted, then resumed from step 2
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip-smoke-launch-")
    try:
        ckpt = os.path.join(root, "ckpt")
        kw = dict(LAUNCH_KW, ckpt_dir=ckpt)
        whole, hist = LT.train("qwen3-1.7b", device="cuda", ranks=RANKS,
                               **kw)
        check(sorted(os.listdir(ckpt)) == ["step_0000000002",
                                           "step_0000000003"],
              f"launcher: checkpoints {sorted(os.listdir(ckpt))}")
        shutil.rmtree(os.path.join(ckpt, "step_0000000003"))
        _, resumed = LT.train("qwen3-1.7b", device="cuda", ranks=RANKS, **kw)
        check(len(hist) == 3 and resumed == hist[2:],
              f"launcher: resumed losses {resumed} vs uninterrupted {hist}")
        _build.reset_launches()
        got = CheckpointManager(ckpt).restore(3, M.state_shapes(
            configs.smoke_config("qwen3-1.7b")), device="cuda")
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in _build.KERNELS}
        for a, b in zip(_pytree.leaves(got), _pytree.leaves(whole)):
            assert_bitwise(a.cpu(), b, "launcher: the restored checkpoint")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launch_s = time.perf_counter() - t0
    log(f"[sharded training] launch/train.py --ranks {RANKS} --smoke (mesh "
        f"{LT.mesh_shape(RANKS)}): losses {hist}, resumed from step 2 "
        f"{resumed} (bitwise); its step-3 checkpoint restored on the card "
        f"bitwise, launches {launches}; {launch_s:.1f} s with 8 process "
        f"starts on {card}")
    return {"step_ms": step_ms, "rank_ms": [rk["ms"] for rk in tp],
            "losses": r0["losses"], "ref_losses": r0["ref_losses"],
            "grad_norms": r0["grad_norms"],
            "ref_grad_norms": r0["ref_grad_norms"],
            "grad_norm_err": r0["grad_norm_err"], "min_move": r0["min_move"],
            "param_err": r0["param_err"], "state_bytes": r0["state_bytes"],
            "local_state_bytes": [rk["local_state_bytes"] for rk in tp],
            "peak_bytes": [rk["peak_bytes"] for rk in tp],
            "init_peak_bytes": [rk["init_peak_bytes"] for rk in tp],
            "resume_peak_bytes": [rk["resume_peak_bytes"] for rk in tp],
            "resume_s": r0["resume_s"],
            "bytes_per_step": by_op,
            "host_hop_bytes_per_step": per_step.get("host_hop_bytes", 0),
            "ledger": r0["ledger"], "fsdp": r0["fsdp"], "phase_s": tp_s,
            "launch": {"losses": hist, "resumed": resumed,
                       "restore_launches": launches, "s": launch_s},
            "slots": slot_times, "slots_s": slots_s}


# -- phase 21: sharded serving ---------------------------------------------------
SERVE_ULP_TIMES = 2             # the logit bound: this many times the gap that
                                # one ulp on every weight opens in the same
                                # single-process run
SERVE_MESH = (2, 2)             # the world; (1, 4) is a view of its 4 ranks
# part: (arch, periods (None: whole), mesh, B, prompt tokens, decode steps,
# xdma_cache)
SERVE_PARTS = {
    "a": ("qwen2_0p5b", 12, (1, 4), 4, 512, 4, False),
    "b": ("phi4_mini_3p8b", 4, (2, 2), 4, 256, 4, True),
    "c_whisper": ("whisper_small", None, (1, 4), 4, 64, 4, True),
    "c_xlstm": ("xlstm_125m", 1, (1, 4), 8, 256, 4, False),
}
# (b)'s continuous batching: 4 requests arriving together, ragged prompts,
# a pool of 360 pages a rank (the prompts take 352 of a rank's blocks, 2
# tokens a page): the youngest requests are evicted as the batch decodes
# and restored as others finish (at 376 pages nothing is evicted, under 352
# the prompts do not fit)
SERVE_CB = dict(trace=((0.0, 64, 6), (0.0, 128, 6), (0.0, 96, 6),
                       (0.0, 64, 6)), max_len=160, pages=360, seed=SEED)


def phase21_configs():
    """``{part: (cfg, mesh shape, B, prompt, steps)}``, f32: (a) qwen2-0.5b
    cut to 12 of its 24 layers, (b) phi4-mini cut to 4 of its 32 layers
    with the XDMA cache, (c) whisper-small whole (the XDMA self cache, the
    cross cache bshd) and xlstm-125m cut to one period (4 of 12 layers)."""
    import dataclasses
    from repro_torch import configs
    out = {}
    for name, (arch, periods, mesh, B, S, steps, xdma) in SERVE_PARTS.items():
        cfg = dataclasses.replace(configs.get_config(arch),
                                  dtype=torch.float32, xdma_cache=xdma)
        if periods:
            cfg = dataclasses.replace(cfg, n_periods=periods)
        out[name] = (cfg, mesh, B, S, steps)
    return out


def serve_batch(cfg, dev, B, S, part):
    """The part's prompt, drawn on ``dev`` from a seed (the same values in
    this process and in every rank)."""
    gen = torch.Generator(device=dev).manual_seed(
        SEED + sorted(SERVE_PARTS).index(part))
    b = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                 device=dev, dtype=torch.int32)}
    if cfg.encoder_layers:
        b["audio_embeds"] = torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                        generator=gen, device=dev)
    return b


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def greedy_run(cfg, params, batch, n, max_len, *, mesh=None, forced=None,
               cache_dtype=torch.float32):
    """Prefill, then ``n - 1`` decode steps: the greedy tokens (B, n) and
    the logits each was picked from (B, n, V); with ``forced`` (B, n)
    every step decodes its token instead (teacher forcing).  Also the
    prefill's and each decode step's ms, the final cache, and the
    collective ledger's growth over the decode steps."""
    from repro_torch import sharding as S
    from repro_torch.models import lm
    lead = batch["tokens"]
    dev = lead.device
    cache = lm.init_cache(cfg, lead.shape[0], max_len, cache_dtype,
                          device=dev)
    sync(dev)
    t0 = time.perf_counter()
    logits, cache = lm.prefill(cfg, params, batch, cache, mesh=mesh,
                               max_len=max_len)
    sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    before = S.collective_stats()
    toks, lgs, step_ms = [], [], []
    for i in range(n):
        lgs.append(logits[:, -1].float())
        toks.append(torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None])
        if i + 1 < n:
            tok = toks[-1] if forced is None else forced[:, i:i + 1].to(dev)
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(cfg, params, tok, cache,
                                           mesh=mesh, max_len=max_len)
            sync(dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
    after = S.collective_stats()
    grown = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    return (torch.cat(toks, 1), torch.stack(lgs, 1), prefill_ms, step_ms,
            cache, grown)


def top2_margin(logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def tokens_agree(got, want, margin, bound, what):
    """``got`` equals ``want`` (B, n) row by row up to a row's first
    divergence, which must fall where the single-process top-2 margin is
    under ``bound`` (the tie rule); returns the divergences."""
    got, want, margin = got.cpu(), want.cpu(), margin.cpu()
    ties = []
    for b in range(want.shape[0]):
        diff = (got[b] != want[b]).nonzero()
        if len(diff):
            i = int(diff[0])
            check(float(margin[b, i]) < bound,
                  f"{what}: row {b} diverges at step {i} where the "
                  f"single-process top-2 margin {float(margin[b, i])} is not "
                  f"under {bound}")
            ties.append((b, i, float(margin[b, i])))
    return ties


def one_ulp(params, seed, chunk=1 << 26):
    """Every float weight moved one ulp up or down at random (a seeded
    coin a element): how far rounding alone moves a run.  A bf16 weight
    moves by its bits (``nextafter`` has no bf16 kernel), ``chunk``
    elements at a time (a 27 B model's embedding is 1.4 G elements): its
    magnitude one step away from zero or toward it, zero up and the
    largest finite magnitude down."""
    from repro_torch import _pytree
    gen = None
    leaves = []
    for t in _pytree.leaves(params):
        if gen is None:
            gen = torch.Generator(device=t.device).manual_seed(seed)
        if t.dtype != torch.bfloat16:
            up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
            inf = torch.full((), math.inf, dtype=t.dtype, device=t.device)
            leaves.append(torch.where(up, torch.nextafter(t, inf),
                                      torch.nextafter(t, -inf)))
            continue
        flat = t.reshape(-1)
        out = torch.empty_like(flat)
        one = torch.ones((), dtype=torch.int32, device=t.device)
        for s in range(0, flat.numel(), chunk):
            x = flat[s:s + chunk]
            up = torch.rand(x.shape, generator=gen, device=t.device) < 0.5
            bits = x.view(torch.int16).to(torch.int32)
            mag, sign = bits & 0x7FFF, bits & 0x8000
            step = torch.where(up | (mag == 0), one, -one)
            step = torch.where(mag + step >= 0x7F80, -one, step)
            v = (mag + step) | sign
            out[s:s + chunk] = torch.where(v >= 0x8000, v - 0x10000, v).to(
                torch.int16).view(torch.bfloat16)
        leaves.append(out.view(t.shape))
    return _pytree.unflatten(params, leaves)


def phase21_reference(card, device):
    """The single-process port on the card, TF32 off, for each part: the
    greedy tokens, their logits and top-2 margins, the part's logit bound
    (``SERVE_ULP_TIMES`` times the gap a one-ulp move of every weight opens
    in the same teacher-forced run: the run's own conditioning), and for
    (b) each request's greedy tokens alone (the continuous engine's
    reference)."""
    from repro_torch.models import lm
    from repro_torch.serving import trace_stream
    dev = torch.device(device)
    undo = no_tf32()
    refs = {}
    try:
        for name, (cfg, _, B, S, n) in phase21_configs().items():
            params = lm.init_params(cfg, SEED, device=dev)
            batch = serve_batch(cfg, dev, B, S, name)
            toks, lgs, pre_ms, step_ms, _, _ = greedy_run(cfg, params, batch,
                                                          n, S + n)
            moved = one_ulp(params, SEED)
            _, lgs_ulp, _, _, _, _ = greedy_run(cfg, moved, batch, n, S + n,
                                                forced=toks)
            del moved
            scale = float(lgs.abs().max())
            gap = float((lgs_ulp - lgs).abs().max())
            refs[name] = {"tokens": toks.cpu(), "logits": lgs.cpu(),
                          "margin": top2_margin(lgs).cpu(),
                          "prefill_ms": pre_ms, "step_ms": step_ms,
                          "scale": scale, "ulp_gap": gap,
                          "bound": SERVE_ULP_TIMES * gap}
            if name == "b":
                reqs = trace_stream(cfg, SERVE_CB["trace"],
                                    seed=SERVE_CB["seed"])
                cb = {}
                for rq in reqs:
                    t, lg, _, _, _, _ = greedy_run(
                        cfg, params, {"tokens": torch.from_numpy(
                            rq.tokens).to(dev)[None]}, rq.max_new,
                        SERVE_CB["max_len"])
                    cb[rq.rid] = {"tokens": t[0].cpu(),
                                  "margin": top2_margin(lg)[0].cpu()}
                refs[name]["requests"] = cb
            del params
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        undo()
    return refs


def serve_part(mesh, card, name, cfg, B, S, n, ref):
    """One part in this rank: the weights drawn whole on the card from the
    seed, one weight at a time, kept on the host and cut to this rank's
    blocks by the serving specs; (1) the teacher-forced loop (the
    single-process tokens fed back) for the logits, the prefill's and
    each step's ms, the cache's bytes and one step's collective bytes;
    (2) ``ServingEngine(mesh=)`` with the plane, its tokens and kernel 1's
    launches on this rank's blocks, then one round trip of its final
    cache through the plane, bitwise; (3) for (b)
    ``ContinuousBatchingEngine(mesh=)`` on a pool that evicts (kernel 3)
    and restores (kernel 3) this rank's blocks of the youngest requests."""
    from repro_torch import _pytree
    from repro_torch import sharding as SH
    from repro_torch.kernels import _build, agu, datapath
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     ServingEngine, trace_stream)

    dev, r = mesh.device, mesh.rank
    tag = f"[sharded serving ({name}) rank {r}]"
    cfg = cfg.with_axes(SH.Axes(batch=("data",), model="model"))
    specs, shapes = M.serving_specs(cfg, mesh)
    t0 = time.perf_counter()
    local = M.shard_tree(lm.init_params(cfg, SEED, device=dev, store="cpu"),
                         specs, mesh, device=dev)
    sync(dev)
    out = {"init_s": time.perf_counter() - t0,
           "param_bytes": tree_bytes(local), "whole_param_bytes":
           tree_bytes(shapes)}
    batch = serve_batch(cfg, dev, B, S, name)
    toks, lgs, pre_ms, step_ms, cache, grown = greedy_run(
        cfg, local, batch, n, S + n, mesh=mesh, forced=ref["tokens"])
    want = ref["logits"].to(dev)
    scale = float(want.abs().max())
    err = float((lgs - want).abs().max())
    check(bool(torch.isfinite(lgs).all()), f"{tag} non-finite logits")
    check(err <= ref["bound"],
          f"{tag} logits {err} off the single-process run (bound "
          f"{ref['bound']}: {SERVE_ULP_TIMES} x the one-ulp gap "
          f"{ref['ulp_gap']})")
    steps = n - 1
    out.update(err=err, scale=scale, prefill_ms=pre_ms, step_ms=step_ms,
               cache_bytes=tree_bytes(cache),
               coll_bytes_per_step={k[len("bytes:"):]: v // steps
                                    for k, v in grown.items()
                                    if k.startswith("bytes:")},
               host_hop_bytes_per_step=grown.get("host_hop_bytes", 0)
               // steps)
    del cache

    eng = ServingEngine(cfg, local, S + n, cache_dtype=torch.float32,
                        mesh=mesh, device=dev)
    _build.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    got = eng.generate(batch, n)
    sync(dev)
    out["generate_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = {k.name: k.launches for k in _build.KERNELS}
    check(agu.RELAYOUT.launches > 0,
          f"{tag} kernel 1 did not launch on the plane")
    out["tokens"] = got.cpu()
    last = eng.last_cache
    moved = eng._cache_through_plane(eng._new_scheduler(), last, "check")
    for a, b in zip(_pytree.leaves(moved), _pytree.leaves(last)):
        if isinstance(a, torch.Tensor):
            assert_bitwise(a, b, f"{tag} the plane's round trip")
    del eng, last, moved

    if name == "b":
        reqs = trace_stream(cfg, SERVE_CB["trace"], seed=SERVE_CB["seed"])
        cont = ContinuousBatchingEngine(
            cfg, local, SERVE_CB["max_len"], max_batch=4,
            cache_dtype=torch.float32, capacity_pages=SERVE_CB["pages"],
            mesh=mesh, device=dev)
        _build.reset_launches()
        t0 = time.perf_counter()
        rep = cont.serve(reqs)
        sync(dev)
        out["continuous"] = {
            "tokens": rep.tokens, "steps": rep.steps,
            "pool": rep.pool_stats, "s": time.perf_counter() - t0,
            "launches": {k.name: k.launches for k in _build.KERNELS}}
        check(agu.RELAYOUT.launches > 0,
              f"{tag} kernel 1 did not launch on the page pool")
        pool = rep.pool_stats
        check(pool["evictions"] > 0 and pool["restores"] > 0
              and rep.preemptions > 0,
              f"{tag} the pool of {SERVE_CB['pages']} pages evicted "
              f"{pool['evictions']} and restored {pool['restores']} pages")
        check(datapath.BLOCK.launches > 0,
              f"{tag} kernel 3 did not launch on the evictions and restores")
        out["continuous"]["preemptions"] = rep.preemptions
    del local
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase21_rank(mesh, card, refs):
    """One rank of phase 21: every part on its mesh (the world's (2, 2) or
    the (1, 4) view), TF32 off."""
    torch.set_num_threads(2)             # four ranks share the host's cores
    undo = no_tf32()
    try:
        out = {}
        from repro_torch import sharding as SH
        for name, (cfg, shape, B, S, n) in phase21_configs().items():
            with SH.view(mesh, shape) as m:
                out[name] = serve_part(m, card, name, cfg, B, S, n,
                                       refs[name])
        return out
    finally:
        undo()


def phase21(card, device="cuda"):
    """Phase 21: sharded serving.  The single-process references here, then
    ``phase21_rank`` in a world of 4 gloo ranks on the card: (a) qwen2-0.5b
    (12 layers) on (1, 4) (sequence-parallel prefill, the cache split by
    sequence), (b) phi4-mini cut to 4 layers on (2, 2) with the XDMA cache
    (KV heads split, the batch over the data axis; then the continuous
    engine), (c) whisper-small whole and xlstm-125m (4 layers) on (1, 4)
    (the cross and recurrent caches).  Every rank's tokens are held to the
    single-process tokens under the tie rule."""
    import tempfile
    from repro_torch import sharding as S

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs = phase21_reference(card, device)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with expandable_segments(), \
            tempfile.TemporaryDirectory(prefix="chip-smoke-serve-") as work:
        world = S.run_spmd(phase21_rank, SERVE_MESH, ("data", "model"),
                           args=(card, refs), device=device, workdir=work)
    world_s = time.perf_counter() - t0
    times = {}
    for name, (cfg, shape, B, S_, n) in phase21_configs().items():
        ref = refs[name]
        parts = [rk[name] for rk in world]
        bound = 2 * ref["bound"]
        ties = [tokens_agree(p["tokens"], ref["tokens"], ref["margin"],
                             bound, f"sharded serving ({name}) rank {r}")
                for r, p in enumerate(parts)]
        line = (f"[sharded serving] ({name}) {cfg.name}, {cfg.n_layers} "
                f"layers, f32, mesh {shape}, B {B} x {S_} + {n} steps: "
                f"logits {[p['err'] for p in parts]} off the "
                f"single-process run by rank (max|logit| "
                f"{ref['scale']}; bound {ref['bound']}: {SERVE_ULP_TIMES} "
                f"x the one-ulp gap {ref['ulp_gap']}); ServingEngine tokens equal the "
                f"single-process tokens in every rank "
                f"(divergences under the tie rule, margin below {bound}: "
                f"{ties}); prefill {[p['prefill_ms'] for p in parts]} ms "
                f"by rank (single-process {ref['prefill_ms']:.1f}), decode "
                f"steps {[p['step_ms'] for p in parts]} ms by rank "
                f"(single-process {ref['step_ms']}), generate with the "
                f"plane {[p['generate_ms'] for p in parts]} ms; a rank's "
                f"cache {[p['cache_bytes'] for p in parts]} bytes, its "
                f"weights {[p['param_bytes'] for p in parts]} of "
                f"{parts[0]['whole_param_bytes']} bytes; rank 0's collective "
                f"bytes a decode step {parts[0]['coll_bytes_per_step']}, "
                f"host hop {[p['host_hop_bytes_per_step'] for p in parts]} "
                f"bytes a step by rank; kernel 1 on each rank's blocks "
                f"{[p['launches']['agu_relayout'] for p in parts]} launches "
                f"in generate, the round trip bitwise; on {card}")
        times[name] = {k: [p[k] for p in parts] for k in (
            "err", "prefill_ms", "step_ms", "generate_ms", "cache_bytes",
            "param_bytes", "coll_bytes_per_step", "host_hop_bytes_per_step",
            "launches", "init_s")}
        times[name].update(scale=ref["scale"], ulp_gap=ref["ulp_gap"],
                           bound=ref["bound"], ties=ties,
                           ref_prefill_ms=ref["prefill_ms"],
                           ref_step_ms=ref["step_ms"])
        if name == "b":
            reqs = ref["requests"]
            for r, p in enumerate(parts):
                c = p["continuous"]
                for rid, want in reqs.items():
                    tokens_agree(torch.as_tensor(c["tokens"][rid])[None],
                                 want["tokens"][None], want["margin"][None],
                                 bound, f"continuous ({name}) rank {r} "
                                 f"request {rid}")
                check(c["steps"] == parts[0]["continuous"]["steps"]
                      and c["pool"] == parts[0]["continuous"]["pool"],
                      f"continuous ({name}) rank {r}: decisions differ")
            line += (f"; ContinuousBatchingEngine: 4 requests in "
                     f"{parts[0]['continuous']['steps']} steps, "
                     f"{parts[0]['continuous']['preemptions']} preemptions "
                     f"on a pool of {SERVE_CB['pages']} pages, tokens equal "
                     f"each request's single-process run in every rank, "
                     f"pool {parts[0]['continuous']['pool']}, kernel "
                     f"launches by rank "
                     f"{[p['continuous']['launches'] for p in parts]}, "
                     f"{[p['continuous']['s'] for p in parts]} s")
            times[name]["continuous"] = [
                {k: v for k, v in p["continuous"].items() if k != "tokens"}
                for p in parts]
        log(line)
    log(f"[sharded serving] references {ref_s:.1f} s, the world {world_s:.1f}"
        f" s with 4 process starts on {card}")
    times.update(ref_s=ref_s, world_s=world_s)
    return times


# -- phase 22: the production mesh's last regimes and the dry run -------------
POD_MESH = (2, 2, 1)           # ("pod", "data", "model"): the batch over a pair
POD_NAMES = ("pod", "data", "model")
POD_TRAIN = dict(B=4, S=512, micro=1, steps=2)
# (b): prefill_32k / decode_32k's cache on 4 prompts of 512 tokens
POD_SERVE = dict(B=4, S=512, max_len=32768, steps=2)
LONG_ARCH = "gemma3_27b"       # (c): one period (5 local + 1 global layer)
LONG_SLOTS = 1 << 19           # long_500k's 524288 cache slots
LONG_POS = 500_000             # the cache's filled length (a seq rank 1 slot)
# (e): the continuous engine on (c)'s model and mesh, a bf16 cache of
# 32768 slots (16384 a seq rank): 6 requests (arrival s on the simulated
# clock, prompt tokens, new tokens), 3 at a time, pages of 4096 rows (512
# tokens of a rank's 8 KV heads of the global layer, a rank's whole window
# block of a local layer).  Each of the first three prompts sits just under
# a page boundary, so their decodes grow the global K / V; the pool holds
# their prompts and one growth, so the next growth evicts a request, which
# is restored when one finishes.
LONG_CB = dict(trace=((0.0, 1020, 12), (0.0, 1530, 10), (0.0, 2040, 16),
                      (0.5, 4090, 8), (1.0, 512, 12), (1.5, 3000, 14)),
               max_len=32768, batch=3, page_rows=4096, seed=SEED + 5)
# (d): the dry run's cells, each in a process of its own started after the
# build: (arch, shape, the command's flags); the last counts phase 18's step
# on one card, whose allocator peak must come within PEAK_REL of the counted
# peak plus PEAK_SLACK (blocks rounded up, what kernels allocate inside)
DRY_CELLS = (("qwen3-1.7b", "train_4k", ("--multi-pod",)),
             ("gemma3-27b", "long_500k", ()),
             ("qwen3-1.7b", "train_4k", (
                 "--one-card", "--batch", str(TRAIN_B), "--seq",
                 str(TRAIN_S), "--microbatches", str(TRAIN_MICRO))))
PEAK_REL, PEAK_SLACK = 0.03, 256 << 20


def phase22_configs():
    """(a) and (b): qwen3-1.7b at full width cut to 2 of its 28 layers, in
    f32; (c): gemma3-27b at full width cut to one period of its layers (5
    local and 1 global) and its tail of 2, 8 of 62, its weights and cache
    in bf16."""
    import dataclasses
    from repro_torch import configs
    pod = dataclasses.replace(configs.get_config(TP_ARCH),
                              n_periods=TP_PERIODS, dtype=torch.float32)
    long = dataclasses.replace(configs.get_config(LONG_ARCH), n_periods=1,
                               dtype=torch.bfloat16)
    return pod, long


def start_dryrun():
    """(d): one ``python -m repro_torch.launch.dryrun`` a cell, started
    now, read in phase 22: meta tensors on the host, no card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape, flags in DRY_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape] + list(flags)
        procs.append(((arch, shape, flags), time.perf_counter(),
                      subprocess.Popen(cmd, env=env, cwd=ROOT,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)))
    return procs


def finish_dryrun(procs, card, train_peak):
    """(d)'s records: every field set, the bytes held (argument, output,
    temp, peak) and moved counted, the memory term the bytes moved over
    the HBM rate; phase 18's step (``train_peak``: its allocator's peak
    above the bytes live before the cell) within PEAK_REL + PEAK_SLACK of
    its counted peak."""
    out = {}
    for (arch, shape, flags), t0, proc in procs:
        stdout, stderr = proc.communicate(timeout=900)
        check(proc.returncode == 0,
              f"dry run {arch} {shape}: exit {proc.returncode}\n{stderr}")
        rec = json.loads(stdout.strip().splitlines()[-1])
        mem = rec["bytes_per_device"]
        nulls = sorted(k for k, v in rec.items() if v is None)
        nulls += sorted(k for k, v in mem.items() if v is None)
        check(not nulls, f"dry run {arch} {shape}: null fields {nulls}")
        check(rec["flops_per_device"] > 0
              and len(rec["roofline_s"]) == 3,
              f"dry run {arch} {shape}: {rec}")
        check(mem["peak"] >= mem["argument"] > 0 and mem["temp"] > 0
              and rec["op_bytes_per_device"] > rec["state_bytes_per_device"]
              and rec["roofline_s"]["memory"]
              == rec["op_bytes_per_device"] / HBM_BYTES_PER_S,
              f"dry run {arch} {shape}: bytes {mem}, moved "
              f"{rec['op_bytes_per_device']}, terms {rec['roofline_s']}")
        if "--one-card" in flags:
            off = abs(train_peak - mem["peak"])
            bound = PEAK_REL * mem["peak"] + PEAK_SLACK
            log(f"[dry run] phase 18's step ({arch}, B {TRAIN_B} x "
                f"{TRAIN_S} in {TRAIN_MICRO} microbatches, one card): "
                f"counted peak {mem['peak']} bytes (argument "
                f"{mem['argument']}, temp {mem['temp']}, bytes moved "
                f"{rec['op_bytes_per_device']}), the card's "
                f"max_memory_allocated over step 2 less the bytes live "
                f"before the cell {train_peak}: {off} apart, "
                f"{(train_peak - mem['peak']) / mem['peak']:+.2%} (bound "
                f"{bound}: {PEAK_REL:.0%} + {PEAK_SLACK} bytes) on {card}")
            check(off <= bound,
                  f"dry run: phase 18's measured peak {train_peak} is "
                  f"{off} bytes off the counted {mem['peak']} (bound "
                  f"{bound})")
            rec["measured_peak_bytes"] = train_peak
        log(f"[dry run] (d) {json.dumps(rec)}")
        log(f"[dry run] (d) {arch} {shape} on {rec['mesh']}: rank 0 of "
            f"{rec['n_devices']} counted in {rec['count_s']} s (a process "
            f"of its own, {time.perf_counter() - t0:.1f} s after it "
            f"started); bounds against the H100 data sheet, counts not "
            f"timings; the run on {card}")
        out[f"{arch}/{shape}/{rec['mesh']}"] = rec
    return out


def long_cache(cfg, dev, mesh=None):
    """(c)'s cache: every leaf of the whole ``LONG_SLOTS`` cache drawn from
    a seed on ``dev``, one at a time (bf16 K / V; ``pos`` at
    ``LONG_POS``); with ``mesh`` each leaf's block by the fitted cache
    specs, the whole leaf freed before the next is drawn."""
    from repro_torch import _pytree
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm
    whole = lm._whole_cache(cfg, 1, LONG_SLOTS, torch.bfloat16,
                            torch.device("meta"))
    specs = (None if mesh is None else M.spec_leaves(
        M.serving_cache_specs(cfg, whole, mesh), whole))
    out = []
    for i, t in enumerate(_pytree.leaves(whole)):
        if t.dim() == 0:
            out.append(torch.tensor(LONG_POS, dtype=torch.int32))
            continue
        gen = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
        x = torch.randn(t.shape, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        if specs is not None:
            x = M.shard_tree([x], [specs[i]], mesh)[0]
        out.append(x)
        del x
    return _pytree.unflatten(whole, out)


def long_token(cfg, dev):
    gen = torch.Generator(device=dev).manual_seed(SEED + 99)
    return torch.randint(0, cfg.vocab, (1, 1), generator=gen, device=dev,
                         dtype=torch.int32)


def phase22_reference(card, device):
    """The single-process port on the card, TF32 off: (b) the greedy
    tokens of qwen3-1.7b (2 layers, f32) over B 4 x 512 prompts into a
    cache of 32768 slots, their logits and margins and the one-ulp bound;
    (c) gemma3-27b's one period in bf16 decoding one token on the whole
    seeded cache of ``LONG_SLOTS`` slots, its logits and the one-ulp
    bound, with the weights' and the cache's bytes; (e) each request of
    ``LONG_CB``'s stream alone on the same model, its greedy tokens,
    logits and margins, and the one-ulp bound over them."""
    from repro_torch import _pytree
    from repro_torch.models import lm
    from repro_torch.serving.engine import make_serve_step
    dev = torch.device(device)
    pod, long = phase22_configs()
    undo = no_tf32()
    refs = {}
    try:
        P = POD_SERVE
        n = P["steps"] + 1
        params = lm.init_params(pod, SEED, device=dev)
        batch = serve_batch(pod, dev, P["B"], P["S"], "a")
        toks, lgs, pre_ms, step_ms, _, _ = greedy_run(pod, params, batch, n,
                                                      P["max_len"])
        moved = one_ulp(params, SEED)
        _, lgs_ulp, _, _, _, _ = greedy_run(pod, moved, batch, n,
                                            P["max_len"], forced=toks)
        del moved, params
        gap = float((lgs_ulp - lgs).abs().max())
        refs["b"] = {"tokens": toks.cpu(), "logits": lgs.cpu(),
                     "margin": top2_margin(lgs).cpu(),
                     "scale": float(lgs.abs().max()), "ulp_gap": gap,
                     "bound": SERVE_ULP_TIMES * gap, "prefill_ms": pre_ms,
                     "step_ms": step_ms}
        gc.collect()
        torch.cuda.empty_cache()

        # drawn on the card, kept f32 on the host, each leaf then put on
        # the card in bf16: the card never holds the f32 tree
        params = lm.init_params(long, SEED, device=dev, store="cpu")
        params = _pytree.unflatten(params, [
            p.to(dev, torch.bfloat16) if p.is_floating_point()
            else p.to(dev) for p in _pytree.leaves(params)])
        gc.collect()
        torch.cuda.empty_cache()
        cache = long_cache(long, dev)
        tok = long_token(long, dev)
        serve = make_serve_step(long, max_len=LONG_SLOTS)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sync(dev)
        t0 = time.perf_counter()
        logits, _ = serve(params, cache, tok)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        moved = one_ulp(params, SEED)
        logits_ulp, _ = serve(moved, cache, tok)
        lg = logits[:, -1].float()
        gap = float((logits_ulp[:, -1].float() - lg).abs().max())
        global_k = cache["blocks"][-1]["k"]
        refs["c"] = {"logits": lg.cpu(), "scale": float(lg.abs().max()),
                     "ulp_gap": gap, "bound": SERVE_ULP_TIMES * gap,
                     "ms": ms, "step_peak_bytes": peak,
                     "param_bytes": tree_bytes(params),
                     "cache_bytes": tree_bytes(cache),
                     "global_cache_bytes": 2 * global_k.numel()
                     * global_k.element_size()}
        del cache, logits, logits_ulp
        gc.collect()
        torch.cuda.empty_cache()

        refs["e"] = long_continuous_reference(long, params, moved, dev)
        del params, moved
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        undo()
    return refs


def phase22_rank(mesh, card, refs):
    """One rank of phase 22 in a (2, 2, 1) ("pod", "data", "model") world:
    (a) the sharded f32 step with the batch and FSDP over ("pod", "data")
    (rank 0 then runs the single-process step and holds the sharded one to
    it); (b) prefill and decode with the batch over the pair, teacher-forced
    for the logits, then ``ServingEngine(mesh=)``; (c) on the ranks as a
    (2, 2) ("data", "model") mesh, ``seq="data"``: gemma3-27b's one period
    decoding one token on its block of the seeded 524288-slot cache."""
    import dataclasses

    from repro_torch import _pytree
    from repro_torch import sharding as S
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import _build, agu
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import make_serve_step
    from repro_torch.train import step as T
    import torch.distributed as dist

    torch.set_num_threads(2)             # four ranks share the host's cores
    dev, r = mesh.device, mesh.rank
    pod, long = phase22_configs()
    undo = no_tf32()
    out = {}
    try:
        # (a) the multi-pod step
        tag = f"[multi-pod training rank {r}]"
        A = POD_TRAIN
        shape = ShapeConfig("pod", A["S"], A["B"], "train", A["micro"])
        opt_cfg = AdamWConfig(warmup_steps=0)
        cfg = dataclasses.replace(pod.with_axes(M.axes_for(mesh, shape)),
                                  fsdp=True)
        check(cfg.axes.batch == ("pod", "data"), f"{tag} axes {cfg.axes}")
        specs, shapes = M.state_specs(cfg, mesh)
        pairs = sorted({str(e) for sp in M.spec_leaves(
            specs["params"], shapes["params"]) for e in sp
            if isinstance(e, tuple)})
        check(pairs == [str(("pod", "data"))], f"{tag} FSDP over {pairs}")
        ds = SyntheticLM(vocab=cfg.vocab, seq_len=A["S"], global_batch=A["B"],
                         seed=SEED)
        batches = [batch_on(ds.batch_at(i), dev) for i in range(A["steps"])]
        t0 = time.perf_counter()
        state = T.init_state(cfg, SEED, device=dev, mesh=mesh)
        sync(dev)
        a = {"init_s": time.perf_counter() - t0,
             "local_state_bytes": tree_bytes(state),
             "state_bytes": tree_bytes(shapes)}
        step = T.make_train_step(cfg, shape, opt_cfg, mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        before = S.collective_stats()
        a["ms"], a["losses"], a["grad_norms"] = [], [], []
        for b in batches:
            dist.barrier()
            t0 = time.perf_counter()
            state, m = step(state, b)
            a["losses"].append(float(m["loss"]))
            a["grad_norms"].append(float(m["grad_norm"]))
            sync(dev)
            a["ms"].append((time.perf_counter() - t0) * 1e3)
        a["peak_bytes"] = torch.cuda.max_memory_allocated()
        after = S.collective_stats()
        a["bytes_per_step"] = {
            k[len("bytes:"):]: (v - before.get(k, 0)) // A["steps"]
            for k, v in after.items() if k.startswith("bytes:")
            and v != before.get(k, 0)}
        whole = M.gather_tree(state, specs, mesh, device="cpu")
        del state
        if r == 0:
            ref_state = T.init_state(pod, SEED, device=dev)
            start = ref_state["params"]
            ref_step = T.make_train_step(pod, shape, opt_cfg)
            a["ref_losses"], a["ref_grad_norms"] = [], []
            for b in batches:
                ref_state, rm = ref_step(ref_state, b)
                a["ref_losses"].append(float(rm["loss"]))
                a["ref_grad_norms"].append(float(rm["grad_norm"]))
            trip = list(zip(_pytree.leaves(whole["params"]),
                            _pytree.leaves(ref_state["params"]),
                            _pytree.leaves(start)))
            a["param_err"] = max(max_abs_err(x.to(dev), y)
                                 for x, y, _ in trip)
            a["min_move"] = min(max_abs_err(y, p0) for _, y, p0 in trip)
            del ref_state, start, trip
            for x, y in zip(a["losses"], a["ref_losses"]):
                check(abs(x - y) <= 1e-5 * abs(y),
                      f"{tag} sharded loss {x} vs single-process {y}")
            for x, y in zip(a["grad_norms"], a["ref_grad_norms"]):
                check(abs(x - y) <= 1e-5 * y,
                      f"{tag} gradient norm {x} vs single-process {y}")
            check(a["min_move"] > 3e-4,
                  f"{tag} a leaf moved only {a['min_move']} in the steps")
            check(a["param_err"] < 1e-4,
                  f"{tag} gathered parameters {a['param_err']} off the "
                  "single-process step's (bound 1e-4)")
        del whole
        out["a"] = a
        gc.collect()
        torch.cuda.empty_cache()

        # (b) multi-pod serving
        tag = f"[multi-pod serving rank {r}]"
        P, ref = POD_SERVE, refs["b"]
        n = P["steps"] + 1
        cfg = pod.with_axes(S.Axes(batch=("pod", "data"), model="model"))
        sp, shapes = M.serving_specs(cfg, mesh)
        local = M.shard_tree(lm.init_params(cfg, SEED, device=dev,
                                            store="cpu"), sp, mesh,
                             device=dev)
        batch = serve_batch(cfg, dev, P["B"], P["S"], "a")
        toks, lgs, pre_ms, step_ms, cache, grown = greedy_run(
            cfg, local, batch, n, P["max_len"], mesh=mesh,
            forced=ref["tokens"])
        err = float((lgs - ref["logits"].to(dev)).abs().max())
        check(bool(torch.isfinite(lgs).all()), f"{tag} non-finite logits")
        check(err <= ref["bound"],
              f"{tag} logits {err} off the single-process run (bound "
              f"{ref['bound']}: {SERVE_ULP_TIMES} x the one-ulp gap "
              f"{ref['ulp_gap']})")
        b = {"err": err, "prefill_ms": pre_ms, "step_ms": step_ms,
             "cache_bytes": tree_bytes(cache),
             "param_bytes": tree_bytes(local),
             "coll_bytes_per_step": {
                 k[len("bytes:"):]: v // P["steps"] for k, v in grown.items()
                 if k.startswith("bytes:")}}
        del cache
        eng = ServingEngine(cfg, local, P["max_len"],
                            cache_dtype=torch.float32, mesh=mesh, device=dev)
        _build.reset_launches()
        sync(dev)
        t0 = time.perf_counter()
        b["tokens"] = eng.generate(batch, n).cpu()
        sync(dev)
        b["generate_ms"] = (time.perf_counter() - t0) * 1e3
        b["launches"] = agu.RELAYOUT.launches
        check(agu.RELAYOUT.launches > 0,
              f"{tag} kernel 1 did not launch on the plane")
        del eng, local
        out["b"] = b
        gc.collect()
        torch.cuda.empty_cache()

        # (c) long_500k: the context-parallel cache on the (2, 2) view
        tag = f"[long context rank {r}]"
        ref = refs["c"]
        view = S.regroup(mesh, {"data": "pod", "model": "data",
                                ("data", "model"): ("pod", "data")}, (2, 2))
        with view as m:
            cfg = long.with_axes(S.Axes(batch=(), model="model", seq="data"))
            sp, shapes = M.serving_specs(cfg, m)
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats()
            # the ranks draw the whole f32 weights in turn (one rank's at a
            # time on the card), each keeping its bf16 blocks
            for turn in range(mesh.world_size):
                if turn == r:
                    whole = lm.init_params(cfg, SEED, device=dev)
                    local = M.shard_tree(whole, sp, m, device=dev)
                    del whole
                    local = _pytree.unflatten(local, [
                        p.to(torch.bfloat16) if p.is_floating_point() else p
                        for p in _pytree.leaves(local)])
                    gc.collect()
                    torch.cuda.empty_cache()
                dist.barrier()
            cache = long_cache(cfg, dev, m)
            sync(dev)
            c = {"init_s": time.perf_counter() - t0,
                 "init_peak_bytes": torch.cuda.max_memory_allocated(),
                 "param_bytes": tree_bytes(local),
                 "cache_bytes": tree_bytes(cache),
                 "global_k_spec": M.serving_cache_specs(
                     cfg, lm._whole_cache(cfg, 1, LONG_SLOTS, torch.bfloat16,
                                          torch.device("meta")),
                     m)["blocks"][-1]["k"]}
            serve = make_serve_step(cfg, mesh=m, max_len=LONG_SLOTS)
            tok = long_token(cfg, dev)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = S.collective_stats()
            dist.barrier()
            t0 = time.perf_counter()
            logits, new = serve(local, cache, tok)
            sync(dev)
            c["ms"] = (time.perf_counter() - t0) * 1e3
            c["step_peak_bytes"] = torch.cuda.max_memory_allocated() - base
            after = S.collective_stats()
            c["coll_bytes"] = {k[len("bytes:"):]: v - before.get(k, 0)
                               for k, v in after.items()
                               if k.startswith("bytes:")
                               and v != before.get(k, 0)}
            lg = logits[:, -1].float()
            c["err"] = float((lg - ref["logits"].to(dev)).abs().max())
            check(bool(torch.isfinite(lg).all()), f"{tag} non-finite logits")
            check(c["err"] <= ref["bound"],
                  f"{tag} logits {c['err']} off the single-process decode "
                  f"(bound {ref['bound']}: {SERVE_ULP_TIMES} x the one-ulp "
                  f"gap {ref['ulp_gap']})")
            check(int(new["pos"]) == LONG_POS + 1, f"{tag} pos {new['pos']}")
            del cache, new, logits
            out["c"] = c
            gc.collect()
            torch.cuda.empty_cache()

            # (e) continuous batching on the context-parallel cache
            out["e"] = long_continuous(m, cfg, local, refs["e"], f"[long "
                                       f"continuous rank {r}]")
            del local
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        undo()
    return out


def long_continuous_reference(cfg, params, moved, dev):
    """(e)'s reference: each request of ``LONG_CB``'s stream alone,
    greedy on the whole model (``params``) with a bf16 cache, its tokens,
    logits and top-2 margins; the gap one ulp on every weight (``moved``)
    opens, each request teacher-forced on its tokens, over them all."""
    from repro_torch.serving import trace_stream
    t0 = time.perf_counter()
    E, cb, gap = LONG_CB, {}, 0.0
    for rq in trace_stream(cfg, E["trace"], seed=E["seed"]):
        b = {"tokens": torch.from_numpy(rq.tokens).to(dev)[None]}
        t, lg, _, _, _, _ = greedy_run(cfg, params, b, rq.max_new,
                                       E["max_len"],
                                       cache_dtype=torch.bfloat16)
        _, lg_ulp, _, _, _, _ = greedy_run(cfg, moved, b, rq.max_new,
                                           E["max_len"], forced=t,
                                           cache_dtype=torch.bfloat16)
        gap = max(gap, float((lg_ulp - lg).abs().max()))
        cb[rq.rid] = {"tokens": t[0].cpu(), "logits": lg[0].cpu(),
                      "margin": top2_margin(lg)[0].cpu()}
    return {"requests": cb, "ulp_gap": gap, "bound": SERVE_ULP_TIMES * gap,
            "s": time.perf_counter() - t0}


def long_continuous(mesh, cfg, local, ref, tag):
    """(e) in one rank: ``ContinuousBatchingEngine(mesh=)`` serving
    ``LONG_CB``'s stream on this rank's blocks of a context-parallel bf16
    cache, on a pool of the first three prompts' pages and one growth (the
    engine's own count, the same on every rank).  Every request's tokens,
    its logits' distance from the single-process run up to the first
    token the two pick otherwise, the decisions, and the launches of
    kernel 1 (page stores and loads) and kernel 3 (evictions and
    restores), which must both have run."""
    from repro_torch.kernels import _build, agu, datapath
    from repro_torch.serving import (ContinuousBatchingEngine, PagedKVPool,
                                     trace_stream)
    import torch.distributed as dist

    E = LONG_CB
    dev = mesh.device
    reqs = trace_stream(cfg, E["trace"], seed=E["seed"])

    def engine(pool):
        return ContinuousBatchingEngine(
            cfg, local, E["max_len"], max_batch=E["batch"],
            cache_dtype=torch.bfloat16, pool=pool, mesh=mesh, device=dev,
            keep_logits=True)
    probe = engine(PagedKVPool(1, E["page_rows"]))
    pages = (sum(probe._footprint(rq.prompt_len) for rq in reqs[:3])
             + max(probe._growth(rq.prompt_len + k) for rq in reqs
                   for k in range(rq.max_new)))
    eng = engine(PagedKVPool(pages, E["page_rows"]))
    _build.reset_launches()
    dist.barrier()
    t0 = time.perf_counter()
    rep = eng.serve(reqs)
    sync(dev)
    e = {"s": time.perf_counter() - t0, "steps": rep.steps,
         "pool": rep.pool_stats, "pages": pages,
         "preemptions": rep.preemptions, "elapsed_s": rep.elapsed_s,
         "tokens": {k: torch.as_tensor(v) for k, v in rep.tokens.items()},
         "launches": {k.name: k.launches for k in _build.KERNELS},
         "footprints": [probe._footprint(rq.prompt_len) for rq in reqs],
         "err": {}}
    check(sorted(rep.tokens) == sorted(ref["requests"]),
          f"{tag} served {sorted(rep.tokens)} of {len(reqs)} requests")
    check(agu.RELAYOUT.launches > 0,
          f"{tag} kernel 1 did not launch on the page pool")
    check(datapath.BLOCK.launches > 0,
          f"{tag} kernel 3 did not launch on the evictions and restores")
    check(rep.preemptions > 0 and rep.pool_stats["evictions"] > 0
          and rep.pool_stats["restores"] > 0,
          f"{tag} the pool of {pages} pages evicted "
          f"{rep.pool_stats['evictions']} and restored "
          f"{rep.pool_stats['restores']} pages")
    for rid, want in ref["requests"].items():
        got, lg = e["tokens"][rid], torch.as_tensor(rep.logits[rid])
        check(bool(torch.isfinite(lg).all()), f"{tag} non-finite logits")
        diff = (got != want["tokens"]).nonzero()
        n = int(diff[0]) + 1 if len(diff) else len(got)
        e["err"][rid] = float((lg[:n] - want["logits"][:n]).abs().max())
    return e


def rank_block_kernels(card):
    """The kernels on a rank's blocks, timed in this process on the same
    geometry: kernel 1 on one leaf of phase 22 (b)'s cache (1 row x 32768
    slots x 8 KV heads x 128, f32, as its (32768, 1024) matrix) through the
    KV plane's store and load, and kernel 3 on one of phase 21 (b)'s pool
    pages (32 x 128 f32) through its evict and restore wire (Compress /
    Decompress over blocks of 8 rows).  Each round trip bitwise its input
    and each leg bitwise its plain version; the kernel's time beside the
    plain version's, a library yardstick's (the tile permutes) and the
    bound (each leg reads and writes the matrix once)."""
    from repro_torch.core import layouts as L
    from repro_torch.core import xdma
    from repro_torch.core.descriptor import page_descriptor
    from repro_torch.kernels import _build, agu, datapath
    from repro_torch.serving.transfer import kv_plane_descs
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def plain(x, d):
        return datapath.plain(x, d.pre + d.post, d.src.layout, d.dst.layout)

    def untiled_lib(x, tile):
        R, C = x.shape
        tr, tc = tile
        tiled = x.view(R // tr, tr, C // tc, tc).permute(0, 2, 1,
                                                         3).contiguous()
        return tiled.permute(0, 2, 1, 3).contiguous().view(R, C)

    out = {}
    cases = (("plane", "agu_relayout", agu.RELAYOUT,
              torch.randn(32768, 1024, generator=gen, device=dev),
              kv_plane_descs(32768, 1024, "float32")),
             ("page", "block_datapath", datapath.BLOCK,
              torch.randn(32, 128, generator=gen, device=dev),
              (page_descriptor(32, 128, "float32", direction="store",
                               wire_compress_rows=8),
               page_descriptor(32, 128, "float32", direction="load",
                               wire_compress_rows=8))))
    for name, kernel, counter, x, (store, load) in cases:
        lay = store.dst.layout

        def trip(x=x, store=store, load=load):
            return xdma.transfer(xdma.transfer(x, store), load)
        _build.reset_launches()
        at_rest = xdma.transfer(x, store)
        back = xdma.transfer(at_rest, load)
        torch.cuda.synchronize()
        check(counter.launches > 0,
              f"{name}: kernel {kernel} did not launch on the round trip")
        launches = counter.launches
        assert_bitwise(at_rest, plain(x, store), f"{name}: the store")
        assert_bitwise(back, plain(at_rest, load), f"{name}: the load")
        assert_bitwise(back, x, f"{name}: the round trip")
        assert_bitwise(untiled_lib(x, lay.tile), x, f"{name}: the library")
        out[name] = {
            "kernel": kernel, "launches": launches,
            "shape": f"{tuple(x.shape)} {x.dtype}, MN <-> {lay.name}",
            "ms": gpu_ms(trip),
            "plain_ms": gpu_ms(lambda x=x, store=store, load=load: plain(
                plain(x, store), load)),
            "library_ms": gpu_ms(lambda x=x, t=lay.tile: untiled_lib(x, t)),
            "bound_ms": bound_ms(4 * x.numel() * x.element_size())}
        r = out[name]
        log(f"[rank blocks] kernel {kernel} on {name} ({r['shape']}, "
            f"{launches} launches a round trip): bitwise the plain version "
            f"each way; {r['ms']:.4f} ms a round trip, plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.6f} on {card}")
    return out


def phase22(card, dry, train_peak, device="cuda"):
    """Phase 22: the references here, then ``phase22_rank`` in a world of
    4 gloo ranks on the card as ("pod", "data", "model") = (2, 2, 1):
    (a) multi-pod training, (b) multi-pod serving, (c) the single-pod
    long_500k decode on the context-parallel cache, (e) the continuous
    engine on that cache; then (d) the dry run's records (``dry``: the
    processes ``start_dryrun`` started; ``train_peak`` phase 18's measured
    peak)."""
    import tempfile
    from repro_torch import sharding as S

    pod, long = phase22_configs()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs = phase22_reference(card, device)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with expandable_segments(), \
            tempfile.TemporaryDirectory(prefix="chip-smoke-pod-") as work:
        world = S.run_spmd(phase22_rank, POD_MESH, POD_NAMES,
                           args=(card, refs), device=device, workdir=work)
    world_s = time.perf_counter() - t0
    a = [rk["a"] for rk in world]
    for rk in a[1:]:
        check(rk["losses"] == a[0]["losses"],
              "multi-pod training: the ranks' losses differ")
    log(f"[multi-pod training] (a) {pod.name}, {pod.n_layers} layers, f32, "
        f"mesh {POD_MESH} over {POD_NAMES}, the batch and FSDP over (pod, "
        f"data), B {POD_TRAIN['B']} x {POD_TRAIN['S']}: "
        f"{[max(rk['ms'][i] for rk in a) for i in range(POD_TRAIN['steps'])]}"
        f" ms a step (slowest rank); losses {a[0]['losses']} (single-process "
        f"{a[0]['ref_losses']}, bound 1e-5 relative), gradient norms "
        f"{a[0]['grad_norms']} (single-process {a[0]['ref_grad_norms']}, "
        f"bound 1e-5 relative), parameters {a[0]['param_err']} off (bound "
        f"1e-4; each leaf moved at least {a[0]['min_move']}); a rank's "
        f"state {[rk['local_state_bytes'] for rk in a]} of "
        f"{a[0]['state_bytes']} bytes, peak allocated in the steps "
        f"{[rk['peak_bytes'] / 1e9 for rk in a]} GB; rank 0's collective "
        f"bytes a step {a[0]['bytes_per_step']}; init "
        f"{[round(rk['init_s'], 1) for rk in a]} s on {card}")
    ref, b = refs["b"], [rk["b"] for rk in world]
    bound = 2 * ref["bound"]
    ties = [tokens_agree(p["tokens"], ref["tokens"], ref["margin"], bound,
                         f"multi-pod serving rank {r}")
            for r, p in enumerate(b)]
    log(f"[multi-pod serving] (b) {pod.name}, {pod.n_layers} layers, f32, "
        f"mesh {POD_MESH}, the batch over (pod, data), B {POD_SERVE['B']} x "
        f"{POD_SERVE['S']} into {POD_SERVE['max_len']} slots + "
        f"{POD_SERVE['steps']} steps: logits {[p['err'] for p in b]} off "
        f"the single-process run by rank (max|logit| {ref['scale']}; bound "
        f"{ref['bound']}: {SERVE_ULP_TIMES} x the one-ulp gap "
        f"{ref['ulp_gap']}); ServingEngine tokens equal the single-process "
        f"tokens in every rank (divergences under the tie rule: {ties}); "
        f"prefill {[p['prefill_ms'] for p in b]} ms by rank (single-process "
        f"{ref['prefill_ms']:.1f}), decode steps {[p['step_ms'] for p in b]}"
        f" ms (single-process {ref['step_ms']}), generate with the plane "
        f"{[p['generate_ms'] for p in b]} ms, kernel 1 "
        f"{[p['launches'] for p in b]} launches; a rank's cache "
        f"{b[0]['cache_bytes']} bytes, weights {b[0]['param_bytes']} bytes;"
        f" rank 0's collective bytes a decode step "
        f"{b[0]['coll_bytes_per_step']} on {card}")
    ref, c = refs["c"], [rk["c"] for rk in world]
    log(f"[long context] (c) {long.name}, one period and the tail "
        f"({long.n_layers} layers), bf16, mesh (2, 2) over (data, model), seq=data, the "
        f"global layer's cache {LONG_SLOTS} slots ({ref['global_cache_bytes']}"
        f" bytes whole, K and V; spec {c[0]['global_k_spec']}), len "
        f"{LONG_POS}: one decode step {[p['ms'] for p in c]} ms by rank "
        f"(single-process {ref['ms']:.1f} ms, its step's peak "
        f"{ref['step_peak_bytes'] / 1e9:.3f} GB above the state), logits "
        f"{[p['err'] for p in c]} off the single-process decode (max|logit|"
        f" {ref['scale']}; bound {ref['bound']}: {SERVE_ULP_TIMES} x the "
        f"one-ulp gap {ref['ulp_gap']}); weights {ref['param_bytes']} bytes"
        f" whole, {[p['param_bytes'] for p in c]} a rank; the cache "
        f"{ref['cache_bytes']} bytes whole, {[p['cache_bytes'] for p in c]}"
        f" a rank; peak allocated a rank in the init "
        f"{[p['init_peak_bytes'] / 1e9 for p in c]} GB, the step's above the "
        f"state {[p['step_peak_bytes'] / 1e9 for p in c]} GB; rank 0's "
        f"collective bytes {c[0]['coll_bytes']}; init "
        f"{[round(p['init_s'], 1) for p in c]} s on {card}")
    ref, e = refs["e"], [rk["e"] for rk in world]
    bound = 2 * ref["bound"]
    for r, p in enumerate(e):
        for rid, want in ref["requests"].items():
            tokens_agree(p["tokens"][rid][None], want["tokens"][None],
                         want["margin"][None], bound,
                         f"long continuous rank {r} request {rid}")
            check(p["err"][rid] <= ref["bound"],
                  f"long continuous rank {r} request {rid}: logits "
                  f"{p['err'][rid]} off the single-process run (bound "
                  f"{ref['bound']}: {SERVE_ULP_TIMES} x the one-ulp gap "
                  f"{ref['ulp_gap']})")
        check((p["steps"], p["pool"], p["elapsed_s"]) == (
            e[0]["steps"], e[0]["pool"], e[0]["elapsed_s"]),
            f"long continuous rank {r}: decisions differ from rank 0's")
    log(f"[long continuous] (e) {long.name}, {long.n_layers} layers, bf16, "
        f"mesh (2, 2) over (data, model), seq=data, "
        f"ContinuousBatchingEngine over a bf16 cache of "
        f"{LONG_CB['max_len']} slots: {len(LONG_CB['trace'])} requests "
        f"(arrival s, prompt, new) {LONG_CB['trace']}, {LONG_CB['batch']} at "
        f"a time, pages of {LONG_CB['page_rows']} rows, a pool of "
        f"{e[0]['pages']} pages a rank (footprints at the prompt "
        f"{e[0]['footprints']}): {e[0]['steps']} steps, "
        f"{e[0]['preemptions']} preemptions, pool {e[0]['pool']}, the same "
        f"decisions on every rank; tokens equal each request's "
        f"single-process run in every rank under the tie rule (margin "
        f"below {bound}), logits {[max(p['err'].values()) for p in e]} off "
        f"by rank (bound {ref['bound']}: {SERVE_ULP_TIMES} x the one-ulp "
        f"gap {ref['ulp_gap']}); kernel launches by rank "
        f"{[p['launches'] for p in e]}; served in "
        f"{[round(p['s'], 1) for p in e]} s by rank (single-process "
        f"references {ref['s']:.1f} s with their one-ulp runs) on {card}")
    log(f"[phase 22] references {ref_s:.1f} s, the world {world_s:.1f} s "
        f"with 4 process starts on {card}")
    blocks = rank_block_kernels(card)
    records = finish_dryrun(dry, card, train_peak)
    return {"ref_s": ref_s, "world_s": world_s, "rank_blocks": blocks,
            "a": a, "b": [
        {k: v for k, v in p.items() if k != "tokens"} for p in b], "c": c,
        "e": [{k: v for k, v in p.items() if k != "tokens"} for p in e],
        "refs": {k: {x: y for x, y in v.items()
                     if x not in ("tokens", "logits", "margin", "requests")}
                 for k, v in refs.items()}, "dry_run": records}


# -- the examples phase: the user's four entry points on the card -------------
EX_TRAIN = dict(steps=4, ckpt_every=3)   # the full qwen2-0.5b: 3 saves of
                                         # its 5.9 GB state, 1 restart


def phase_examples(card, drive, device="cuda"):
    """The examples phase: the port's twins of the reference's four
    example scripts (``examples/torch_*.py``), each through its ``run``
    on the card as its command line runs it.  The quickstart's fifteen
    moves (kernels 1, 2 and 3 must launch; every parity flag true, the
    ring's ``WouldBlock`` retries equal to its full events, its
    incremental makespan equal to the replay, the telemetry's per-link
    bytes equal to the ledger's, every multicast copy exact); the KV-cache
    loop (kernel 3 on its rank-2 path: the RMSNorm store of the (B, S, d)
    K matrix, logical rank 3, and the transposed load; the store within
    the f32 chain tolerance of its plain chain, the load bitwise, the
    decoded tokens the same example's on the CPU, TF32 off); compressed_dp
    in a world of 8 gloo ranks on the card (every rank the same reduced
    gradient; the reduced gradient and every rank's residual bitwise, and
    the error and wire bytes as printed, the same example's on the CPU,
    which the CPU tests hold bitwise to the reference's jitted program);
    train_lm with ``--full-100m`` for ``EX_TRAIN`` steps (the full
    qwen2-0.5b, B 8 x 64 in 2 microbatches; the loss falls over the run,
    the restart from the step-3 checkpoint ends bitwise the uninterrupted
    run, the final
    checkpoint restores bitwise; the serving plane's kernel 1 must
    launch).  Any failed check fails the run.  Returns each example's wall
    seconds and launches."""
    import tempfile

    from repro_torch.core import reset_process_state
    from repro_torch.kernels import agu, datapath

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_compressed_dp as DP
    import torch_kv_cache_serving as KV
    import torch_quickstart as QS
    import torch_train_lm as TL

    out = {}

    def example(name, kernels, body, failures, lines):
        t0 = time.perf_counter()
        rec, counts = drive(f"examples {name}", kernels, body)
        wall = time.perf_counter() - t0
        for line in lines(rec):
            log(f"[examples {name}] {line}")
        bad = failures(rec)
        check(not bad, f"examples {name}: {bad}")
        log(f"[examples {name}] {wall:.1f} s wall; kernel launches {counts} "
            f"on {card}")
        out[name] = {"s": wall, "launches": counts}
        return rec

    # the quickstart from a fresh process's state, on the card, then on the
    # CPU: every line it prints (the counters, the cost model's makespans
    # and speedups, the shapes and the flags) the CPU run's, which the CPU
    # tests hold to the reference script's; the trace paths aside
    trace = os.path.join(ROOT, "chiprun_out", "quickstart.trace.json")
    reset_process_state()
    rec = example("quickstart", [agu.RELAYOUT, datapath.STREAMED,
                                 datapath.BLOCK],
                  lambda: QS.run(device, trace_path=trace), QS.failures,
                  QS.lines)
    reset_process_state()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-qs-") as work:
        cpu = QS.run("cpu", trace_path=os.path.join(work, "t.json"))
    same = [QS.lines(dict(r, trace_export=("-", r["trace_export"][1])))
            for r in (rec, cpu)]
    differ = [(a, b) for a, b in zip(*same) if a != b]
    check(len(same[0]) == len(same[1]) and not differ,
          f"examples quickstart: lines on the card differ from the CPU "
          f"run's: {differ}")
    log(f"[examples quickstart] all {len(same[0])} lines equal the CPU "
        f"run's (its trace path aside)")
    del cpu
    log(f"[examples quickstart] the RMSNorm parities' max abs err (f32 chain "
        f"tolerance {QS.F32_TOL}): transfer {rec['transfer_parity'][1]}, "
        f"async {rec['async_parity'][1]}; bitwise: kernel==plain, "
        f"compressed roundtrip, ring outputs, autotune round trip")
    out["quickstart"]["errors"] = {
        k: rec[k][1] for k in ("transfer_parity", "async_parity")}

    undo = no_tf32()
    try:
        rec = example("kv_cache_serving", [datapath.BLOCK],
                      lambda: KV.run(device), KV.failures, KV.lines)
        cpu = KV.run("cpu")
    finally:
        undo()
    check(rec["decoded"] == cpu["decoded"],
          f"examples kv_cache_serving: the card decoded {rec['decoded']}, "
          f"the CPU {cpu['decoded']}")
    log(f"[examples kv_cache_serving] the store's max abs err "
        f"{rec['store_parity'][1]} (f32 chain tolerance {KV.F32_TOL}), the "
        f"load bitwise; decoded tokens equal the CPU run's {cpu['decoded']}")
    del rec, cpu

    gc.collect()
    torch.cuda.empty_cache()
    rec = example("compressed_dp", [], lambda: DP.run(device), DP.failures,
                  DP.lines)
    log(f"[examples compressed_dp] {DP.WORKERS} ranks ({rec['backend']}), "
        f"launches by rank {rec['launches']}")
    cpu = DP.run("cpu")
    bitwise = [name for name, a, b in
               [("reduced", rec["reduced"], cpu["reduced"])]
               + [(f"residual {r}", a, b)
                  for r, (a, b) in enumerate(zip(rec["errs"], cpu["errs"]))]
               if not torch.equal(a.view(torch.int32), b.view(torch.int32))]
    check(not bitwise and DP.lines(rec) == DP.lines(cpu),
          f"examples compressed_dp: the card's {bitwise} not bitwise the CPU "
          f"run's, or its lines {DP.lines(rec)} not the CPU's "
          f"{DP.lines(cpu)}")
    log(f"[examples compressed_dp] the reduced gradient and the {DP.WORKERS} "
        f"residuals bitwise the CPU run's; its lines equal")
    del cpu
    out["compressed_dp"].update(rel_err=rec["rel_err"],
                                rank_launches=rec["launches"])

    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-lm-") as work:
        rec = example("train_lm", [agu.RELAYOUT],
                      lambda: TL.run(device, full=True, ckpt_dir=work,
                                     **EX_TRAIN),
                      TL.failures, TL.lines)
    log(f"[examples train_lm] --full-100m: losses {rec['losses']}, resumed "
        f"from step {rec['restart_step']} {rec['resumed_losses']}")
    out["train_lm"].update(losses=rec["losses"])
    del rec
    gc.collect()
    torch.cuda.empty_cache()
    total = {k: sum(v["launches"][k] for v in out.values())
             for k in ("agu_relayout", "streamed_datapath", "block_datapath")}
    check(all(total.values()), f"examples: kernel launches {total}")
    return out


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
    print(card, flush=True)

    # each phase's seconds, on a line of its own as it ends (the time limit)
    phase_s, mark = {}, [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now
        log(f"[phase seconds] {name}: {phase_s[name]:.1f} s on {card}")

    t0 = time.perf_counter()
    # phase 20 (c)-(f) launches no kernel: its world trains on the card
    # while nvcc builds, and is joined before any kernel is driven or timed
    pool = concurrent.futures.ThreadPoolExecutor(1)
    slots = pool.submit(phase20_slots, card)
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
    # true>" (true: the head dim is the instance width), "flash_wgmma_kernel<
    # __half, 256>"; every tensor-core instance (mma: 2 dtypes x 4 widths x
    # full or not; wgmma: 2 dtypes x 3 widths) must be found and must not
    # spill, and ptxas must not have serialized a wgmma instance's products
    # (its note C7518)
    k6_log = _build.BUILD_LOG.get("flash_attention.cu", "")
    mma_spills, wgmma_mangled = {}, {}
    for mangled, regs, stack, spill in ptxas_entries(k6_log):
        name = re.search(r"\d(flash_wgmma_kernel|flash_mma_kernel|"
                         r"flash_kernel|flash_chunked_kernel)I"
                         r"(6__half|13__nv_bfloat16|f)Li(\d+)E(Lb([01])E)?",
                         mangled)
        if name:
            dtype = {"f": "float"}.get(name.group(2),
                                       name.group(2).lstrip("0123456789"))
            full = ("" if name.group(5) is None
                    else ", " + ("true" if name.group(5) == "1" else "false"))
            inst = f"{name.group(1)}<{dtype}, {name.group(3)}{full}>"
            log(f"[ptxas] {inst}: {regs} registers, {stack} bytes of stack, "
                f"{spill} bytes of spill traffic")
            if name.group(1) != "flash_kernel" and \
                    name.group(1) != "flash_chunked_kernel":
                mma_spills[inst] = spill
            if name.group(1) == "flash_wgmma_kernel":
                wgmma_mangled[inst] = mangled
    want_inst = {f"flash_mma_kernel<{t}, {hd}, {full}>"
                 for t in ("__half", "__nv_bfloat16")
                 for hd in (16, 32, 64, 128) for full in ("true", "false")}
    want_inst |= {f"flash_wgmma_kernel<{t}, {hd}>"
                  for t in ("__half", "__nv_bfloat16") for hd in (64, 128, 256)}
    check(set(mma_spills) == want_inst,
          f"kernel6: the build log of flash_attention.cu names tensor-core "
          f"instances {sorted(mma_spills)}, not {sorted(want_inst)} (a "
          f"library built without its log: remove build/kernels)")
    check(not any(mma_spills.values()),
          f"kernel6: tensor-core instances spill: "
          f"{ {k: v for k, v in mma_spills.items() if v} }")
    serial = [inst for inst, m in wgmma_mangled.items()
              if re.search(r"C7518[^\n]*" + re.escape(m), k6_log)]
    check(not serial, f"kernel6: ptxas serialized the wgmma products of "
                      f"{serial}")
    # the wgmma instances run on Hopper's warpgroup tensor cores: SASS HGMMA
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass",
                           str(_build._target("flash_attention.cu"))],
                          capture_output=True, text=True, timeout=300).stdout
    hgmma = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        mangled = fn.split("\n", 1)[0].strip()
        inst = next((i for i, m in wgmma_mangled.items() if m == mangled),
                    None)
        if inst:
            hgmma[inst] = (fn.count("HGMMA"), fn.count("UTMALDG"),
                           fn.count("UTMASTG"))
    log(f"[sass] kernel 6 wgmma instances (HGMMA, UTMALDG, UTMASTG): {hgmma}")
    check(set(hgmma) == set(wgmma_mangled) and
          all(h[0] and h[1] and h[2] for h in hgmma.values()),
          f"kernel6: the library's SASS lacks HGMMA or TMA copies in "
          f"{sorted(set(wgmma_mangled) - {i for i, h in hgmma.items() if all(h)})}")
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
    # kernel 3's generic path: 4 kernels x 2 carriers (f32 "f", int64 "x")
    # x 4 source element sizes x 2 index widths (uint32 "j", uint64 "m"),
    # and the tiled output pass's 2 x 4 32-bit instances; every one must be
    # found and none may spill
    k3_generic, k3_rank2_spill = {}, 0
    for mangled, regs, stack, spill in ptxas_entries(
            _build.BUILD_LOG.get("block_datapath.cu", "")):
        name = re.search(r"\d(out_kernel|out_tiled_kernel|out_reduce_kernel|"
                         r"stat_kernel|mask_kernel)I([fx])Li(\d)E([jm])E",
                         mangled)
        if name is None:
            k3_rank2_spill += spill
            continue
        fn, carrier, size, index = name.groups()
        inst = (f"{fn}<{'float' if carrier == 'f' else 'long long'}, "
                f"{size}, uint{32 if index == 'j' else 64}_t>")
        k3_generic[inst] = (regs, stack, spill)
    for fn in ("out_kernel", "out_tiled_kernel", "out_reduce_kernel",
               "stat_kernel", "mask_kernel"):
        got = {k: v for k, v in k3_generic.items() if k.startswith(fn + "<")}
        log(f"[ptxas] kernel 3 generic {fn}: {len(got)} instances, at most "
            f"{max((v[0] for v in got.values()), default=0)} registers, "
            f"{max((v[1] for v in got.values()), default=0)} bytes of stack, "
            f"{sum(v[2] for v in got.values())} bytes of spill traffic")
    log(f"[ptxas] kernel 3 rank-2 instances: {k3_rank2_spill} bytes of spill "
        f"traffic")
    check(len(k3_generic) == 72,
          f"kernel3: the build log of block_datapath.cu names "
          f"{len(k3_generic)} generic instances, not 72 (a library built "
          f"without its log: remove build/kernels)")
    check(not any(v[2] for v in k3_generic.values()),
          f"kernel3: generic instances spill: "
          f"{ {k: v for k, v in k3_generic.items() if v[2]} }")
    # the rank-2 instances' spill, held to what the batched twins measured
    # when they came in (2170 bytes over the file, NVIDIA H100 80GB HBM3)
    check(k3_rank2_spill <= K3_RANK2_SPILL_BYTES,
          f"kernel3: rank-2 instances spill {k3_rank2_spill} bytes, above "
          f"the {K3_RANK2_SPILL_BYTES} they were measured at")
    slot_times = slots.result()
    pool.shutdown()
    log(f"[build] phase 20 (c)-(f) joined {time.perf_counter() - t0:.1f} s "
        f"after the build started")
    # phase 22 (d) counts on the host while the card runs phases 2-21
    dry = start_dryrun()

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
        log(f"[{phase}] launches {counts}; by path: kernel 1 "
            f"{agu.RELAYOUT.paths}, kernel 2 {datapath.STREAMED.paths}, "
            f"kernel 3 {datapath.BLOCK.paths}, kernel 6 {FA.FLASH.paths}")
        return out, counts

    phase_done("build (phase 20 (c)-(f) alongside)")

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

    phase_done("phase 2")

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

    phase_done("phase 3")

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
    # the checkpoint's down-cast wire on qwen3-1.7b's (2048, 6144) f32 MLP
    # leaf: Cast(bf16), Compress(8), Decompress, MN -> MN; a cast between
    # dtypes, so a mask pass and an output pass on the generic path, bitwise
    # the plain chain and x.to(torch.bfloat16)
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    mlp = torch.randn(2048, 6144, generator=gen, device=dev)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-wire-") as root:
        down = CheckpointManager(root, stage_dtype=torch.bfloat16,
                                 wire_compress_blocks=8)
        wire = down.stage_descriptor(mlp, torch.bfloat16)
        _build.reset_launches()
        y_down = down._stage(mlp, torch.bfloat16)
    torch.cuda.synchronize()
    check(datapath.BLOCK.paths == {"generic": 2},
          f"kernel3: the down-cast wire's paths {datapath.BLOCK.paths}, "
          f"expected its mask and output passes on the generic path")
    assert_bitwise(y_down, plain(mlp, wire), "kernel3 down-cast wire vs the "
                   "plain chain")
    lib_down = lambda: mlp.to(torch.bfloat16)  # noqa: E731
    assert_bitwise(lib_down(), y_down, "kernel3 down-cast wire library "
                   "yardstick")
    run_down = plugin_compiler.compile_local(wire)
    pair_times.append({
        "pair": f"checkpoint down-cast wire (generic): {wire.summary()} "
                f"2048x6144", "dtype": "float32 -> bfloat16",
        "paths": dict(datapath.BLOCK.paths),
        "ms": gpu_ms(lambda: run_down(mlp)),
        "plain_ms": gpu_ms(lambda: plain(mlp, wire)),
        "library_ms": gpu_ms(lib_down),
        "bound_ms": bound_ms(nbytes(mlp, y_down))})
    log_case("kernel3", pair_times[-1])
    log(f"[kernel3] the down-cast wire: library (x.to(bfloat16)) "
        f"{pair_times[-1]['library_ms']:.4f} ms on {card}")
    del mlp, y_down
    # a cast and a transpose on the generic path, 4096 x 4096 f32 -> bf16:
    # the source runs across the output's rows, so the output pass stages
    # through a shared tile; bitwise the plain chain and the library call
    sq = torch.randn(4096, 4096, generator=gen, device=dev)
    ct = describe("MN", "MN", P.Cast(torch.bfloat16), P.Transpose())
    run_ct = plugin_compiler.compile_local(ct)
    _build.reset_launches()
    y_ct = run_ct(sq)
    torch.cuda.synchronize()
    check(datapath.BLOCK.paths == {"generic": 1},
          f"kernel3: the cast + transpose's paths {datapath.BLOCK.paths}, "
          f"expected one output pass on the generic path")
    assert_bitwise(y_ct, plain(sq, ct), "kernel3 cast + transpose vs the "
                   "plain chain")
    lib_ct = lambda: sq.transpose(-1, -2).to(  # noqa: E731
        torch.bfloat16).contiguous()
    assert_bitwise(lib_ct(), y_ct, "kernel3 cast + transpose library "
                   "yardstick")
    pair_times.append({
        "pair": f"cast + transpose (generic, tiled): {ct.summary()} "
                f"4096x4096", "dtype": "float32 -> bfloat16",
        "paths": dict(datapath.BLOCK.paths),
        "ms": gpu_ms(lambda: run_ct(sq)),
        "plain_ms": gpu_ms(lambda: plain(sq, ct)),
        "library_ms": gpu_ms(lib_ct),
        "bound_ms": bound_ms(nbytes(sq, y_ct))})
    log_case("kernel3", pair_times[-1])
    log(f"[kernel3] the cast + transpose: library (transpose(-1, -2)"
        f".to(bfloat16).contiguous()) {pair_times[-1]['library_ms']:.4f} ms "
        f"on {card}")
    del sq, y_ct
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
    # the streams and ranks above 8 kernel 3 once refused (ROADMAP §3,
    # faults 10 and 11)
    phase4_streams(dev, gen, card, drive, pair_times)
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

    phase_done("phase 4")

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

    phase_done("phase 5")

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

    phase_done("phase 6")

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

    phase_done("phase 7")

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
    check(FA.FLASH.paths == {"wgmma": len(attn_in)},
          f"kernel6: the bf16 model layers took paths {FA.FLASH.paths}, "
          f"not the Hopper tensor-core path (wgmma) each")

    def k6_named(path, q, k, v, out, **kw):
        """Kernel 6 on ``path`` through its C entry point, the arguments as
        the wrapper builds them with that path named in them: the path
        ``_path`` does not pick for this shape, timed beside it."""
        a = FA.flash_args(q, k, v, out, **kw)
        a.path = FA.PATHS.index(path)
        return lambda: FA.FLASH(ctypes.addressof(a), q.data_ptr(),
                                k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                path=path)

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
    check(FA.FLASH.paths.get("mma") == 1,
          f"kernel6: the f16 check (hd 32) took paths {FA.FLASH.paths}, not "
          f"mma")
    log(f"[kernel6] paths: model layers {{'wgmma': {len(attn_in)}}}, small "
        f"checks f32 on fma, f16 hd 32 on mma; all within tolerance")
    # head dims between the instance widths (hd 8: the qwen2 smoke width,
    # on the mma path; 80 and 192 on the wgmma path, zero-padded to 128 and
    # 256) and mixed dtypes (cast up to their promotion, the result in q's
    # dtype), GQA with a window
    hd_cases = (("hd 8 bf16", 8, torch.bfloat16, torch.bfloat16, "mma"),
                ("hd 80 bf16", 80, torch.bfloat16, torch.bfloat16, "wgmma"),
                ("hd 192 bf16", 192, torch.bfloat16, torch.bfloat16,
                 "wgmma"),
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
    # the wgmma path's edges: (what, B, Sq, Sk, H, KV, hd, dtype, causal,
    # window) against the plain version, each one wgmma launch; then a view
    # one element past a 16-byte boundary, which TMA cannot address: one
    # mma launch
    wg_cases = (("f16 GQA causal, ragged S 1000", 2, 1000, 1000, 4, 2, 128,
                 torch.float16, True, None),
                ("Sq 300 < Sk 700, not causal", 1, 300, 700, 4, 2, 128,
                 torch.bfloat16, False, None),
                ("Sq 700 > Sk 300, causal", 1, 700, 300, 4, 2, 128,
                 torch.bfloat16, True, None),
                ("S 1000, causal window 200", 1, 1000, 1000, 4, 2, 128,
                 torch.bfloat16, True, 200),
                ("window 0 (no live key)", 1, 256, 256, 2, 2, 128,
                 torch.bfloat16, True, 0),
                ("hd 64 f16 window 96 not causal", 1, 520, 520, 4, 1, 64,
                 torch.float16, False, 96),
                ("hd 256 S 520 window 300", 1, 520, 520, 4, 2, 256,
                 torch.bfloat16, True, 300))
    for what, B, Sq, Sk, H, KV, hd, dt, causal, window in wg_cases:
        sm = [(torch.randn(B, n, h, hd, generator=gen, device=dev) / s_).to(dt)
              for n, h, s_ in ((Sq, H, 4), (Sk, KV, 4), (Sk, KV, 1))]
        before = dict(FA.FLASH.paths)
        got = FA.flash_attention_gqa(*sm, causal=causal, window=window)
        torch.cuda.synchronize()
        check(FA.FLASH.paths.get("wgmma", 0) == before.get("wgmma", 0) + 1
              and sum(FA.FLASH.paths.values()) == sum(before.values()) + 1,
              f"kernel6 {what}: paths {FA.FLASH.paths}, expected one wgmma")
        want = FA.flash_attention_gqa_plain(*sm, causal=causal,
                                            window=window)
        assert_close(got, want, attn_tol, f"kernel6 {what} vs plain")
        log(f"[kernel6] {what} (wgmma): max abs err {max_abs_err(got, want)} "
            f"within {attn_tol}")
    base = torch.randn(1, 200, 2, 66, generator=gen, device=dev).to(
        torch.bfloat16)
    uq = base.reshape(-1)[1:1 + 200 * 2 * 64].view(1, 200, 2, 64)
    check(FA.flash_args(uq, uq, uq, torch.empty_like(uq), causal=True,
                        window=None).vec == 0, "kernel6: the view is aligned")
    before = dict(FA.FLASH.paths)
    got = FA.flash_attention_gqa(uq, uq, uq, causal=True)
    torch.cuda.synchronize()
    check(FA.FLASH.paths.get("mma", 0) == before.get("mma", 0) + 1
          and sum(FA.FLASH.paths.values()) == sum(before.values()) + 1,
          f"kernel6 unaligned view: paths {FA.FLASH.paths}, expected one mma")
    want = FA.flash_attention_gqa_plain(uq, uq, uq, causal=True)
    assert_close(got, want, attn_tol, "kernel6 unaligned view vs plain")
    log(f"[kernel6] unaligned view (mma): max abs err "
        f"{max_abs_err(got, want)} within {attn_tol}")
    del base, uq
    # the widest instance, timed: hd 256 (wgmma path in bf16), S 2048, 8
    # heads; the FMA path's 256-wide instance on the same inputs beside it
    wide = [torch.randn(1, 2048, 8, 256, generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3)]
    before = FA.FLASH.paths.get("wgmma", 0)
    wide_out = FA.flash_attention_gqa(*wide, causal=True)
    check(FA.FLASH.paths.get("wgmma", 0) == before + 1,
          f"kernel6 hd 256: paths {FA.FLASH.paths}, expected one wgmma")
    wide_want = FA.flash_attention_gqa_plain(*wide, causal=True)
    assert_close(wide_out, wide_want, attn_tol, "kernel6 hd 256 bf16")
    wide_fma_out = torch.empty_like(wide_out)
    wide_fma = k6_named("fma", *wide, wide_fma_out, causal=True, window=None)
    wide_fma()
    assert_close(wide_fma_out, wide_want, attn_tol,
                 "kernel6 hd 256 bf16, fma path")
    wt = [t.transpose(1, 2).contiguous() for t in wide]
    wflops = 4 * 8 * 256 * (2048 * 2049 // 2)
    wide_run = lambda: FA.flash_attention_gqa(*wide, causal=True)  # noqa: E731
    wide_ms = gpu_ms(wide_run, reps=5)
    wide_fma_ms = gpu_ms(wide_fma, reps=3)
    wide_ms = (wide_ms + gpu_ms(wide_run, reps=5)) / 2
    wide_plain = gpu_ms(lambda: FA.flash_attention_gqa_plain(*wide,
                                                             causal=True),
                        reps=3, warmup=1)
    wide_lib = gpu_ms(lambda: F.scaled_dot_product_attention(
        *wt, is_causal=True), reps=5)
    wide_bound = max(wflops / BF16_FLOPS,
                     nbytes(*wide, wide_out) / HBM_BYTES_PER_S) * 1e3
    log(f"[kernel6] hd 256 bf16 (wgmma path) B1 S2048 H8: {wide_ms:.4f} ms "
        f"(fma path {wide_fma_ms:.4f}), plain {wide_plain:.4f} ms, SDPA "
        f"{wide_lib:.4f} ms, bound {wide_bound:.4f} ms "
        f"({wflops / wide_ms / 1e9:.1f} TFLOP/s) on {card}")
    pair_times.append({"pair": "flash_attention_gqa hd256 B1 S2048 H8 KV8 "
                               "causal (wgmma path)",
                       "dtype": "torch.bfloat16",
                       "ms": wide_ms, "fma_ms": wide_fma_ms,
                       "plain_ms": wide_plain, "library_ms": wide_lib,
                       "bound_ms": wide_bound, "flops": wflops})
    del wide, wt, wide_out, wide_want, wide_fma_out
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
        # the PR 17 design (mma.sync) on the same inputs, checked, then
        # timed in turns with the wgmma path: wgmma, mma, mma, wgmma
        mma_out = torch.empty_like(out)
        mma_run = k6_named("mma", *qkv, mma_out, causal=True, window=window)
        mma_run()
        assert_close(mma_out, want, attn_tol, f"kernel6 {name}, mma path")
        wg_run = lambda: FA.flash_attention_gqa(   # noqa: E731
            *qkv, causal=True, window=window)
        turns = [gpu_ms(f, reps=5) for f in (wg_run, mma_run, mma_run,
                                             wg_run)]
        r = {"pair": f"flash_attention_gqa {name} B{B} S{S} H{H} "
                     f"KV{qkv[1].shape[2]} hd{hd} window {window}",
             "dtype": "torch.bfloat16", "max_abs_err": max_abs_err(out, want),
             "ms": (turns[0] + turns[3]) / 2,
             "mma_ms": (turns[1] + turns[2]) / 2,
             "plain_ms": gpu_ms(lambda: FA.flash_attention_gqa_plain(
                 *qkv, causal=True, window=window), reps=3, warmup=1),
             "library_ms": gpu_ms(lib),
             "flops": flops,
             "bound_ms": max(flops / BF16_FLOPS,
                             nbytes(*qkv, out) / HBM_BYTES_PER_S) * 1e3}
        pair_times.append(r)
        log(f"[kernel6] {name}: within {attn_tol} of the plain version "
            f"(max abs err {r['max_abs_err']}); wgmma {r['ms']:.4f} ms "
            f"(turns {turns[0]:.4f}, {turns[3]:.4f}), mma "
            f"{r['mma_ms']:.4f} ({turns[1]:.4f}, {turns[2]:.4f}), plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} ({flops / r['ms'] / 1e9:.1f} TFLOP/s, "
            f"{r['bound_ms'] / r['ms']:.1%} of the bound) on {card}")
        del want, mma_out
    r = pair_times[-2]                            # the phi4-mini prefill
    rows["flash_attention"] = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": FA.FLASH.replaces, "launches": counts["flash_attention"],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "operations", "library_ms": r["library_ms"],
        "shape": r["pair"] + " bfloat16 causal"}

    phase_done("phase 8")

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

    phase_done("phase 9")

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

    phase_done("phase 10")

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

    phase_done("phase 11")

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
    for k, t in ranks[0]["side_ms"].items():
        more = "" if "bound_ms" not in t else (
            f" ({t['shape']}, paths {t['paths']}), plain "
            f"{t['plain_ms']:.4f} ms, library "
            f"(transpose(-1, -2).contiguous()) {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_ms'] / t['ms']:.1%} of "
            f"the bound)")
        log(f"[collectives] {k} alone: {t['ms']:.4f} ms of device time (rank "
            f"0 alone on the card){more} on {card}")
    log(f"[collectives] the gradient leaf (96 MiB) to the host and back "
        f"alone: {statistics.median(rk['hop_ms'] for rk in ranks):.3f} ms on "
        f"{card}; phase {coll_s:.1f} s with 4 process starts; launches by "
        f"rank {[rk['counts'] for rk in ranks]}")

    phase_done("phase 12")

    # -- phase 13: the movement-plane consumers, one process -------------------
    cons = phase13(dev, gen, card, drive, wall_ms)

    phase_done("phase 13")

    # -- phase 14: the serving path, full phi4-mini through ServingEngine ------
    serving, cfg14, params14 = phase14(dev, gen, card, drive)

    phase_done("phase 14")

    # -- phase 15: continuous batching on the phase-14 model ---------------------
    continuous = phase15(dev, gen, card, drive, cfg14, params14)
    del params14
    torch.cuda.empty_cache()

    phase_done("phase 15")

    # -- phase 16: an MoE model served at full width -----------------------------
    moe_serving = phase16(dev, gen, card, drive)

    phase_done("phase 16")

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
        f"int8 wire {[rk['out']['int8_rel'] for rk in ep]}; its backward's "
        f"all-to-all bytes a rank {[rk['out']['int8_bwd']['bwd_bytes'] for rk in ep]} "
        f"(the plain version's {[rk['out']['int8_bwd']['plain_bwd_bytes'] for rk in ep]}), "
        f"gradients bitwise the plain version's "
        f"{[rk['out']['int8_bwd']['bitwise'] for rk in ep]}; launches on the "
        f"int8 wire by rank {[rk['counts'] for rk in ep]}; phase {ep_s:.1f} s "
        f"with 4 process starts on {card}")

    phase_done("phase 17")

    # -- phase 18: training at full qwen3-1.7b width -----------------------------
    gc.collect()
    torch.cuda.empty_cache()
    training = phase18(dev, gen, card, drive)
    torch.cuda.empty_cache()

    phase_done("phase 18")

    # -- phase 19: data-parallel training, 4 ranks on the one card ---------------
    dp_times = phase19(card)

    phase_done("phase 19")

    # -- phase 20: the sharded trainer, 4 ranks on the one card ------------------
    tp_times = phase20(card, slot_times)

    phase_done("phase 20")

    # -- phase 21: sharded serving, 4 ranks on the one card ----------------------
    serve_times = phase21(card)

    phase_done("phase 21")

    # -- phase 22: the production mesh's last regimes, 4 ranks on the card ------
    pod_times = phase22(card, dry, training["step_peak_bytes"])

    phase_done("phase 22")

    # -- the examples phase: the user's four entry points ---------------------
    examples = phase_examples(card, drive)
    phase_done("examples")
    log(f"[phase seconds] all phases: {sum(phase_s.values()):.1f} s on {card}")

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
                   "moe_ep": {"ms": moe_ep, "ranks": ep, "phase_s": ep_s},
                   "training": training, "dp_training": dp_times,
                   "sharded_training": tp_times,
                   "sharded_serving": serve_times,
                   "production_regimes": pod_times,
                   "examples": examples, "phase_s": phase_s},
                  f, indent=1)
    print(json.dumps({"kernels": [{k: rows[n][k] for k in ROW_KEYS}
                                  for n in order]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
