"""Time kernel 3 (the block datapath) of one checkout on one NVIDIA GPU.

Run from the root of a checkout, naming the checkout whose port to time
(by default this one)::

    python3 scripts/time_block.py [ROOT] [--index64]

It builds that checkout's kernel 3 and times, in GPU time (CUDA events,
median of 15 calls after 3 warm-up calls), each beside its bound (the
bytes the call must move at 3.35 TB/s) and one PyTorch call that computes
the same function:

* the KV tunnel's source side, ``compile_side(MN, (Transpose(),),
  side="src")`` on a (1, 8192, 1024) bf16 stream (phi4-mini's KV shard),
  beside ``x.transpose(-1, -2).contiguous()``;
* the checkpoint's stacked leaf, a (2, 6144, 2048) f32 leaf through the
  Compress(8) -> Decompress wire, MN -> MN, beside ``clone``;
* the checkpoint's down-cast wire, ``CheckpointManager(stage_dtype=
  torch.bfloat16, wire_compress_blocks=8)`` on qwen3-1.7b's (2048, 6144)
  f32 MLP leaf (Cast f32 -> bf16, Compress(8), Decompress), beside
  ``x.to(torch.bfloat16)``;
* the checkpoint's save of qwen3-1.7b's embedding, (151936, 2048) f32,
  MN -> the at-rest MNM8N128 through the same wire (the rank-2 path at
  rank 2), beside ``permute(...).contiguous()``;
* the Load of ``chip_smoke.py``'s phase 4 (MNM16N128 -> MN + Transpose,
  8192 x 3072 bf16), the rank-2 path's main-path launch;
* a cast and a transpose, 4096 x 4096 f32 -> bf16, MN -> MN (the generic
  path; its output pass stages through a shared tile where the checkout
  has one), beside ``x.transpose(-1, -2).to(torch.bfloat16).contiguous()``;
* ``chip_smoke.py``'s small rank-3 chain, (2, 64, 256) f32 through
  Transpose, Scale, ReduceStage(max), RMSNorm (the generic path's
  statistics and reduce passes), beside no library call.

The build's wall seconds are printed too (near 0 where the checkout's
library is already built).  Each output is checked bitwise against the
plain version and the PyTorch
call (the rank-3 chain, whose RMSNorm sums in another order, within
1e-5), and the launches of each case are counted by path.  ``--index64``
runs the generic path's 64-bit index instances where the 32-bit ones
would run.  Timing two checkouts in one call, in turns (A, B, B, A),
compares them on one card.  The last line is one JSON object with the
card's name and power limit and every time.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
INDEX64 = "--index64" in sys.argv[1:]
ROOT = os.path.abspath(ARGS[0] if ARGS else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)


def gpu_ms(fn, reps=15, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)      # keeps the card busy while we enqueue
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def same_bits(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def main():
    if not torch.cuda.is_available():
        print("time_block: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import layouts as L
    from repro_torch.core import plugins as P
    from repro_torch.core import plugin_compiler
    from repro_torch.core.descriptor import describe
    from repro_torch.kernels import _build, datapath

    t0 = time.perf_counter()
    _build.build_all(["block_datapath.cu"])
    build_s = time.perf_counter() - t0
    if INDEX64:
        datapath._INDEX32 = 0      # no launch fits the 32-bit instances
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    plain = lambda x, d: datapath.plain(  # noqa: E731
        x, d.pre + d.post, d.src.layout, d.dst.layout)
    cases = []          # (name, run, plain, library, input, moved bytes)

    kv = torch.randn(1, 8192, 1024, generator=gen, device=dev).to(
        torch.bfloat16)
    side = plugin_compiler.compile_side(L.MN, (P.Transpose(),), side="src")
    cases.append(("kv tunnel src side (1, 8192, 1024) bf16", side,
                  lambda x: datapath.plain(x, (P.Transpose(),), L.MN, L.MN),
                  lambda x: x.transpose(-1, -2).contiguous(), kv,
                  2 * kv.numel() * 2))
    with tempfile.TemporaryDirectory(prefix="time-block-") as root:
        wire = CheckpointManager(root, wire_compress_blocks=8)
        stacked = torch.randn(2, 6144, 2048, generator=gen, device=dev)
        d = wire.stage_descriptor(stacked)
        cases.append(("stacked leaf (2, 6144, 2048) f32, Compress wire",
                      plugin_compiler.compile_local(d),
                      lambda x, d=d: plain(x, d), torch.clone, stacked,
                      2 * stacked.numel() * 4))
        emb = torch.randn(151936, 2048, generator=gen, device=dev)
        d = wire.stage_descriptor(emb, None, L.MNM8N128)
        cases.append(("embedding save (151936, 2048) f32 -> MNM8N128, "
                      "Compress wire", plugin_compiler.compile_local(d),
                      lambda x, d=d: plain(x, d),
                      lambda x: x.view(151936 // 8, 8, 2048 // 128,
                                       128).permute(0, 2, 1, 3).contiguous(),
                      emb, 2 * emb.numel() * 4))
        down = CheckpointManager(root, stage_dtype=torch.bfloat16,
                                 wire_compress_blocks=8)
        mlp = torch.randn(2048, 6144, generator=gen, device=dev)
        d = down.stage_descriptor(mlp, torch.bfloat16)
        cases.append(("down-cast wire (2048, 6144) f32 -> bf16",
                      plugin_compiler.compile_local(d),
                      lambda x, d=d: plain(x, d),
                      lambda x: x.to(torch.bfloat16), mlp,
                      mlp.numel() * (4 + 2)))
    xb = torch.randn(8192, 3072, generator=gen, device=dev).to(torch.bfloat16)
    xt = L.MNM16N128.from_logical(xb)
    load = describe("MNM16N128", "MN", P.Transpose(), backend="compiled")
    cases.append(("load MNM16N128->MN + Transpose 8192x3072 bf16",
                  plugin_compiler.compile_local(load),
                  lambda x: plain(x, load),
                  lambda x: x.permute(1, 3, 0, 2).reshape(3072, 8192), xt,
                  2 * xt.numel() * 2))
    sq = torch.randn(4096, 4096, generator=gen, device=dev)
    ct = describe("MN", "MN", P.Cast(torch.bfloat16), P.Transpose())
    cases.append(("cast + transpose 4096x4096 f32 -> bf16 (generic)",
                  plugin_compiler.compile_local(ct),
                  lambda x: plain(x, ct),
                  lambda x: x.transpose(-1, -2).to(torch.bfloat16).contiguous(),
                  sq, sq.numel() * (4 + 2)))
    sm = torch.randn(2, 64, 256, generator=gen, device=dev)
    r3 = describe("MN", "MN", P.Transpose(), P.Scale(2.0),
                  P.ReduceStage("max"), P.RMSNormPlugin())
    cases.append(("small rank-3 chain (2, 64, 256) f32 (generic)",
                  plugin_compiler.compile_local(r3), lambda x: plain(x, r3),
                  None, sm, sm.numel() * 4 + 2 * 64 * 4))

    times = {}
    for name, run, ref, lib, x, moved in cases:
        _build.reset_launches()
        got = run(x)
        torch.cuda.synchronize()
        paths = dict(datapath.BLOCK.paths)
        if lib is None:
            torch.testing.assert_close(got, ref(x), rtol=1e-5, atol=1e-5)
        elif not (same_bits(got, ref(x)) and same_bits(got, lib(x))):
            raise AssertionError(f"{name}: not bitwise its plain version and "
                                 f"its library call")
        ms = gpu_ms(lambda: run(x))
        lib_ms = None if lib is None else gpu_ms(lambda: lib(x))
        bound = moved / HBM_BYTES_PER_S * 1e3
        times[name] = {"ms": ms, "library_ms": lib_ms, "bound_ms": bound,
                       "paths": paths}
        lib_text = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"[{os.path.basename(ROOT) or ROOT}"
              f"{' --index64' if INDEX64 else ''}] {name}: {ms:.4f} ms "
              f"(paths {paths}), library {lib_text}, bound {bound:.4f} "
              f"ms ({bound / ms:.1%}) on {card}", flush=True)
    log = _build.BUILD_LOG.get("block_datapath.cu", "")
    print(f"[{os.path.basename(ROOT) or ROOT}] build {build_s:.1f} s on "
          f"{card}", flush=True)
    print(json.dumps({"root": ROOT, "index64": INDEX64, "card": card,
                      "build_s": build_s, "times": times,
                      "spill_bytes": sum(int(b) for b in re.findall(
                          r"(\d+) bytes spill", log))}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
