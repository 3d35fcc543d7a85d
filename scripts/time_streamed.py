"""Time kernel 2 (the streamed datapath) of one checkout on one NVIDIA GPU.

Run from the root of a checkout, naming the checkout whose port to time
(by default this one)::

    python3 scripts/time_streamed.py [ROOT]

It builds that checkout's kernels 2 and 4 and times, in GPU time (CUDA
events, median of 15 calls after 3 warm-up calls):

* kernel 2's two main-path launches of ``chip_smoke.py``: the Prefill
  RMSNorm store, 8192 x 3072 bf16 with a weight, MN -> MNM16N128, and
  Cast(bf16) -> Scale(1.5) -> BiasAdd(0.25) on 8192 x 3072 f32 into the
  same layout;
* the same store at gemma3-27B width (8192 x 5376 bf16);
* kernel 4 (``ops.rmsnorm_relayout``) on both stores, the same work;
* parts of the phi4-mini store on kernel 2: the bare copy (an Identity
  chain), the RMSNorm without its weight, and the store into MN.

Each time goes beside its bound, the bytes the call must move at 3.35
TB/s.  Timing two checkouts in one call, in turns (A, B, B, A), compares
them on one card.  The last line is one JSON object with the card's name
and power limit and every time.
"""
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
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


def main():
    if not torch.cuda.is_available():
        print("time_streamed: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import plugins as P
    from repro_torch.core import plugin_compiler
    from repro_torch.core.descriptor import describe
    from repro_torch.kernels import _build, ops

    _build.build_all(["streamed_datapath.cu", "rmsnorm_relayout.cu"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for name, n in (("phi4-mini", 3072), ("gemma3-27B", 5376)):
        w = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn(8192, n, generator=gen, device=dev).to(torch.bfloat16)
        run = plugin_compiler.compile_local(
            describe("MN", "MNM16N128", P.RMSNormPlugin(weight=w)))
        y = run(x)
        moved = 2 * x.numel() * x.element_size() + w.numel() * 2
        cases.append((f"k2 store {name} 8192x{n} bf16", lambda r=run, x=x:
                      r(x), moved))
        cases.append((f"k4 store {name} 8192x{n} bf16", lambda x=x, w=w:
                      ops.rmsnorm_relayout(x, w, (16, 128)), moved))
        del y
        if name != "phi4-mini":
            continue
        for what, dst, chain in (("copy (Identity)", "MNM16N128",
                                  (P.Identity(),)),
                                 ("RMSNorm, no weight", "MNM16N128",
                                  (P.RMSNormPlugin(),)),
                                 ("store into MN", "MN",
                                  (P.RMSNormPlugin(weight=w),))):
            f = plugin_compiler.compile_local(describe("MN", dst, *chain))
            f(x)
            cases.append((f"k2 {what} {name} 8192x{n} bf16",
                          lambda f=f, x=x: f(x), 2 * x.numel() * 2))
    xf = torch.randn(8192, 3072, generator=gen, device=dev)
    run_cast = plugin_compiler.compile_local(describe(
        "MN", "MNM16N128", P.Cast(torch.bfloat16), P.Scale(1.5),
        P.BiasAdd(0.25)))
    cases.append(("k2 cast->scale->bias 8192x3072 f32->bf16",
                  lambda: run_cast(xf), xf.numel() * (4 + 2)))
    times = {}
    for name, fn, moved in cases:
        ms = gpu_ms(fn)
        bound = moved / HBM_BYTES_PER_S * 1e3
        times[name] = {"ms": ms, "bound_ms": bound}
        print(f"[{os.path.basename(ROOT) or ROOT}] {name}: {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({bound / ms:.1%}) on {card}", flush=True)
    print(json.dumps({"root": ROOT, "card": card, "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
