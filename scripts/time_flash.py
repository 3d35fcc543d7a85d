"""Time kernel 6 (flash attention) on one NVIDIA GPU, path beside path.

Run from the root of a checkout::

    python3 scripts/time_flash.py

It builds kernel 6, prints each ``wgmma`` instance's registers and spills
(``nvcc -Xptxas -v``), any note that ptxas serialized its ``wgmma``
products, and the counts of HGMMA, UTMALDG and UTMASTG instructions in its
SASS (``cuobjdump``).  Then, in a child process, it holds 17 shapes to the
plain version (rtol 2e-2, atol 2e-3: bf16 and f16, GQA, Sq != Sk, ragged
tails, windows, a window of 0, head dims 40 to 256, an unaligned view on
the ``mma`` path).  Then it times, in GPU time (CUDA events, median of 10
calls after 3 warm-up calls), the ``wgmma`` path and the path it replaced
(``mma``, or ``fma`` at hd 256) through the C entry point, in turns (A, B,
A, B), beside ``scaled_dot_product_attention`` and the bound (the live
pairs' 4 hd flops each at 989 TFLOP/s): the phi4-mini and gemma3-27B
layers of ``chip_smoke.py`` phase 8, hd 256 and hd 64, and two long shapes
(S 16384 causal, S 8192 full; 16 heads of 128) where the per-tile start
and end weigh little.  Needs one card; writes the build log to
``chiprun_out/k6_build.txt``.
"""
import ctypes
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak


def log(*a):
    print(*a, flush=True)


def checks():
    from repro_torch.kernels import flash_attention as FA
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [  # B, Sq, Sk, H, KV, hd, causal, window, dtype
        (1, 256, 256, 2, 1, 64, True, None, torch.bfloat16),
        (1, 256, 256, 2, 1, 128, True, None, torch.bfloat16),
        (1, 256, 256, 2, 1, 128, False, None, torch.bfloat16),
        (1, 256, 256, 2, 1, 256, True, None, torch.bfloat16),
        (2, 1000, 1000, 4, 2, 128, True, None, torch.bfloat16),
        (1, 300, 700, 4, 2, 128, False, None, torch.float16),
        (1, 700, 300, 4, 2, 128, True, None, torch.bfloat16),
        (1, 1000, 1000, 4, 2, 128, True, 200, torch.bfloat16),
        (1, 256, 256, 2, 2, 128, True, 0, torch.bfloat16),
        (1, 500, 500, 4, 2, 80, True, 64, torch.bfloat16),
        (1, 500, 500, 4, 2, 192, True, 64, torch.bfloat16),
        (1, 520, 520, 4, 1, 256, False, None, torch.float16),
        (1, 333, 333, 2, 1, 40, True, None, torch.bfloat16),
        (3, 4096, 4096, 24, 8, 128, True, None, torch.bfloat16),
        (1, 4096, 4096, 32, 16, 128, True, 1024, torch.bfloat16),
        (2, 2000, 2000, 8, 2, 64, True, 300, torch.float16),
    ]
    ok = True
    for B, Sq, Sk, H, KV, hd, causal, window, dt in cases:
        q = (torch.randn(B, Sq, H, hd, generator=g, device=dev) / 2).to(dt)
        k = (torch.randn(B, Sk, KV, hd, generator=g, device=dev) / 2).to(dt)
        v = torch.randn(B, Sk, KV, hd, generator=g, device=dev).to(dt)
        FA.FLASH.paths.clear()
        got = FA.flash_attention_gqa(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = FA.flash_attention_gqa_plain(q, k, v, causal=causal,
                                            window=window)
        err = (got.float() - want.float()).abs().max().item()
        good = torch.allclose(got.float(), want.float(), rtol=2e-2,
                              atol=2e-3) and FA.FLASH.paths == {"wgmma": 1}
        ok &= good
        log(f"check B{B} Sq{Sq} Sk{Sk} H{H} KV{KV} hd{hd} causal {causal} "
            f"window {window} {dt}: paths {dict(FA.FLASH.paths)}, max abs "
            f"err {err:.3e}, ok {good}")
    base = torch.randn(1, 200, 2, 66, generator=g, device=dev).to(
        torch.bfloat16)
    q = base[..., :64]                  # rows of 132 bytes: TMA cannot
    FA.FLASH.paths.clear()
    got = FA.flash_attention_gqa(q, q, q, causal=True)
    want = FA.flash_attention_gqa_plain(q, q, q, causal=True)
    good = torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-3) \
        and FA.FLASH.paths == {"mma": 1}
    ok &= good
    log(f"check unaligned view: paths {dict(FA.FLASH.paths)}, ok {good}")
    return ok


def gpu_ms(fn, reps=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s, e = torch.cuda.Event(True), torch.cuda.Event(True)
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        ts.append(s.elapsed_time(e))
    ts.sort()
    return ts[len(ts) // 2]


def timing():
    from repro_torch.kernels import flash_attention as FA
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    # name, B, S, H, KV, hd, causal, window
    shapes = [("phi4-mini prefill", 1, 4096, 24, 8, 128, True, None),
              ("gemma3-27B local", 1, 4096, 32, 16, 128, True, 1024),
              ("hd 256", 1, 2048, 8, 8, 256, True, None),
              ("hd 64", 1, 4096, 32, 8, 64, True, None),
              ("long causal", 1, 16384, 16, 16, 128, True, None),
              ("long full", 1, 8192, 16, 16, 128, False, None)]
    for name, B, S, H, KV, hd, causal, window in shapes:
        q, k, v = (torch.randn(B, S, h, hd, generator=g, device=dev).to(
            torch.bfloat16) for h in (H, KV, KV))
        out = torch.empty_like(q)

        def via(path):
            a = FA.flash_args(q, k, v, out, causal=causal, window=window)
            a.path = FA.PATHS.index(path)
            return lambda: FA.FLASH(ctypes.addressof(a), q.data_ptr(),
                                    k.data_ptr(), v.data_ptr(),
                                    out.data_ptr(), path=path)
        old = "mma" if hd <= 128 else "fma"
        res = {}
        for path in ("wgmma", old, "wgmma", old):
            res.setdefault(path, []).append(gpu_ms(via(path)))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if window is None:
            lib = gpu_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
            pairs = S * (S + 1) // 2 if causal else S * S
        else:
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - window)
            lib = gpu_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
            pairs = int(mask.sum())
        flops = 4 * B * H * hd * pairs
        best = min(res["wgmma"])
        log(f"time {name} B{B} S{S} H{H} KV{KV} hd{hd}: wgmma "
            f"{res['wgmma']} ms, {old} {res[old]} ms, SDPA {lib:.4f} ms, "
            f"bound {flops / BF16_FLOPS * 1e3:.4f} ms; wgmma "
            f"{flops / best / 1e9:.1f} TFLOP/s")


def main():
    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 2
    log(sys.version.split()[0], torch.__version__, torch.version.cuda)
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip())
    from repro_torch.kernels import _build
    t0 = time.time()
    lib = _build.build_all(["flash_attention.cu"])[0]
    log(f"build {time.time() - t0:.1f} s")
    text = _build.BUILD_LOG["flash_attention.cu"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k6_build.txt"), "w") as f:
        f.write(text)
    for line in text.splitlines():
        if "C7518" in line or "error" in line.lower():
            log("  ", line[:300])
    for ent in re.split(r"Compiling entry function", text)[1:]:
        name = re.match(r"\s*'(\w+)'", ent).group(1)
        if "wgmma" in name:
            regs = re.search(r"Used (\d+) registers", ent)
            spill = re.findall(r"(\d+) bytes spill", ent)
            log("  ptxas", name[-60:], regs.group(0) if regs else "?",
                "spill bytes", spill)
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)],
                          capture_output=True, text=True).stdout
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0]
        if "wgmma" in name:
            log("  sass", name.strip()[-60:], "HGMMA", fn.count("HGMMA"),
                "UTMALDG", fn.count("UTMALDG"), "UTMASTG",
                fn.count("UTMASTG"))
    r = subprocess.run([sys.executable, __file__, "checks"], timeout=300)
    log("checks rc", r.returncode)
    if r.returncode:
        return 1
    r = subprocess.run([sys.executable, __file__, "timing"], timeout=600)
    log("timing rc", r.returncode)
    return r.returncode


if __name__ == "__main__":
    if sys.argv[1:] == ["checks"]:
        sys.exit(0 if checks() else 1)
    elif sys.argv[1:] == ["timing"]:
        timing()
    else:
        sys.exit(main())
