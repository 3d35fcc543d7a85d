"""How often the CPU's first batched f32 matmul of a process goes astray.

``chip_smoke.py`` holds kernel 6's f32 path against the plain version run on
the CPU.  On a host whose cores are busy, the first multithreaded batched
matmul of a process has been seen to return one batch element's results
about 5e-5 off a float64 reference, where the same call made again, or made
on one thread, comes within 1e-6.  This script counts it::

    python3 scripts/cpu_reference_check.py [--procs 40] [--busy 8]

It keeps ``--busy`` cores spinning and starts ``--procs`` fresh processes in
each of two modes, ``threads`` (torch's default intra-op threads) and
``one`` (``torch.set_num_threads(1)`` first).  Each process computes
``flash_attention_gqa_plain`` on the same seeded (2, 96, 4 / 2 / 2, 64) f32
input, window 24, as the first matmul it makes, and reports its largest
error against a float64 softmax attention of the same input.  The last
line is one JSON object: per mode, the processes run, those off by more
than 2e-5 (the check's atol) and the largest error seen.  Needs no GPU.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ATOL = 2e-5

CHILD = r"""
import sys
import torch
sys.path.insert(0, sys.argv[1])
if sys.argv[2] == "one":
    torch.set_num_threads(1)
from repro_torch.kernels import flash_attention as FA
gen = torch.Generator().manual_seed(0)
q, k, v = [torch.randn(2, 96, h, 64, generator=gen) for h in (4, 2, 2)]
got = FA.flash_attention_gqa_plain(q, k, v, window=24)
torch.set_num_threads(1)
qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
kd, vd = (t.repeat_interleave(2, dim=1) for t in (kd, vd))
s = qd @ kd.transpose(-1, -2) * 64 ** -0.5
i, j = torch.arange(96)[:, None], torch.arange(96)[None, :]
s = s.masked_fill(~((j <= i) & (j > i - 24)), float("-inf"))
want = (torch.softmax(s, -1) @ vd).transpose(1, 2)
print(float((got.double() - want).abs().max()))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=40)
    ap.add_argument("--busy", type=int, default=8)
    args = ap.parse_args()
    spin = [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(args.busy)]
    result = {}
    try:
        errs = {"threads": [], "one": []}
        for _ in range(args.procs):
            for mode, seen in errs.items():
                out = subprocess.run(
                    [sys.executable, "-c", CHILD, os.path.join(ROOT, "src"),
                     mode], capture_output=True, text=True, check=True)
                seen.append(float(out.stdout.split()[-1]))
        for mode, seen in errs.items():
            result[mode] = {"procs": len(seen),
                            "over_atol": sum(e > ATOL for e in seen),
                            "max_abs_err": max(seen)}
            print(f"{mode}: {result[mode]}", flush=True)
    finally:
        for p in spin:
            p.kill()
            p.wait()
    print(json.dumps({"atol": ATOL, "busy_cores": args.busy, **result}))


if __name__ == "__main__":
    main()
