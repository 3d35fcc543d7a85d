"""The dry run's records as a markdown table, one row an (arch, shape) with
its two meshes side by side (16 x 16 | 2 x 16 x 16): the batch and seq
roles, GFLOP a device, state GB a device, GB the ops move a device, peak
GB a device, collective MB a device by op and the bottleneck term with the
three terms in ms.  These are counts set against NVIDIA's H100 SXM data
sheet, not timings.  A cell missing from the file is marked "not
counted".

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --out dryrun.jsonl
    python scripts/dryrun_table.py dryrun.jsonl
"""
import json
import sys

OPS = {"all_gather": "AG", "all_reduce": "AR", "reduce_scatter": "RS",
       "all_to_all": "A2A", "broadcast": "BC", "reduce": "R",
       "all_reduce_max": "ARmax"}
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("16x16", "2x16x16")


def _g(x):
    return f"{x:.3g}"


def _cells(r):
    if "skipped" in r:
        return None
    ax = r["axes"]
    roles = ("+".join(ax["batch"]) or "-") + " / " + (ax["seq"] or "-")
    coll = r["collective_bytes_per_device"]
    by_op = " ".join(f"{name} {_g(coll[op] / 1e6)}"
                     for op, name in OPS.items() if op in coll) or "none"
    t = r["roofline_s"]
    terms = "/".join(_g(t[k] * 1e3) for k in ("compute", "memory",
                                               "collective"))
    return (roles, _g(r["flops_per_device"] / 1e9),
            _g(r["state_bytes_per_device"] / 1e9),
            _g(r["op_bytes_per_device"] / 1e9),
            _g(r["bytes_per_device"]["peak"] / 1e9), by_op,
            f"{r['bottleneck']} {terms}")


def main(path):
    recs = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                r = json.loads(line)
                recs[(r["arch"], r["shape"], r["mesh"])] = r
    print("| arch | shape | batch / seq | GFLOP a device | state GB a "
          "device | GB moved a device | peak GB a device | collective MB a "
          "device | bottleneck, compute / memory / collective ms |")
    print("|---|---|---|---|---|---|---|---|---|")
    skipped, missing = [], []
    for arch in sorted({a for a, _, _ in recs}):
        for shape in SHAPES:
            pair = [recs.get((arch, shape, m)) for m in MESHES]
            if any(r is None for r in pair):
                missing.append(f"{arch} {shape}")
                continue
            cells = [_cells(r) for r in pair]
            if cells[0] is None:
                skipped.append(f"{arch} {shape} ({pair[0]['skipped']})")
                continue
            cols = [" \\| ".join(c[i] for c in cells) for i in range(7)]
            print(f"| {arch} | {shape} | " + " | ".join(cols) + " |")
    if skipped:
        print(f"\nSkipped on both meshes: {'; '.join(skipped)}.")
    if missing:
        print(f"\nNot counted: {'; '.join(missing)}.")


if __name__ == "__main__":
    main(sys.argv[1])
