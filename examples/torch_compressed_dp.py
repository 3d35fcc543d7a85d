"""Gradient compression through XDMA plugins on the PyTorch port: the int8
wire format for the DP all-reduce, with error feedback.

  PYTHONPATH=src python examples/torch_compressed_dp.py [--device cpu]

The twin of ``examples/compressed_dp.py``: 8 workers, each holding one row
of an (8, 4096) f32 gradient, run ``compressed_psum_with_feedback`` as one
``run_spmd`` world of 8 processes (gloo where the ranks share a card, as
here, or on the CPU; NCCL where each rank has a card of its own).  The
reduce quantizes with the ``Quantize`` plugin, sends int8 values and one
f32 scale per 128-lane row through an all-to-all and an all-gather, and
follows the reference's jitted program bitwise.  It runs on the card by
default; ``--device cpu`` runs the ranks on the CPU.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import core as C  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

WORKERS, PARAMS = 8, 4096


def gradients():
    """The per-worker gradient rows (B = 8 workers x 4096 params)."""
    return np.random.default_rng(0).standard_normal(
        (WORKERS, PARAMS)).astype(np.float32)


def sync_rank(mesh):
    """One rank: its row of the gradient through the compressed all-reduce
    with a zero residual; returns the reduced row, the new residual and
    the kernel launches of the call."""
    g = torch.from_numpy(gradients()[mesh.rank]).to(mesh.device)
    _build.reset_launches()
    red, err = C.compressed_psum_with_feedback(g, torch.zeros_like(g), "dp",
                                               WORKERS)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    launches = {k.name: k.launches for k in _build.KERNELS}
    return {"reduced": red.cpu(), "err": err.cpu(), "launches": launches,
            "backend": mesh.backend}


def run(device="cuda"):
    """The 8-worker world on ``device``; returns the record ``lines``
    prints: the relative error of the reduce against the exact sum, and
    the wire bytes of both phases at int8 against f32."""
    g = gradients()
    with tempfile.TemporaryDirectory(prefix="repro-dp-") as tmp:
        ranks = S.run_spmd(sync_rank, (WORKERS,), ("dp",),
                           workdir=os.path.join(tmp, "world"),
                           device=str(device))
    exact = torch.from_numpy(g).sum(0)
    red = ranks[0]["reduced"]
    rel = float((red - exact).abs().max() / exact.abs().max())
    size = g.size
    f32_bytes = 2 * size * 4                    # RS + AG at f32
    int8_bytes = 2 * size * 1 + 2 * (size // 128) * 4
    return {"device": str(device), "rel_err": rel, "int8_bytes": int8_bytes,
            "f32_bytes": f32_bytes, "backend": ranks[0]["backend"],
            "same_on_every_rank": all(torch.equal(r["reduced"], red)
                                      for r in ranks),
            "reduced": red, "errs": [r["err"] for r in ranks],
            "launches": [r["launches"] for r in ranks]}


def failures(rec) -> list:
    """Every rank holds the same reduced gradient."""
    return [] if rec["same_on_every_rank"] else ["ranks disagree"]


def lines(rec) -> list:
    """The record as ``examples/compressed_dp.py`` words it."""
    f32, int8 = rec["f32_bytes"], rec["int8_bytes"]
    return [f"compressed all-reduce rel err: {rec['rel_err']:.4f}",
            f"wire bytes: {int8} vs f32 {f32} ({f32 / int8:.1f}x "
            f"compression)"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    rec = run(args.device)
    print("\n".join(lines(rec)), flush=True)
    bad = failures(rec)
    if bad:
        raise SystemExit(f"compressed_dp: checks failed: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
