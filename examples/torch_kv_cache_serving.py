"""The paper's §III-C loop on a live model, on the PyTorch port:
disaggregated prefill / decode with XDMA KV movement.

  PYTHONPATH=src python examples/torch_kv_cache_serving.py [--device cpu]

The twin of ``examples/kv_cache_serving.py``.  A prefill stage computes the
KV cache, XDMA streams it (RMSNorm fused on the store, the transpose
fused on the load: both on kernel 3, the block datapath, since the K
matrix is (B, S, d), logical rank 3) and a decode stage consumes it.  It
runs on the card by default; ``--device cpu`` runs the kernels' plain
PyTorch versions.  The record also holds the stored and loaded K against
their plain chains (the store within the f32 chain tolerance of
``tests/oracle.py``, the load bitwise).
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch import core as C  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.transfer import (kv_load_transposed,  # noqa: E402
                                          kv_prefill_store)

B, S, NEW = 2, 64, 8
F32_TOL = dict(rtol=2e-5, atol=1e-5)     # tests/oracle.py, an f32 stream


def config():
    """qwen3's smoke config with a KV geometry that matches the MXU tile
    (d_kv = 8 x 64 = 512, like the paper's DeepSeek-V3 KV shape)."""
    return dataclasses.replace(configs.smoke_config("qwen3_1p7b"),
                               dtype=torch.float32, n_heads=8, n_kv_heads=8,
                               head_dim=64)


def run(device="cuda", *, params=None, prompt=None, seed=0):
    """Prefill, the KV store and load, then ``NEW`` greedy decode steps on
    ``device``; returns the record ``lines`` prints.  ``params=None``:
    ``lm.init_params(cfg, seed)``; ``prompt=None``: (B, S) tokens drawn
    from ``seed + 1``."""
    dev = torch.device(device)
    cfg = config()
    if params is None:
        params = lm.init_params(cfg, seed, device=dev)
    if prompt is None:
        prompt = torch.randint(0, cfg.vocab, (B, S), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(
                                   seed + 1))
    rec = {"device": str(dev)}

    # ---- prefill stage ------------------------------------------------------
    batch = {"tokens": torch.as_tensor(prompt).to(dev)}
    cache = lm.init_cache(cfg, B, max_len=S + 32, dtype=torch.float32,
                          device=dev)
    logits, cache = lm.prefill(cfg, params, batch, cache)
    rec["pos"] = int(cache["pos"])

    # ---- XDMA movement: the K cache stored tiled (+norm), loaded K^T -------
    k0 = cache["blocks"][0]["k"][0, :, :S]       # layer-0 K, (B, S, KV, hd)
    tiled = kv_prefill_store(k0)
    rec["stored_shape"] = tuple(tiled.shape)
    kt = kv_load_transposed(tiled)
    rec["loaded_shape"] = tuple(kt.shape)
    mat = k0.reshape(B, S, -1)
    layout = C.layout_for_dtype(torch.float32)
    want = C.xdma_copy(mat, C.describe("MN", layout, C.RMSNormPlugin()))
    rec["store_parity"] = (bool(torch.allclose(tiled, want, **F32_TOL)),
                           float((tiled - want).abs().max()))
    rec["load_parity"] = bool(torch.equal(
        kt, C.xdma_copy(tiled, C.describe(layout, "MN", C.Transpose()))))

    # the engine-level equivalent with an explicit descriptor:
    desc = C.describe("MN", C.layout_for_dtype(torch.float32),
                      C.RMSNormPlugin())
    rec["descriptor"] = desc.summary()

    # ---- decode stage -------------------------------------------------------
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    outs = []
    for _ in range(NEW):
        outs.append(tok)
        logits, cache = lm.decode_step(cfg, params, tok, cache)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    rec["decoded"] = torch.cat(outs, 1).cpu().tolist()
    return rec


def failures(rec) -> list:
    """The record's parity checks that do not hold."""
    return [k for k, ok in (("store_parity", rec["store_parity"][0]),
                            ("load_parity", rec["load_parity"])) if not ok]


def lines(rec) -> list:
    """The record as ``examples/kv_cache_serving.py`` words it."""
    return [f"prefill done; cache pos = {rec['pos']}",
            f"K stored tiled: {rec['stored_shape']} (paper Prefill workload)",
            f"K loaded as K^T: {rec['loaded_shape']} (paper Load workload)",
            f"descriptor: {rec['descriptor']}",
            f"decoded: {rec['decoded'][0]}"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "kernels' plain versions")
    rec = run(dev)
    print("\n".join(lines(rec)), flush=True)
    bad = failures(rec)
    if bad:
        raise SystemExit(f"kv_cache_serving: checks failed: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
