"""Dry-run: count one step's work for every (arch x input-shape) cell,
with no allocation (PyTorch port: the twin of ``repro.launch.dryrun``).

For each cell this:
  1. builds the state (train) or the bf16 weights and the decode cache
     (prefill, decode) on the ``meta`` device — shapes and dtypes only;
  2. runs the step function (``make_train_step``, ``lm.prefill``,
     ``make_serve_step``) once on meta tensors under
     ``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix
     products the step issues (block rematerialisation included);
  3. sums the state's bytes from the specs, and reports the two roofline
     terms of one card against NVIDIA's H100 SXM data sheet (989 TFLOP/s
     dense bf16, 3.35 TB/s HBM3), named as such.

The reference lowers and compiles each cell for a 256- or 512-device TPU
mesh and reads XLA's cost analysis; ``repro.launch.hlo_cost`` walks XLA's
optimised HLO text for trip counts and collective bytes.  Neither has a
twin here: torch has no HLO to walk and no GSPMD mesh to lower for, so the
port counts the work of one step on one card and records no collective
term.  Where an op cannot run on meta (the MoE layer's dispatch sizes its
buffers from the routing, a data-dependent shape), the cell records
``null`` with the reason and makes up no number; any other failure raises.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out results.jsonl]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import _pytree
from repro_torch import configs
from repro_torch.configs import specs as SP
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.serving.engine import make_serve_step
from repro_torch.train.step import init_state, make_train_step

# NVIDIA H100 SXM data sheet, per card (dense, no sparsity, at 700 W)
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
HARDWARE = ("NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, "
            "3.35 TB/s HBM3")

META = torch.device("meta")


def attention_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful attention FLOPs (QK^T + PV = 4*B*S*S_kv*H*hd per layer, causal
    halves it); windowed layers cap S_kv at the window.  Dominates 2*N*D at
    32k+ context, so MFU accounting must include it."""
    B, S = shape.global_batch, shape.seq_len
    layers = list(cfg.period) * cfg.n_periods + list(cfg.tail)
    total = 0.0
    for spec in layers:
        if spec.kind != "attn":
            continue
        s_kv = min(S, spec.window) if spec.window else S
        if shape.kind == "decode":
            total += 4.0 * B * s_kv * cfg.n_heads * cfg.head_dim
        else:
            causal = 0.5 if spec.window is None else 1.0  # window already caps
            total += 4.0 * B * S * s_kv * cfg.n_heads * cfg.head_dim * causal
    if cfg.encoder_layers:      # encoder self-attn + decoder cross-attn
        Se = cfg.encoder_seq
        total += cfg.encoder_layers * 4.0 * B * Se * Se * cfg.n_heads * cfg.head_dim
        if shape.kind == "decode":
            total += cfg.n_layers * 4.0 * B * Se * cfg.n_heads * cfg.head_dim
        else:
            total += cfg.n_layers * 4.0 * B * S * Se * cfg.n_heads * cfg.head_dim
    return total


def model_flops(cfg: ModelConfig, shape: ShapeConfig, n_total: int,
                n_active: int) -> float:
    """6*N*D + 3*attn for training, 2*N*D + attn for prefill,
    2*N_active*B + attn for decode."""
    attn = attention_flops(cfg, shape)
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len + 3.0 * attn
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len + attn
    return 2.0 * n_active * shape.global_batch + attn


def _meta(specs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s, dtype=dt, device=META)
            for k, (s, dt) in specs.items()}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _pytree.leaves(tree)
               if isinstance(t, torch.Tensor))


def _bf16(params):
    """Serving holds weights in bf16 (training keeps its state's dtype)."""
    return _pytree.tree_map_with_path(
        lambda _, p: p.to(torch.bfloat16) if p.is_floating_point() else p,
        params)


def cell_step(cfg: ModelConfig, shape: ShapeConfig):
    """``(run, state_bytes)``: ``run()`` takes one step of the cell on meta
    tensors; ``state_bytes`` is what the step's state holds (train: params
    and optimizer; serving: bf16 weights and the cache)."""
    batch = _meta(SP.batch_specs(cfg, shape))
    if shape.kind == "train":
        state = init_state(cfg, device=META)
        step = make_train_step(cfg, shape)
        return (lambda: step(state, batch)), _nbytes(state)
    params = _bf16(lm.init_params(cfg, device=META))
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device=META)
    state_bytes = _nbytes(params) + _nbytes(cache)
    if shape.kind == "prefill":
        def run():
            with torch.no_grad():
                return lm.prefill(cfg, params, batch, cache)
        return run, state_bytes
    tokens = _meta(SP.decode_token_specs(cfg, shape))
    serve = make_serve_step(cfg)

    def run():
        with torch.no_grad():
            t = tokens.get("tokens", tokens.get("embeds"))
            return serve(params, cache, t)
    return run, state_bytes


def run_cell(arch: str, shape_name: str, *, xdma_cache: bool = False,
             moe_int8: bool = False) -> Dict[str, Any]:
    t0 = time.time()
    shape = SHAPES[shape_name]
    cfg = configs.get_config(arch)
    if xdma_cache:
        cfg = dataclasses.replace(cfg, xdma_cache=True)
    if moe_int8:
        cfg = dataclasses.replace(cfg, moe_wire_int8=True)
    n_total, n_active = SP.count_params(cfg)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": "1",
                           "n_devices": 1, "hardware": HARDWARE,
                           "params_total": n_total,
                           "params_active": n_active}
    run, state_bytes = cell_step(cfg, shape)
    rec["state_bytes"] = state_bytes
    mf = model_flops(cfg, shape, n_total, n_active)
    rec["model_flops"] = mf
    counter = FlopCounterMode(display=False)
    moe = any(spec.moe for spec in cfg.period + cfg.tail)
    try:
        with counter:
            run()
    except (NotImplementedError, RuntimeError) as e:
        # the MoE dispatch's data-dependent shapes have no meta kernel; any
        # other failure is a fault of the step and propagates
        if not moe:
            raise
        rec.update(flops=None, roofline_s=None, bottleneck=None,
                   useful_flop_ratio=None, roofline_fraction=None,
                   reason=f"{type(e).__name__} on the meta device: "
                          f"{e}"[:500])
        rec["count_s"] = round(time.time() - t0, 1)
        return rec
    flops = float(counter.get_total_flops())
    rec["flops"] = flops
    comp_t = flops / H100_BF16_FLOPS
    mem_t = state_bytes / H100_HBM_BYTES_PER_S
    rec["roofline_s"] = {"compute": comp_t, "memory": mem_t}
    rec["bottleneck"] = max(rec["roofline_s"], key=rec["roofline_s"].get)
    rec["useful_flop_ratio"] = (mf / flops) if flops else None
    ach_t = max(comp_t, mem_t)
    rec["roofline_fraction"] = ((mf / H100_BF16_FLOPS) / ach_t
                                if ach_t else None)
    rec["count_s"] = round(time.time() - t0, 1)
    return rec


def iter_cells():
    for arch_alias, mod in sorted(configs._ALIASES.items()):
        skips = configs.shape_skips(arch_alias)
        for shape_name in SHAPES:
            yield arch_alias, shape_name, skips.get(shape_name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--xdma-cache", action="store_true",
                    help="layout-optimal KV cache (the paper technique)")
    ap.add_argument("--moe-int8", action="store_true",
                    help="int8 wire format on the MoE dispatch (XDMA plugin)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    done = set()
    if args.out and args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"]))
                except (ValueError, KeyError):
                    pass

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    if args.all:
        cells = list(iter_cells())
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, None)]
    for arch, shape_name, skip in cells:
        if skip is not None:
            emit({"arch": arch, "shape": shape_name, "skipped": skip})
            continue
        if (arch, shape_name) in done:
            continue
        rec = run_cell(arch, shape_name, xdma_cache=args.xdma_cache,
                       moe_int8=args.moe_int8)
        variants = [v for v, on in (("xdma_cache", args.xdma_cache),
                                    ("moe_int8", args.moe_int8)) if on]
        if variants:
            rec["variant"] = "+".join(variants)
        emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
