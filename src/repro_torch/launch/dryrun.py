"""Dry-run: count one rank's step for every (arch x input-shape x mesh)
cell on the production mesh, with no allocation (PyTorch port: the twin of
``repro.launch.dryrun``).

For each cell this:
  1. builds the production mesh's shape (``make_production_mesh(...,
     check_world=False)``: (16, 16) data x model, or (2, 16, 16) pod x
     data x model with ``--multi-pod``) and sets ``cfg.axes`` by
     ``axes_for`` (FSDP for ``train``), as the reference's ``lower_cell``
     does;
  2. plays rank 0 of that mesh in this one process: the mesh's axes, pairs
     and world are registered on the ``meta`` backend
     (:func:`repro_torch.sharding.meta_mesh`), where every collective
     counts its call and bytes and moves nothing;
  3. builds rank 0's blocks of the state on the ``meta`` device: the train
     state by the fitted state specs, or the bf16 weights by the serving
     specs and the decode cache by the fitted cache specs, and runs the
     same step a real rank runs (``make_train_step(..., mesh=)``,
     ``lm.prefill``, ``make_serve_step(..., mesh=)``) once, under
     ``torch.utils.flop_counter.FlopCounterMode`` and
     :class:`repro_torch.launch.op_cost.OpCost` together;
  4. records the FLOPs per device, the bytes its ops move
     (``op_bytes_per_device``, the twin of the reference's
     ``hlo_bytes_per_device``), its ``bytes_per_device`` (the state, the
     argument (state and batch), the output, temp and peak bytes: what a
     card must hold), the collective bytes per device by op and by op and
     axis (the ``collectives`` bank,
     :func:`repro_torch.sharding.collective_stats`, and the MoE plane's
     ``wire`` bank), and the three roofline terms against NVIDIA's H100
     SXM data sheet, named in the record: compute (FLOPs), memory (the
     bytes the ops move) and collective.

The reference compiles each cell for 256 or 512 TPU devices, reads XLA's
memory analysis and walks the optimised HLO (``repro.launch.hlo_cost``)
for its bytes; the port counts at dispatch (``op_cost``: how its four
memory fields map to XLA's is set out there), and its collectives are
explicit calls, so the ledger of one rank's step is the collective term.
Any failure of a cell raises.

``--one-card`` counts the step of one card with no mesh (the single-process
program ``chip_smoke.py`` runs on the H100, whose allocator's peak is held
to this count), and ``--batch`` / ``--seq`` / ``--microbatches`` resize the
shape.

The bound is optimistic: the collective term counts every byte at one
NVLink's 450 GB/s each way, but a 256-card mesh spans 32 nodes of 8 cards,
and what crosses between nodes runs on the network, far slower.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k \\
      --one-card --batch 4 --microbatches 2
  python -m repro_torch.launch.dryrun --all --both-meshes [--out results.jsonl]

``--all`` counts its cells a process a core, each record written as its
cell ends (out of order: ``scripts/dryrun_table.py`` keys them).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import sys
import time
from typing import Any, Dict, Optional, Union

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import _pytree
from repro_torch import configs
from repro_torch import sharding as SH
from repro_torch.configs import specs as SP
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.core import remote
from repro_torch.launch import mesh as MM
from repro_torch.launch import op_cost
from repro_torch.models import lm
from repro_torch.serving.engine import make_serve_step
from repro_torch.train.step import init_state, make_train_step

# NVIDIA H100 SXM data sheet, per card (dense, no sparsity, at 700 W)
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
H100_NVLINK_BYTES_PER_S = 450e9     # NVLink 4: 900 GB/s, 450 GB/s each way
HARDWARE = ("NVIDIA H100 SXM data sheet: 989 TFLOP/s dense bf16, "
            "3.35 TB/s HBM3, NVLink 900 GB/s (450 GB/s each way)")

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


def _meta(specs: Dict[str, Any], device=META) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in specs.items()}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _pytree.leaves(tree)
               if isinstance(t, torch.Tensor))


def _bf16(params):
    """Serving holds weights in bf16 (training keeps its state's dtype)."""
    return _pytree.tree_map_with_path(
        lambda _, p: p.to(torch.bfloat16) if p.is_floating_point() else p,
        params)


def cell_config(arch: Union[str, ModelConfig], shape: ShapeConfig, mesh, *,
                xdma_cache: bool = False,
                moe_int8: bool = False) -> ModelConfig:
    """``arch``'s config (a name, or a config) with the axis roles of
    ``shape`` on ``mesh`` (``axes_for``), FSDP for training and the
    variants, as the reference's ``lower_cell`` sets them."""
    cfg = configs.get_config(arch) if isinstance(arch, str) else arch
    cfg = cfg.with_axes(MM.axes_for(mesh, shape))
    if xdma_cache:
        cfg = dataclasses.replace(cfg, xdma_cache=True)
    if moe_int8:
        cfg = dataclasses.replace(cfg, moe_wire_int8=True)
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, fsdp=True)
    return cfg


class Step:
    """One step of a cell: ``step()`` takes it and returns what it
    returns; ``arguments`` are the tensors live as it starts (its state
    and its batch), which :func:`count_step` counts as held."""

    def __init__(self, fn, arguments):
        self.fn, self.arguments = fn, arguments

    def __call__(self):
        return self.fn()


def cell_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
              device=META, seed: int = 0):
    """``(step, state_bytes)``: ``step()`` takes one step of the cell (a
    :class:`Step`) and ``state_bytes`` is what the step's state holds
    (train: parameters and optimizer; serving: bf16 weights and the
    cache), on ``device`` (meta: shapes only; the batch is zeros, the
    weights ``seed``'s elsewhere).

    With ``mesh`` (a registered mesh: :func:`repro_torch.sharding.
    meta_mesh` or a ``run_spmd`` rank's, ``cfg`` from :func:`cell_config`)
    it is this rank's step of the sharded program: its blocks of the
    state, the whole batch, of which the step takes its rows."""
    batch = _meta(SP.batch_specs(cfg, shape), device)
    if shape.kind == "train":
        state = init_state(cfg, seed, device=device, mesh=mesh)
        step = make_train_step(cfg, shape, mesh=mesh)
        return (Step(lambda: step(state, batch), (state, batch)),
                _nbytes(state))
    params = _bf16(lm.init_params(cfg, seed, device=device))
    if mesh is not None:
        specs, _ = MM.serving_specs(cfg, mesh)
        params = MM.shard_tree(params, specs, mesh, device=device)
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len,
                          device=device)
    state_bytes = _nbytes(params) + _nbytes(cache)
    if shape.kind == "prefill":
        def prefill():
            with torch.no_grad():
                return lm.prefill(cfg, params, batch, cache, mesh=mesh,
                                  max_len=shape.seq_len)
        return Step(prefill, (params, cache, batch)), state_bytes
    tokens = _meta(SP.decode_token_specs(cfg, shape), device)
    serve = make_serve_step(cfg, mesh=mesh, max_len=shape.seq_len)

    def decode():
        with torch.no_grad():
            t = tokens.get("tokens", tokens.get("embeds"))
            return serve(params, cache, t)
    return Step(decode, (params, cache, tokens)), state_bytes


def _grown(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def count_step(run):
    """``(flops, collectives, wire, memory)`` of one call of ``run`` in
    this rank, counted in one run: ``FlopCounterMode``'s total, what the
    ``collectives`` and ``wire`` banks grew by, and
    :class:`repro_torch.launch.op_cost.OpCost`'s ``{"op_bytes",
    "argument", "output", "temp", "peak"}`` (``run.arguments`` held from
    the start, where ``run`` is a :class:`Step`)."""
    counter = FlopCounterMode(display=False)
    cost = op_cost.OpCost(getattr(run, "arguments", ()))
    coll, wire = SH.collective_stats(), remote.wire_stats()
    with counter, cost:
        out = run()
    return (int(counter.get_total_flops()),
            _grown(coll, SH.collective_stats()),
            _grown(wire, remote.wire_stats()), cost.result(out))


def collective_bytes(coll: Dict[str, int], wire: Dict[str, int]):
    """``(by_op, by_op_and_axis)``: the payload bytes of a step's
    collectives by op (the ``collectives`` bank's over every axis, the MoE
    plane's ``wire`` bank's beside them) and by ``op:axis`` (the plane's
    axis recorded as ``plane``)."""
    by_axis = {}
    for k, v in coll.items():
        if k.startswith("bytes:"):
            by_axis[k[len("bytes:"):]] = v
    for k, v in wire.items():
        if k.startswith("bytes:"):
            by_axis[f"{k[len('bytes:'):]}:plane"] = v
    by_op: Dict[str, int] = {}
    for k, v in by_axis.items():
        op = k.split(":")[0]
        by_op[op] = by_op.get(op, 0) + v
    return by_op, by_axis


def run_cell(arch: Union[str, ModelConfig],
             shape_name: Union[str, ShapeConfig], *,
             multi_pod: bool = False, mesh: Optional[MM.MeshSpec] = None,
             rank: int = 0, xdma_cache: bool = False,
             moe_int8: bool = False, one_card: bool = False
             ) -> Dict[str, Any]:
    """One cell's record: rank ``rank`` of the production mesh (or of
    ``mesh``, a :class:`repro_torch.launch.mesh.MeshSpec`: a small mesh a
    test also runs for real) counted on meta tensors; with ``one_card``
    the step of one card and no mesh (``arch``'s config as it is).
    ``arch`` is a name or a config, ``shape_name`` a name of ``SHAPES`` or
    a shape."""
    t0 = time.time()
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if one_card:
        mesh = MM.MeshSpec((1,), ("data",))
        cfg = configs.get_config(arch) if isinstance(arch, str) else arch
    else:
        if mesh is None:
            mesh = MM.make_production_mesh(multi_pod=multi_pod,
                                           check_world=False)
        cfg = cell_config(arch, shape, mesh, xdma_cache=xdma_cache,
                          moe_int8=moe_int8)
    n_dev = mesh.size
    n_total, n_active = SP.count_params(cfg)
    ax = cfg.axes
    rec: Dict[str, Any] = {
        "arch": arch if isinstance(arch, str) else cfg.name,
        "shape": shape.name, "mesh": "x".join(map(str, mesh.shape)),
        "n_devices": n_dev, "rank": rank, "hardware": HARDWARE,
        "axes": {"batch": list(ax.batch), "model": ax.model, "seq": ax.seq},
        "params_total": n_total, "params_active": n_active}
    if one_card:
        run, state_bytes = cell_step(cfg, shape)
        flops, coll, wire, mem = count_step(run)
    else:
        with SH.meta_mesh(mesh.shape, mesh.axis_names, rank) as m:
            run, state_bytes = cell_step(cfg, shape, m)
            flops, coll, wire, mem = count_step(run)
    mf = model_flops(cfg, shape, n_total, n_active)
    by_op, by_axis = collective_bytes(coll, wire)
    rec.update(model_flops=mf, flops_per_device=flops,
               useful_flop_ratio=mf / (flops * n_dev) if flops else None,
               state_bytes_per_device=state_bytes,
               op_bytes_per_device=mem["op_bytes"],
               bytes_per_device={"state": state_bytes,
                                 **{k: mem[k] for k in (
                                     "argument", "output", "temp", "peak")}},
               collective_bytes_per_device=by_op,
               collective_bytes_by_axis=by_axis,
               collectives=coll, wire=wire)
    terms = {"compute": flops / H100_BF16_FLOPS,
             "memory": mem["op_bytes"] / H100_HBM_BYTES_PER_S,
             "collective": sum(by_op.values()) / H100_NVLINK_BYTES_PER_S}
    rec["roofline_s"] = terms
    rec["bottleneck"] = max(terms, key=terms.get)
    ach_t = max(terms.values())
    rec["roofline_fraction"] = ((mf / (n_dev * H100_BF16_FLOPS)) / ach_t
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
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--xdma-cache", action="store_true",
                    help="layout-optimal KV cache (the paper technique)")
    ap.add_argument("--moe-int8", action="store_true",
                    help="int8 wire format on the MoE dispatch (XDMA plugin)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--one-card", action="store_true",
                    help="one card's step with no mesh (the config as it is)")
    ap.add_argument("--batch", type=int, help="the shape's global batch")
    ap.add_argument("--seq", type=int, help="the shape's sequence length")
    ap.add_argument("--microbatches", type=int,
                    help="the shape's microbatches")
    args = ap.parse_args(argv)
    resize = {k: v for k, v in (("global_batch", args.batch),
                                ("seq_len", args.seq),
                                ("microbatches", args.microbatches))
              if v is not None}
    if resize and args.all:
        ap.error("--batch, --seq and --microbatches resize one cell's shape")

    done = set()
    if args.out and args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except (ValueError, KeyError):
                    pass

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = [(arch, shape_name, mp, skip)
                 for arch, shape_name, skip in iter_cells()
                 for mp in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, mp, None) for mp in meshes]
    work = []
    for arch, shape_name, mp, skip in cells:
        mesh_name = "2x16x16" if mp else "16x16"
        if skip is not None:
            emit({"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "skipped": skip})
        elif (arch, shape_name, mesh_name) not in done:
            shape = SHAPES[shape_name]
            if resize:
                shape = dataclasses.replace(shape, **resize)
            work.append((arch, shape, dict(
                multi_pod=mp, one_card=args.one_card,
                xdma_cache=args.xdma_cache, moe_int8=args.moe_int8)))
    if not args.all:
        for cell in work:
            emit(_count_cell(cell))
        return 0
    # the sweep: a process a core, each record written as its cell ends
    # (one train cell of xlstm or jamba takes an hour or more)
    with concurrent.futures.ProcessPoolExecutor(
            os.cpu_count(),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        for fut in concurrent.futures.as_completed(
                [pool.submit(_count_cell, cell) for cell in work]):
            emit(fut.result())
    return 0


def _count_cell(cell) -> Dict[str, Any]:
    """One cell of the CLI's list: ``run_cell``'s record, its variant
    named."""
    arch, shape, kw = cell
    rec = run_cell(arch, shape, **kw)
    variants = [v for v in ("xdma_cache", "moe_int8") if kw[v]]
    if variants:
        rec["variant"] = "+".join(variants)
    return rec


if __name__ == "__main__":
    sys.exit(main())
