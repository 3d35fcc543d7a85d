"""Bytes of a few smoke cells on a (2, 2) ("data", "model") mesh: the port's
dry run (rank 0 on meta, ``repro_torch.launch.dryrun.run_cell``) beside the
reference's own count (its jitted step lowered and compiled for 4 XLA host
devices, the optimised HLO walked by ``repro.launch.hlo_cost``, its memory
analysis read): collective bytes a device by kind, the bytes the ops move
(the port's ``op_bytes_per_device``, the reference's
``hlo_bytes_per_device``), and the temp and peak bytes a device.

The two partition differently (GSPMD chooses the reference's collectives,
the port's are explicit calls), and XLA fuses ops and assigns buffers where
the port runs every op eagerly, so they are set side by side, not held to
a bound.  Runs on the CPU; prints one JSON line a cell.

    PYTHONPATH=src python scripts/dryrun_vs_hlo.py
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as RCF  # noqa: E402
from repro.configs import specs as RSP  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.launch import dryrun as RDR  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import mesh as RMM  # noqa: E402
from repro.models import lm as RL  # noqa: E402
from repro.serving.engine import make_serve_step as r_serve_step  # noqa: E402
from repro.sharding import make_mesh_compat  # noqa: E402
from repro.train.step import init_state as r_init_state  # noqa: E402
from repro.train.step import make_train_step as r_train_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

MESH = ((2, 2), ("data", "model"))
CELLS = (("qwen3_1p7b", ("t", 16, 8, "train", 2)),
         ("qwen3_1p7b", ("d", 32, 4, "decode", 1)),
         ("qwen3_1p7b", ("long", 64, 1, "decode", 1)),
         ("qwen3_moe_30b_a3b", ("t", 16, 8, "train", 2)),
         ("qwen3_moe_30b_a3b", ("d", 32, 4, "decode", 1)))
KINDS = {"all-gather": "all_gather", "all-reduce": "all_reduce",
         "reduce-scatter": "reduce_scatter", "all-to-all": "all_to_all",
         "collective-permute": "collective_permute"}


def reference_bytes(arch, shape):
    """The reference's lowered step of the smoke cell on 4 host devices, as
    ``repro.launch.dryrun.lower_cell`` lowers a production cell:
    ``(collective bytes a device by kind, HBM bytes a device, temp, peak)``
    (``hlo_cost``'s walk; XLA's memory analysis)."""
    mesh = make_mesh_compat(*MESH)
    rshape = RShape(*shape)
    cfg = RCF.smoke_config(arch).with_axes(RMM.axes_for(mesh, rshape))
    if rshape.kind == "train":
        cfg = dataclasses.replace(cfg, fsdp=True)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    batch = RSP.batch_specs(cfg, rshape)
    bspecs = RMM.batch_input_specs(batch, cfg.axes)
    with mesh:
        if rshape.kind == "train":
            state = jax.eval_shape(functools.partial(r_init_state, cfg=cfg),
                                   key)
            sspecs = RMM.infer_state_specs(state, cfg.axes)
            lowered = jax.jit(
                r_train_step(cfg, rshape, mesh=mesh),
                in_shardings=(RDR._ns(mesh, sspecs, state),
                              RDR._ns(mesh, bspecs, batch)),
                out_shardings=(RDR._ns(mesh, sspecs, state), None),
            ).lower(state, batch)
        else:
            params = RDR._bf16_params(jax.eval_shape(
                functools.partial(RL.init_params, cfg=cfg), key))
            pspecs = RMM.infer_param_specs(params, cfg.axes)
            cache = jax.eval_shape(functools.partial(
                RL.init_cache, cfg, rshape.global_batch, rshape.seq_len))
            cspecs = RMM.cache_specs(cfg, cache, cfg.axes)
            tok = RSP.decode_token_specs(cfg, rshape)
            tspecs = RMM.batch_input_specs(tok, cfg.axes)
            step = r_serve_step(cfg, mesh=mesh)

            def serve(p, c, t):
                return step(p, c, t.get("tokens", t.get("embeds")))
            lowered = jax.jit(
                serve,
                in_shardings=(RDR._ns(mesh, pspecs, params),
                              RDR._ns(mesh, cspecs, cache),
                              RDR._ns(mesh, tspecs, tok)),
                out_shardings=(None, RDR._ns(mesh, cspecs, cache)),
            ).lower(params, cache, tok)
    compiled = lowered.compile()
    walk = hlo_cost.analyze(compiled.as_text())
    mem = compiled.memory_analysis()
    return ({KINDS.get(k, k): int(v) for k, v in walk["collectives"].items()},
            int(walk["bytes"]), mem.temp_size_in_bytes,
            mem.peak_memory_in_bytes)


def main():
    for arch, shape in CELLS:
        rec = DR.run_cell(configs.smoke_config(arch), ShapeConfig(*shape),
                          mesh=M.MeshSpec(*MESH))
        coll, moved, temp, peak = reference_bytes(arch, shape)
        mem = rec["bytes_per_device"]
        print(json.dumps({
            "arch": arch, "shape": list(shape), "mesh": "2x2",
            "axes": rec["axes"],
            "port": {"collective_bytes_per_device":
                     rec["collective_bytes_per_device"],
                     "op_bytes_per_device": rec["op_bytes_per_device"],
                     "temp": mem["temp"], "peak": mem["peak"]},
            "reference": {"collective_bytes_per_device": coll,
                          "hlo_bytes_per_device": moved,
                          "temp": temp, "peak": peak}}), flush=True)


if __name__ == "__main__":
    main()
