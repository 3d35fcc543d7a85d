"""Training launcher: fault-tolerant loop with checkpoint/restart, async
saves, a straggler watchdog and resume (PyTorch port: the twin of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 50 --batch 8 --seq 64 --smoke --ckpt-dir /tmp/ckpt \\
      [--device cpu] [--ranks 4]

The model trains on the card unless given ``--device cpu``; a checkpoint
resumes through the port's :class:`~repro_torch.checkpoint.
CheckpointManager` onto the same device.

``--ranks N`` is the reference launcher's multi-device branch: a (data,
model) mesh of N ranks, ``model`` the first of 4, 2, 1 that divides N
(:func:`mesh_shape`), the config's axes from ``launch.mesh.axes_for`` with
``fsdp=True``, the state sharded by its fitted specs, and the sharded step
(:func:`repro_torch.train.step.make_train_step` with ``mesh=``) in every
rank of a :func:`repro_torch.sharding.run_spmd` world (:func:`train_rank`).
A checkpoint holds whole leaves (gathered; rank 0 writes it) and a resume
shards them again, so one checkpoint moves between the sharded trainer,
the single-process trainer and the reference's ``CheckpointManager``.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import statistics
import tempfile
import time
from typing import Optional, Tuple

import torch

from repro_torch import configs
from repro_torch import sharding as S
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import mesh as M
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_state, make_train_step

log = logging.getLogger("repro_torch.train")


class StragglerWatchdog:
    """Flags steps slower than ``factor`` x the running median.  On a real
    fleet this triggers re-slicing / hot-spare swap; here it logs and counts
    (the decision signal is the deliverable)."""

    def __init__(self, factor: float = 3.0, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.times = []
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return False
        med = float(statistics.median(self.times[:-1]))
        if dt > self.factor * med:
            self.flagged += 1
            log.warning("straggler step: %.3fs vs median %.3fs", dt, med)
            return True
        return False


def _batch(raw, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}


def mesh_shape(n_ranks: int) -> Tuple[int, int]:
    """The reference launcher's mesh over ``n_ranks`` devices: ``(n //
    model, model)`` over ("data", "model"), ``model`` the first of 4, 2, 1
    that divides ``n``."""
    model = next(m for m in (4, 2, 1) if n_ranks % m == 0)
    return (n_ranks // model, model)


def train(arch: str, *, steps: int, batch: int, seq: int, smoke: bool,
          ckpt_dir: Optional[str], ckpt_every: int = 20, microbatches: int = 1,
          lr: float = 3e-4, resume: bool = True, seed: int = 0,
          device="cuda", ranks: int = 1):
    """Train ``steps`` steps on the synthetic stream; returns ``(state,
    losses)``.  With ``ckpt_dir`` it saves every ``ckpt_every`` steps
    (asynchronously) and at the end, and resumes from the newest
    checkpoint there, the stream picked up at that step.

    ``ranks > 1`` trains sharded over a world of that many processes
    (:func:`train_rank` in each; gloo on the CPU or where ranks share a
    card), any config; ``state`` is then the whole state, gathered, on the
    CPU."""
    cfg = configs.smoke_config(arch) if smoke else configs.get_config(arch)
    if ranks > 1:
        kw = dict(steps=steps, batch=batch, seq=seq, smoke=smoke,
                  ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                  microbatches=microbatches, lr=lr, resume=resume, seed=seed)
        with tempfile.TemporaryDirectory(prefix="repro-train-") as work:
            out = S.run_spmd(train_rank, mesh_shape(ranks),
                             ("data", "model"), workdir=work,
                             args=(arch, kw), device=device)
        log.info("mesh %s on %s: losses %s; rank 0's collectives (calls and "
                 "bytes by op and axis) %s", mesh_shape(ranks), device,
                 out[0]["history"], out[0]["ledger"])
        return out[0]["state"], out[0]["history"]
    dev = torch.device(device)
    shape = ShapeConfig("cli", seq, batch, "train", microbatches)
    opt_cfg = AdamWConfig(lr=lr, total_steps=max(steps, 10))
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                     seed=seed, family=cfg.family, d_model=cfg.d_model,
                     encoder_seq=cfg.encoder_seq)

    state = init_state(cfg, seed, device=dev)
    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        state = mgr.restore(start_step, state, device=dev)
        log.info("resumed from step %d", start_step)

    step_fn = make_train_step(cfg, shape, opt_cfg)
    dog = StragglerWatchdog()
    history = []
    for i in range(start_step, steps):
        t0 = time.time()
        state, metrics = step_fn(state, _batch(ds.batch_at(i), dev))
        loss = float(metrics["loss"])
        dt = time.time() - t0
        dog.observe(dt)
        history.append(loss)
        if i % 5 == 0 or i == steps - 1:
            log.info("step %d loss %.4f lr %.2e gnorm %.3f (%.2fs) on %s",
                     i, loss, float(metrics["lr"]),
                     float(metrics["grad_norm"]), dt, dev)
        if mgr and (i + 1) % ckpt_every == 0:
            mgr.save(i + 1, state, blocking=False)
    if mgr:
        mgr.save(steps, state, blocking=True)
    return state, history


def restore_sharded(mgr: CheckpointManager, step: int, cfg, mesh):
    """This rank's blocks of the whole-leaf checkpoint at ``step``: the
    leaves read onto the host, only this rank's blocks (by ``cfg``'s fitted
    state specs) put on its device, so the card never holds the whole
    state."""
    specs, shapes = M.state_specs(cfg, mesh)
    return M.shard_tree(mgr.restore(step, shapes, device="cpu"), specs,
                        mesh, device=mesh.device)


def train_rank(mesh, arch: str, kw: dict):
    """One rank of the sharded trainer (a :func:`repro_torch.sharding.
    run_spmd` body over a ("data", "model") mesh): :func:`train`'s loop on
    this rank's blocks of the state.  Returns the losses, the collective
    ledger of the run and, on rank 0, the whole final state."""
    steps, seed, ckpt_dir = kw["steps"], kw["seed"], kw["ckpt_dir"]
    shape = ShapeConfig("cli", kw["seq"], kw["batch"], "train",
                        kw["microbatches"])
    cfg = configs.smoke_config(arch) if kw["smoke"] else \
        configs.get_config(arch)
    # the reference launcher's config on a mesh (launch/train.py:67-69)
    cfg = dataclasses.replace(cfg.with_axes(M.axes_for(mesh, shape)),
                              fsdp=True)
    dev = mesh.device
    lead = mesh.rank == 0
    opt_cfg = AdamWConfig(lr=kw["lr"], total_steps=max(steps, 10))
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=kw["seq"],
                     global_batch=kw["batch"], seed=seed, family=cfg.family,
                     d_model=cfg.d_model, encoder_seq=cfg.encoder_seq)
    specs, _ = M.state_specs(cfg, mesh)
    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and kw["resume"] and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        state = restore_sharded(mgr, start_step, cfg, mesh)
        log.info("rank %d resumed from step %d", mesh.rank, start_step)
    else:
        state = init_state(cfg, seed, device=dev, mesh=mesh)

    step_fn = make_train_step(cfg, shape, opt_cfg, mesh=mesh)
    dog = StragglerWatchdog()
    history = []
    for i in range(start_step, steps):
        t0 = time.time()
        state, metrics = step_fn(state, _batch(ds.batch_at(i), dev))
        loss = float(metrics["loss"])
        dt = time.time() - t0
        dog.observe(dt)
        history.append(loss)
        if lead and (i % 5 == 0 or i == steps - 1):
            log.info("step %d loss %.4f lr %.2e gnorm %.3f (%.2fs) on %s, "
                     "mesh %s", i, loss, float(metrics["lr"]),
                     float(metrics["grad_norm"]), dt, dev, mesh.shape)
        if mgr and (i + 1) % kw["ckpt_every"] == 0:
            # every rank gathers, leaf by leaf onto the host; rank 0 writes
            whole = M.gather_tree(state, specs, mesh, device="cpu")
            if lead:
                mgr.save(i + 1, whole, blocking=False)
            del whole
    whole = M.gather_tree(state, specs, mesh, device="cpu")
    if mgr and lead:
        mgr.save(steps, whole, blocking=True)
    return {"history": history, "ledger": S.collective_stats(),
            "state": whole if lead else None}


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=1,
                    help="train sharded over a (data, model) mesh of this "
                         "many processes")
    args = ap.parse_args(argv)
    state, history = train(args.arch, steps=args.steps, batch=args.batch,
                           seq=args.seq, smoke=args.smoke,
                           ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           microbatches=args.microbatches, lr=args.lr,
                           seed=args.seed, device=args.device,
                           ranks=args.ranks)
    if history:
        print(f"final loss: {history[-1]:.4f} (from {history[0]:.4f})")
    return state, history


if __name__ == "__main__":
    main()
