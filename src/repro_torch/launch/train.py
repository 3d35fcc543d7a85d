"""Training launcher: fault-tolerant loop with checkpoint/restart, async
saves, a straggler watchdog and resume (PyTorch port: the twin of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --steps 50 --batch 8 --seq 64 --smoke --ckpt-dir /tmp/ckpt \\
      [--device cpu]

The model trains on the card unless given ``--device cpu``; a checkpoint
resumes through the port's :class:`~repro_torch.checkpoint.
CheckpointManager` onto the same device.  This is the single-process
trainer: the reference's launcher also builds a GSPMD (data, model) mesh
over the local devices and shards the state FSDP-style, which has no
counterpart in one torch process.  The port's multi-rank trainer is
:func:`repro_torch.train.step.make_dp_train_step` in every rank of a
:func:`repro_torch.sharding.run_spmd` body.
"""
from __future__ import annotations

import argparse
import logging
import statistics
import time
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticLM
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


def train(arch: str, *, steps: int, batch: int, seq: int, smoke: bool,
          ckpt_dir: Optional[str], ckpt_every: int = 20, microbatches: int = 1,
          lr: float = 3e-4, resume: bool = True, seed: int = 0,
          device="cuda"):
    """Train ``steps`` steps on the synthetic stream; returns ``(state,
    losses)``.  With ``ckpt_dir`` it saves every ``ckpt_every`` steps
    (asynchronously) and at the end, and resumes from the newest
    checkpoint there, the stream picked up at that step."""
    cfg = configs.smoke_config(arch) if smoke else configs.get_config(arch)
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
    args = ap.parse_args(argv)
    state, history = train(args.arch, steps=args.steps, batch=args.batch,
                           seq=args.seq, smoke=args.smoke,
                           ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           microbatches=args.microbatches, lr=args.lr,
                           seed=args.seed, device=args.device)
    if history:
        print(f"final loss: {history[-1]:.4f} (from {history[0]:.4f})")
    return state, history


if __name__ == "__main__":
    main()
