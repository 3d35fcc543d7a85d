"""Serving launcher: batched greedy generation with the XDMA-tiled KV path
(PyTorch port: the twin of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --smoke --batch 2 --prompt-len 16 --gen 12 [--device cpu]

The weights come from the port's seeded initializer; the model runs on the
card unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import lm
from repro_torch.serving.engine import ServingEngine

log = logging.getLogger("repro_torch.serve")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (configs.smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    dev = torch.device(args.device)
    params = lm.init_params(cfg, args.seed, device=dev)
    eng = ServingEngine(cfg, params, max_len=args.prompt_len + args.gen + 8,
                        device=dev)

    ds = SyntheticLM(vocab=cfg.vocab, seq_len=args.prompt_len,
                     global_batch=args.batch, seed=args.seed,
                     family=cfg.family, d_model=cfg.d_model,
                     encoder_seq=cfg.encoder_seq)
    raw = ds.batch_at(0)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in raw.items()
             if k != "labels"}

    t0 = time.time()
    out = eng.generate(batch, args.gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = args.batch * args.gen
    log.info("generated %dx%d tokens in %.2fs (%.1f tok/s) on %s",
             args.batch, args.gen, dt, toks / dt, dev)
    print(out)
    return out


if __name__ == "__main__":
    main()
