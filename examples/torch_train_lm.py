"""End-to-end example on the PyTorch port: train a qwen2-family model with
checkpoint and restart, then sample from it.

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200]
      [--full-100m] [--device cpu]

The twin of ``examples/train_lm.py``.  By default it trains qwen2-0.5b's
smoke config; ``--full-100m`` trains the full qwen2-0.5b (494M parameters)
for at most 50 steps.  B 8 x 64 tokens a step in 2 microbatches at lr 3e-3,
through ``repro_torch.launch.train.train``, which saves through the port's
``CheckpointManager`` every ``ckpt_every`` steps and at the end; the loss
must fall over the run, as the reference asserts.  Then the restart: the
checkpoints after the last one before the end are removed and ``train``
runs again in the same directory, so it resumes from that step with the
saved optimizer state; its final state must be bitwise the uninterrupted
run's (on the card under deterministic algorithms), and the final
checkpoint must restore bitwise to the state it saved.  It runs on the card
by default; ``--device cpu`` runs on the CPU.
"""
import argparse
import contextlib
import os
import shutil
import sys
import tempfile

# cuBLAS reads its workspace setting when it starts: deterministic
# algorithms (the restart's bitwise check on the card) need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch import _pytree, configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCH = "qwen2-0.5b"
BATCH, SEQ, MICRO, LR = 8, 64, 2, 3e-3


@contextlib.contextmanager
def deterministic(dev):
    """Deterministic algorithms on the card (a resumed run is then bitwise
    the uninterrupted one); nothing to do on the CPU."""
    if dev.type != "cuda":
        yield
        return
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved)


def same_tree(a, b) -> bool:
    """Whether two trees hold bitwise equal leaves."""
    la, lb = _pytree.leaves(a), _pytree.leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.cpu(), y.cpu()) if isinstance(x, torch.Tensor)
        else x == y for x, y in zip(la, lb))


def run(device="cuda", *, steps=200, full=False, ckpt_dir=None,
        ckpt_every=None):
    """Train, restart from a checkpoint, sample; returns the record
    ``lines`` prints.  ``ckpt_every`` defaults to 50, as the reference's,
    or half the run where that is shorter, so that a checkpoint before the
    end exists to restart from.  A checkpoint already in ``ckpt_dir`` is
    where ``train`` starts (a step-0 checkpoint of the reference's initial
    state, say), else ``init_state(cfg, 0)``."""
    dev = torch.device(device)
    steps = min(steps, 50) if full else steps
    smoke = not full
    cfg = configs.smoke_config(ARCH) if smoke else configs.get_config(ARCH)
    if ckpt_every is None:
        ckpt_every = min(50, max(1, steps // 2))
    ckpt = ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    rec = {"device": str(dev), "ckpt_dir": ckpt, "steps": steps}
    kw = dict(steps=steps, batch=BATCH, seq=SEQ, smoke=smoke, ckpt_dir=ckpt,
              ckpt_every=ckpt_every, microbatches=MICRO, lr=LR, device=dev)
    with deterministic(dev):
        state, history = train(ARCH, **kw)
        rec["losses"] = history
        # the restart: back to the last checkpoint before the end
        mgr = CheckpointManager(ckpt)
        saved = mgr.restore(steps, state, device=dev)
        rec["restore_bitwise"] = same_tree(saved, state)
        del saved
        back = max((s for s in mgr.steps() if s < steps), default=None)
        rec["restart_step"] = back
        if back is not None:
            for s in mgr.steps():
                if s > back:
                    shutil.rmtree(os.path.join(ckpt, f"step_{s:010d}"))
            resumed, again = train(ARCH, **kw)
            rec["resumed_losses"] = again
            rec["resume_bitwise"] = same_tree(resumed, state)
            del resumed

    eng = ServingEngine(cfg, state["params"], max_len=96, device=dev)
    prompt = {"tokens": (torch.arange(16, dtype=torch.int32)[None]
                         % cfg.vocab).to(dev)}
    rec["sampled"] = eng.generate(prompt, 16).cpu().tolist()
    rec["state"] = state
    return rec


def failures(rec) -> list:
    """The record's checks that do not hold: the loss falls over the run
    (the reference's check), the final checkpoint restores bitwise, the
    restarted run ends bitwise the uninterrupted run's."""
    bad = []
    h = rec["losses"]
    if not h[-1] < h[0]:
        bad.append(f"training must reduce loss: {h[0]} -> {h[-1]}")
    if not rec["restore_bitwise"]:
        bad.append("the final checkpoint did not restore bitwise")
    if rec["restart_step"] is None:
        bad.append("no checkpoint before the end to restart from")
    elif not rec["resume_bitwise"]:
        bad.append(f"the run restarted at step {rec['restart_step']} did "
                   f"not end bitwise the uninterrupted run")
    return bad


def lines(rec) -> list:
    """The record as ``examples/train_lm.py`` words it, and the restart."""
    h = rec["losses"]
    out = [f"checkpoints -> {rec['ckpt_dir']}",
           f"loss: {h[0]:.3f} -> {h[-1]:.3f} over {rec['steps']} steps"]
    if rec["restart_step"] is not None:
        out.append(f"restart from step {rec['restart_step']}: final state "
                   f"bitwise the uninterrupted run's: {rec['resume_bitwise']}"
                   f"; final checkpoint restores bitwise: "
                   f"{rec['restore_bitwise']}")
    out.append(f"sampled continuation: {rec['sampled'][0]}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    rec = run(dev, steps=args.steps, full=args.full_100m)
    print("\n".join(lines(rec)), flush=True)
    bad = failures(rec)
    if bad:
        raise SystemExit(f"train_lm: checks failed: {bad}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
