"""End to end on the port: train -> checkpoint -> simulated failure ->
resume -> serve (``tests/test_system.py:20,57``), and the same loop across
the two packages (the reference trains and saves, the port resumes).

The qwen3 smoke model in f32 on the CPU.  The crash and resume is held to
the uninterrupted run bitwise (the restored state is the saved one, and
the CPU's arithmetic is deterministic); the port's losses to the
reference's loop on the same initial state; the step the port takes from
the reference's checkpoint to the reference's own next step, within the
one-step bounds of ``tests/test_torch_train_steps.py`` (loss 1e-5
relative, parameters ``2 lr + 1e-5 |p|``).
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_model_cases as TC  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as RCkpt  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch import _pytree  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShape  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, cosine_schedule  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.train import step as PS  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401

SHAPE = ("t", 24, 4, "train", 2)


def _batch(ds, i):
    return {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}


def _port_state(rstate):
    return TC.PL.params_from_numpy(jax.tree.map(np.asarray, rstate),
                                   device="cpu")


def _equal(a, b):
    la, lb = _pytree.leaves(a), _pytree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_full_loop_train_crash_resume_serve(tmp_path):
    rcfg, cfg = TC.configs("qwen3_1p7b", dtype=TC.F32)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=24, global_batch=4, seed=11)
    step = PS.make_train_step(cfg, PShape(*SHAPE))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    rstate = RS.init_state(jax.random.PRNGKey(0), rcfg)

    # phase 1: train 4 steps, async-checkpoint every 2
    state = _port_state(rstate)
    losses = []
    for i in range(4):
        state, metrics = step(state, _batch(ds, i))
        losses.append(float(metrics["loss"]))
        if (i + 1) % 2 == 0:
            mgr.save(i + 1, state, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 4
    uninterrupted = state
    for i in range(4, 6):
        uninterrupted, _ = step(uninterrupted, _batch(ds, i))

    # phase 2: "node failure" -> fresh state, restore, resume the stream
    # exactly where it left
    restored = mgr.restore(4, PS.init_state(cfg, 1, device="cpu"),
                           device="cpu")
    assert _equal(restored, state)
    for i in range(4, 6):
        restored, metrics = step(restored, _batch(ds, i))
        losses.append(float(metrics["loss"]))
    assert int(restored["step"]) == 6
    assert np.isfinite(float(metrics["loss"]))
    assert _equal(restored, uninterrupted)

    # the reference's loop from the same state: the same losses
    rstep = jax.jit(RS.make_train_step(rcfg, RShape(*SHAPE)))
    rlosses = []
    for i in range(6):
        rstate, rm = rstep(rstate, {k: jnp.asarray(v)
                                    for k, v in ds.batch_at(i).items()})
        rlosses.append(float(rm["loss"]))
    np.testing.assert_allclose(losses, rlosses, rtol=1e-4)

    # phase 3: serve from the trained weights
    eng = ServingEngine(cfg, restored["params"], max_len=48,
                        cache_dtype=torch.float32, device="cpu")
    prompt = {"tokens": torch.from_numpy(ds.batch_at(0)["tokens"][:2, :8])}
    out = eng.generate(prompt, 4)
    assert tuple(out.shape) == (2, 4)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab


def test_elastic_restore_structure(tmp_path):
    """A state restored onto the CPU (the counterpart of the reference's
    ``sharding_tree`` restore) is bitwise the saved one."""
    _, cfg = TC.configs("qwen2_0p5b", dtype=TC.F32)
    state = PS.init_state(cfg, 0, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    back = mgr.restore(1, state, device="cpu")
    for a, b in zip(_pytree.leaves(state), _pytree.leaves(back)):
        assert a.device == b.device == torch.device("cpu")
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_resumes_the_references_training(tmp_path):
    """The reference trains 2 steps and checkpoints; the port restores the
    checkpoint (bitwise the reference's state) and takes step 3, held to
    the reference's own step 3."""
    rcfg, cfg = TC.configs("qwen3_1p7b", dtype=TC.F32)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=24, global_batch=4, seed=11)
    rstep = jax.jit(RS.make_train_step(rcfg, RShape(*SHAPE)))
    rstate = RS.init_state(jax.random.PRNGKey(0), rcfg)
    for i in range(2):
        rstate, _ = rstep(rstate, {k: jnp.asarray(v)
                                   for k, v in ds.batch_at(i).items()})
    RCkpt(str(tmp_path)).save(2, rstate)
    restored = CheckpointManager(str(tmp_path)).restore(
        2, PS.init_state(cfg, 0, device="cpu"), device="cpu")
    for a, r in zip(_pytree.leaves(restored), jax.tree.leaves(rstate)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    new, m = PS.make_train_step(cfg, PShape(*SHAPE))(restored, _batch(ds, 2))
    rnew, rm = rstep(rstate, {k: jnp.asarray(v)
                              for k, v in ds.batch_at(2).items()})
    assert int(new["step"]) == int(rnew["step"]) == 3
    assert abs(float(m["loss"]) - float(rm["loss"])) \
        <= 1e-5 * abs(float(rm["loss"]))
    lr3 = float(cosine_schedule(AdamWConfig(), 3))
    for a, r in zip(_pytree.leaves(new["params"]),
                    jax.tree.leaves(rnew["params"])):
        r = np.asarray(r)
        assert (np.abs(a.numpy() - r) <= 2 * lr3 + 1e-5 * np.abs(r)).all()
