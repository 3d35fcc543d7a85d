"""The reference's loss-falls test of ``tests/test_train.py`` on the port
(``repro_torch.train.step`` on the synthetic stream), held to the
reference on the same inputs; moved from ``tests/test_torch_train.py``,
unchanged, so that its time runs beside that file's.
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch_model_cases as TC  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.optim import adamw as RO  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShape  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM as PSyn  # noqa: E402
from repro_torch.optim import adamw as PO  # noqa: E402
from repro_torch.train import step as PS  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401


def test_loss_decreases_on_synthetic_stream():
    """25 steps of the bf16 qwen3 smoke model (the reference's test): the
    loss falls by more than 0.3; the first step's loss is the reference's
    on the same parameters within bf16 rounding."""
    rcfg, pcfg = TC.configs("qwen3_1p7b")
    shape = (32, 8, "train")
    ds = PSyn(vocab=pcfg.vocab, seq_len=32, global_batch=8, seed=0)
    opt_kw = dict(lr=3e-3, warmup_steps=5, total_steps=100)
    rstate = RS.init_state(jax.random.PRNGKey(0), rcfg)
    state = TC.PL.params_from_numpy(jax.tree.map(np.asarray, rstate),
                                    device="cpu")
    step = PS.make_train_step(pcfg, PShape("t", *shape),
                              PO.AdamWConfig(**opt_kw))
    losses = []
    for i in range(25):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch_at(i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert int(state["step"]) == 25
    assert losses[-1] < losses[0] - 0.3, losses[:3] + losses[-3:]
    ref_step = jax.jit(RS.make_train_step(rcfg, RShape("t", *shape),
                                          RO.AdamWConfig(**opt_kw)))
    _, rm = ref_step(rstate, {k: jnp.asarray(v)
                              for k, v in ds.batch_at(0).items()})
    assert abs(losses[0] - float(rm["loss"])) <= 2.5e-2 * abs(float(rm["loss"]))
