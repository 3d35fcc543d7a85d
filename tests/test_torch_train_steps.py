"""One step of the port's ``make_train_step`` for every architecture.

``tests/test_models.py:48`` on the port (the bf16 smoke configs from the
port's own initializer, B 4 x 16 tokens in 2 microbatches: one step, finite
loss and grad norm), and the same step in f32 held to the reference's
jitted ``make_train_step`` on the reference's initial state: the loss
within 1e-5 relative, the metrics alike, every parameter within
``2 lr(1) + 1e-5 |p|`` (Adam's first update is about ``lr sign(g)``, so a
gradient near zero whose sign differs moves a parameter by up to 2 lr), the
grad norm within 1e-3 relative (the gradients' own bound: jamba's Mamba
``A_log`` gradient is 3.7e-4 of its max off the reference's).  One step
of every smoke config alone runs in ``tests/test_torch_train_steps_smoke.py``.
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_model_cases as TC  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch import _pytree  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShape  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, cosine_schedule  # noqa: E402
from repro_torch.train import step as PS  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401


def _batch(cfg, B=4, S=16, seed=0):
    b = TC.batch(cfg, B=B, S=S, seed=seed)
    b["labels"] = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    return b


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_train_step_matches_reference(arch):
    rcfg, pcfg = TC.configs(arch, dtype=TC.F32)
    rstate = RS.init_state(jax.random.PRNGKey(0), rcfg)
    state = TC.PL.params_from_numpy(jax.tree.map(np.asarray, rstate),
                                    device="cpu")
    rb, pb = TC.inputs(_batch(rcfg), rcfg, pcfg)
    rnew, rm = jax.jit(RS.make_train_step(
        rcfg, RShape("t", 16, 4, "train", 2)))(rstate, rb)
    new, m = PS.make_train_step(pcfg, PShape("t", 16, 4, "train", 2))(
        state, pb)
    for k in ("loss", "nll", "zloss", "lr"):
        assert abs(float(m[k]) - float(rm[k])) <= 1e-5 * abs(float(rm[k])), k
    # the norm of gradients held per leaf within 1e-3 of max|g|
    # (tests/test_torch_train_grads.py)
    assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) \
        <= 1e-3 * float(rm["grad_norm"])
    assert abs(float(m["aux"]) - float(rm["aux"])) \
        <= 1e-5 * abs(float(rm["aux"])) + 1e-7
    lr1 = float(cosine_schedule(AdamWConfig(), 1))
    assert int(new["step"]) == int(rnew["step"]) == 1
    for tree in ("params", ("opt", "mu"), ("opt", "nu")):
        got = new[tree] if isinstance(tree, str) else new[tree[0]][tree[1]]
        ref = rnew[tree] if isinstance(tree, str) else rnew[tree[0]][tree[1]]
        for (path, a), r in zip(_pytree.flatten_with_paths(got),
                                jax.tree.leaves(ref)):
            r = np.asarray(r)
            if tree == "params":
                bound = 2 * lr1 + 1e-5 * np.abs(r)
            else:       # moments: f32 rounding of the same gradient
                bound = 1e-3 * np.abs(r).max() + 1e-9
            assert (np.abs(a.numpy() - r) <= bound).all(), \
                (arch, tree, _pytree.path_key(path))
