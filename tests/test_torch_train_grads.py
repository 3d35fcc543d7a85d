"""Gradient parity of the port's ``loss_fn`` with the reference's, for
every architecture.

The reference's ``init_params`` output crosses to the port through numpy;
the same seeded batch (tokens or embeds, labels) goes through
``jax.value_and_grad(repro.train.step.loss_fn)`` (jitted) and through the
port's autograd (``repro_torch.train.step._value_and_grad``), both in f32.
The loss within 1e-5 relative; every gradient leaf within 1e-3 x max|g_ref|
+ 1e-6 (the floor covers leaves whose reference gradient is noise near
zero, such as xlstm's sLSTM input-gate bias at 2e-8); a leaf the loss does
not reach (qwen2-vl's unused ``embed`` table, fed embeddings) is ``None``
to autograd and zeros to ``jax.grad``.
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_model_cases as TC  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch import _pytree  # noqa: E402
from repro_torch.train import step as PS  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_loss_fn_gradients_match_reference(arch):
    rcfg, pcfg = TC.configs(arch, dtype=TC.F32)
    rp, pp = TC.params(rcfg)
    b = TC.batch(rcfg, B=2, S=16)
    b["labels"] = np.random.default_rng(5).integers(
        0, rcfg.vocab, (2, 16)).astype(np.int32)
    rb, pb = TC.inputs(b, rcfg, pcfg)
    rloss, rgrad = jax.jit(jax.value_and_grad(
        lambda p, x: RS.loss_fn(rcfg, p, x)[0]))(rp, rb)
    loss, metrics, grads = PS._value_and_grad(pcfg, pp, pb)
    assert abs(float(loss) - float(rloss)) <= 1e-5 * abs(float(rloss))
    assert set(metrics) == {"nll", "aux", "zloss"}
    flat = _pytree.flatten_with_paths(pp)
    ref = jax.tree.leaves(rgrad)
    assert len(flat) == len(ref) == len(grads)
    for (path, leaf), g, r in zip(flat, grads, ref):
        r = np.asarray(r, np.float32)
        got = np.zeros_like(r) if g is None else g.numpy()
        assert got.shape == tuple(leaf.shape)
        tol = 1e-3 * float(np.abs(r).max()) + 1e-6
        err = float(np.abs(got - r).max())
        assert err <= tol, (arch, _pytree.path_key(path), err, tol)
