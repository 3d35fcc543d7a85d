"""One train step of every smoke config on the port (finite loss, every
leaf moved): moved from ``tests/test_torch_train_steps.py``, unchanged,
so that its time runs beside that file's.
"""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch_model_cases as TC  # noqa: E402
from repro_torch import _pytree  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShape  # noqa: E402
from repro_torch.train import step as PS  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401
from test_torch_train_steps import (  # noqa: E402
    _batch)


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_smoke_train_step(arch):
    _, pcfg = TC.configs(arch)
    state = PS.init_state(pcfg, 0, device="cpu")
    # f32 master parameters, as the reference's init_state holds them
    assert all(p.dtype == torch.float32
               for p in _pytree.leaves(state["params"]))
    assert all(m.dtype == torch.float32
               for m in _pytree.leaves(state["opt"]["mu"]))
    step = PS.make_train_step(pcfg, PShape("smoke", 16, 4, "train",
                                           microbatches=2))
    pb = {k: torch.from_numpy(np.array(v)) for k, v in _batch(pcfg).items()}
    if "embeds" in pb:
        pb["embeds"] = pb["embeds"].to(pcfg.dtype)
    new, metrics = step(state, pb)
    assert int(new["step"]) == 1 and int(state["step"]) == 0
    assert all(p.dtype == torch.float32 for p in _pytree.leaves(new["params"]))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert set(metrics) == {"nll", "aux", "zloss", "loss", "lr", "grad_norm"}
