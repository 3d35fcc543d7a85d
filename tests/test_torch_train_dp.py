"""The port's data-parallel training plane (``repro_torch.train.step``:
``make_dp_train_step``, ``dp_grad_sync``, ``dp_param_broadcast``) against
the reference's single-process step.

The reference's own DP tests (``tests/test_trace.py:326``,
``tests/test_telemetry.py:182``) fail under jax 0.9 (ROADMAP §3, note B),
so their assertions are held here against the reference's jitted
``make_train_step`` on the same state and batch: one 4-rank gloo world on
the CPU (``tests/torch_remote_cases.py::dp_train_body``) runs the plain
step, the int8-codec step and a scheduled 2-microbatch step; the loss
within 1e-5 and the parameters within 1e-4 of the single-process step (the
reference test's bounds), one ``reduce`` event per gradient leaf plus the
loss mean, every collective issued from ``core/remote.py``, int8 wires
below their payloads, the software-AGU replay slower.  A size-1 ``dp``
axis in this process runs the telemetry case, and
``tests/test_multicast.py:290`` the weight broadcast.
"""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_model_cases as TC  # noqa: E402
import torch_remote_cases as RC  # noqa: E402
from repro import configs as RCF  # noqa: E402
from repro.configs.base import ShapeConfig as RShape  # noqa: E402
from repro.data.pipeline import SyntheticLM  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch import _pytree  # noqa: E402
from repro_torch import configs as PCF  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.configs.base import ShapeConfig as PShape  # noqa: E402
from repro_torch.data.pipeline import stage_batch  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402
from repro_torch.runtime import DistributedScheduler, Topology  # noqa: E402
from repro_torch.runtime import telemetry  # noqa: E402
from repro_torch.runtime.trace import capture  # noqa: E402
from repro_torch.train import step as PS  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401


@pytest.fixture(scope="module")
def case():
    """The reference's state and batch (numpy), and its single-process
    jitted step on them."""
    cfg = RC.dp_config(RCF, dataclasses, jnp.float32)
    seq, batch = RC.DP_SHAPE["seq"], RC.DP_SHAPE["batch"]
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                     seed=1)
    raw = ds.batch_at(0)
    state = RS.init_state(jax.random.PRNGKey(0), cfg)
    state_np = jax.tree.map(np.asarray, state)
    ref, m = jax.jit(RS.make_train_step(
        cfg, RShape("t", seq, batch, "train", 1)))(
        state, {k: jnp.asarray(v) for k, v in raw.items()})
    return {"state": state_np, "batch": raw, "loss": float(m["loss"]),
            "params": jax.tree.leaves(jax.tree.map(np.asarray,
                                                   ref["params"]))}


@pytest.fixture(scope="module")
def world(case, tmp_path_factory):
    return S.run_spmd(RC.dp_train_body, *RC.DP_MESH, device="cpu",
                      args=(case["state"], case["batch"]),
                      workdir=str(tmp_path_factory.mktemp("dp_spmd")))


def _worst(params, ref):
    return max(float(np.abs(a.numpy() - r).max())
               for a, r in zip(_pytree.leaves(params), ref))


def test_dp_train_step_matches_the_single_process_step(case, world):
    """tests/test_trace.py:326's uncompressed assertions, in every rank."""
    n_leaves = len(case["params"])
    for rank in world:
        out = rank["plain"]
        assert abs(float(out["loss"]) - case["loss"]) < 1e-5
        assert _worst(out["params"], case["params"]) < 1e-4
        assert int(out["step"]) == 1
        reduces = [e for e in out["events"] if e[0] == "reduce"]
        assert len(reduces) == n_leaves + 1          # + the loss mean
        assert out["calls"] and all(ok for _, ok in out["calls"])
    for other in world[1:]:                          # replicated update
        for a, b in zip(_pytree.leaves(world[0]["plain"]["params"]),
                        _pytree.leaves(other["plain"]["params"])):
            assert torch.equal(a, b)


def test_dp_train_step_compressed_codec(case, world):
    """The int8 wire: the loss (uncompressed) within 1e-5 of the reference
    step's, every matrix leaf's wire smaller than its payload, the
    software-AGU replay of the step's trace slower than the Frontend's."""
    for rank in world:
        out = rank["compressed"]
        assert abs(float(out["loss"]) - case["loss"]) < 1e-5
        red = [e for e in out["events"] if e[0] == "reduce" and e[2]]
        assert red and all(e[2] < e[1] for e in red if len(e[3]) >= 2)
        assert all(ok for _, ok in out["calls"])
        hw, sw = out["makespans"]
        assert sw > hw
        # close but not equal: the codec rounds each gradient to int8
        worst = _worst(out["params"], case["params"])
        assert 0 < worst < 1e-2


def test_dp_train_step_through_a_scheduler_with_microbatches(case, world):
    """Each rank's two microbatches accumulated, every leaf's reduce a
    scheduler task: the single-process step's bounds, and one task a leaf."""
    n_leaves = len(case["params"])
    for rank in world:
        out = rank["scheduled"]
        assert abs(float(out["loss"]) - case["loss"]) < 1e-5
        assert _worst(out["params"], case["params"]) < 1e-4
        assert sum(1 for lb in out["labels"]
                   if lb.startswith("dp_grad[")) == n_leaves


def test_dp_train_step_on_a_size_one_axis_telemetry_parity(case):
    """tests/test_telemetry.py:182 on the port: the compressed DP step on a
    one-rank 'dp' axis records events, and the links bank and the ledger
    agree on its per-link bytes (both empty: it moves through reduce
    endpoints); its loss is the single-process step's."""
    cfg = RC.dp_config(PCF, dataclasses, torch.float32)
    state = TC.PL.params_from_numpy(case["state"], device="cpu")
    shape = PShape("t", RC.DP_SHAPE["seq"], RC.DP_SHAPE["batch"], "train", 1)
    with S.local_axis("dp"):
        step = PS.make_dp_train_step(cfg, shape, mesh=MeshSpec((1,), ("dp",)),
                                     axis="dp", compressed=True)
        telemetry.reset("links")
        with capture(name="train") as tr:
            batch = stage_batch(case["batch"], torch.float32, device="cpu")
            _, m = step(state, batch)
    assert len(tr.events) > 0
    bank = {k: v for k, v in
            telemetry.bank("links").with_prefix("bytes:").items() if v}
    assert bank == tr.per_link_bytes()
    assert abs(float(m["loss"]) - case["loss"]) < 1e-5


def test_dp_param_broadcast_delivers_every_replica_bitwise():
    """tests/test_multicast.py:290 on the port, on the reference's inputs."""
    from repro.runtime import (DistributedScheduler as RSched,
                               Topology as RTopo)
    from repro.runtime import capture as rcapture
    rng = np.random.default_rng
    leaves = {"w": rng(0).standard_normal((32, 64)).astype(np.float32),
              "emb": rng(1).standard_normal((2, 8, 128)).astype(np.float32)}
    params = {k: torch.from_numpy(v) for k, v in leaves.items()}
    params["step"] = torch.zeros((), dtype=torch.int32)
    with capture(name="bcast") as tr:
        sched = DistributedScheduler(Topology.ring(4))
        reps = PS.dp_param_broadcast(params, scheduler=sched)
    assert len(reps) == 3
    for rep in reps:
        assert torch.equal(rep["w"], params["w"])
        assert torch.equal(rep["emb"], params["emb"])
        assert rep["step"] is params["step"]     # counters stay off-plane
    assert tr.by_endpoint().get("multicast", 0) >= 6   # 2 leaves x 3 hops
    rparams = {k: jnp.asarray(v) for k, v in leaves.items()}
    rparams["step"] = jnp.zeros((), jnp.int32)
    with rcapture(name="bcast") as rtr:
        RS.dp_param_broadcast(rparams, scheduler=RSched(RTopo.ring(4)))
    assert tr.by_endpoint() == rtr.by_endpoint()
    assert tr.per_link_bytes() == rtr.per_link_bytes()
