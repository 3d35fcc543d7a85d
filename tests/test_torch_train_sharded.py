"""The sharded launcher, ``launch/train.py --ranks 4 --device cpu --smoke``
(the reference launcher's multi-device branch): one world of 4 gloo ranks
on the CPU (``tests/torch_remote_cases.py::launcher_body``) trains qwen3's
smoke config 3 steps on the reference's (1, 4) mesh with a checkpoint at
step 2, then resumes from it: the resumed step's loss and state bitwise
the uninterrupted run's.  Its checkpoint holds whole leaves, so it
restores bitwise into the port's single-process trainer and into the
reference's ``CheckpointManager``.  The same world trains jamba's smoke
config (Mamba and MoE slots), and every config's train-state specs fit a
(2, 2) and a (1, 4) mesh.
"""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_remote_cases as RC  # noqa: E402
from repro import configs as RCF  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as RManager  # noqa: E402
from repro.train import step as RS  # noqa: E402
from repro_torch import _pytree  # noqa: E402
from repro_torch import configs as PCF  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.train import step as PS  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_launch")
    ckpt = str(root / "ckpt")
    world = S.run_spmd(RC.launcher_body, LT.mesh_shape(4),
                       ("data", "model"), device="cpu", args=(ckpt,),
                       workdir=str(root / "spmd"))
    return world, ckpt


def test_mesh_is_the_reference_launchers():
    """``(n // model, model)``, ``model`` the first of 4, 2, 1 dividing n
    (``src/repro/launch/train.py:61-73``)."""
    assert [LT.mesh_shape(n) for n in (1, 2, 3, 4, 6, 8, 16)] == [
        (1, 1), (1, 2), (3, 1), (1, 4), (3, 2), (2, 4), (4, 4)]


def test_sharded_launcher_trains_and_resumes_bitwise(run):
    world, ckpt = run
    r0 = world[0]
    assert tuple(r0["mesh"]) == (1, 4)
    assert len(r0["full"]) == 3 and all(np.isfinite(r0["full"]))
    for rank in world:                       # the metrics are global
        assert rank["full"] == r0["full"]
        assert rank["resumed"] == r0["full"][2:]
    assert r0["resumed"] == r0["full"][2:]   # bitwise
    for a, b in zip(_pytree.leaves(r0["state"]),
                    _pytree.leaves(r0["resumed_state"])):
        assert torch.equal(a, b)
    assert sorted(os.listdir(ckpt)) == ["step_0000000002", "step_0000000003"]
    led = r0["ledger"]
    assert led.get("calls:all_reduce:model", 0) > 0
    assert led.get("calls:reduce_scatter:model", 0) > 0   # wk / wv gathered


def test_sharded_checkpoint_restores_into_the_single_process_trainers(run):
    """The whole leaves rank 0 wrote at step 3: bitwise the gathered final
    state through the port's ``CheckpointManager`` and the reference's, and
    the port's single-process launcher resumes from them."""
    world, ckpt = run
    state = world[0]["state"]
    arch = RC.LAUNCH_ARCH
    pcfg = PCF.smoke_config(arch)
    template = PS.init_state(pcfg, 0, device="cpu")
    got = CheckpointManager(ckpt).restore(3, template, device="cpu")
    for a, b in zip(_pytree.leaves(got), _pytree.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    rcfg = RCF.smoke_config(arch)
    shapes = jax.eval_shape(lambda: RS.init_state(jax.random.PRNGKey(0),
                                                  rcfg))
    ref = RManager(ckpt).restore(3, shapes)
    for a, b in zip(jax.tree.leaves(ref), _pytree.leaves(state)):
        assert np.array_equal(np.asarray(a), b.numpy())
    # the single-process trainer picks the run up at step 3
    kw = dict(RC.LAUNCH_KW, steps=4, ckpt_dir=ckpt + ".final.resume")
    os.makedirs(kw["ckpt_dir"])
    os.rename(ckpt + ".final", os.path.join(kw["ckpt_dir"],
                                            "step_0000000003"))
    _, hist = LT.train(arch, device="cpu", **kw)
    assert len(hist) == 1 and np.isfinite(hist[0])


def test_sharded_launcher_trains_jamba(run):
    """jamba's smoke config (attention, Mamba and MoE slots) for 2 steps
    on the launcher's (1, 4) mesh: finite losses, the same on every rank
    (the metrics are global)."""
    world, _ = run
    losses = world[0]["jamba"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    for rank in world:
        assert rank["jamba"] == losses


@pytest.mark.parametrize("arch", PCF.ARCHS)
def test_state_specs_build_for_every_config(arch):
    """Every config's train-state specs fit a (2, 2) and a (1, 4) mesh:
    each leaf's block shape divides, the MoE experts split by expert or by
    ``d_ff``, the Mamba, mLSTM and sLSTM matrices over the model axis."""
    from repro_torch.launch import mesh as M
    from repro_torch.configs.base import ShapeConfig
    shape = ShapeConfig("t", 16, 8, "train")
    for dims in ((2, 2), (1, 4)):
        mesh = M.MeshSpec(dims, ("data", "model"))
        cfg = PCF.smoke_config(arch)
        cfg = dataclasses.replace(cfg.with_axes(M.axes_for(mesh, shape)),
                                  fsdp=True)
        specs, shapes = M.state_specs(cfg, mesh)
        flat = _pytree.flatten_with_paths(shapes)
        leaves = M.spec_leaves(specs, shapes)
        assert len(leaves) == len(flat)
        for (path, t), sp in zip(flat, leaves):
            M.local_shape(t.shape, sp, mesh)
            key = _pytree.path_key(path)
            if not key.startswith("params/"):
                continue
            if key.endswith("ffn/w_gate") and t.dim() == 4:   # experts
                ep = cfg.n_experts % dims[1] == 0
                assert (tuple(sp)[1:2] == ("model",)) == ep, (key, dims, sp)
            if key.endswith(("mamba/w_x", "mlstm/wv", "slstm/w_z")):
                assert "model" in sp, (arch, dims, key, sp)
