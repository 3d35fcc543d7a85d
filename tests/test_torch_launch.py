"""The port's launchers on the CPU (``--device cpu``; on a machine with a
card they default to the card): ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` (the loss falls; a second run
resumes from the first's checkpoint) and ``python -m
repro_torch.launch.dryrun`` (one cell's counted FLOPs and bytes; an MoE
cell records null and the reason).  The train launcher's loss-and-resume
run is in ``tests/test_torch_launch_train.py``."""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch,batch,gen", [("qwen3-moe-30b-a3b", 2, 4),
                                            ("jamba-1.5-large-398b", 1, 3)])
def test_serve_launcher_runs_an_moe_smoke_config_on_the_cpu(arch, batch,
                                                           gen):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--device", "cpu", "--batch", str(batch),
         "--prompt-len", "8", "--gen", str(gen)],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert f"generated {batch}x{gen} tokens" in out.stderr
    assert "on cpu" in out.stderr
    assert out.stdout.count("[") >= batch        # the token rows


def test_serve_launcher_entry_point_returns_the_tokens():
    import torch

    from repro_torch.launch import serve
    toks = serve.main(["--arch", "mixtral-8x7b", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "6",
                       "--gen", "3"])
    assert tuple(toks.shape) == (2, 3) and toks.dtype == torch.int32


def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)


def test_train_entry_point_returns_the_state():
    import torch

    from repro_torch.launch import train
    state, history = train.main(["--arch", "xlstm-125m", "--smoke",
                                 "--device", "cpu", "--steps", "2",
                                 "--batch", "2", "--seq", "8"])
    assert len(history) == 2 and int(state["step"]) == 2
    assert state["opt"]["mu"]["embed"]["embed"].dtype == torch.float32


def test_dryrun_counts_a_dense_and_an_moe_cell_on_the_production_mesh():
    out = _run("repro_torch.launch.dryrun", "--arch", "qwen2-0.5b",
               "--shape", "decode_32k")
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["flops_per_device"] > 0 and rec["bottleneck"] == "memory"
    assert "H100" in rec["hardware"] and rec["n_devices"] == 256
    assert rec["mesh"] == "16x16" and rec["axes"]["batch"] == ["data"]
    # one decode step reads every weight and cache byte of the rank: its
    # bf16 weights by the serving specs plus its bf16 cache of 8 of the
    # 128 rows x 32768 tokens
    assert rec["state_bytes_per_device"] > 2 * rec["params_total"] / 16
    assert rec["collective_bytes_per_device"]["all_reduce"] > 0
    from repro_torch.launch import dryrun
    moe = dryrun.run_cell("mixtral-8x7b", "decode_32k")
    assert moe["flops_per_device"] > 0 and moe["model_flops"] > 0
    assert moe["collective_bytes_per_device"]["all_reduce"] > 0
    assert set(moe["roofline_s"]) == {"compute", "memory", "collective"}


def test_dryrun_raises_where_a_dense_cell_fails(monkeypatch):
    """No cell records null in place of a count: a failing step is a fault
    and propagates out of ``run_cell``, a dense cell's and an MoE cell's
    alike."""
    from repro_torch.launch import dryrun

    def failing(cfg, shape, mesh=None, **kw):
        def run():
            raise RuntimeError("shape mismatch")
        return run, 0
    monkeypatch.setattr(dryrun, "cell_step", failing)
    with pytest.raises(RuntimeError, match="shape mismatch"):
        dryrun.run_cell("qwen2-0.5b", "decode_32k")
    with pytest.raises(RuntimeError, match="shape mismatch"):
        dryrun.run_cell("mixtral-8x7b", "decode_32k")


def test_dryrun_step_on_a_smoke_config_counts_its_matmuls():
    """The dry run's step on meta tensors counts what the same step's
    products take on real tensors (FlopCounterMode on the CPU)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import _pytree, configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.train.step import init_state, make_train_step

    cfg = configs.smoke_config("qwen3_1p7b")
    shape = ShapeConfig("t", 32, 4, "train", 2)
    run, nbytes = dryrun.cell_step(cfg, shape)
    meta = FlopCounterMode(display=False)
    with meta:
        run()
    state = init_state(cfg, 0, device="cpu")
    batch = {"tokens": torch.zeros((4, 32), dtype=torch.int32),
             "labels": torch.zeros((4, 32), dtype=torch.int32)}
    real = FlopCounterMode(display=False)
    with real:
        make_train_step(cfg, shape)(state, batch)
    assert meta.get_total_flops() == real.get_total_flops() > 0
    assert nbytes == sum(t.numel() * t.element_size()
                         for t in _pytree.leaves(state))
