"""The port's training examples against the reference's:
``examples/torch_compressed_dp.py`` against ``examples/compressed_dp.py``,
and ``examples/torch_train_lm.py`` against ``repro.launch.train.train``.

compressed_dp: the reference's program (its ``SNIPPET``, verbatim) runs in
a subprocess with 8 XLA CPU devices and also saves its reduced gradient and
residuals; the port runs one ``run_spmd`` world of 8 gloo ranks on the CPU.
The printed error and wire bytes are equal, and the reduced gradient and
each rank's residual are bitwise the reference's jitted program's.

train_lm: qwen2-0.5b's smoke config for 4 steps, as the reference's
default with ``--steps 4``.  The reference's ``train`` runs in a subprocess
on one CPU device with the example's arguments and samples the example's
continuation; it also saves its initial state as a step-0 checkpoint in
the port's checkpoint directory, which the port's ``train`` resumes from.
Each step's loss is the reference's within bf16 rounding
(``test_torch_train_loss``'s bound), the loss falls over the run in both
(the reference's check), the sampled continuation is the
reference's and the port's planeless greedy loop's, the final checkpoint
restores bitwise, and the run restarted from the step-2 checkpoint ends
bitwise the uninterrupted run's state.
"""
import pytest

pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_model_cases as TC  # noqa: E402
from repro_torch import configs  # noqa: E402
from test_torch_examples import EXAMPLES, ROOT  # noqa: E402
from torch_parity import bits, reset_global_state  # noqa: E402,F401

import torch_compressed_dp as PDP  # noqa: E402
import torch_train_lm as PTL  # noqa: E402

sys.path.insert(0, EXAMPLES)
import compressed_dp as RDP  # noqa: E402  (the reference's script)
sys.path.remove(EXAMPLES)


@pytest.fixture(scope="module")
def compressed_dp(tmp_path_factory):
    """(the reference's printed lines, its reduced row and residuals, the
    port's record)."""
    out = tmp_path_factory.mktemp("ref_dp")
    save = (f"\nnp.save({str(out / 'red.npy')!r}, np.asarray(red))"
            f"\nnp.save({str(out / 'err.npy')!r}, np.asarray(err))\n")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.run([sys.executable, "-c", RDP.SNIPPET + save],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert ref.returncode == 0, ref.stderr
    rec = PDP.run("cpu")
    return (ref.stdout.splitlines(), np.load(out / "red.npy"),
            np.load(out / "err.npy"), rec)


def test_compressed_dp_prints_the_references_error_and_wire_bytes(
        compressed_dp):
    ref, _, _, rec = compressed_dp
    assert PDP.lines(rec) == ref
    assert rec["backend"] == "gloo"


def test_compressed_dp_reduces_bitwise_the_references_jitted_program(
        compressed_dp):
    _, red, err, rec = compressed_dp
    assert PDP.failures(rec) == []
    np.testing.assert_array_equal(bits(rec["reduced"]), bits(red[0]))
    np.testing.assert_array_equal(
        bits(torch.stack(rec["errs"])), bits(err))


# the reference's examples/train_lm.py at its smoke default, 4 steps; its
# initial state saved as a step-0 checkpoint in the directory argv[1]
REF_TRAIN = """
import json, sys
import jax, jax.numpy as jnp
from repro import configs
from repro.checkpoint.manager import CheckpointManager
from repro.launch.train import train
from repro.serving.engine import ServingEngine
from repro.train.step import init_state
cfg = configs.smoke_config("qwen2-0.5b")
CheckpointManager(sys.argv[1]).save(
    0, init_state(jax.random.PRNGKey(0), cfg), blocking=True)
state, history = train("qwen2-0.5b", steps=4, batch=8, seq=64, smoke=True,
                       ckpt_dir=None, ckpt_every=50, microbatches=2, lr=3e-3)
eng = ServingEngine(cfg, state["params"], max_len=96)
out = eng.generate({"tokens": jnp.arange(16, dtype=jnp.int32)[None]
                    % cfg.vocab}, 16)
print(json.dumps({"losses": history, "sampled": out.tolist()}))
"""
BF16_REL = 2.5e-2      # test_torch_train_loss's bound on a bf16 step's loss


@pytest.fixture(scope="module")
def train_lm(tmp_path_factory):
    """(the reference's losses and sampled tokens, the port's record)."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.run([sys.executable, "-c", REF_TRAIN, ckpt], env=env,
                         capture_output=True, text=True, timeout=600)
    assert ref.returncode == 0, ref.stderr
    ref = json.loads(ref.stdout.splitlines()[-1])
    return ref, PTL.run("cpu", steps=4, ckpt_dir=ckpt)


def test_train_lm_loss_falls(train_lm):
    ref, rec = train_lm
    assert len(rec["losses"]) == len(ref["losses"]) == 4
    for got, want in zip(rec["losses"], ref["losses"]):
        assert abs(got - want) <= BF16_REL * abs(want), (rec["losses"],
                                                         ref["losses"])
    # the reference's check (examples/train_lm.py:48) holds in both
    assert ref["losses"][-1] < ref["losses"][0]
    assert rec["losses"][-1] < rec["losses"][0]


def test_train_lm_restart_from_step_2_is_bitwise_the_uninterrupted_run(
        train_lm):
    _, rec = train_lm
    assert rec["restart_step"] == 2
    assert rec["resume_bitwise"] is True
    assert rec["restore_bitwise"] is True
    # the restarted run trained steps 2-3 only, to the same losses
    assert rec["resumed_losses"] == rec["losses"][2:]
    assert PTL.failures(rec) == []


def test_train_lm_samples_the_greedy_continuation(train_lm):
    ref, rec = train_lm
    cfg = configs.smoke_config(PTL.ARCH)
    prompt = {"tokens": torch.arange(16, dtype=torch.int32)[None] % cfg.vocab}
    want, _ = TC.planeless_generate(cfg, rec["state"]["params"], prompt,
                                    16, 96, torch.bfloat16)
    assert rec["sampled"] == want.tolist()
    assert rec["sampled"] == ref["sampled"]
    assert PTL.lines(rec)[-1] == \
        f"sampled continuation: {want[0].tolist()}"
