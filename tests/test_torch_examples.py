"""The port's quickstart (``examples/torch_quickstart.py``) against the
reference's own script, ``examples/quickstart.py``.

The reference script runs in a subprocess on the CPU, as a user runs it;
the port's twin runs in this process on the CPU with the reference's
weights and prompts carried across through numpy.  Their printed lines are
compared move by move: every shape, integer, dict and flag equal, every
cost-model makespan and speedup equal to the printed digit, the decoded
tokens equal.  The only wording that differs is move 4's backend name
(``WORDING``).  On the CPU every parity of the port is bitwise, its
tolerance parities included.
"""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.models import lm as RL  # noqa: E402
from repro.serving.engine import ServingEngine as RefEngine  # noqa: E402
from repro_torch.models import lm as PL  # noqa: E402
from repro_torch.runtime import chrometrace  # noqa: E402
from torch_parity import _reset_all, reset_global_state  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
if EXAMPLES not in sys.path:
    sys.path.insert(0, EXAMPLES)

import torch_quickstart as PQ  # noqa: E402

# the reference's wording -> the port's, where the line names its backend
WORDING = {"pallas==ref:": "kernel==plain:"}
# the first words of each move's first line in examples/quickstart.py
MOVE_STARTS = ("descriptor:", "src address generator:",
               "physical tiled shape:", "pallas==ref:", "loaded K^T shape:",
               "transfer parity:", "XDMAQueue(", "async parity:",
               "compressed store:", "TransferTrace(", "continuous:",
               "telemetry:", "ring-full backpressure:",
               "autotuned store layout", "multicast:")


def reference_lines(script, cwd):
    """``examples/<script>`` run on the CPU in ``cwd``: its printed lines."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, os.path.join(EXAMPLES, script)],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def by_move(lines):
    """The lines of each of the fifteen moves, in order."""
    moves, starts = [], list(MOVE_STARTS)
    for line in lines:
        line = next((line.replace(a, b, 1) for a, b in WORDING.items()
                     if line.startswith(a)), line)
        head = starts[0] if starts else None
        if head is not None and line.startswith(WORDING.get(head, head)):
            moves.append([])
            starts.pop(0)
        moves[-1].append(line)
    assert not starts, f"moves never started: {starts}"
    return moves


def numpy_tokens(a):
    """A reference array of tokens as a CPU tensor."""
    return torch.from_numpy(np.array(a))


def carried(ref_params):
    """The reference's parameters, carried to the port through numpy."""
    return PL.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                device="cpu")


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    """(the reference's lines by move, the port's record, its lines by move,
    the reference's move-10 tokens)."""
    ref_dir = tmp_path_factory.mktemp("ref_quickstart")
    ref = reference_lines("quickstart.py", ref_dir)
    rcfg = dataclasses.replace(RC.smoke_config("phi4_mini_3p8b"),
                               dtype=jnp.float32, n_kv_heads=2, head_dim=128)
    rp = RL.init_params(jax.random.PRNGKey(0), rcfg)
    prompt = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0, rcfg.vocab)
    ref_tokens = np.asarray(RefEngine(rcfg, rp, max_len=32,
                                      cache_dtype=jnp.float32).generate(
        {"tokens": prompt}, 2))
    scfg = dataclasses.replace(RC.smoke_config("qwen3_1p7b"),
                               dtype=jnp.float32)
    sp = RL.init_params(jax.random.PRNGKey(0), scfg)
    port_dir = tmp_path_factory.mktemp("port_quickstart")
    _reset_all()                  # the state a fresh process starts from
    rec = PQ.run("cpu", params=carried(rp), prompt=numpy_tokens(prompt),
                 serve_params=carried(sp),
                 trace_path=str(port_dir / "quickstart.trace.json"))
    rec["trace_path_full"] = str(port_dir / "quickstart.trace.json")
    rec_lines = PQ.lines(dict(rec, trace_export=(
        "quickstart.trace.json", rec["trace_export"][1])))
    return by_move(ref), rec, by_move(rec_lines), ref_tokens


@pytest.mark.parametrize("move", range(1, 16))
def test_quickstart_move_prints_the_references_lines(quickstart, move):
    ref, _, port, _ = quickstart
    assert port[move - 1] == ref[move - 1]


def test_quickstart_parities_are_bitwise_on_the_cpu(quickstart):
    """Every parity flag holds, with no error at all on the CPU (the
    tolerance parities of the RMSNorm chains included), and every other
    check of the record (``failures``) passes."""
    _, rec, _, _ = quickstart
    for key in ("kernel_eq_plain", "transfer_parity", "async_parity",
                "compressed_exact", "ring_outputs", "autotune_roundtrip"):
        assert rec[key] == (True, 0.0), key
    assert PQ.failures(rec) == []


def test_quickstart_decode_gives_the_references_tokens(quickstart):
    _, rec, _, ref_tokens = quickstart
    np.testing.assert_array_equal(np.array(rec["decode_tokens"]), ref_tokens)


def test_quickstart_trace_export_loads_back(quickstart):
    _, rec, _, _ = quickstart
    with open(rec["trace_path_full"]) as f:
        events = json.load(f)["traceEvents"]
    assert chrometrace.validate_events(events) == rec["trace_export"][1]


def test_queue_run_counts_no_cfg_phase_as_the_references_one_program():
    """``XDMAQueue.run`` lowers its local tasks without a ``cfg_stats``
    event: the reference jits the chain into one program, which no CFG
    phase of its plugin compiler counts (quickstart move 9's stats).
    ``run_task`` counts its one CFG phase on both."""
    from repro.core import api as RA
    from repro.core import plugin_compiler as rpc
    from repro_torch.core import api as PA
    from repro_torch.core import plugin_compiler as ppc
    from repro.core import RMSNormPlugin as RNorm, Transpose as RT
    from repro.core import describe as rdescribe
    from torch_parity import port_desc
    descs = [rdescribe("MN", "MNM8N128", RNorm()),
             rdescribe("MNM8N128", "MN", RT())]
    x = np.random.default_rng(3).standard_normal((64, 256)).astype(
        np.float32)
    rq = RA.XDMAQueue(descs, name="q")
    pq = PA.XDMAQueue([port_desc(d) for d in descs], name="q")
    rpc.clear_stats()
    ppc.clear_stats()
    want = np.asarray(rq.run(jnp.asarray(x)))
    got = pq.run(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-5)
    assert ppc.cfg_stats() == rpc.cfg_stats() == {
        "fused": 0, "fallback": 0, "reasons": {}}
    rq.run_task(jnp.asarray(x), 0)
    pq.run_task(torch.from_numpy(x), 0)
    assert ppc.cfg_stats() == rpc.cfg_stats()
    assert ppc.cfg_stats()["fused"] == 1
