"""The port's KV-cache serving example
(``examples/torch_kv_cache_serving.py``) against the reference's own
script, ``examples/kv_cache_serving.py``.

The reference script runs in a subprocess on the CPU, as a user runs it;
the port's twin runs in this process on the CPU with the reference's
weights and prompt carried across through numpy.  Every printed line is
equal (the cache position, the stored and loaded shapes, the descriptor,
the decoded tokens), and the stored and loaded K equal their plain chains
bitwise on the CPU.
"""
import pytest

pytest.importorskip("torch")

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.models import lm as RL  # noqa: E402
from test_torch_examples import (carried, numpy_tokens,  # noqa: E402
                                 reference_lines)
from torch_parity import reset_global_state  # noqa: E402,F401

import torch_kv_cache_serving as PKV  # noqa: E402


@pytest.fixture(scope="module")
def kv_serving(tmp_path_factory):
    ref = reference_lines("kv_cache_serving.py",
                          tmp_path_factory.mktemp("ref_kv"))
    rcfg = dataclasses.replace(RC.smoke_config("qwen3-1.7b"),
                               dtype=jnp.float32, n_heads=8, n_kv_heads=8,
                               head_dim=64)
    rp = RL.init_params(jax.random.PRNGKey(0), rcfg)
    prompt = jax.random.randint(jax.random.PRNGKey(1), (PKV.B, PKV.S), 0,
                                rcfg.vocab)
    rec = PKV.run("cpu", params=carried(rp), prompt=numpy_tokens(prompt))
    return ref, rec


def test_kv_cache_serving_prints_the_references_lines(kv_serving):
    ref, rec = kv_serving
    assert PKV.lines(rec) == ref


def test_kv_cache_serving_decodes_the_references_tokens(kv_serving):
    ref, rec = kv_serving
    want = json.loads(ref[-1].removeprefix("decoded: "))
    assert rec["decoded"][0] == want
    assert len(rec["decoded"]) == PKV.B


def test_kv_cache_serving_store_and_load_bitwise_on_the_cpu(kv_serving):
    _, rec = kv_serving
    assert rec["store_parity"] == (True, 0.0)
    assert rec["load_parity"] is True
    assert PKV.failures(rec) == []
