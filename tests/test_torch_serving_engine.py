"""Parity of the port's serving engine (``repro_torch.serving.engine``) with
the reference's.

The reference's ``ServingEngine`` (prefill and decode under ``jax.jit``) and
the port's, on the reference's parameters carried through numpy, generate
the same greedy tokens: at f32 every token; at the default bf16 every token
up to the first step where the reference's top-2 logit margin is within the
bf16 logit tolerance (``torch_model_cases.logit_tol``), where a tie can go
either way.  The movement plane's ledger under ``capture()`` is the
reference's event for event, and the plane is value-preserving: tokens and
final cache are bitwise those of the planeless loop.  The reference's
``tests/test_serving.py:15,26,63`` run on the port.
"""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_model_cases as TC  # noqa: E402
from repro.models import lm as RL  # noqa: E402
from repro.runtime import trace as RT  # noqa: E402
from repro.serving.engine import ServingEngine as RServingEngine  # noqa: E402
from repro_torch import _pytree  # noqa: E402
from repro_torch.models import lm as PL  # noqa: E402
from repro_torch.runtime import trace as PT  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401

# (arch, f32?, batch, prompt length, steps, max_len)
CASES = {
    "qwen3_f32": ("qwen3_1p7b", True, 2, 8, 6, 40),
    "phi4_f32": ("phi4_mini_3p8b", True, 1, 6, 4, 40),
    "whisper_f32": ("whisper_small", True, 2, 4, 5, 32),
    "qwen2_bf16": ("qwen2_0p5b", False, 2, 8, 6, 40),
    "xlstm_bf16": ("xlstm_125m", False, 2, 8, 5, 32),
}


def _engines(name):
    arch, f32, B, S, n, max_len = CASES[name]
    kw = {"dtype": TC.F32} if f32 else {}
    rcfg, pcfg = TC.configs(arch, **kw)
    rp, pp = TC.params(rcfg)
    cache_dt = TC.F32 if f32 else (jnp.bfloat16, torch.bfloat16)
    ref = RServingEngine(rcfg, rp, max_len=max_len, cache_dtype=cache_dt[0])
    port = ServingEngine(pcfg, pp, max_len=max_len, cache_dtype=cache_dt[1],
                         device="cpu")
    b = TC.batch(rcfg, B=B, S=S, seed=1)
    return ref, port, b, n


def _margins(eng, b, gen):
    """The reference's top-2 logit margin at each generated step (its full
    forward over prompt + generated tokens), and max|logit|."""
    cfg = eng.cfg
    seq = np.concatenate([b["tokens"], np.asarray(gen)[:, :-1]], 1)
    batch = {"tokens": jnp.asarray(seq)}
    if "audio_embeds" in b:
        batch["audio_embeds"] = jnp.asarray(b["audio_embeds"])
    logits = np.asarray(RL.forward(cfg, eng.params, batch)[0], np.float32)
    steps = logits[:, b["tokens"].shape[1] - 1:]
    top2 = np.sort(steps, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0], np.abs(logits).max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_generate_matches_reference_engine(name):
    ref, port, b, n = _engines(name)
    rb, pb = TC.inputs(b, ref.cfg, port.cfg)
    want = np.asarray(ref.generate(dict(rb), n))
    got = port.generate(dict(pb), n)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    got = got.numpy()
    margin, scale = _margins(ref, b, want)
    tol = TC.logit_tol(port.cfg.dtype, scale)
    close = np.flatnonzero((margin <= tol).any(0))
    upto = int(close[0]) if close.size else n
    if port.cfg.dtype == torch.float32:
        assert upto == n, f"an f32 near-tie at step {upto}: margin {margin}"
    assert upto >= 1
    np.testing.assert_array_equal(got[:, :upto], want[:, :upto])


def test_generation_greedy_deterministic_and_plane_is_value_preserving():
    """tests/test_serving.py:15 on the port, and the plane's promise: the
    tokens and the final cache are bitwise the planeless loop's."""
    ref, port, b, n = _engines("qwen3_f32")
    _, pb = TC.inputs(b, ref.cfg, port.cfg)
    out1 = port.generate(dict(pb), n)
    out2 = port.generate(dict(pb), n)
    out3, cache3 = TC.planeless_generate(port.cfg, port.params, pb, n,
                                         port.max_len, port.cache_dtype)
    assert tuple(out1.shape) == (2, n)
    assert torch.equal(out1, out2) and torch.equal(out1, out3)
    for a, c in zip(_pytree.leaves(port.last_cache), _pytree.leaves(cache3)):
        assert a.dtype == c.dtype and torch.equal(a, c)


def test_generation_matches_forward_argmax():
    """tests/test_serving.py:26 on the port: greedy decode == the argmax of
    the full forward, token by token."""
    _, port, b, n = _engines("phi4_f32")
    toks = torch.from_numpy(b["tokens"])
    gen = port.generate({"tokens": toks}, n)
    seq = toks
    for t in range(n):
        logits, _ = PL.forward(port.cfg, port.params, {"tokens": seq})
        nxt = int(torch.argmax(logits[0, -1]))
        assert nxt == int(gen[0, t]), (t, nxt, gen)
        seq = torch.cat([seq, torch.tensor([[nxt]], dtype=seq.dtype)], 1)


def _ledger(tr):
    return ([(e.kind, e.endpoint, e.link, tuple(e.logical_shape or ()),
              str(e.in_dtype).replace("torch.", ""), e.nbytes, e.label)
             for e in tr.events], tr.per_link_bytes())


@pytest.mark.parametrize("name", ["whisper_f32", "xlstm_bf16"])
def test_plane_ledger_matches_reference(name):
    """Under capture(): the prompt staging and every cache leaf's store and
    load, in the reference's order, on the reference's links, with its
    shapes, dtypes, bytes and labels."""
    ref, port, b, n = _engines(name)
    rb, pb = TC.inputs(b, ref.cfg, port.cfg)
    with RT.capture(name="serve") as rtr:
        ref.generate(dict(rb), 2)
    with PT.capture(name="serve") as ptr:
        port.generate(dict(pb), 2)
    want, got = _ledger(rtr), _ledger(ptr)
    assert got == want
    assert len(got[0]) > 4 * (2 + 1)


def test_distribute_weights_tree_matches_reference():
    """Every replica's tree is the source's, leaf for leaf and bitwise; the
    multicast plane carries the reference's bytes on each link."""
    ref, port, _, _ = _engines("phi4_f32")
    with RT.capture(name="w") as rtr:
        rout, _ = ref.distribute_weights(3)
    with PT.capture(name="w") as ptr:
        pout, _ = port.distribute_weights(3)
    assert sorted(pout) == sorted(rout)
    for node in pout:
        for w, g in zip(jax.tree.leaves(rout[node]),
                        _pytree.leaves(pout[node])):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert ptr.per_link_bytes() == rtr.per_link_bytes()
    assert [e.label for e in ptr.events] == [e.label for e in rtr.events]


def test_plane_releases_each_steps_buffers():
    """The scheduler keeps the serving timeline, not every step's moved
    buffers: after ``generate`` each task's output is released (its
    ``result()`` raises) and the report still covers every task."""
    ref, port, b, n = _engines("qwen3_f32")
    _, pb = TC.inputs(b, ref.cfg, port.cfg)
    port.generate(dict(pb), 2)
    sched = port.last_scheduler
    tasks = sched._tasks.values()
    assert tasks and all(t.done for t in tasks)
    from repro_torch.runtime import scheduler as S
    assert all(t.value is S._RELEASED and t.inputs == () for t in tasks)
    fut = S.XDMAFuture(sched, next(iter(sched._tasks)))
    with pytest.raises(RuntimeError, match="released"):
        fut.result()
    assert len(sched.sim_tasks()) == len(tasks)
    assert sched.report().makespan > 0
