"""The port's sharding-spec inference (``repro_torch.launch.mesh``), input
specs and parameter counts (``repro_torch.configs.specs``) and the dry
run's FLOP accounting (``repro_torch.launch.dryrun``) against the
reference's.

``tests/test_specs.py`` runs on the port, its ``PartitionSpec``s written as
the port's tuples, the parameter shapes from ``init_params`` on the meta
device; every spec tree the port infers for a full config equals the
reference's (canonical ``PartitionSpec`` entries), and the counts and
FLOPs equal the reference's for every arch and shape.
"""
import pytest

pytest.importorskip("torch")

import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as RCF  # noqa: E402
from repro.configs import specs as RSP  # noqa: E402
from repro.configs.base import SHAPES as RSHAPES  # noqa: E402
from repro.launch import mesh as RMM  # noqa: E402
from repro.models import lm as RL  # noqa: E402
from repro.sharding import Axes as RAxes  # noqa: E402
from repro.train.step import init_state as rinit  # noqa: E402
from repro_torch import _pytree  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import specs as SP  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as MM  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.sharding import Axes, kv_cache_spec  # noqa: E402
from repro_torch.train.step import init_state  # noqa: E402
from torch_parity import reset_global_state  # noqa: E402,F401

AX = Axes(batch=("data",), model="model", model_size=16, batch_size=16)
RAX = RAxes(batch=("data",), model="model", model_size=16, batch_size=16)
ALIASES = sorted(configs._ALIASES)


def _meta_params(cfg):
    return lm.init_params(cfg, device="meta")


# -- tests/test_specs.py on the port ------------------------------------------
def test_param_rules_dense():
    specs = MM.infer_param_specs(
        _meta_params(configs.smoke_config("phi4_mini_3p8b")), AX)
    blk = specs["blocks"][0]
    assert blk["attn"]["wq"] == (None, None, "model")     # stacked lead dim
    assert blk["attn"]["wo"] == (None, "model")
    assert blk["ffn"]["w_gate"] == (None, None, "model")
    assert blk["ffn"]["w_down"] == (None, "model")
    assert specs["embed"]["embed"] == ("model",)
    assert specs["embed"]["head"] == (None, "model")
    assert specs["norm_final"]["scale"] == ()


def test_expert_rules_ep_vs_tp():
    specs = MM.infer_param_specs(
        _meta_params(configs.get_config("qwen3-moe-30b-a3b")), AX)  # EP
    assert specs["blocks"][0]["ffn"]["w_gate"] == (None, "model")
    specs2 = MM.infer_param_specs(
        _meta_params(configs.get_config("mixtral-8x7b")), AX)       # TP
    assert specs2["blocks"][0]["ffn"]["w_gate"] == (None, None, None, "model")
    assert specs2["blocks"][0]["ffn"]["w_down"] == (None, None, "model")


def test_fsdp_adds_dp_dim():
    specs = MM.infer_param_specs(
        _meta_params(configs.get_config("qwen3-1.7b")), AX, fsdp=True)
    assert specs["blocks"][0]["attn"]["wq"] == (None, "data", "model")
    # small leaves stay unsharded by fsdp
    assert specs["norm_final"]["scale"] == ()


def test_kv_cache_spec_rules():
    assert kv_cache_spec(AX, 16) == ("data", None, "model", None)
    assert kv_cache_spec(AX, 2) == ("data", "model", None, None)
    long_ax = Axes(batch=(), model="model", seq="data", model_size=16)
    assert kv_cache_spec(long_ax, 16) == (None, "data", "model", None)
    assert kv_cache_spec(long_ax, 2) == (None, ("data", "model"), None, None)


def test_fit_specs_drops_nondivisible():
    mesh = MM.MeshSpec((1,), ("model",))
    specs = {"a": ("model",), "b": ("model",)}
    shapes = {"a": ((7,), torch.float32), "b": ((8,), torch.float32)}
    fitted = MM.fit_specs(mesh, specs, shapes)
    assert fitted["a"] == ("model",)   # 7 % 1 == 0
    assert fitted["b"] == ("model",)
    wide = MM.fit_specs(MM.MeshSpec((4,), ("model",)), specs, shapes)
    assert wide == {"a": (), "b": ("model",)}


def test_axes_for_shapes():
    mesh = MM.MeshSpec((1, 1), ("data", "model"))
    ax = MM.axes_for(mesh, SHAPES["long_500k"])
    assert ax.seq == "data" and ax.batch == ()
    ax2 = MM.axes_for(mesh, SHAPES["train_4k"])
    assert ax2.batch == ("data",) and ax2.seq is None


# -- the whole trees, against the reference's --------------------------------
def _canon(p):
    t = tuple(p)
    while t and t[-1] is None:
        t = t[:-1]
    return t


def _ref_leaves(tree):
    """The reference's spec tree's leaves as the port's (PartitionSpec ->
    tuple, trailing Nones stripped), in the pytree order."""
    from jax.sharding import PartitionSpec as P
    return [_canon(p) for p in
            jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))]


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "jamba-1.5-large-398b",
                                  "xlstm-125m", "whisper-small",
                                  "gemma3-27b"])
def test_state_and_cache_specs_match_reference(arch):
    cfg, rcfg = configs.get_config(arch), RCF.get_config(arch)
    key = jax.ShapeDtypeStruct((2,), jnp.uint32)
    rstate = jax.eval_shape(lambda k: rinit(k, rcfg), key)
    state = init_state(cfg, device="meta")
    got = MM.infer_state_specs(state, AX)
    assert MM.spec_leaves(got, state) == _ref_leaves(
        RMM.infer_state_specs(rstate, RAX))
    rcache = jax.eval_shape(lambda: RL.init_cache(rcfg, 4, 64))
    cache = lm.init_cache(cfg, 4, 64, device="meta")
    got = MM.cache_specs(cfg, cache, AX)
    assert MM.spec_leaves(got, cache) == _ref_leaves(
        RMM.cache_specs(rcfg, rcache, RAX))


def test_batch_specs_and_input_specs_match_reference():
    for arch in ("qwen2-vl-7b", "whisper-small", "qwen3-1.7b"):
        for name in ("train_4k", "decode_32k"):
            cfg, rcfg = configs.get_config(arch), RCF.get_config(arch)
            got = SP.batch_specs(cfg, SHAPES[name])
            want = RSP.batch_specs(rcfg, RSHAPES[name])
            assert {k: (s, str(dt).replace("torch.", ""))
                    for k, (s, dt) in got.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
            specs = MM.batch_input_specs(got, AX)
            assert [specs[k] for k in sorted(specs)] == _ref_leaves(
                RMM.batch_input_specs(want, RAX))
            tok = SP.decode_token_specs(cfg, SHAPES[name])
            rtok = RSP.decode_token_specs(rcfg, RSHAPES[name])
            assert {k: s for k, (s, _) in tok.items()} == \
                {k: tuple(v.shape) for k, v in rtok.items()}


def test_production_mesh_refuses_a_small_world(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(RuntimeError, match="need 256 devices"):
        MM.make_production_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 256)
    assert MM.make_production_mesh().shape == (16, 16)
    with pytest.raises(RuntimeError, match="need 512 devices"):
        MM.make_production_mesh(multi_pod=True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 512)
    mesh = MM.make_production_mesh(multi_pod=True)
    assert mesh.shape == (2, 16, 16) and mesh.size == 512
    assert MM.axes_for(mesh, SHAPES["train_4k"]).batch == ("pod", "data")


# -- counts and FLOPs ----------------------------------------------------------
def _reference_dryrun():
    """``repro.launch.dryrun``, imported with the process's JAX backend
    already up and ``XLA_FLAGS`` put back (the module sets it on import,
    for its own 512-device runs)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


@pytest.mark.parametrize("arch", ALIASES)
def test_count_params_and_flops_match_reference(arch):
    RDR = _reference_dryrun()
    cfg, rcfg = configs.get_config(arch), RCF.get_config(arch)
    counts = SP.count_params(cfg)
    assert counts == RSP.count_params(rcfg)
    assert SP.count_params(configs.smoke_config(arch)) == \
        RSP.count_params(RCF.smoke_config(arch))
    for name in SHAPES:
        assert DR.attention_flops(cfg, SHAPES[name]) == \
            RDR.attention_flops(rcfg, RSHAPES[name])
        assert DR.model_flops(cfg, SHAPES[name], *counts) == \
            RDR.model_flops(rcfg, RSHAPES[name], *counts)
    real = sum(t.numel() for t in _pytree.leaves(_meta_params(cfg)))
    assert counts[0] == real
