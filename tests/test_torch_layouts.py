"""Parity of the port's layout IR (``repro_torch.core.layouts``) with the
reference's, and of the kernels' layout maps with the layout algebra.

Every conversion here is an element permutation (plus zero padding), so
every comparison is bitwise.
"""
import pytest

pytest.importorskip("torch")

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import layouts as RL  # noqa: E402
from repro_torch.core import layouts as PL  # noqa: E402
from repro_torch.kernels import maps  # noqa: E402
from torch_parity import bits, reset_global_state, to_torch  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CANONICAL = ["MN", "NM", "MNP64", "MNM8N128", "MNM16N128", "MNM32N128",
             "MNM8N8", "NMM8N128", "KV4M8N128"]
DTYPES = {"float32": np.float32, "bfloat16": jnp.bfloat16, "int8": np.int8}


def _logical(name, dtype, seed=0):
    shape = (8, 32, 256) if name == "KV4M8N128" else (64, 256)
    x = np.random.default_rng(seed).standard_normal(shape) * 20
    return x.astype(DTYPES[dtype])


def test_port_imports_neither_jax_nor_the_reference():
    # the runtime package resolves its exports lazily, so its modules are
    # named one by one
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.runtime\n"
            "import repro_torch.core.baselines, repro_torch.core.autotune, "
            "repro_torch.runtime.scheduler, repro_torch.runtime.trace, "
            "repro_torch.runtime.chrometrace, repro_torch.runtime.topology, "
            "repro_torch.runtime.ring, repro_torch.runtime.simulator\n"
            "import repro_torch.sharding, repro_torch.core.remote, "
            "repro_torch.serving, repro_torch.serving.transfer, "
            "repro_torch.serving.paged, repro_torch.data, "
            "repro_torch.data.pipeline, repro_torch.checkpoint, "
            "repro_torch.checkpoint.manager\n"
            "import repro_torch.configs, repro_torch.configs.base, "
            "repro_torch.layers, repro_torch.layers.norms, "
            "repro_torch.layers.rope, repro_torch.layers.embedding, "
            "repro_torch.layers.mlp, repro_torch.layers.attention, "
            "repro_torch.layers.mamba, repro_torch.layers.xlstm, "
            "repro_torch.models, repro_torch.models.lm, "
            "repro_torch.serving.engine, repro_torch.layers.moe, "
            "repro_torch.serving.requests, repro_torch.serving.continuous, "
            "repro_torch.launch, repro_torch.launch.serve\n"
            "import repro_torch.optim, repro_torch.optim.adamw, "
            "repro_torch.train, repro_torch.train.step, "
            "repro_torch.configs.specs, repro_torch.launch.mesh, "
            "repro_torch.launch.train, repro_torch.launch.dryrun, "
            "repro_torch.launch.op_cost\n"
            "from repro_torch import configs\n"
            "[configs.get_config(a) for a in configs.ARCHS]\n"
            "from repro_torch.launch import mesh as M, train as LT\n"
            "M.state_specs(configs.smoke_config('qwen3_1p7b'), "
            "M.MeshSpec(LT.mesh_shape(4), ('data', 'model')))\n"
            "from repro_torch import sharding as S\n"
            "from repro_torch.configs.base import SHAPES\n"
            "pod = M.make_production_mesh(multi_pod=True, check_world=False)\n"
            "with S.meta_mesh(pod.shape, pod.axis_names, 0):\n"
            "    M.state_specs(configs.get_config('qwen3-1.7b').with_axes("
            "M.axes_for(pod, SHAPES['train_4k'])), pod)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_dry_run_imports_no_reference_module():
    """``repro_torch.launch.dryrun`` alone, one smoke cell counted on a
    meta mesh (its bytes by ``launch.op_cost``): no ``repro`` module and no
    JAX in the process."""
    code = ("import sys\n"
            "from repro_torch import configs\n"
            "from repro_torch.configs.base import ShapeConfig\n"
            "from repro_torch.launch import dryrun, mesh, op_cost\n"
            "rec = dryrun.run_cell(configs.smoke_config('qwen3_1p7b'), "
            "ShapeConfig('d', 32, 4, 'decode'), mesh=mesh.MeshSpec((2, 2, 2), "
            "('pod', 'data', 'model')))\n"
            "assert rec['flops_per_device'] > 0\n"
            "assert rec['op_bytes_per_device'] > 0\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("example", ["torch_quickstart", "torch_train_lm",
                                     "torch_kv_cache_serving",
                                     "torch_compressed_dp"])
def test_the_examples_import_no_reference_module(example):
    """Each of the port's example scripts (``examples/torch_*.py``),
    imported as a module (its ``run`` and ``lines`` resolved, ``__main__``
    not run): no ``repro`` module and no JAX in the process."""
    path = os.path.join(ROOT, "examples", f"{example}.py")
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location({example!r}, "
            f"{path!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "assert callable(mod.run) and callable(mod.lines)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", CANONICAL)
def test_from_and_to_logical_bitwise(name, dtype):
    x = _logical(name, dtype)
    ref_phys = np.asarray(RL.by_name(name).from_logical(jnp.asarray(x)))
    port_phys = PL.by_name(name).from_logical(to_torch(x))
    assert tuple(port_phys.shape) == ref_phys.shape
    np.testing.assert_array_equal(bits(port_phys), bits(ref_phys))
    assert port_phys.is_contiguous()
    back = PL.by_name(name).to_logical(port_phys)
    np.testing.assert_array_equal(
        bits(back), bits(RL.by_name(name).to_logical(jnp.asarray(ref_phys))))


def test_from_logical_writes_zeros_into_stride_padding():
    x = to_torch(_logical("MNP64", "float32"))
    phys = PL.MNP64.from_logical(x)
    assert tuple(phys.shape) == (64, 320)
    assert torch.equal(phys[:, 256:], torch.zeros(64, 64))


@pytest.mark.parametrize("name", CANONICAL)
def test_shape_algebra_matches_reference(name):
    shape = (8, 32, 256) if name == "KV4M8N128" else (64, 256)
    r, p = RL.by_name(name), PL.by_name(name)
    assert (p.tile, p.perm, p.pad, p.name) == (r.tile, r.perm, r.pad, r.name)
    assert p.physical_shape(shape) == r.physical_shape(shape)
    assert p.logical_shape(p.physical_shape(shape)) == shape
    for dtype in ("float32", "bfloat16", "int8"):
        assert p.nbytes(shape, dtype) == r.nbytes(shape, dtype)
        assert (p.physical_nbytes(shape, dtype)
                == r.physical_nbytes(shape, dtype))


@pytest.mark.parametrize("name", CANONICAL)
def test_affine_patterns_match_reference(name):
    shape = (8, 32, 256) if name == "KV4M8N128" else (64, 256)
    rp = RL.affine_pattern(RL.by_name(name), shape)
    pp = PL.affine_pattern(PL.by_name(name), shape)
    assert (pp.bounds, pp.strides, pp.base) == (rp.bounds, rp.strides, rp.base)
    assert pp.burst_length() == rp.burst_length()
    assert pp.contiguity() == rp.contiguity()


@pytest.mark.parametrize("src,dst,transpose", [
    ("MN", "MNM8N128", False), ("MNM16N128", "MN", False),
    ("MNM8N128", "MNM8N128", True), ("MN", "NM", False),
    ("NMM8N128", "MN", False), ("MNP64", "MNM16N128", False),
    ("MN", "MN", True)])
def test_relayout_pairs_match_reference(src, dst, transpose):
    shape = (128, 256)
    rp = RL.relayout_pair(RL.by_name(src), RL.by_name(dst), shape,
                          transpose=transpose)
    pp = PL.relayout_pair(PL.by_name(src), PL.by_name(dst), shape,
                          transpose=transpose)
    assert (pp.bounds, pp.src_strides, pp.dst_strides) == \
        (rp.bounds, rp.src_strides, rp.dst_strides)
    assert pp.runs() == rp.runs()
    assert [(q.bounds, q.src_base, q.dst_base) for q in pp.split(2)] == \
        [(q.bounds, q.src_base, q.dst_base) for q in rp.split(2)]


def test_nest_incompatible_pair_has_no_pattern():
    t6, t4 = PL.Layout((6, 128), "t6"), PL.Layout((4, 128), "t4")
    assert PL.relayout_pair(t6, t4, (24, 256)) is None


@pytest.mark.parametrize("args,kw", [
    ((8, 128), {}), ((16, 128), {}), ((1, 8, 128), {}), ((4, 8, 128), {}),
    ((8, 128), {"grid_colmajor": True}), ((8, 128), {"tile_transposed": True}),
    ((16, 64), {"pad_last": 64})])
def test_tiled_layout_interning_matches_reference(args, kw):
    r, p = RL.tiled_layout(*args, **kw), PL.tiled_layout(*args, **kw)
    assert (p.name, p.tile, p.perm, p.pad) == (r.name, r.tile, r.perm, r.pad)
    assert PL.tiled_layout(*args, **kw) is p
    if r.name in ("MNM8N128", "MNM16N128", "KV4M8N128"):
        assert p is PL.by_name(r.name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8",
                                   "int32"])
def test_layout_for_dtype(dtype):
    assert (PL.layout_for_dtype(dtype).name
            == RL.layout_for_dtype(jnp.dtype(dtype)).name)
    assert PL.layout_for_dtype(PL.torch_dtype(dtype)).name == \
        PL.layout_for_dtype(dtype).name


def test_by_name_unknown_raises():
    with pytest.raises(KeyError):
        PL.by_name("MNM7N3")


def test_bad_layouts_raise_like_reference():
    with pytest.raises(ValueError):
        PL.Layout((0, 128))
    with pytest.raises(ValueError):
        PL.Layout(None, perm=(0, 0))
    with pytest.raises(ValueError):
        PL.MNM8N128.check((12, 128))


# -- the kernels' layout maps against the layout algebra ----------------------
def _offsets(layout, logical_shape):
    """The kernels' per-dim map, ``(i // t) * sgrid + (i % t) * stile``
    summed over the logical dims: the physical offset of every logical
    element, row-major."""
    out = torch.zeros((), dtype=torch.int64)
    for d, (t, sg, st) in enumerate(maps.dim_maps(layout, logical_shape)):
        i = torch.arange(logical_shape[d], dtype=torch.int64)
        shape = [1] * len(logical_shape)
        shape[d] = -1
        out = out + ((i // t) * sg + (i % t) * st).reshape(shape)
    return out


@pytest.mark.parametrize("name", CANONICAL + ["tiled_pad", "tile_t"])
def test_kernel_maps_walk_the_affine_pattern(name):
    layout = {"tiled_pad": PL.tiled_layout(16, 64, pad_last=64),
              "tile_t": PL.tiled_layout(8, 128, tile_transposed=True)
              }.get(name) or PL.by_name(name)
    shape = (8, 32, 256) if name == "KV4M8N128" else (64, 256)
    got = _offsets(layout, shape).reshape(-1).numpy()
    want = PL.affine_pattern(layout, shape).addresses()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", CANONICAL)
def test_physical_dims_invert_the_writer(name):
    """Decompose every physical index the way the block kernel does and
    check it lands on the logical element the writer put there."""
    layout = PL.by_name(name)
    shape = (8, 32, 256) if name == "KV4M8N128" else (32, 256)
    phys = maps.physical_dims(layout, shape)
    p = np.arange(int(np.prod(layout.physical_shape(shape))))
    coords = np.zeros((len(shape), p.size), dtype=np.int64)
    rem = p.copy()
    for extent, d, weight in reversed(phys):
        coords[d] += (rem % extent) * weight
        rem //= extent
    padded = [shape[d] + layout.dim_pad(len(shape), d)
              for d in range(len(shape))]
    assert all((coords[d] < padded[d]).all() for d in range(len(shape)))
    inside = np.all(coords < np.asarray(shape)[:, None], axis=0)
    logical = np.arange(int(np.prod(shape))).reshape(shape)
    written = PL.by_name(name).from_logical(torch.from_numpy(logical + 1))
    flat = written.reshape(-1).numpy()
    np.testing.assert_array_equal(flat[~inside], 0)
    want = logical[tuple(coords[:, inside])] + 1
    np.testing.assert_array_equal(flat[inside], want)


def test_inner_axis():
    """The logical axis innermost in a layout's physical order is the one
    the tiled copy runs its accesses along (``maps.run_axis``), here with
    16-byte packs of 4 elements."""
    shape = (64, 256)
    for layout, axis in ((PL.MN, 1), (PL.NM, 0), (PL.NMM8N128, 1),
                         (PL.tiled_layout(8, 128, tile_transposed=True), 0)):
        got = maps.run_axis(maps.dim_maps(layout, shape), shape, 4)
        assert got == (axis, 4), layout.name
