"""How far one f32 rounding of the weights moves a model's gradient,
against how far the sharded trainer's gradient is from the single-process
one (CPU).

    PYTHONPATH=src python scripts/sharded_grad_gap.py [ARCH] [--seq N]

For ``ARCH``'s full configuration in f32 (the port's seeded initializer),
on B 4 x N tokens of the synthetic stream: the single-process gradient
(the reference point), the same with every weight moved one f32 ulp up
(``nextafter``: a perturbation the size of one rounding), and the sharded
trainer's on a (2, 2) ("data", "model") mesh of 4 gloo ranks.  Prints,
for the leaves furthest off, each gap as a share of the leaf's largest
gradient, and the logits' largest magnitude.  A sharded gap of the size
of the one-ulp gap is rounding, not a fault.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))
import torch  # noqa: E402

B = 4


def _setup(arch, seq):
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    cfg = dataclasses.replace(configs.get_config(arch), dtype=torch.float32)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=B, seed=0,
                     family=cfg.family, d_model=cfg.d_model,
                     encoder_seq=cfg.encoder_seq)
    return cfg, {k: torch.from_numpy(v) for k, v in ds.batch_at(0).items()}


def sharded_grads(mesh, arch, seq):
    """One rank's part: the sharded gradient, whole, on rank 0."""
    from repro_torch import _pytree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as M
    from repro_torch.models import lm
    from repro_torch.train import step as T
    torch.set_num_threads(2)
    plain, batch = _setup(arch, seq)
    cfg = dataclasses.replace(plain.with_axes(M.axes_for(
        mesh, ShapeConfig("gap", seq, B, "train", 1))), fsdp=True)
    specs, _ = M.state_specs(cfg, mesh)
    params = M.shard_tree(lm.init_params(plain, 0, device="cpu"),
                          specs["params"], mesh)
    _, _, g = T._value_and_grad(cfg, params, T._data_block(batch, "data"),
                                mesh=mesh)
    whole = M.gather_tree(_pytree.unflatten(params, g), specs["params"],
                          mesh)
    return _pytree.leaves(whole) if mesh.rank == 0 else None


def main():
    from repro_torch import _pytree
    from repro_torch import sharding as S
    from repro_torch.models import lm
    from repro_torch.train import step as T
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="xlstm_125m")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()
    cfg, batch = _setup(args.arch, args.seq)
    params = lm.init_params(cfg, 0, device="cpu")
    names = [_pytree.path_key(p) for p, _ in
             _pytree.flatten_with_paths(params)]
    _, _, one = T._value_and_grad(cfg, params, batch)
    up = _pytree.unflatten(params, [
        torch.nextafter(p, torch.full_like(p, float("inf")))
        if p.is_floating_point() else p for p in _pytree.leaves(params)])
    ulp = T._value_and_grad(cfg, up, batch)[2]
    with tempfile.TemporaryDirectory() as work:
        sharded = S.run_spmd(sharded_grads, (2, 2), ("data", "model"),
                             args=(args.arch, args.seq), device="cpu",
                             workdir=work)[0]
    logits, _ = lm.forward(cfg, params, batch)

    def gap(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())
    rows = [(n, gap(u, o), gap(s, o))
            for n, o, u, s in zip(names, one, ulp, sharded)
            if float(o.abs().max()) > 0]
    print(f"{args.arch} f32, B {B} x {args.seq}: largest |logit| "
          f"{float(logits.abs().max()):.1f}")
    print("leaf, one ulp up off the reference point, sharded off it (of "
          "the leaf's largest gradient)")
    for n, u, s in sorted(rows, key=lambda r: -r[2])[:args.top]:
        print(f"{n} {u:.3e} {s:.3e}")
    print(f"largest: one ulp {max(r[1] for r in rows):.3e}, sharded "
          f"{max(r[2] for r in rows):.3e}")


if __name__ == "__main__":
    main()
