"""The port's serving launcher, ``python -m repro_torch.launch.serve``, on
the CPU (``--device cpu``; on a machine with a card it defaults to the
card)."""
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
