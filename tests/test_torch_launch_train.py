"""The train launcher (``python -m repro_torch.launch.train``) in a
subprocess on the CPU: moved from ``tests/test_torch_launch.py``,
unchanged, so that its time runs beside that file's.
"""
import pytest

pytest.importorskip("torch")

import os  # noqa: E402
import re  # noqa: E402
from test_torch_launch import (  # noqa: E402
    _run)


def test_train_launcher_loss_falls_and_resumes_on_the_cpu(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    args = ("--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--batch",
            "4", "--seq", "32", "--lr", "3e-3", "--ckpt-dir", ckpt,
            "--ckpt-every", "5")
    out = _run("repro_torch.launch.train", *args, "--steps", "20")
    assert out.returncode == 0, out.stderr
    first, last = re.search(r"final loss: ([\d.]+) \(from ([\d.]+)\)",
                            out.stdout).group(2, 1)
    assert float(last) < float(first) - 0.3, out.stdout
    assert "on cpu" in out.stderr
    out = _run("repro_torch.launch.train", *args, "--steps", "22")
    assert out.returncode == 0, out.stderr
    assert "resumed from step 20" in out.stderr
    assert sorted(os.listdir(ckpt))[-1] == "step_0000000022"
