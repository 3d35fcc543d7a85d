"""Feed-forward blocks: SwiGLU (LM family) and GeLU (whisper)."""
from __future__ import annotations

import torch.nn.functional as F

from ._init import Init


def init_swiglu(init: Init, d: int, d_ff: int):
    return {
        "w_gate": init.normal((d, d_ff), d ** -0.5),
        "w_up": init.normal((d, d_ff), d ** -0.5),
        "w_down": init.normal((d_ff, d), d_ff ** -0.5),
    }


def swiglu(cfg, p, x):
    dt = x.dtype
    h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
    return h @ p["w_down"].to(dt)


def init_gelu_mlp(init: Init, d: int, d_ff: int):
    return {
        "w_up": init.normal((d, d_ff), d ** -0.5),
        "b_up": init.zeros((d_ff,)),
        "w_down": init.normal((d_ff, d), d_ff ** -0.5),
        "b_down": init.zeros((d,)),
    }


def gelu_mlp(cfg, p, x):
    dt = x.dtype
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(x @ p["w_up"].to(dt) + p["b_up"].to(dt), approximate="tanh")
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)
