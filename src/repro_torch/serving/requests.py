"""Request streams: Poisson / trace-driven arrivals over model configs
(PyTorch port: the port's own copy of ``repro.serving.requests``, plain
numpy; the same seed draws the same stream).

A serving workload is a list of :class:`Request` records — arrival time,
prompt tokens, decode budget — generated either synthetically (Poisson
arrivals with sampled prompt/output lengths, the standard serving-benchmark
shape) or replayed from an explicit trace.  Prompts are drawn over a model
config's vocabulary so the same stream drives any config in
``src/repro_torch/configs``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Request", "poisson_stream", "trace_stream", "uniform_stream"]


@dataclasses.dataclass
class Request:
    """One serving request: ``tokens`` is the prompt (prompt_len,) int32,
    ``max_new`` the decode budget (total generated tokens incl. the prefill
    argmax), ``arrival_s`` the offered arrival time in seconds."""

    rid: int
    arrival_s: float
    tokens: np.ndarray
    max_new: int

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[-1])

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new


def _mk_prompt(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    return rng.integers(0, vocab, size=(n,), dtype=np.int64).astype(np.int32)


def poisson_stream(cfg, n_requests: int, rate_rps: float, *,
                   prompt_lens: Sequence[int] = (4, 8),
                   max_new: Sequence[int] = (2, 4),
                   seed: int = 0) -> List[Request]:
    """Poisson arrivals at ``rate_rps`` requests/s; prompt length and decode
    budget sampled uniformly from the given choices.  Deterministic per
    seed, so static vs continuous engines replay the *identical* stream."""
    if rate_rps <= 0:
        raise ValueError("rate_rps must be > 0")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n_requests)
    arrivals = np.cumsum(gaps)
    reqs = []
    for i in range(n_requests):
        pl = int(rng.choice(list(prompt_lens)))
        mn = int(rng.choice(list(max_new)))
        reqs.append(Request(rid=i, arrival_s=float(arrivals[i]),
                            tokens=_mk_prompt(rng, pl, cfg.vocab),
                            max_new=mn))
    return reqs


def uniform_stream(cfg, n_requests: int, gap_s: float, *,
                   prompt_len: int = 4, max_new: int = 3,
                   seed: int = 0) -> List[Request]:
    """Fixed inter-arrival gap and fixed shapes — the deterministic stream
    the parity tests use (every request identical in geometry)."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, arrival_s=i * float(gap_s),
                    tokens=_mk_prompt(rng, prompt_len, cfg.vocab),
                    max_new=max_new)
            for i in range(n_requests)]


def trace_stream(cfg, trace: Sequence[Tuple[float, int, int]], *,
                 seed: int = 0) -> List[Request]:
    """Replay an explicit trace of ``(arrival_s, prompt_len, max_new)``
    tuples (e.g. re-scaled production arrival logs)."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i, arrival_s=float(t), tokens=_mk_prompt(rng, pl, cfg.vocab),
                    max_new=int(mn))
            for i, (t, pl, mn) in enumerate(trace)]
