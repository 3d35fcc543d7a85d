"""Deterministic synthetic data pipeline (PyTorch port).

The twin of ``repro.data.pipeline``.  :class:`SyntheticLM` is the
reference's numpy generator, unchanged, so both packages draw the same
bytes: a reproducible token stream (uniform random ids, about half of
them replaced by a learnable recurrence), shardable by host, keyed on
(seed, step) so a restart resumes the stream exactly.

Staging takes a host batch to the device through the movement plane: float
payloads run through an in-order XDMA queue holding one Cast task (the cast
fused into the copy), integer ids are copied as they are.  The batch lands
on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    family: str = "dense"       # vlm/audio add stub-frontend tensors
    d_model: int = 0
    encoder_seq: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for a global step (host slice). Pure function of (seed, step)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        B, S, V = self.host_batch, self.seq_len, self.vocab
        # structured stream: next token = (a*prev + b) % V on half the steps
        base = rng.integers(0, V, size=(B, S + 1), dtype=np.int64)
        a, b = 31, 17
        for t in range(1, S + 1):
            deterministic = (base[:, t - 1] % 2) == 0
            base[:, t] = np.where(deterministic,
                                  (a * base[:, t - 1] + b) % V, base[:, t])
        batch: Dict[str, np.ndarray] = {
            "tokens": base[:, :-1].astype(np.int32),
            "labels": base[:, 1:].astype(np.int32),
        }
        if self.family == "vlm":
            batch["embeds"] = rng.standard_normal(
                (B, S, self.d_model)).astype(np.float32)
            pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
            batch["positions"] = np.stack([pos, pos, pos])
            del batch["tokens"]
        elif self.family == "audio":
            batch["audio_embeds"] = rng.standard_normal(
                (B, self.encoder_seq, self.d_model)).astype(np.float32)
        return batch


def make_batch_iterator(ds: SyntheticLM, start_step: int = 0) -> Iterator[Dict]:
    step = start_step
    while True:
        yield ds.batch_at(step)
        step += 1


# -- host -> device staging (an XDMA task queue) ------------------------------
@functools.lru_cache(maxsize=None)
def make_staging_queue(dtype_name: str):
    """The host->device staging DMA as an in-order XDMA queue: one Cast task,
    built once per dtype (the CFG phase) and run for every batch."""
    from repro_torch.core import MN, Cast, XDMAQueue, describe
    return XDMAQueue([describe(MN, MN, Cast(dtype_name))],
                     name=f"stage->{dtype_name}")


def _dtype_name(dtype) -> str:
    from repro_torch.core.layouts import dtype_info
    return dtype_info(dtype)[1]


def _is_float(v) -> bool:
    return np.issubdtype(np.asarray(v).dtype, np.floating)


def _to_device(v, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(v)).to(device)


def stage_batch(batch: Dict[str, np.ndarray], dtype, *,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Stage one host batch onto ``device`` (the card by default): float
    payloads run through the staging queue (the cast fused into the copy);
    integer id tensors are copied unchanged.  The queue is a movement-plane
    chokepoint, so an ambient ``capture()`` records one event per float
    tensor."""
    queue = make_staging_queue(_dtype_name(dtype))
    out = {}
    for k, v in batch.items():
        t = _to_device(v, device)
        out[k] = queue.run(t) if _is_float(v) else t
    return out


def prefetch_staged(batches: Iterator[Dict], dtype, *, depth: int = 2,
                    scheduler=None, device="cuda") -> Iterator[Dict]:
    """Double-buffered staging through the distributed runtime.

    While batch *n* is being consumed, up to ``depth`` later batches already
    have their float payloads submitted as staging tasks on the ``h2d``
    links, round-robin, so a multi-link fabric stages tensors concurrently.
    Yields staged dicts on ``device``, bit-identical to :func:`stage_batch`
    (both run the same cached Cast lowering); ``scheduler.report()`` shows
    the overlapped timeline."""
    from collections import deque

    from repro_torch.runtime import DistributedScheduler, Topology

    if depth < 1:
        raise ValueError("prefetch depth must be >= 1")
    if scheduler is None:
        scheduler = DistributedScheduler(Topology.host_device(2),
                                         name="staging")
    h2d = [n for n in scheduler.topology.link_names if n.startswith("h2d")] \
        or list(scheduler.topology.link_names)
    desc = make_staging_queue(_dtype_name(dtype)).descriptors[0]
    lane = 0

    def submit(batch: Dict) -> Dict:
        nonlocal lane
        staged = {}
        for k, v in batch.items():
            t = _to_device(v, device)
            if _is_float(v):
                staged[k] = scheduler.submit(t, desc,
                                             link=h2d[lane % len(h2d)],
                                             label=f"stage:{k}")
                lane += 1
            else:
                staged[k] = t
        return staged

    def ready(staged: Dict) -> Dict:
        return {k: v.result() if hasattr(v, "result") else v
                for k, v in staged.items()}

    window: deque = deque()
    for batch in batches:
        window.append(submit(batch))
        if len(window) > depth:
            yield ready(window.popleft())
    while window:
        yield ready(window.popleft())
