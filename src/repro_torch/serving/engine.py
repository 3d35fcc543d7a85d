"""Serving engine: batched prefill + greedy decode (PyTorch port: the twin of
``repro.serving.engine``).

Movement plane: ``generate`` drives every byte of serving data movement
through a :class:`~repro_torch.runtime.DistributedScheduler` — prompt
staging on the h2d links, then one store+load round trip per cache tensor
after prefill and after every decode step (the paper's Prefill-store and
Load KV workloads on the live cache, link pairs alternating per tensor).
The moved cache is threaded back into the next decode step, so the plane is
the datapath, not a mirror: the descriptors are value-preserving (tiled
relayout round trips when a shard is tile-aligned, plain copies otherwise;
on the card an empty-chain relayout runs kernel 1) and generation is
bit-identical to a planeless decode loop.
Run ``generate`` inside :func:`repro_torch.runtime.trace.capture` to get the
serving movement ledger; ``engine.last_scheduler.report()`` has the
simulated timeline of the most recent call.

The reference compiles prefill and decode with ``jax.jit``; the port runs
them eagerly.  The engine runs on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import _pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.descriptor import describe
from repro_torch.models import lm
from repro_torch.serving import transfer as T

__all__ = ["ServingEngine", "make_serve_step"]


def make_serve_step(cfg: ModelConfig, *, mesh=None):
    """serve_step(params, cache, tokens) -> (logits, cache): one new token
    against the full KV/state cache."""

    def serve_step(params, cache, tokens):
        return lm.decode_step(cfg, params, tokens, cache, mesh=mesh)

    return serve_step


def _is_movement(leaf) -> bool:
    """Cache/prompt leaves that are data movement (vs control state):
    matrix-shaped floating tensors.  Scalars, position counters and id
    vectors ride along outside the plane."""
    return (isinstance(leaf, torch.Tensor) and leaf.dim() >= 2
            and leaf.is_floating_point())


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    # torch.argmax, like jnp.argmax, takes the first of tied maxima
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


class ServingEngine:
    """Minimal batched-request serving loop (greedy)."""

    def __init__(self, cfg: ModelConfig, params, max_len: int,
                 cache_dtype=torch.bfloat16, mesh=None, topology=None,
                 device=None):
        from repro_torch.serving.paged import default_serving_topology

        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.mesh = mesh
        self.device = torch.device("cuda" if device is None else device)
        self.topology = (topology if topology is not None
                         else default_serving_topology())
        self.last_scheduler = None
        self.last_cache = None          # the cache after the last step

    # -- the movement plane --------------------------------------------------
    def _new_scheduler(self):
        from repro_torch.runtime import DistributedScheduler

        return DistributedScheduler(self.topology, name="serving")

    def _stage_prompt(self, sched, batch: Dict[str, Any]) -> Dict[str, Any]:
        """Prompt payloads (embeds, audio frames) enter through the h2d
        staging links; integer id tensors pass through untouched."""
        names = sched.topology.link_names
        staged, futs = {}, {}
        for k, v in batch.items():
            arr = torch.as_tensor(v).to(self.device)
            if _is_movement(arr):
                futs[k] = sched.submit(arr, describe("MN", "MN"),
                                       link=names[0], label=f"prompt:{k}")
            else:
                staged[k] = arr
        sched.flush()
        staged.update({k: f.result() for k, f in futs.items()})
        sched.release(list(futs.values()))
        return staged

    def _cache_through_plane(self, sched, cache, tag: str):
        """One store+load round trip per cache tensor, link pairs alternating
        per tensor so shard i+1's store overlaps shard i's load.  Returns the
        cache rebuilt from the moved (bit-identical) buffers."""
        leaves = _pytree.leaves(cache)
        futs = {}
        lane = 0
        for i, leaf in enumerate(leaves):
            if _is_movement(leaf):
                futs[i] = T.kv_cache_roundtrip(leaf, scheduler=sched,
                                               lane=lane, label=tag)
                lane += 1
        sched.flush()
        for i, f in futs.items():
            leaves[i] = f.result().reshape(leaves[i].shape)
        # the scheduler keeps the timeline, not every step's buffers
        sched.release(list(futs.values()))
        return _pytree.unflatten(cache, leaves)

    # -- replica scale-up: the model to N replicas as one tree ---------------
    def distribute_weights(self, n_replicas: int = 4, *, topology=None):
        """Stage this engine's parameters onto ``n_replicas`` serving
        replicas through the multicast plane (one tree-routed descriptor
        per weight matrix), on ``topology`` or a ``ring(n_replicas + 1)``
        fabric whose first node hosts the source copy.  Returns
        ``({replica: params}, scheduler)``."""
        from repro_torch.runtime import DistributedScheduler, Topology

        topo = (topology if topology is not None
                else Topology.ring(n_replicas + 1))
        sched = DistributedScheduler(topo, name="weights")
        nodes = list(topo.nodes)
        out = T.replica_weight_broadcast(
            self.params, scheduler=sched, src=nodes[0],
            replicas=nodes[1:1 + n_replicas])
        self.last_scheduler = sched
        return out, sched

    # -- the serving loop ----------------------------------------------------
    def generate(self, batch: Dict[str, Any], n_steps: int, *,
                 scheduler=None):
        """batch: prompt tensors.  Returns (B, n_steps) generated int32 token
        ids on the engine's device; the final cache is kept as
        ``self.last_cache``.

        All prompt/KV movement is issued through ``scheduler`` (a fresh one
        on this engine's topology when not given; kept as
        ``self.last_scheduler``)."""
        lead = batch.get("tokens", batch.get("embeds"))
        B = lead.shape[0]
        sched = scheduler if scheduler is not None else self._new_scheduler()
        self.last_scheduler = sched
        batch = self._stage_prompt(sched, batch)
        cache = lm.init_cache(self.cfg, B, self.max_len, self.cache_dtype,
                              device=self.device)
        logits, cache = lm.prefill(self.cfg, self.params, batch, cache,
                                   mesh=self.mesh)
        cache = self._cache_through_plane(sched, cache, "kv:prefill")
        outs = []
        tok = _greedy(logits)
        for i in range(n_steps):
            outs.append(tok)
            logits, cache = lm.decode_step(self.cfg, self.params, tok, cache,
                                           mesh=self.mesh)
            cache = self._cache_through_plane(sched, cache, f"kv:decode{i}")
            tok = _greedy(logits)
        self.last_cache = cache
        return torch.cat(outs, dim=1)
