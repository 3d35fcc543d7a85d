"""Continuous batching over the paged-KV pool: admission, composition,
preemption — every KV byte moving as a page descriptor (PyTorch port: the
twin of ``repro.serving.continuous``).

The engine holds no per-request cache tensors.  A request's KV state lives
in :class:`~repro_torch.serving.paged.PagedKVPool` pages — the *valid
prefix* of each sequence-indexed cache leaf, paged as fixed-row tiles —
plus an integer position.  Each serving step:

1. **re-admission** — preempted requests restore their pages (oldest first)
   when slots free up;
2. **admission** — arrived requests join while the batch has room and the
   pool can hold their prompt pages;
3. **prefill** — admitted prompts run ``lm.prefill`` (grouped by prompt
   length), and the valid prefix of every cache leaf scatters into fresh
   pages;
4. **preemption** — if the next decode's page growth exceeds the free pool,
   the youngest requests evict wholesale to host (Compress wire codec)
   until the rest fit;
5. **decode** — active pages gather into a batch cache (page-table
   indirection in reverse), one ``lm.decode_step`` advances every active
   request — a scalar position when the batch is aligned (the exact program
   ``ServingEngine`` runs, which makes the tokens bitwise equal) or a
   per-request position vector when ragged — and the dirty pages scatter
   back;
6. the simulated clock advances by the step's scheduler makespan.

Under sharded serving (``mesh=``, every rank of the mesh running the same
engine on the same request stream, ``params`` this rank's blocks by
``launch.mesh.serving_specs``) the batch is replicated over the data axis
and each rank pages its blocks of every request's cache: its KV heads, or
its block of a sequence split over the model axis, over a context-parallel
``seq`` axis or over the pair ``(seq, model)``
(``layers.attention.kv_seq_axis``: rank r holds slots ``[r blk, (r + 1)
blk)`` of every request), or the whole leaf where the split does not
divide it.  Every decision (admission, preemption, defrag, the clock) is
read from state that is the same on every rank: the page counts and
movements (the ranks' blocks share one geometry; a sequence block pages
whole as the first block fills, and a decode stores from the written
slot's row in its block, on every rank), the compute cost (the whole
model's parameter count) and the tokens (from the whole logits).

On the card every page store and load is kernel 1 (the page layout's
relayout) and every evict and restore kernel 3 (the Compress wire codec).
The scheduler's finished tasks are released once the pool has landed
their results, so moved pages are not pinned by the timeline.

``StaticBatchEngine`` is the baseline: same pool, same kernels, but gang
admission only (a new batch forms only when the previous one fully drains,
and finished members keep occupying batch rows and page traffic until the
gang completes).  The engines run on the card unless given
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import _pytree
from repro_torch.models import lm
from repro_torch.runtime import DistributedScheduler, telemetry as _tm
from repro_torch.serving.paged import (PagedKVPool, default_serving_topology,
                                       pages_for_rows, DEFAULT_PAGE_ROWS)
from repro_torch.serving.requests import Request

__all__ = ["ContinuousBatchingEngine", "StaticBatchEngine", "ServeReport"]

HW_FLOPS = 50e12                # matches the MoE capacity-planner's engine

# Serving SLO counters: queue-depth high-water, preemption and step tallies
# — always counting, like every CSR bank.
_SERVING = _tm.bank("serving")


# ---------------------------------------------------------------------------
# cache-leaf geometry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _LeafMeta:
    """How one cache leaf pages: where its batch/sequence axes are and the
    canonical (rows, cols) matrix view the pool stores.

    kind: 'pos' (the shared position counter), 'const' (no batch axis —
    broadcast from the template), 'seq' (sequence-indexed: only the valid
    prefix pages, so memory grows with decoded tokens), 'state' (per-request
    but not sequence-indexed — SSM states, rolling-window caches — paged
    whole every step)."""

    index: int
    kind: str
    batch_axis: int = -1
    seq_axis: int = -1              # in the full (batched) leaf
    rpt: int = 1                    # canonical rows per token (seq leaves)
    rows: int = 0                   # total canonical rows (B=1 leaf)
    cols: int = 1

    def seq_axis_nb(self) -> int:
        """Sequence axis after the batch axis is removed."""
        return self.seq_axis - (1 if self.batch_axis < self.seq_axis else 0)


def _leaf_metas(cfg, max_len: int, cache_dtype) -> Tuple[List[_LeafMeta], Any]:
    """Classify every cache leaf by probing ``init_cache`` shapes at
    (B=1, L), (B=2, L) and (B=1, kL) on the meta device (no memory): the
    axis that moves with B is the batch axis, the one that moves with L the
    sequence axis.  Leaves invariant to L (rolling windows shorter than
    max_len, SSM states) page whole.  Under sharded serving the probes are
    this rank's blocks, so a page holds a rank's block (its rows of a
    sequence split over the model axis, ``seq`` or the pair); there k is
    the mesh's size plus one, so that every axis divides kL exactly where
    it divides L and the probe splits a leaf where L's cache does (k = 2
    would split a max_len the axis does not divide).  Returns (metas, B=1
    template tree of meta tensors)."""
    probe = lambda b, l: lm.init_cache(cfg, b, l, cache_dtype,  # noqa: E731
                                       device="meta")
    sh = lm.shards_of(cfg, serving=True)
    k = 2 if sh is None else math.prod(sh.mesh.shape) + 1
    t1 = probe(1, max_len)
    p1 = _pytree.flatten_with_paths(t1)
    l2 = _pytree.flatten_with_paths(probe(2, max_len))
    ll = _pytree.flatten_with_paths(probe(1, k * max_len))
    metas: List[_LeafMeta] = []
    for i, ((path, a), (_, b), (_, c)) in enumerate(zip(p1, l2, ll)):
        keys = _pytree.path_key(path)
        if "pos" in keys and a.dim() == 0:
            metas.append(_LeafMeta(i, "pos"))
            continue
        batch_ax = next((j for j in range(a.dim())
                         if a.shape[j] != b.shape[j]), -1)
        if batch_ax < 0:
            metas.append(_LeafMeta(i, "const"))
            continue
        nb = tuple(a.shape[:batch_ax]) + tuple(a.shape[batch_ax + 1:])
        if len(nb) < 1:
            raise NotImplementedError(f"cache leaf {keys} has no state "
                                      "beyond the batch axis")
        cols = int(nb[-1])
        seq_ax = next((j for j in range(a.dim())
                       if a.shape[j] != c.shape[j]), -1)
        if seq_ax < 0:
            rows = int(np.prod(nb[:-1], dtype=np.int64)) if len(nb) > 1 else 1
            metas.append(_LeafMeta(i, "state", batch_axis=batch_ax,
                                   rows=rows, cols=cols))
            continue
        seq_nb = seq_ax - (1 if batch_ax < seq_ax else 0)
        S = int(a.shape[seq_ax])
        rest = tuple(d for j, d in enumerate(nb) if j != seq_nb)
        if not rest:
            raise NotImplementedError(f"cache leaf {keys}: sequence axis is "
                                      "the only non-batch axis")
        cols = int(rest[-1])
        rpt = int(np.prod(rest[:-1], dtype=np.int64)) if len(rest) > 1 else 1
        metas.append(_LeafMeta(i, "seq", batch_axis=batch_ax, seq_axis=seq_ax,
                               rpt=rpt, rows=S * rpt, cols=cols))
    return metas, t1


def _to_canonical(meta: _LeafMeta, leaf_nb: torch.Tensor) -> torch.Tensor:
    """Per-request leaf (batch axis removed) -> the (rows, cols) matrix the
    pool pages.  Sequence leaves put the token axis outermost so the valid
    prefix is a row prefix."""
    if meta.kind == "seq":
        x = leaf_nb.movedim(meta.seq_axis_nb(), 0)
        return x.reshape(meta.rows, meta.cols)
    return leaf_nb.reshape(meta.rows, meta.cols)


def _from_canonical(meta: _LeafMeta, mat: torch.Tensor,
                    nb_shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`_to_canonical`."""
    if meta.kind == "seq":
        seq_nb = meta.seq_axis_nb()
        S = nb_shape[seq_nb]
        rest = tuple(d for j, d in enumerate(nb_shape) if j != seq_nb)
        return mat.reshape((S,) + rest).movedim(0, seq_nb)
    return mat.reshape(nb_shape)


# ---------------------------------------------------------------------------
# request state + report
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _ReqState:
    req: Request
    status: str = "queued"          # queued | active | preempted | done
    pos: int = 0                    # tokens resident in the (logical) cache
    generated: List[int] = dataclasses.field(default_factory=list)
    pages: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    finish_s: float = -1.0
    # simulated-clock stamp of every generated token (SLO metrics: TTFT is
    # token_times[0] - arrival, TBT the successive differences)
    token_times: List[float] = dataclasses.field(default_factory=list)
    logits: List[torch.Tensor] = dataclasses.field(default_factory=list)

    @property
    def done_tokens(self) -> bool:
        return len(self.generated) >= self.req.max_new


@dataclasses.dataclass
class ServeReport:
    """What a serve() run produced: per-request tokens plus the load-side
    aggregates (simulated time base — the scheduler's costed timeline)."""

    engine: str
    n_requests: int
    total_tokens: int
    elapsed_s: float
    tokens_per_s: float
    p50_s: float
    p99_s: float
    steps: int
    preemptions: int
    pool_stats: Dict[str, int]
    tokens: Dict[int, np.ndarray]
    # SLO latency aggregates on the simulated clock: time-to-first-token and
    # time-between-tokens percentiles over completed requests
    ttft_p50_s: float = 0.0
    ttft_p99_s: float = 0.0
    tbt_p50_s: float = 0.0
    tbt_p99_s: float = 0.0
    # with ``keep_logits``: each request's (tokens, vocab) f32 logits, the
    # row each of its tokens was picked from (whole logits under a mesh)
    logits: Optional[Dict[int, np.ndarray]] = None

    def summary(self) -> str:
        return (f"{self.engine}: {self.n_requests} reqs, "
                f"{self.total_tokens} toks in {self.elapsed_s * 1e6:.1f}us "
                f"-> {self.tokens_per_s:,.0f} tok/s, "
                f"p50 {self.p50_s * 1e6:.1f}us p99 {self.p99_s * 1e6:.1f}us, "
                f"ttft p99 {self.ttft_p99_s * 1e6:.1f}us, "
                f"{self.preemptions} preemptions")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class ContinuousBatchingEngine:
    """Serve a request stream with per-step admission over a paged-KV pool.

    The decode program is the ``lm.decode_step`` the fixed-batch
    :class:`~repro_torch.serving.engine.ServingEngine` runs — when every
    active request sits at the same position the composed cache uses a
    scalar ``pos`` and every generated token is bit-identical to the
    fixed-batch engine's.  ``keep_logits`` keeps, on the host, the logits
    each token was picked from (``ServeReport.logits``).
    """

    name = "continuous"

    def __init__(self, cfg, params, max_len: int, *, max_batch: int = 4,
                 cache_dtype=torch.float32, topology=None,
                 pool: Optional[PagedKVPool] = None,
                 page_rows: int = DEFAULT_PAGE_ROWS,
                 capacity_pages: Optional[int] = None,
                 defrag: bool = True, mesh=None,
                 ring_depth: Optional[int] = None,
                 backpressure: str = "block", device=None,
                 keep_logits: bool = False):
        if cfg.encoder_layers:
            raise NotImplementedError("continuous batching serves decoder "
                                      "LMs; encoder-decoder configs use "
                                      "ServingEngine")
        if mesh is not None:
            # sharded serving: every data rank serves every request (a
            # request's rows would otherwise move between data ranks as the
            # batch's composition changes), each rank's pages holding its
            # model-axis blocks of the request's cache
            cfg = dataclasses.replace(cfg, axes=dataclasses.replace(
                cfg.axes, batch=()))
        self.cfg = cfg
        self.params = params
        self.max_len = int(max_len)
        self.max_batch = int(max_batch)
        self.cache_dtype = cache_dtype
        self.device = torch.device("cuda" if device is None else device)
        self.mesh = mesh
        self.topology = topology if topology is not None \
            else default_serving_topology()
        self.auto_defrag = defrag
        self.pool = pool if pool is not None else PagedKVPool(
            capacity_pages if capacity_pages is not None else 64, page_rows)
        self.metas, self._template = _leaf_metas(cfg, max_len, cache_dtype)
        # the whole model's count (a rank's blocks hold a part of it): the
        # simulated clock, and so every admission, is the same on every
        # rank
        self._n_params = sum(
            int(l.numel()) for l in _pytree.leaves(
                params if mesh is None else lm.init_params(cfg,
                                                           device="meta"))
            if isinstance(l, torch.Tensor) and l.dim() >= 1)
        self.ring_depth = ring_depth
        self.backpressure = backpressure
        self.keep_logits = keep_logits
        self.last_scheduler = None
        self.steps = 0
        self.preemptions = 0

    def _new_scheduler(self) -> DistributedScheduler:
        """One fresh per-step scheduler, carrying the engine's ring knobs
        (``ring_depth=None`` keeps the scheduler default)."""
        kw = {} if self.ring_depth is None else {"ring_depth": self.ring_depth}
        return DistributedScheduler(self.topology, name="serving-cb",
                                    backpressure=self.backpressure, **kw)

    def _commit(self, sched) -> None:
        """Land the pool's pending movements, then let the scheduler drop
        the buffers of those tasks (and of the tasks they depended on)."""
        sched.release(self.pool.commit())

    # -- page accounting -----------------------------------------------------
    def _pages_at(self, meta: _LeafMeta, pos: int) -> int:
        """Pool pages leaf ``meta`` occupies when ``pos`` tokens are valid."""
        if meta.kind == "seq":
            # a sequence split over the model axis pages every rank's block
            # as the first block fills, so every rank counts the same pages
            rows = min(pos, self.max_len, meta.rows // meta.rpt) * meta.rpt
        elif meta.kind == "state":
            rows = meta.rows
        else:
            return 0
        return pages_for_rows(rows, self.pool.page_rows)

    def _footprint(self, pos: int) -> int:
        return sum(self._pages_at(m, pos) for m in self.metas)

    def _growth(self, pos: int) -> int:
        return self._footprint(pos + 1) - self._footprint(pos)

    # -- page scatter/gather -------------------------------------------------
    def _scatter(self, st: _ReqState, cache_b1, *, deps=(), dirty_from=None,
                 label: str = "store") -> None:
        """Write one request's cache (a B=1 slice) into its pages.  With
        ``dirty_from`` (a token position), sequence leaves only store the
        pages overlapping rows written at/after that position."""
        leaves = _pytree.leaves(cache_b1)
        R = self.pool.page_rows
        dtype_name = str(self.cache_dtype).replace("torch.", "")
        for m in self.metas:
            if m.kind in ("pos", "const"):
                continue
            leaf_nb = leaves[m.index].squeeze(m.batch_axis)
            mat = _to_canonical(m, leaf_nb)
            plist = st.pages.setdefault(m.index, [])
            want = self._pages_at(m, st.pos)
            if m.kind == "seq" and dirty_from is not None:
                # the written slot's row in its block (every rank stores
                # from there: the same movements, and so the same clock)
                first = ((min(dirty_from, self.max_len - 1)
                          % (m.rows // m.rpt)) * m.rpt) // R
            else:
                first = 0
            for j in range(first, want):
                if j >= len(plist):
                    plist.append(self.pool.alloc(m.cols, dtype_name))
                if (j + 1) * R <= m.rows:
                    page_mat = mat[j * R:(j + 1) * R]
                else:
                    page_mat = torch.cat([mat[j * R:], mat.new_zeros(
                        ((j + 1) * R - m.rows, m.cols))])
                self.pool.store(plist[j], page_mat, deps=deps, label=label)

    def _gather(self, st: _ReqState):
        """One request's page loads: futures keyed by leaf index, each a
        list of page futures."""
        futs: Dict[int, List[Any]] = {}
        for m in self.metas:
            if m.kind in ("pos", "const"):
                continue
            futs[m.index] = [self.pool.load(pid)
                             for pid in st.pages.get(m.index, [])]
        return futs

    def _compose_leaf(self, m: _LeafMeta, page_vals: List[torch.Tensor]
                      ) -> torch.Tensor:
        """Pages -> one per-request cache leaf (batch axis restored), the
        unvalidated tail zero-filled exactly as ``init_cache`` leaves it."""
        R = self.pool.page_rows
        have = len(page_vals) * R
        if page_vals:
            mat = torch.cat(page_vals, 0)
            if have < m.rows:
                mat = torch.cat([mat, mat.new_zeros((m.rows - have,
                                                     m.cols))])
            else:
                mat = mat[:m.rows]
        else:
            mat = torch.zeros((m.rows, m.cols), dtype=self.cache_dtype,
                              device=self.device)
        shape = tuple(_pytree.leaves(self._template)[m.index].shape)
        nb_shape = shape[:m.batch_axis] + shape[m.batch_axis + 1:]
        return _from_canonical(m, mat, nb_shape).unsqueeze(m.batch_axis)

    # -- batch composition ---------------------------------------------------
    def _compose_cache(self, active: List[_ReqState],
                       gathered: List[Dict[int, List[Any]]]):
        """Per-request pages -> one batched decode cache.  A scalar ``pos``
        (0-d, on the CPU, as ``init_cache`` makes it) when the batch is
        position-aligned (the fixed-batch engine's program), a per-request
        vector otherwise."""
        t_leaves = _pytree.leaves(self._template)
        out: List[Any] = []
        for m in self.metas:
            if m.kind == "pos":
                poss = [min(st.pos, self.max_len) for st in active]
                out.append(torch.tensor(poss[0], dtype=torch.int32)
                           if len(set(poss)) == 1
                           else torch.tensor(poss, dtype=torch.int32,
                                             device=self.device))
            elif m.kind == "const":
                out.append(torch.zeros(t_leaves[m.index].shape,
                                       dtype=t_leaves[m.index].dtype,
                                       device=self.device))
            else:
                parts = [self._compose_leaf(
                    m, [f.result() for f in gathered[i][m.index]])
                    for i in range(len(active))]
                out.append(torch.cat(parts, m.batch_axis))
        return _pytree.unflatten(self._template, out)

    def _split_cache(self, cache, n: int):
        """Batched cache -> per-request B=1 caches (for page scatter)."""
        leaves = _pytree.leaves(cache)
        outs = []
        for i in range(n):
            li = list(leaves)
            for m in self.metas:
                if m.kind in ("seq", "state"):
                    li[m.index] = leaves[m.index].narrow(m.batch_axis, i, 1)
            outs.append(_pytree.unflatten(cache, li))
        return outs

    # -- admission policy ----------------------------------------------------
    def _admit(self, active, preempted, queue, clock):
        """Default (continuous) policy: restore preempted oldest-first, then
        admit arrivals while the batch and the pool have room.  A restore
        takes its slots at once; an admission's prompt pages are taken by
        its prefill, so each admission counts the pages of those admitted
        before it in the step (the reference counts only the free pages,
        and two arrivals that fit one at a time ran the pool out of pages
        in their prefill)."""
        restored = []
        while preempted and len(active) < self.max_batch:
            st = preempted[0]
            need = sum(len(v) for v in st.pages.values())
            if need > self.pool.free_pages:
                break
            preempted.pop(0)
            for plist in st.pages.values():
                for pid in plist:
                    self.pool.restore(pid)
            st.status = "active"
            active.append(st)
            restored.append(st)
        admitted, free = [], self.pool.free_pages
        while queue and len(active) < self.max_batch:
            st = queue[0]
            if st.req.arrival_s > clock:
                break
            need = self._footprint(st.req.prompt_len)
            if need > free:
                break
            free -= need
            queue.pop(0)
            st.status = "active"
            active.append(st)
            admitted.append(st)
        return restored, admitted

    def _mark(self, tel, sched, t0, cursor, name):
        """Close one engine phase on the simulated clock: the span runs from
        ``cursor`` to ``t0 + makespan-so-far``."""
        now = t0 + sched.makespan()
        if now > cursor:
            tel.add_span(f"engine.{name}", cursor, now, track="engine",
                         step=self.steps, engine=self.name)
        return max(cursor, now)

    # -- the serving loop ----------------------------------------------------
    def serve(self, requests: Sequence[Request], *,
              max_steps: int = 10_000) -> ServeReport:
        for r in requests:
            if r.total_len > self.max_len:
                raise ValueError(f"request {r.rid}: prompt {r.prompt_len} + "
                                 f"max_new {r.max_new} exceeds max_len "
                                 f"{self.max_len}")
        queue = [_ReqState(r) for r in
                 sorted(requests, key=lambda r: (r.arrival_s, r.rid))]
        states = {st.req.rid: st for st in queue}
        active: List[_ReqState] = []
        preempted: List[_ReqState] = []
        clock = 0.0
        self.steps = 0
        self.preemptions = 0
        tel = _tm.active()

        while (queue or active or preempted) and self.steps < max_steps:
            if not active and not preempted and queue \
                    and queue[0].req.arrival_s > clock:
                clock = queue[0].req.arrival_s     # idle: jump to next arrival
            sched = self._new_scheduler()
            self.last_scheduler = sched
            self.pool.bind(sched)
            _SERVING.inc("steps")
            _SERVING.record_max("queue_depth_hw", len(queue))
            cursor = clock                         # engine-phase span cursor

            restored, admitted = self._admit(active, preempted, queue, clock)
            if restored:
                sched.flush()
                self._commit(sched)                # restored pages land now
            if tel is not None:
                cursor = self._mark(tel, sched, clock, cursor, "admission")

            # prefill new admissions, grouped by prompt length (a gang of
            # equal prompts runs the fixed-batch prefill program)
            by_len: Dict[int, List[_ReqState]] = {}
            for st in admitted:
                by_len.setdefault(st.req.prompt_len, []).append(st)
            for plen, group in sorted(by_len.items()):
                toks = torch.from_numpy(np.stack(
                    [st.req.tokens for st in group]).astype(np.int32)).to(
                        self.device)
                cache0 = lm.init_cache(self.cfg, len(group), self.max_len,
                                       self.cache_dtype, device=self.device)
                logits, cache = lm.prefill(self.cfg, self.params,
                                           {"tokens": toks}, cache0,
                                           mesh=self.mesh,
                                           max_len=self.max_len)
                cost = 2.0 * self._n_params * len(group) * plen / HW_FLOPS
                cfut = sched.submit_compute(lambda *a: None, cost_s=cost,
                                            label=f"compute:prefill:{plen}")
                nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
                kept = self._kept(logits)
                for i, st in enumerate(group):
                    st.pos = plen
                    st.generated.append(int(nxt[i]))
                    if kept is not None:
                        st.logits.append(kept[i])
                for i, (st, c1) in enumerate(
                        zip(group, self._split_cache(cache, len(group)))):
                    self._scatter(st, c1, deps=(cfut,), label="store")
            if admitted:
                sched.flush()
                self._commit(sched)
            if tel is not None:
                cursor = self._mark(tel, sched, clock, cursor, "prefill")

            if not active:
                self.steps += 1
                continue

            # memory pressure: will the next decode's page growth fit?
            decoding = [st for st in active if not st.done_tokens
                        or self._gang_member(st)]
            growth = sum(self._growth(st.pos) for st in decoding)
            while growth > self.pool.free_pages and len(active) > 1:
                victim = max(active, key=lambda s: s.req.arrival_s)
                active.remove(victim)
                for plist in victim.pages.values():
                    for pid in plist:
                        self.pool.evict(pid)
                victim.status = "preempted"
                preempted.append(victim)
                preempted.sort(key=lambda s: s.req.arrival_s)
                self.preemptions += 1
                _SERVING.inc("preemptions")
                sched.flush()
                self._commit(sched)                # slots free for the rest
                decoding = [st for st in active if not st.done_tokens
                            or self._gang_member(st)]
                growth = sum(self._growth(st.pos) for st in decoding)
            if tel is not None:
                cursor = self._mark(tel, sched, clock, cursor, "preempt")

            # gather -> compose -> decode -> scatter dirty pages
            gathered = [self._gather(st) for st in active]
            sched.flush()
            if tel is not None:
                cursor = self._mark(tel, sched, clock, cursor, "gather")
            cache = self._compose_cache(active, gathered)
            toks = torch.tensor([[st.generated[-1]] for st in active],
                                dtype=torch.int32, device=self.device)
            logits, cache = lm.decode_step(self.cfg, self.params, toks, cache,
                                           mesh=self.mesh,
                                           max_len=self.max_len)
            gfuts = [f for g in gathered for fl in g.values() for f in fl]
            cost = 2.0 * self._n_params * len(active) / HW_FLOPS
            cfut = sched.submit_compute(lambda *a: None, *gfuts, cost_s=cost,
                                        label="compute:decode")
            if tel is not None:
                sched.flush()              # decode cost lands before the mark
                cursor = self._mark(tel, sched, clock, cursor, "decode")
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            kept = self._kept(logits)
            for i, (st, c1) in enumerate(
                    zip(active, self._split_cache(cache, len(active)))):
                written = st.pos                   # decode wrote this slot
                st.pos = min(st.pos + 1, self.max_len)
                if not st.done_tokens:
                    st.generated.append(int(nxt[i]))
                    if kept is not None:
                        st.logits.append(kept[i])
                self._scatter(st, c1, deps=(cfut,), dirty_from=written,
                              label="decode")
            sched.flush()
            self._commit(sched)
            if tel is not None:
                cursor = self._mark(tel, sched, clock, cursor, "scatter")
            if self.auto_defrag and self.pool.fragmentation():
                self.pool.defrag()
                sched.flush()
                self._commit(sched)
                if tel is not None:
                    cursor = self._mark(tel, sched, clock, cursor, "defrag")

            clock += sched.makespan()
            self.steps += 1

            # stamp every token generated this step at the post-step clock
            for st in states.values():
                while len(st.token_times) < len(st.generated):
                    st.token_times.append(clock)
                    if tel is not None:
                        if len(st.token_times) == 1:
                            tel.record_value(
                                "ttft_s", clock - st.req.arrival_s)
                        else:
                            tel.record_value(
                                "tbt_s", clock - st.token_times[-2])

            # completions: continuous frees a request the step it drains;
            # a static gang keeps its finished rows resident (finish time
            # still stamped at their own last token) until everyone drains
            holds = self._gang_holds(active)
            for st in [s for s in active if s.done_tokens]:
                if holds:
                    if st.finish_s < 0:
                        st.finish_s = clock
                else:
                    self._finish(st, active, clock)

        return self._report(states, clock)

    def _kept(self, logits):
        """The last position's logits on the host in f32, where kept."""
        return (logits[:, -1].float().cpu() if self.keep_logits else None)

    def _gang_member(self, st: _ReqState) -> bool:
        return False                               # continuous: no gangs

    def _gang_holds(self, active) -> bool:
        return False                               # continuous: no gangs

    def _finish(self, st: _ReqState, active: List[_ReqState],
                clock: float) -> None:
        active.remove(st)
        st.status = "done"
        if st.finish_s < 0:
            st.finish_s = clock
        for plist in st.pages.values():
            for pid in plist:
                self.pool.free(pid)
        st.pages.clear()

    def _report(self, states, clock) -> ServeReport:
        done = [st for st in states.values() if st.status == "done"]
        lats = np.asarray([st.finish_s - st.req.arrival_s for st in done]) \
            if done else np.asarray([0.0])
        total = sum(len(st.generated) for st in done)
        ttfts = np.asarray([st.token_times[0] - st.req.arrival_s
                            for st in done if st.token_times]) \
            if done else np.asarray([])
        tbts = np.asarray([b - a for st in done
                           for a, b in zip(st.token_times, st.token_times[1:])])
        if ttfts.size == 0:
            ttfts = np.asarray([0.0])
        if tbts.size == 0:
            tbts = np.asarray([0.0])
        return ServeReport(
            engine=self.name, n_requests=len(done), total_tokens=total,
            elapsed_s=clock, tokens_per_s=total / clock if clock else 0.0,
            p50_s=float(np.percentile(lats, 50)),
            p99_s=float(np.percentile(lats, 99)),
            steps=self.steps, preemptions=self.preemptions,
            pool_stats=dict(self.pool.stats),
            tokens={st.req.rid: np.asarray(st.generated, np.int32)
                    for st in done},
            ttft_p50_s=float(np.percentile(ttfts, 50)),
            ttft_p99_s=float(np.percentile(ttfts, 99)),
            tbt_p50_s=float(np.percentile(tbts, 50)),
            tbt_p99_s=float(np.percentile(tbts, 99)),
            logits=({st.req.rid: torch.stack(st.logits).numpy()
                     for st in done} if self.keep_logits else None))


class StaticBatchEngine(ContinuousBatchingEngine):
    """The fixed-gang baseline: admission only when the engine is empty, and
    the gang holds its batch rows (decode compute + full page traffic) until
    every member drains — the serving shape ``ServingEngine.generate``
    implements, extended with arrivals and queueing."""

    name = "static"

    def _admit(self, active, preempted, queue, clock):
        if active:                                 # gang still draining
            return [], []
        return super()._admit(active, preempted, queue, clock)

    def _gang_member(self, st: _ReqState) -> bool:
        return True                                # finished rows keep going

    def _gang_holds(self, active) -> bool:
        return not all(st.done_tokens for st in active)
