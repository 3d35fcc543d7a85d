"""The port's telemetry plane: CSR-style counter banks, spans, one snapshot.

A copy of ``repro.runtime.telemetry`` (standard library only), kept in the
port so that its banks are separate from the reference's: a process that
runs both packages (the parity tests) counts each side on its own.

* :class:`CounterBank` — one bank of named monotonic counters per domain.
  The port's stats surfaces are views over these banks:
  ``repro_torch.core.api.cache_stats()`` (bank ``cfg_cache``),
  ``repro_torch.kernels.agu.agu_stats()`` (bank ``agu``) and
  ``repro_torch.core.plugin_compiler.cfg_stats()`` (bank
  ``plugin_compiler``), ``repro_torch.core.autotune.autotune_stats()``
  (bank ``autotune``); the scheduler counts into ``links``, ``queues``,
  ``rings`` and ``multicast``.
* :class:`Telemetry` — a session: host-clock spans and value histograms.
  :func:`session` installs one; ``xdma.transfer``, ``XDMAQueue`` and
  ``DistributedScheduler`` guard their span hooks on a single ``is None``
  check.
* :func:`snapshot` — every counter bank, every span, every histogram, plus
  the stats surfaces, in one JSON-ready dict.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

__all__ = ["CounterBank", "SpanEvent", "Telemetry", "bank", "banks",
           "register", "reset", "session", "active", "span", "record_value",
           "snapshot"]


# ---------------------------------------------------------------------------
# counter banks (always on — the CSR file)
# ---------------------------------------------------------------------------
class CounterBank:
    """One domain's named counters: monotonic counts plus high-water marks.

    Counter names are flat strings; structured counters use a ``:`` suffix
    convention (``bytes:<link>``, ``reason:<why>``) that
    :meth:`with_prefix` can strip back into a sub-dict.
    """

    __slots__ = ("domain", "_c")

    def __init__(self, domain: str):
        self.domain = domain
        self._c: Dict[str, int] = {}

    def inc(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` (creating it at 0)."""
        self._c[name] = self._c.get(name, 0) + n

    def record_max(self, name: str, value: int) -> None:
        """High-water mark: keep the maximum ever seen for ``name``."""
        if value > self._c.get(name, 0):
            self._c[name] = value

    def set(self, name: str, value: int) -> None:
        self._c[name] = value

    def get(self, name: str, default: int = 0) -> int:
        return self._c.get(name, default)

    def __getitem__(self, name: str) -> int:
        return self._c.get(name, 0)

    def __contains__(self, name: str) -> bool:
        return name in self._c

    def __len__(self) -> int:
        return len(self._c)

    def as_dict(self) -> Dict[str, int]:
        """All counters, name-sorted (a stable JSON-ready view)."""
        return {k: self._c[k] for k in sorted(self._c)}

    def with_prefix(self, prefix: str) -> Dict[str, int]:
        """Counters named ``<prefix><rest>`` as ``{rest: value}``."""
        n = len(prefix)
        return {k[n:]: v for k, v in sorted(self._c.items())
                if k.startswith(prefix)}

    def clear(self) -> None:
        self._c.clear()

    def __repr__(self):
        return f"CounterBank({self.domain!r}, {len(self._c)} counters)"


_BANKS: Dict[str, CounterBank] = {}


def bank(domain: str) -> CounterBank:
    """Get (or create and register) the counter bank for ``domain``."""
    b = _BANKS.get(domain)
    if b is None:
        b = _BANKS[domain] = CounterBank(domain)
    return b


def register(b: CounterBank) -> CounterBank:
    """Register (or replace) a caller-owned bank under its domain: the
    owner keeps its own bank object while the registry always exposes the
    most recent instance."""
    _BANKS[b.domain] = b
    return b


def banks() -> Dict[str, CounterBank]:
    """Every registered bank, by domain (live objects, not copies)."""
    return dict(_BANKS)


def reset(domain: Optional[str] = None) -> None:
    """Zero one domain's counters, or every registered bank's."""
    if domain is not None:
        if domain in _BANKS:
            _BANKS[domain].clear()
        return
    for b in _BANKS.values():
        b.clear()


# ---------------------------------------------------------------------------
# spans + histograms (session-scoped — zero-cost when no session is open)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SpanEvent:
    """One timed region.  ``track`` groups spans into timeline rows
    (``transfer`` / ``queue`` for the chokepoints); ``depth``/``parent``
    encode the nesting observed at record time (host-clock spans nest by the
    Python ``with`` stack)."""

    name: str
    track: str
    start_s: float
    end_s: float
    depth: int = 0
    parent: int = -1                # index into Telemetry.spans, -1 = root
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return self.end_s - self.start_s

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "track": self.track,
                "start_s": self.start_s, "end_s": self.end_s,
                "depth": self.depth, "parent": self.parent,
                "args": dict(self.args)}


class Telemetry:
    """One telemetry session: spans and value histograms.

    ``clock`` supplies host-side span timestamps (default
    ``time.perf_counter``); simulated-clock spans bypass it through
    :meth:`add_span` with explicit times.
    """

    def __init__(self, name: str = "telemetry",
                 clock: Callable[[], float] = time.perf_counter):
        self.name = name
        self.clock = clock
        self.spans: List[SpanEvent] = []
        self.values: Dict[str, List[float]] = {}
        self._stack: List[int] = []     # indices of open host-clock spans

    # -- spans ---------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, track: str = "host", **args: Any
             ) -> Iterator[SpanEvent]:
        """Time a region on the host clock.  Nesting follows the ``with``
        stack: the yielded span's ``depth``/``parent`` point at the
        enclosing open span."""
        ev = SpanEvent(name=name, track=track, start_s=self.clock(),
                       end_s=0.0, depth=len(self._stack),
                       parent=self._stack[-1] if self._stack else -1,
                       args=dict(args))
        idx = len(self.spans)
        self.spans.append(ev)
        self._stack.append(idx)
        try:
            yield ev
        finally:
            self._stack.pop()
            ev.end_s = self.clock()

    def add_span(self, name: str, start_s: float, end_s: float, *,
                 track: str = "sim", **args: Any) -> SpanEvent:
        """Record a span with explicit timestamps (a simulated clock)."""
        ev = SpanEvent(name=name, track=track, start_s=float(start_s),
                       end_s=float(end_s), args=dict(args))
        self.spans.append(ev)
        return ev

    def spans_on(self, track: str) -> List[SpanEvent]:
        return [s for s in self.spans if s.track == track]

    # -- histograms ----------------------------------------------------------
    def record_value(self, name: str, value: float) -> None:
        """Append one sample to histogram ``name`` (TTFT/TBT seconds...)."""
        self.values.setdefault(name, []).append(float(value))

    def percentile(self, name: str, q: float) -> float:
        """Nearest-rank percentile of histogram ``name``: the smallest
        recorded sample with at least ``q``% of the samples at or below it
        (``ceil(n*q/100)``-th order statistic) — always an actual sample,
        never an interpolated value, so a 1-sample p99 is that sample and a
        2-sample p99 is the max.  0.0 when the histogram is empty."""
        vals = sorted(self.values.get(name, ()))
        if not vals:
            return 0.0
        k = max(1, math.ceil(len(vals) * float(q) / 100.0))
        return vals[min(k, len(vals)) - 1]

    def histogram_summary(self, name: str) -> Dict[str, float]:
        vals = self.values.get(name, ())
        if not vals:
            return {"count": 0}
        return {"count": len(vals), "mean": sum(vals) / len(vals),
                "min": min(vals), "max": max(vals),
                "p50": self.percentile(name, 50),
                "p99": self.percentile(name, 99)}

    def summary(self) -> str:
        return (f"Telemetry({self.name!r}, {len(self.spans)} spans, "
                f"{sum(len(v) for v in self.values.values())} samples, "
                f"{len(_BANKS)} counter banks)")


# -- the ambient session slot (one `is None` check when off) --
_ACTIVE: Optional[Telemetry] = None
_NULL = contextlib.nullcontext()


def active() -> Optional[Telemetry]:
    """The ambient telemetry session, or None when telemetry is off."""
    return _ACTIVE


@contextlib.contextmanager
def session(tel: Optional[Telemetry] = None, *, name: str = "telemetry",
            clock: Callable[[], float] = time.perf_counter
            ) -> Iterator[Telemetry]:
    """Open a telemetry session: the chokepoints' span hooks write into the
    yielded :class:`Telemetry`.  Nested sessions shadow the outer one
    (innermost wins)."""
    global _ACTIVE
    t = tel if tel is not None else Telemetry(name=name, clock=clock)
    prev = _ACTIVE
    _ACTIVE = t
    try:
        yield t
    finally:
        _ACTIVE = prev


def span(name: str, track: str = "host", **args: Any):
    """Module-level span hook: a real span inside an open session, a shared
    no-op context otherwise (one ``is None`` check, nothing allocated)."""
    a = _ACTIVE
    if a is None:
        return _NULL
    return a.span(name, track=track, **args)


def record_value(name: str, value: float) -> None:
    """Module-level histogram hook (no-op without an open session)."""
    a = _ACTIVE
    if a is not None:
        a.record_value(name, value)


# ---------------------------------------------------------------------------
# the one read port
# ---------------------------------------------------------------------------
def snapshot() -> Dict[str, Any]:
    """Everything the telemetry plane knows, as one JSON-ready dict — or
    ``{}`` when no session is open (telemetry disabled: nothing to read,
    nothing computed).

    ``counters`` holds every registered bank; ``surfaces`` re-exports the
    stats surfaces verbatim (views over the same banks) plus the scheduler's
    ``links`` / ``rings`` / ``multicast`` banks; ``spans``/``histograms``
    are the session's timing data.
    """
    a = _ACTIVE
    if a is None:
        return {}
    # lazy imports: the stats surfaces live in modules that import *us*
    from repro_torch.core import api as _api
    from repro_torch.core import autotune as _at
    from repro_torch.core import plugin_compiler as _pc
    from repro_torch.kernels import agu as _agu

    cs = _api.cache_stats()
    surfaces: Dict[str, Any] = {
        "cache_stats": {"hits": cs.hits, "misses": cs.misses,
                        "evictions": cs.evictions, "size": cs.size},
        "agu_stats": _agu.agu_stats(),
        "autotune_stats": _at.autotune_stats(),
        "cfg_stats": _pc.cfg_stats(),
        "scheduler_links": bank("links").as_dict(),
        "scheduler_rings": bank("rings").as_dict(),
        "multicast_stats": bank("multicast").as_dict(),
        "pool_stats": {d[len("pool:"):]: b.as_dict()
                       for d, b in _BANKS.items() if d.startswith("pool:")},
    }
    return {
        "session": a.name,
        "counters": {d: b.as_dict() for d, b in _BANKS.items()},
        "surfaces": surfaces,
        "spans": [s.as_dict() for s in a.spans],
        "histograms": {k: a.histogram_summary(k) for k in sorted(a.values)},
    }
