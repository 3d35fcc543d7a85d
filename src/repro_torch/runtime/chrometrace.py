"""Chrome trace-event JSON export: any replay or telemetry session as a
Perfetto-loadable timeline (DESIGN.md §11).

The port's copy of ``repro.runtime.chrometrace``, over the port's telemetry.

The paper's figures are *timelines* — which link was busy when, what stalled
where — and the repo already has exact simulated timelines
(:class:`~repro_torch.runtime.simulator.SimReport` spans) plus the telemetry
plane's session spans.  This module serializes both into the Chrome
trace-event format (the ``traceEvents`` JSON Perfetto/``chrome://tracing``
load natively):

* :func:`sim_report_events` — one timeline row (``tid``) per resource, links
  first; one complete (``"ph": "X"``) event per task span, with the task id,
  contention stall, and label in ``args``; plus a ``"ph": "C"`` counter
  track per resource sampling *queue occupancy* (tasks still queued on that
  resource) at every span boundary.
* :func:`trace_events` — a captured :class:`~repro_torch.runtime.trace
  .TransferTrace` replayed on a topology and exported; each event's ``cat``
  is the chokepoint that recorded it (``transfer`` / ``queue`` /
  ``scheduler`` / ``compute``), so all three movement chokepoints are
  visible as categories.
* :func:`telemetry_events` — a :class:`~repro_torch.runtime.telemetry.Telemetry`
  session's spans (engine step phases on the simulated clock, chokepoint
  spans on the host clock), one row per track.
* :func:`export` / :func:`to_json` — wrap events as
  ``{"traceEvents": [...]}`` and write/return the JSON.
* :func:`validate_events` — the schema gate tests and CI run on every
  exported file.

Timestamps are microseconds (the trace-event contract).  Simulated-clock
sources (sim replays, engine phases) share one timebase, so a serving
replay and its engine-phase spans line up in Perfetto.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence

from .simulator import SimReport
from .telemetry import Telemetry

__all__ = ["sim_report_events", "trace_events", "telemetry_events",
           "to_json", "export", "validate_events"]

_US = 1e6                           # seconds -> trace-event microseconds


def _meta(pid: int, tid: int, what: str, name: str) -> Dict[str, Any]:
    return {"name": what, "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name}}


def sim_report_events(report: SimReport, *, pid: int = 1,
                      process_name: str = "xdma-sim",
                      trace: Any = None) -> List[Dict[str, Any]]:
    """A :class:`SimReport` as trace events: one row per resource (links in
    topology order, then compute engines), one ``X`` event per span, and an
    occupancy counter track per resource.

    ``trace`` (the :class:`~repro_torch.runtime.trace.TransferTrace` the report
    replayed, if any) enriches each event: ``cat`` becomes the recording
    chokepoint and ``args`` carry the endpoint kind and byte counts.
    """
    by_event = {}
    if trace is not None:
        by_event = {e.id: e for e in trace.events}

    # rows: links first (topology order), then compute engines as seen
    resources: List[str] = list(report.link_busy.keys())
    for s in report.spans:
        if s.resource not in resources:
            resources.append(s.resource)
    tid_of = {res: i for i, res in enumerate(resources)}

    events: List[Dict[str, Any]] = [_meta(pid, 0, "process_name",
                                          process_name)]
    for res, tid in tid_of.items():
        kind = "link" if res in report.link_busy else "compute"
        events.append(_meta(pid, tid, "thread_name", f"{kind}:{res}"))

    # per-resource span lists in time order (simulate() sorts by start)
    per_res: Dict[str, List] = {res: [] for res in resources}
    for s in report.spans:
        per_res[s.resource].append(s)

    for res, spans in per_res.items():
        tid = tid_of[res]
        n = len(spans)
        for i, s in enumerate(spans):
            ev = by_event.get(s.task_id)
            cat = (ev.source if ev is not None
                   else ("link" if res in report.link_busy else "compute"))
            args: Dict[str, Any] = {"task_id": s.task_id,
                                    "stall_us": s.stall * _US}
            if ev is not None:
                args["endpoint"] = ev.endpoint
                if ev.nbytes is not None:
                    args["nbytes"] = int(ev.nbytes)
                if ev.wire_nbytes is not None:
                    args["wire_nbytes"] = int(ev.wire_nbytes)
                if getattr(ev, "multicast_group", None) is not None:
                    # the tree fan-out, visible per resource row in Perfetto:
                    # fork marks hops serving >= 2 destinations
                    args["multicast_group"] = int(ev.multicast_group)
                    if ev.multicast_hop is not None:
                        args["hop"] = "->".join(ev.multicast_hop)
                    args["serves"] = int(ev.multicast_serves)
                    if ev.multicast_serves >= 2:
                        args["fork"] = True
            events.append({"name": s.label or f"task{s.task_id}",
                           "cat": cat, "ph": "X",
                           "ts": s.start * _US, "dur": s.duration * _US,
                           "pid": pid, "tid": tid, "args": args})
            # queue occupancy: tasks still queued on this resource — n - i
            # while span i runs, one fewer once it retires
            for ts, val in ((s.start, n - i), (s.end, n - i - 1)):
                events.append({"name": f"occupancy:{res}", "ph": "C",
                               "ts": ts * _US, "pid": pid, "tid": tid,
                               "args": {"queued": val}})
    return events


def trace_events(trace: Any, topology: Any, *, sw_agu: bool = False,
                 pid: int = 1) -> List[Dict[str, Any]]:
    """Replay a captured :class:`~repro_torch.runtime.trace.TransferTrace` on
    ``topology`` and export the simulated timeline.  Event categories are
    the recording chokepoints (``transfer``/``queue``/``scheduler``/
    ``compute``)."""
    report = trace.replay(topology, sw_agu=sw_agu)
    return sim_report_events(report, pid=pid,
                             process_name=f"xdma-sim:{trace.name}",
                             trace=trace)


def telemetry_events(tel: Telemetry, *, pid: int = 2) -> List[Dict[str, Any]]:
    """A telemetry session's spans as trace events, one row per track."""
    tracks: List[str] = []
    for s in tel.spans:
        if s.track not in tracks:
            tracks.append(s.track)
    tid_of = {t: i for i, t in enumerate(tracks)}
    events: List[Dict[str, Any]] = [_meta(pid, 0, "process_name",
                                          f"telemetry:{tel.name}")]
    for t, tid in tid_of.items():
        events.append(_meta(pid, tid, "thread_name", f"track:{t}"))
    for s in tel.spans:
        events.append({"name": s.name, "cat": s.track, "ph": "X",
                       "ts": s.start_s * _US, "dur": s.duration_s * _US,
                       "pid": pid, "tid": tid_of[s.track],
                       "args": dict(s.args)})
    return events


def to_json(events: Sequence[Dict[str, Any]], *, indent: int = None) -> str:
    """Events wrapped as the trace-event file format."""
    validate_events(events)
    return json.dumps({"traceEvents": list(events),
                       "displayTimeUnit": "ms"}, indent=indent)


def export(events: Sequence[Dict[str, Any]], path: str) -> str:
    """Write ``events`` as a ``.trace.json`` file (open it in Perfetto or
    ``chrome://tracing``); returns ``path``."""
    with open(path, "w") as f:
        f.write(to_json(events))
    return path


_PH_REQUIRED = {
    "X": ("name", "ph", "ts", "dur", "pid", "tid"),
    "C": ("name", "ph", "ts", "pid", "tid", "args"),
    "M": ("name", "ph", "pid", "tid", "args"),
}


def validate_events(events: Iterable[Dict[str, Any]]) -> int:
    """Check every event against the trace-event schema (the phases this
    exporter emits); returns the event count, raises ``ValueError`` on the
    first malformed event."""
    n = 0
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object: {ev!r}")
        ph = ev.get("ph")
        if ph not in _PH_REQUIRED:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        for key in _PH_REQUIRED[ph]:
            if key not in ev:
                raise ValueError(f"event {i} (ph={ph}): missing {key!r}")
        if ph in ("X", "C"):
            if not isinstance(ev["ts"], (int, float)):
                raise ValueError(f"event {i}: ts must be a number")
            if ph == "X" and (not isinstance(ev["dur"], (int, float))
                              or ev["dur"] < 0):
                raise ValueError(f"event {i}: dur must be a number >= 0")
        n += 1
    return n
