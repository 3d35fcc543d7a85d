"""repro_torch.runtime — the port's distributed XDMA runtime.

The twin of ``repro.runtime``, mirroring the paper's distributed
Controller:

* :mod:`~repro_torch.runtime.topology` — the link fabric (nodes = device
  memories, edges = links with a bandwidth / latency / width cost model);
* :mod:`~repro_torch.runtime.scheduler` + :mod:`~repro_torch.runtime.ring`
  — async dispatch through fixed-depth per-(link, tenant) descriptor rings,
  futures, batched rounds and a completion queue;
* :mod:`~repro_torch.runtime.simulator` — deterministic event-driven replay
  of a schedule against a topology;
* :mod:`~repro_torch.runtime.trace` — ``capture()`` / ``replay()`` of the
  application movement ledger;
* :mod:`~repro_torch.runtime.telemetry` + :mod:`~repro_torch.runtime
  .chrometrace` — counter banks, spans, one snapshot, and Chrome
  trace-event export.

This ``__init__`` resolves its exports lazily (PEP 562): ``core.api``
imports the leaf :mod:`~repro_torch.runtime.telemetry` through the package
without pulling in the scheduler and trace stack, which import ``core``.
"""
import importlib

# public name -> submodule that defines it
_EXPORTS = {
    "Link": "topology", "Topology": "topology",
    "MulticastHop": "topology", "MulticastTree": "topology",
    "SimReport": "simulator", "SimTask": "simulator", "Span": "simulator",
    "queue_sim_tasks": "simulator", "serialize": "simulator",
    "simulate": "simulator",
    "multicast_sim_tasks": "simulator", "unicast_sim_tasks": "simulator",
    "DistributedScheduler": "scheduler", "XDMAFuture": "scheduler",
    "MulticastFuture": "scheduler",
    "DescriptorRing": "ring", "WouldBlock": "ring", "Completion": "ring",
    "TraceEvent": "trace", "TransferTrace": "trace", "capture": "trace",
    "replay": "trace",
    "CounterBank": "telemetry", "Telemetry": "telemetry",
}
_SUBMODULES = ("topology", "ring", "simulator", "scheduler", "trace",
               "telemetry", "chrometrace")

__all__ = sorted(_EXPORTS) + list(_SUBMODULES)


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        value = getattr(module, name)
        globals()[name] = value          # cache: next access skips __getattr__
        return value
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(__all__) | set(globals()))
