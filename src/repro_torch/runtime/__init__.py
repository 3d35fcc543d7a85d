"""repro_torch.runtime — the port's runtime; so far only the telemetry plane."""
from . import telemetry  # noqa: F401

__all__ = ["telemetry"]
