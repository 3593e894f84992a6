"""repro_torch.obs — the observability layer of the serving runtime
(port of ``repro.obs``):

  Counter, Gauge, Histogram, MetricsRegistry,
  counter_property, gauge_property        (metrics) typed metrics registry
  FlightRecorder, NULL_SPAN, TICK_PHASES,
  EVENT_NAMES                             (trace)   per-tick span tracing
  collect_status, STATUS_SCHEMA           (status)  the STATUS frame's
                                                    introspection snapshot

``python -m repro_torch.obs.dump trace.json`` summarizes a flight dump.

Every module is host-side Python; the names load lazily, as in the
reference.
"""

from __future__ import annotations

_LAZY = {
    "Counter": "repro_torch.obs.metrics",
    "Gauge": "repro_torch.obs.metrics",
    "Histogram": "repro_torch.obs.metrics",
    "MetricsRegistry": "repro_torch.obs.metrics",
    "counter_property": "repro_torch.obs.metrics",
    "gauge_property": "repro_torch.obs.metrics",
    "FlightRecorder": "repro_torch.obs.trace",
    "NULL_SPAN": "repro_torch.obs.trace",
    "TICK_PHASES": "repro_torch.obs.trace",
    "EVENT_NAMES": "repro_torch.obs.trace",
    "collect_status": "repro_torch.obs.status",
    "STATUS_SCHEMA": "repro_torch.obs.status",
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
