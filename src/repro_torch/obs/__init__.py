"""repro_torch.obs — unified, dependency-free observability for the serving
stack.

One :class:`ObsBus` per engine carries three planes over one injectable
clock:

* **Metrics** — :class:`MetricsRegistry` of counters, gauges, and
  fixed-bucket histograms (label support, Prometheus-text + JSON
  renderers). ``EngineStats`` is a *view* over this registry, so the
  stats the batch path prints and the ``/metrics`` scrape are one
  source of truth.
* **Tracing** — :class:`Tracer`/:class:`Span` events covering the
  request lifecycle (submit → admit/queue-wait → prefill → decode step
  → guard verify/correct → rail heal → finish), NDJSON-dumpable.
* **Flight recording** — :class:`FlightRecorder` ring buffer of the
  last N events, dumped on chaos failure or ``GuardError``.

Registry reads never touch torch and never block the pump thread: the
frontend scrapes from the asyncio thread while decode runs.
"""

from .bus import ObsBus
from .metrics import (Counter, DEFAULT_LATENCY_BUCKETS, Gauge, Histogram,
                      MetricsRegistry)
from .recorder import FlightRecorder
from .serialize import to_plain
from .trace import Span, Tracer

__all__ = [
    "Counter",
    "DEFAULT_LATENCY_BUCKETS",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ObsBus",
    "Span",
    "Tracer",
    "to_plain",
]
