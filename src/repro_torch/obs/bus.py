"""ObsBus: the facade that ties registry + tracer + flight recorder to
one clock, and the single object threaded through the serving stack.

Each :class:`~repro_torch.serve.engine.ServeEngine` owns exactly one bus
(never a process-global singleton): determinism demands that two
identical virtual-time runs see identical metric state, which a shared
registry would break. The bus shares the engine's injectable clock, so
latency histograms replay bit-identically under the load harness.

``enabled=False`` turns off the *optional* instrumentation — tracer
events and flight recording — while keeping the registry live, because
``EngineStats`` is a view over the registry and must keep working. That
split is exactly what ``BENCH_obs.json`` measures: the marginal cost of
tracing on top of the always-on counters.
"""

from __future__ import annotations

import json
import time
from typing import IO, Optional

from .metrics import MetricsRegistry
from .recorder import FlightRecorder
from .trace import Tracer

__all__ = ["ObsBus"]


class ObsBus:
    def __init__(self, clock=time.monotonic, *, enabled: bool = True,
                 recorder_capacity: int = 256) -> None:
        self.clock = clock
        self.enabled = enabled
        self.registry = MetricsRegistry(clock=clock)
        self.recorder = FlightRecorder(capacity=recorder_capacity)
        self.tracer = Tracer(clock=clock, sinks=[self.recorder.record],
                             enabled=enabled)
        self._trace_file: Optional[IO[str]] = None

    # -- convenience passthroughs used by instrumentation sites --------
    def event(self, name: str, **attrs) -> None:
        self.tracer.event(name, **attrs)

    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs)

    def render_prometheus(self) -> str:
        return self.registry.render_prometheus()

    def render_json(self):
        return self.registry.render_json()

    # -- NDJSON trace file sink (launch.serve --trace-out) -------------
    def attach_trace_file(self, path) -> None:
        """Stream every trace event to ``path`` as NDJSON."""
        if self._trace_file is not None:
            raise RuntimeError("trace file already attached")
        fh = open(path, "w")
        self._trace_file = fh

        def _write(event) -> None:
            fh.write(json.dumps(event, default=str) + "\n")

        self._trace_sink = _write
        self.tracer.add_sink(_write)

    def close_trace(self) -> None:
        if self._trace_file is None:
            return
        self.tracer.remove_sink(self._trace_sink)
        self._trace_file.close()
        self._trace_file = None
