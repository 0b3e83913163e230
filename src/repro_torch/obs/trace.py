"""Structured tracing: point events and timed spans over an injectable
clock, fanned out to sink callables.

The trace stream is a flat sequence of dict events — NDJSON-friendly,
one object per line when dumped:

* point event: ``{"kind": "event", "name": str, "t": float, ...attrs}``
* span:        ``{"kind": "span", "name": str, "t": float,
  "dur_s": float, ...attrs}`` (``t`` is the span start; the event is
  emitted at span end so the stream stays time-ordered by emission)

Sinks are plain callables ``sink(event: dict)`` — a
:class:`~repro_torch.obs.recorder.FlightRecorder`'s ``record`` method, a file
writer, or a test list's ``append``. Emission is cheap when disabled:
``Tracer(enabled=False)`` short-circuits before building the event
dict, which is what the instrumentation-overhead benchmark toggles.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

__all__ = ["Span", "Tracer"]

Sink = Callable[[Dict], None]


class Span:
    """A timed section. Use via ``with tracer.span("prefill", uid=...)``;
    extra attributes can be attached mid-flight with :meth:`set`."""

    __slots__ = ("name", "t0", "attrs", "_tracer", "_done")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict) -> None:
        self._tracer = tracer
        self.name = name
        self.t0 = tracer.clock()
        self.attrs = attrs
        self._done = False

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        t1 = self._tracer.clock()
        self._tracer._emit({"kind": "span", "name": self.name,
                            "t": self.t0, "dur_s": t1 - self.t0,
                            **self.attrs})

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()


class _NullSpan:
    """Returned by a disabled tracer so ``with tracer.span(...)`` costs
    one attribute lookup and nothing else."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    def __init__(self, clock=time.monotonic,
                 sinks: Optional[List[Sink]] = None,
                 enabled: bool = True) -> None:
        self.clock = clock
        self.sinks: List[Sink] = list(sinks or [])
        self.enabled = enabled

    def add_sink(self, sink: Sink) -> None:
        self.sinks.append(sink)

    def remove_sink(self, sink: Sink) -> None:
        if sink in self.sinks:
            self.sinks.remove(sink)

    def event(self, name: str, **attrs) -> None:
        if not self.enabled:
            return
        self._emit({"kind": "event", "name": name, "t": self.clock(),
                    **attrs})

    def span(self, name: str, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, attrs)

    def _emit(self, event: Dict) -> None:
        for sink in self.sinks:
            sink(event)
