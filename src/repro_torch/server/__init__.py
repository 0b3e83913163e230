"""Production serving frontend over the continuous-batching engine.

- ``frontend``: stdlib-asyncio HTTP layer — admission queue into
  ``ServeEngine``, per-token NDJSON streaming, SLO/priority admission,
  bounded-queue load shedding (503s), graceful drain.
- ``traffic``: seeded traffic-trace generator (Poisson arrivals,
  heavy-tailed lognormal lengths, diurnal burst envelopes) with replayable
  NDJSON trace files.
- ``harness``: deterministic virtual-time trace replay producing the
  p50/p99 TTFT / tokens-per-s / shed-rate envelope.
- ``client``: minimal streaming HTTP client for tests and examples.

Counterpart of ``repro.server``, with the same names.  Only the frontend's
pump thread touches the engine's device (see ``frontend``).
"""
from .client import GenerateResult, RetryPolicy, get_json, stream_generate
from .frontend import ServeFrontend
from .harness import (LoadHarness, TrafficMetrics, VirtualClock,
                      overload_rate_rps)
from .traffic import (TraceEvent, TrafficConfig, TrafficGenerator,
                      load_trace, save_trace)

__all__ = [
    "GenerateResult", "LoadHarness", "RetryPolicy", "ServeFrontend",
    "TraceEvent",
    "TrafficConfig", "TrafficGenerator", "TrafficMetrics", "VirtualClock",
    "get_json", "load_trace", "overload_rate_rps", "save_trace",
    "stream_generate",
]
