"""Virtual-time load harness: deterministic trace replay over ``ServeEngine``.

Real-socket serving (``repro_torch.server.frontend``) measures the wall
clock and is therefore noisy; the harness instead replays a traffic trace in
*virtual time*.  The engine is constructed with an injected
``VirtualClock``, every model call advances that clock by a fixed
``step_cost_s``, and arrivals are injected exactly when the virtual clock
crosses their trace timestamps.  Queueing delay, TTFT percentiles, deadline
misses, and shed rates then depend only on (trace seed, scheduler policy,
step cost) — bit-reproducible across machines and devices, so a replay on
the GPU can be held field by field against the same replay on the CPU.

The service capacity of the modelled deployment is ``slots / step_cost_s``
tokens/s; ``overload_rate_rps`` converts that into the arrival rate that
offers ``factor``x the sustainable token load, so "2x overload" means the
same thing for every engine configuration.

Counterpart of ``repro.server.harness``.  The engine emits no stop token, so
which request runs when never depends on the model's numbers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..serve import Priority, Request
from .traffic import TraceEvent, TrafficConfig


class VirtualClock:
    """A monotonically advancing fake clock (callable like
    ``time.monotonic``); the harness — or a test — owns its arrow of time."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance time backwards by {dt}")
        self.now += dt
        return self.now


def overload_rate_rps(factor: float, slots: int, step_cost_s: float,
                      cfg: TrafficConfig) -> float:
    """Arrival rate offering ``factor``x the deployment's token capacity.

    Capacity ~= slots tokens per decode call at full occupancy; each request
    demands ~(mean generated tokens + 1 prefill call) model-call equivalents.
    """
    capacity_tok_s = slots / step_cost_s
    per_request = cfg.mean_tokens_per_request() + 1.0
    return factor * capacity_tok_s / per_request


@dataclasses.dataclass
class TrafficMetrics:
    """Envelope measured by one trace replay (virtual-time unless noted)."""
    n_events: int = 0
    admitted: int = 0
    completed: int = 0
    truncated: int = 0
    shed: int = 0
    shed_by_reason: Dict[str, int] = dataclasses.field(default_factory=dict)
    shed_by_priority: Dict[str, int] = dataclasses.field(default_factory=dict)
    tokens_generated: int = 0
    elapsed_virtual_s: float = 0.0
    tokens_per_s: float = 0.0        # virtual-time serving throughput
    ttft_p50_s: Optional[float] = None
    ttft_p99_s: Optional[float] = None
    shed_rate: float = 0.0           # shed / submitted
    deadline_met_frac: Optional[float] = None   # over SLO-carrying, non-shed
    model_steps: int = 0
    wall_s: float = 0.0              # real wall time spent replaying

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class LoadHarness:
    """Replays a trace through an engine that reads the harness's clock.

    The engine MUST have been constructed with ``clock=`` the same
    ``VirtualClock`` instance, or latency telemetry will mix time bases.
    """

    #: default registry gauges captured by the sampling timeline — the
    #: load/energy/rail signals a railscale closed-loop run is judged on
    SAMPLE_GAUGES = ("serve_queue_depth", "serve_active_slots",
                     "serve_energy_per_token_joules", "railscale_level")

    def __init__(self, engine, clock: VirtualClock,
                 step_cost_s: float = 0.02,
                 wall_clock: Callable[[], float] = time.perf_counter,
                 sample_every_s: Optional[float] = None,
                 sample_gauges: Sequence[str] = SAMPLE_GAUGES):
        if getattr(engine, "_clock", None) is not clock:
            raise ValueError("engine was not built with this harness clock; "
                             "pass ServeEngine(..., clock=clock)")
        if step_cost_s <= 0:
            raise ValueError(f"step_cost_s must be > 0, got {step_cost_s}")
        if sample_every_s is not None and sample_every_s <= 0:
            raise ValueError(f"sample_every_s must be > 0, "
                             f"got {sample_every_s}")
        self.engine = engine
        self.clock = clock
        self.step_cost_s = step_cost_s
        # wall_s telemetry (replay cost, not a serving metric) reads this
        # injectable second clock so tests can pin it too
        self.wall_clock = wall_clock
        self.requests: List[Request] = []
        # opt-in virtual-time gauge timeline: every ``sample_every_s``
        # virtual seconds one row of registry gauge values is appended to
        # ``self.samples`` — the deterministic load/energy/level traces a
        # railscale run is judged on.  Default off (bit-identical replay).
        self.sample_every_s = sample_every_s
        self.sample_gauges = tuple(sample_gauges)
        self.samples: List[Dict[str, float]] = []
        self._next_sample_t = 0.0

    def replay(self, events: Sequence[TraceEvent],
               max_steps: int = 1_000_000) -> TrafficMetrics:
        wall0 = self.wall_clock()
        eng, clock = self.engine, self.clock
        events = sorted(events, key=lambda e: e.t_s)
        i, n = 0, len(events)
        steps = 0
        while (i < n or not eng.scheduler.drained()) and steps < max_steps:
            while i < n and events[i].t_s <= clock.now + 1e-12:
                req = events[i].to_request()
                self.requests.append(req)
                eng.submit(req)
                i += 1
            if eng.scheduler.drained():
                if i >= n:
                    break
                clock.now = events[i].t_s   # idle: jump to the next arrival
                continue
            used = eng.step()
            steps += max(used, 1)
            # every model call costs fixed virtual time; a zero-cost
            # iteration (nothing admissible ran) still advances one tick so
            # queued deadlines keep aging and the loop cannot spin
            clock.advance(max(used, 1) * self.step_cost_s)
            self._maybe_sample()
        return self._metrics(events, self.wall_clock() - wall0, steps)

    def _maybe_sample(self) -> None:
        if self.sample_every_s is None or self.clock.now < self._next_sample_t:
            return
        reg = self.engine.obs.registry
        row: Dict[str, float] = {"t_s": float(self.clock.now)}
        for name in self.sample_gauges:
            # get-or-create: a gauge the engine never published reads 0.0
            row[name] = float(reg.gauge(name).value())
        self.samples.append(row)
        # schedule strictly past ``now`` even when the clock idled/jumped
        missed = (self.clock.now - self._next_sample_t) // self.sample_every_s
        self._next_sample_t += (missed + 1) * self.sample_every_s

    def _metrics(self, events: Sequence[TraceEvent], wall_s: float,
                 steps: int) -> TrafficMetrics:
        stats = self.engine.stats
        reqs = self.requests
        shed = [r for r in reqs if r.shed]
        ttfts = np.asarray(sorted(stats.ttft_s), float)
        slo = [r for r in reqs if r.deadline_s is not None and not r.shed
               and r.done]
        met = [r for r in slo if r.deadline_met()]
        elapsed = max(self.clock.now, self.step_cost_s)
        m = TrafficMetrics(
            n_events=len(events),
            admitted=stats.admitted,
            completed=stats.completed,
            truncated=stats.truncated,
            shed=len(shed),
            shed_by_reason={
                reason: sum(1 for r in shed if r.shed_reason == reason)
                for reason in sorted({r.shed_reason for r in shed
                                      if r.shed_reason})},
            shed_by_priority={
                p.name: sum(1 for r in shed if r.priority is p)
                for p in Priority},
            tokens_generated=stats.tokens_generated,
            elapsed_virtual_s=elapsed,
            tokens_per_s=stats.tokens_generated / elapsed,
            ttft_p50_s=(float(np.percentile(ttfts, 50)) if ttfts.size
                        else None),
            ttft_p99_s=(float(np.percentile(ttfts, 99)) if ttfts.size
                        else None),
            shed_rate=len(shed) / max(len(reqs), 1),
            deadline_met_frac=(len(met) / len(slo) if slo else None),
            model_steps=stats.model_steps,
            wall_s=wall_s,
        )
        return m
