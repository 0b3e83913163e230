"""Overload a live streaming server with generated traffic — on the
voltage-scaled emulated array if asked.

Starts the ``repro_torch.server`` asyncio frontend over a smoke-scale engine
(priority scheduling, bounded admission queue), generates a seeded traffic
trace (Poisson arrivals, heavy-tailed lengths, burst envelope) at a chosen
overload factor, fires it over real sockets with per-token streaming, and
prints the measured envelope: completion/shed split by priority tier, TTFT
percentiles, and SLO attainment — then drains gracefully.

    PYTHONPATH=src python -m repro_torch.examples.traffic_overload \
        [--backend emulated] [--overload 2.0] [--rate-scale 10] [--device cpu]

Counterpart of ``examples/traffic_overload.py``.  ``--backend reference``
runs every model GEMM as one ``systolic_mac`` launch on a GPU;
``--backend emulated`` runs the CAD flow first and serves every GEMM on the
calibrated fault-injecting array, so the overload envelope includes the
emulated hardware's energy/flag telemetry.  :func:`run` takes any config
and parameter tree and returns what :func:`main` prints.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .._device import DeviceLike, resolve_device
from ..backend import EmulatedBackend, get_backend
from ..configs import get_config
from ..configs.base import ModelConfig
from ..flow import FlowConfig
from ..flow import run as flow_run
from ..models import model_api
from ..serve import Priority, ServeEngine
from ..server import (GenerateResult, ServeFrontend, TraceEvent,
                      TrafficConfig, TrafficGenerator, get_json,
                      overload_rate_rps, stream_generate)

BACKENDS = ("ideal", "reference", "simulated", "emulated")
MAX_LEN = 48
#: the model step the offered load is sized against (s)
STEP_COST_S = 0.05


@dataclasses.dataclass
class TrafficOverloadResult:
    """The trace, each event's streamed result, and the envelope the
    example prints: the per-tier split, TTFT percentiles (ms, None without
    a first token), the SLO tally, ``/healthz``, the drain and the
    backend's telemetry (None on ``ideal``)."""
    backend: str
    events: List[TraceEvent]
    results: List[Tuple[TraceEvent, GenerateResult]]
    health: Dict[str, Any]
    drained: bool
    wall_s: float
    by_tier: Dict[str, Dict[str, int]]
    ttfts: List[float]
    p50_ms: Optional[float]
    p99_ms: Optional[float]
    slo_met: int
    slo: int
    backend_telemetry: Optional[Dict[str, Any]]
    engine: ServeEngine


async def drive(engine: ServeEngine, events: List[TraceEvent],
                rate_scale: float):
    """Fire ``events`` at the frontend over sockets, trace-second
    ``t / rate_scale`` each; then ``/healthz``, drain and close."""
    frontend = ServeFrontend(engine)
    host, port = await frontend.start()
    t0 = time.perf_counter()

    async def fire(ev):
        await asyncio.sleep(ev.t_s / rate_scale)
        res = await stream_generate(
            host, port, ev.prompt, max_new_tokens=ev.max_new_tokens,
            priority=ev.priority.name.lower(), deadline_s=ev.deadline_s)
        return ev, res

    results = await asyncio.gather(*[fire(ev) for ev in events])
    health = await get_json(host, port, "/healthz")
    drained = await frontend.drain()
    await frontend.close()
    return list(results), health, drained, time.perf_counter() - t0


def run(cfg: ModelConfig, params: Any, backend: str = "ideal",
        overload: float = 2.0, duration: float = 2.0,
        rate_scale: float = 10.0, slots: int = 2, max_pending: int = 4,
        seed: int = 0, device: DeviceLike = None) -> TrafficOverloadResult:
    """The seeded trace at ``overload`` x the slots' capacity through a live
    frontend over the priority engine on ``backend`` (``emulated``: the CAD
    flow's calibrated 8 x 8 vtr-22nm array)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    dev = resolve_device(device)
    engine_kw = {}
    if backend == "emulated":
        fcfg = FlowConfig(array_n=8, tech="vtr-22nm", max_trials=8, seed=2021)
        engine_kw["backend"] = EmulatedBackend.from_flow(flow_run(fcfg), fcfg,
                                                         device=dev)
    elif backend != "ideal":
        engine_kw["backend"] = get_backend(backend, device=dev)
    engine = ServeEngine(cfg, params, slots=slots, max_len=MAX_LEN,
                         policy="priority", max_pending=max_pending,
                         device=dev, **engine_kw)

    tcfg = TrafficConfig(
        rate_rps=overload_rate_rps(overload, slots, STEP_COST_S,
                                   TrafficConfig()),
        duration_s=duration, seed=seed, diurnal_amplitude=0.6,
        diurnal_period_s=duration, max_prompt_len=8, max_gen_len=10,
        vocab_size=cfg.vocab_size)
    events = TrafficGenerator(tcfg).events()
    results, health, drained, wall = asyncio.run(
        drive(engine, events, rate_scale))

    by_tier = {p.name: {"completed": 0, "shed": 0} for p in Priority}
    ttfts, met, slo = [], 0, 0
    for ev, res in results:
        tier = by_tier[ev.priority.name]
        if res.status == "completed":
            tier["completed"] += 1
        elif res.status == "shed":
            tier["shed"] += 1
        if res.summary.get("ttft_s") is not None:
            ttfts.append(res.summary["ttft_s"])
        if ev.deadline_s is not None and res.status != "shed":
            slo += 1
            met += bool(res.summary.get("deadline_met"))
    ttfts.sort()
    pct = (lambda q: float(1e3 * np.percentile(ttfts, q))) if ttfts \
        else (lambda q: None)
    bt = engine.stats.backend_telemetry or (
        engine.backend.summary() if engine.backend is not None else None)
    return TrafficOverloadResult(
        backend=backend, events=events, results=results, health=health,
        drained=drained, wall_s=wall, by_tier=by_tier, ttfts=ttfts,
        p50_ms=pct(50), p99_ms=pct(99), slo_met=met, slo=slo,
        backend_telemetry=bt or None, engine=engine)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # phi4's smoke GEMM shapes stay tractable on the emulated backends;
    # any arch works on --backend ideal
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--backend", default="ideal", choices=BACKENDS)
    ap.add_argument("--overload", type=float, default=2.0,
                    help="offered load as a multiple of serving capacity")
    ap.add_argument("--duration", type=float, default=2.0,
                    help="trace horizon in trace-seconds")
    ap.add_argument("--rate-scale", type=float, default=10.0,
                    help="replay speed-up: trace-seconds / rate-scale = wall")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-pending", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    params = model_api(cfg, device=dev).init_params(args.seed)
    out = run(cfg, params, args.backend, args.overload, args.duration,
              args.rate_scale, args.slots, args.max_pending, args.seed,
              device=dev)
    print(f"offered load: {len(out.events)} requests over {args.duration}s "
          f"({args.overload}x capacity, backend={args.backend})")
    p50 = "n/a" if out.p50_ms is None else f"{out.p50_ms:.0f}ms"
    p99 = "n/a" if out.p99_ms is None else f"{out.p99_ms:.0f}ms"
    health = out.health
    print(f"per tier: {out.by_tier}")
    print(f"TTFT p50 {p50} / p99 {p99}; SLO met {out.slo_met}/{out.slo}; "
          f"shed_rate {health['shed_rate']:.2f}; "
          f"{health['tokens_generated']} tokens in {out.wall_s:.1f}s wall; "
          f"drained={out.drained}")
    bt = out.backend_telemetry
    if bt:
        e = bt.get("energy_per_token_j")
        print(f"[backend:{out.engine.stats.backend}] {bt['calls']} GEMMs, "
              f"{bt['flags']} flags, {bt['replays']} replays, "
              f"{'n/a' if e is None else f'{e:.3g}'} J/token")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
