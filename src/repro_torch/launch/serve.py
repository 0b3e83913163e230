"""Serving launcher: batched requests through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
        --backend reference --requests 6 --slots 4

Counterpart of ``repro.launch.serve`` with the same flags.  It runs on the
GPU; ``--device cpu`` is for machines without one (with ``--smoke``).

Flags:
    --device {cuda,cpu}          where the model lives (default: the GPU;
                                 without one the launcher stops)
    --engine {continuous,wave}   continuous (default) admits a request into
                                 any free slot mid-flight; wave is the legacy
                                 static batcher kept as a baseline
    --requests / --slots         workload size / decode slots
    --max-new                    max new tokens per request (randomized per
                                 request when --mixed is set)
    --max-len                    decode cache length
    --max-steps                  model-call budget for run_until_drained;
                                 exhaustion reports truncated/unserved counts
    --json-out PATH              dump full EngineStats telemetry as JSON
                                 (prefill/decode steps, TTFT, occupancy, ...)
    --backend {ideal,reference,simulated,emulated}
                                 execution backend for ALL model GEMMs
                                 (continuous engine only).  "reference" runs
                                 every one of them through the hand-written
                                 systolic_mac kernel at nominal rails;
                                 "emulated" on the CAD flow's calibrated
                                 voltage islands (Razor flags, replays,
                                 silent corruption, an energy ledger);
                                 "simulated" on the cycle-level simulator
    --hwloop                     attach the Algorithm-2 loop: a watchdog that
                                 re-runs the flow's runtime calibration when
                                 flags persist (over the emulated backend's
                                 real GEMM flags; probe traffic otherwise)
    --hwloop-tech / --hwloop-array-n
                                 the CAD flow's tech node and array size
    --guard {off,freivalds,abft} wrap the execution backend in the ABFT
                                 GuardedBackend (repro_torch.resilience):
                                 checksum verification (on a GPU by the
                                 abft_checksums kernel), locate-and-correct,
                                 and the retry -> rail-heal -> policy
                                 escalation ladder on silent corruption
    --guard-policy {fail_open,fail_closed}
                                 what an unverifiable product does: return
                                 with telemetry (open) or raise (closed)
    --autoscale {static,threshold,pid}
                                 closed-loop energy-aware rail policy
                                 (repro_torch.railscale).  "static" is the
                                 fixed-rail path; the live policies need
                                 --backend emulated and attach a hwloop
                                 session, undervolt toward the calibrated
                                 floor when load is low, and boost toward
                                 nominal under queue / flag / TTFT pressure
    --autoscale-points FILE      load the operating-point ladder from a
                                 ``flow --points-out`` JSON file instead of
                                 characterizing it at startup (on the run's
                                 device)
    --slo-ttft S                 TTFT SLO (seconds) feeding the policy's
                                 headroom signal
    --autoscale-every N          decode steps per autoscaler decision
    --policy {fifo,priority}     scheduler admission policy; priority enables
                                 tiers + TTFT-deadline shedding
    --max-pending N              bounded admission queue (backpressure: a
                                 full queue sheds instead of buffering)
    --metrics PATH               write a Prometheus-text snapshot of the
                                 engine's obs registry at exit
    --trace-out PATH             stream every obs trace event (request
                                 lifecycle, decode steps) to PATH as NDJSON
    --serve-http HOST:PORT       serve the streaming HTTP frontend
                                 (repro_torch.server: POST /v1/generate,
                                 GET /healthz /metrics /v1/stats) until
                                 SIGINT, then drain; port 0 binds a free
                                 port, and the bound address is printed
    --trace FILE                 replay a traffic trace (``python -m
                                 repro_torch.server --out FILE``) in virtual
                                 time and print its TTFT / tokens-per-s /
                                 shed envelope (--json-out writes it)
    --step-cost S                virtual seconds per model call under --trace
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from ..backend import EmulatedBackend, get_backend
from ..configs import ARCHS, get_config
from ..models import model_api
from ..serve import Request, ServeEngine, WaveServeEngine

def _attach_obs_outputs(engine, args) -> None:
    if args.trace_out:
        engine.obs.attach_trace_file(args.trace_out)


def _finish_obs_outputs(engine, args) -> None:
    if args.metrics:
        with open(args.metrics, "w") as f:
            f.write(engine.obs.registry.render_prometheus())
        print(f"wrote {args.metrics}")
    if args.trace_out:
        engine.obs.close_trace()
        print(f"wrote {args.trace_out}")


def make_requests(cfg, n: int, max_new: int, mixed: bool, seed: int):
    """The launcher's random workload: prompts of 2..7 tokens."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n):
        plen = int(rng.integers(2, 8))
        prompt = rng.integers(3, cfg.vocab_size, plen).tolist()
        new = int(rng.integers(1, max_new + 1)) if mixed else max_new
        reqs.append(Request(uid=uid, prompt=prompt, max_new_tokens=new))
    return reqs


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--engine", choices=("continuous", "wave"),
                    default="continuous")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--mixed", action="store_true",
                    help="randomize max_new_tokens per request (1..max-new)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-steps", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", type=str, default=None)
    ap.add_argument("--backend", default="ideal",
                    choices=("ideal", "reference", "simulated", "emulated"))
    ap.add_argument("--guard", default="off",
                    choices=("off", "freivalds", "abft"))
    ap.add_argument("--guard-policy", default="fail_open",
                    choices=("fail_open", "fail_closed"))
    ap.add_argument("--hwloop", action="store_true")
    ap.add_argument("--hwloop-tech", default="vtr-22nm")
    ap.add_argument("--hwloop-array-n", type=int, default=8)
    ap.add_argument("--autoscale", default="static",
                    choices=("static", "threshold", "pid"))
    ap.add_argument("--autoscale-points", type=str, default=None,
                    metavar="FILE")
    ap.add_argument("--slo-ttft", type=float, default=None, metavar="S")
    ap.add_argument("--autoscale-every", type=int, default=4, metavar="N")
    ap.add_argument("--policy", choices=("fifo", "priority"), default="fifo")
    ap.add_argument("--max-pending", type=int, default=None)
    ap.add_argument("--serve-http", type=str, default=None,
                    metavar="HOST:PORT")
    ap.add_argument("--trace", type=str, default=None, metavar="FILE")
    ap.add_argument("--step-cost", type=float, default=0.02,
                    help="virtual seconds per model call under --trace")
    ap.add_argument("--metrics", type=str, default=None, metavar="PATH",
                    help="write a Prometheus-text registry snapshot at exit")
    ap.add_argument("--trace-out", type=str, default=None, metavar="PATH",
                    help="stream obs trace events to PATH as NDJSON")
    return ap


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Parse and validate; conflicting flags stop here through
    ``ap.error``, with the JAX launcher's messages."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.engine != "continuous" and (
            args.backend != "ideal" or args.hwloop or args.serve_http
            or args.trace or args.policy != "fifo"
            or args.max_pending is not None):
        ap.error("--backend/--hwloop/--serve-http/--trace/--policy/"
                 "--max-pending require the continuous engine")
    if args.serve_http and args.trace:
        ap.error("--serve-http and --trace are mutually exclusive")
    if args.autoscale != "static":
        if args.engine != "continuous":
            ap.error("--autoscale needs the continuous engine")
        if args.backend != "emulated":
            ap.error("--autoscale {threshold,pid} actuates the emulated "
                     "array's rails; pass --backend emulated")
        args.hwloop = True   # the session is the sanctioned actuation path
    if args.guard != "off" and args.backend == "ideal":
        ap.error("--guard needs a non-ideal --backend to protect "
                 "(the ideal path never corrupts)")
    return args


@dataclasses.dataclass
class ServeRun:
    """What one launcher run leaves behind."""

    engine: Any
    requests: List[Request]
    stats: Any
    wall_s: float


def build_engine(args: argparse.Namespace, params=None,
                 clock: Callable[[], float] = time.monotonic):
    """Build the model and the engine from parsed flags, reading time from
    ``clock`` (the trace harness passes its ``VirtualClock``).  ``params``
    reuses an existing parameter tree (it must lie on the run's device)
    instead of initialising from ``--seed``."""
    cfg = get_config(args.arch, smoke=args.smoke)
    api = model_api(cfg, device=args.device)     # raises without a GPU
    if params is None:
        params = api.init_params(args.seed)
    engine_kw = {}
    fcfg = store = report = None
    if args.backend == "emulated" or args.hwloop:
        # only these two paths run the CAD flow; one artifact store shared
        # by the backend's flow run and the hwloop watchdog executes it once
        from ..flow import ArtifactStore, FlowConfig
        fcfg = FlowConfig(array_n=args.hwloop_array_n, tech=args.hwloop_tech,
                          max_trials=8, seed=2021)
        store = ArtifactStore()
    if args.backend == "emulated":
        # CAD flow -> calibrated rails -> the serving execution target
        from ..flow import run as flow_run
        report = flow_run(fcfg, store=store)
        engine_kw["backend"] = EmulatedBackend.from_flow(report, fcfg,
                                                         device=api.device)
    elif args.backend == "simulated":
        engine_kw["backend"] = get_backend(
            args.backend, array_n=args.hwloop_array_n, tech=args.hwloop_tech,
            device=api.device)
    elif args.backend != "ideal":
        engine_kw["backend"] = get_backend(args.backend, device=api.device)
    if args.guard != "off":
        from ..resilience import GuardedBackend
        engine_kw["backend"] = GuardedBackend(
            engine_kw["backend"], mode=args.guard, policy=args.guard_policy)
    if args.hwloop:
        from ..hwloop import HwLoopSession
        engine_kw["hwloop"] = HwLoopSession(fcfg, probe_rows=8,
                                            rail_margin=0.02, store=store,
                                            device=api.device)
    if args.autoscale != "static":
        from ..railscale import Autoscaler, OperatingPointTable
        if args.autoscale_points:
            table = OperatingPointTable.load(
                args.autoscale_points, tech=args.hwloop_tech,
                array_n=args.hwloop_array_n)
        else:
            table = OperatingPointTable.characterize(
                report, fcfg, seed=fcfg.seed, device=api.device)
        engine_kw["autoscaler"] = Autoscaler(
            table, args.autoscale, decide_every=args.autoscale_every,
            slo_ttft_s=args.slo_ttft, start_level=0)
    if args.engine == "continuous":
        engine_kw.update(policy=args.policy, max_pending=args.max_pending)
        engine_cls = ServeEngine
    else:
        engine_cls = WaveServeEngine
    engine = engine_cls(cfg, params, slots=args.slots, max_len=args.max_len,
                        clock=clock, device=api.device, **engine_kw)
    _attach_obs_outputs(engine, args)
    return engine


def run(args: argparse.Namespace, params=None) -> ServeRun:
    """Build the engine (:func:`build_engine`), submit the random workload
    and drain it."""
    engine = build_engine(args, params)
    reqs = make_requests(engine.cfg, args.requests, args.max_new, args.mixed,
                         args.seed)
    for req in reqs:
        engine.submit(req)
    t0 = time.time()
    stats = engine.run_until_drained(max_steps=args.max_steps)
    return ServeRun(engine, reqs, stats, time.time() - t0)


def _serve_http(engine, hostport: str) -> None:
    """Run the asyncio streaming frontend until interrupted, then drain."""
    import asyncio

    from ..server import ServeFrontend

    host, _, port = hostport.rpartition(":")
    frontend = ServeFrontend(engine)

    async def serve() -> None:
        bound = await frontend.start(host or "127.0.0.1", int(port))
        print(f"serving on http://{bound[0]}:{bound[1]} "
              f"(POST /v1/generate, GET /healthz /metrics /v1/stats); "
              f"Ctrl-C drains + exits", flush=True)
        try:
            await frontend.serve_forever()    # until SIGINT cancels it
        finally:
            drained = await frontend.drain()
            await frontend.close()
            print(f"drained={drained}; served "
                  f"{engine.stats.completed} completed / "
                  f"{engine.stats.shed} shed / "
                  f"{engine.stats.tokens_generated} tokens", flush=True)

    try:
        asyncio.run(serve())
    except KeyboardInterrupt:
        pass


def _replay_trace(args: argparse.Namespace) -> None:
    """Replay a saved traffic trace deterministically in virtual time."""
    from ..server import LoadHarness, VirtualClock, load_trace

    clock = VirtualClock()
    engine = build_engine(args, clock=clock)
    events = load_trace(args.trace)
    harness = LoadHarness(engine, clock, step_cost_s=args.step_cost)
    m = harness.replay(events)
    p50 = "n/a" if m.ttft_p50_s is None else f"{1e3 * m.ttft_p50_s:.0f}ms"
    p99 = "n/a" if m.ttft_p99_s is None else f"{1e3 * m.ttft_p99_s:.0f}ms"
    met = "n/a" if m.deadline_met_frac is None \
        else f"{100 * m.deadline_met_frac:.0f}%"
    print(f"[trace {args.trace} on {engine.device}] {m.n_events} arrivals "
          f"over {m.elapsed_virtual_s:.2f} virtual s: {m.completed} "
          f"completed / {m.truncated} truncated / {m.shed} shed "
          f"(rate {m.shed_rate:.2f}, by tier {m.shed_by_priority}); "
          f"{m.tokens_per_s:.1f} tok/s, TTFT p50 {p50} p99 {p99}, "
          f"SLO met {met}; wall {m.wall_s:.1f}s")
    if args.json_out:
        payload = {"arch": args.arch, "trace": args.trace,
                   "slots": args.slots, "policy": args.policy,
                   "max_pending": args.max_pending,
                   "step_cost_s": args.step_cost, **m.to_dict()}
        if engine.autoscaler is not None:
            payload["railscale"] = engine.autoscaler.summary()
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.json_out}")
    _finish_obs_outputs(engine, args)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.trace:
        _replay_trace(args)
        return
    if args.serve_http:
        engine = build_engine(args)
        _serve_http(engine, args.serve_http)
        _finish_obs_outputs(engine, args)
        return
    done = run(args)
    engine, reqs, stats, dt = (done.engine, done.requests, done.stats,
                               done.wall_s)
    occ = ", ".join(f"{o:.2f}" for o in stats.occupancy())
    ttft = (f"{1e3 * sum(stats.ttft_s) / len(stats.ttft_s):.0f}ms"
            if stats.ttft_s else "n/a")
    print(f"[{args.engine} on {engine.device}] served {stats.completed} "
          f"completed / {stats.truncated} truncated / {stats.unserved} "
          f"unserved; {stats.tokens_generated} tokens in "
          f"{stats.prefill_steps} prefill + {stats.decode_steps} decode model "
          f"steps, {dt:.1f}s "
          f"({stats.tokens_generated / max(dt, 1e-9):.1f} tok/s, "
          f"mean TTFT {ttft}, occupancy [{occ}])")
    for r in reqs[:3]:
        print(f"  req {r.uid}: prompt {r.prompt} -> {r.out_tokens}"
              f"{' (truncated)' if r.truncated else ''}")
    if stats.backend_telemetry:
        bt = stats.backend_telemetry
        e = bt.get("energy_per_token_j")
        print(f"[backend:{stats.backend}] {bt['calls']} GEMMs, "
              f"{bt['macs']} MACs, {bt['flags']} flags, "
              f"{bt['replays']} replays, "
              f"{'n/a' if e is None else f'{e:.3g}'} J/token")
    if stats.hwloop:
        hw = stats.hwloop
        rates = ", ".join(f"{x:.2f}" for x in hw["flag_rate"])
        e = hw["energy_per_token_j"]        # None when no decode step ran
        print(f"[hwloop] {hw['steps']} emulated steps, flag rates [{rates}], "
              f"{hw['recalibrations']} recalibrations, "
              f"{'n/a' if e is None else f'{e:.3g}'} J/token "
              f"(replay rate {hw['replay_rate']:.2e})")
    if stats.railscale:
        rs = stats.railscale
        rails = ", ".join(f"{v:.3f}" for v in rs.get("rails_v", []))
        print(f"[railscale:{rs['policy']}] level {rs['level']}/"
              f"{rs['levels'] - 1}, {rs['decisions']} decisions, "
              f"transitions {rs['transitions']}, "
              f"{rs['heal_preemptions']} heal preemptions, "
              f"rails [{rails}]")
    if args.json_out:
        payload = {"arch": args.arch, "engine": args.engine,
                   "slots": args.slots, "max_len": args.max_len,
                   "requests": args.requests, "wall_s": dt,
                   "tok_per_s": stats.tokens_generated / max(dt, 1e-9),
                   **stats.to_dict()}
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.json_out}")
    _finish_obs_outputs(engine, args)


if __name__ == "__main__":
    main()
