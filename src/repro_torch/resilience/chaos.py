"""Seeded fault-injection campaign over the full serving stack.

Each scenario scripts ONE failure mode end-to-end — through
:class:`~repro_torch.serve.engine.ServeEngine` (and, where the failure
involves the wire, the asyncio HTTP frontend + client) — and checks the
graceful-degradation contract:

* no crash: the engine drains, the pump thread survives, `/healthz` answers;
* no corrupted completed stream: every stream reported ``completed`` carries
  tokens bit-identical to the truth (by default the ideal-backend decode);
* honest accounting: every request lands in exactly one terminal bucket
  (completed / truncated / shed / cancelled), and sheds carry their reason.

Scenarios (all seeded, all scale down under ``fast=True``):

``silent_burst``     repeated rail collapses into the silent-corruption
                     region mid-serve; the ABFT guard must detect, heal and
                     keep every stream clean through multiple bursts.
``rail_droop``       an HTTP serve with one mid-flight droop of every rail;
                     clients must stream to completion with clean tokens.
``watchdog_delay``   a high-patience watchdog delays recalibration; the
                     guard's heal loop must still restore rails within one
                     guarded GEMM.
``slow_decode``      a stalled engine behind a request-level timeout; the
                     server must cancel, answer 503, and keep serving.
``client_disconnect``a client drops mid-stream; the engine must reap the
                     slot and finish the remaining streams.
``overload_shed``    a burst into a bounded queue; 503s must carry
                     ``Retry-After`` and the shed accounting must balance.

``run_campaign`` executes all of them and aggregates a :class:`ChaosReport`.

Counterpart of ``repro.resilience.chaos``, with three hooks the reference
does not have.  ``model`` returns the ``(cfg, params)`` every engine of the
campaign serves (default: starcoder2-3b's smoke config from the port's
``init_params(0)``, whose numbers are not ``jax.random``'s); ``device``
places the engines and the emulated array (``None`` means the GPU); and
``truth`` picks what a completed stream must equal: ``"ideal"`` (the
reference's rule, the ideal backend's decode of the same workload) or
``"fault_free"`` (the same engine run without the fault).  The scenarios'
scripts, constants and checks are the reference's.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .._device import DeviceLike, resolve_device
from ..backend.impls import EmulatedBackend
from .guard import GuardedBackend

#: Rail voltage deep in the crash region of the vtr-22nm node — every
#: partition produces SILENT corruption there (tests/hwloop pins this down).
V_CRASH = 0.58

#: what a completed stream is held to (see the module docstring)
TRUTHS = ("ideal", "fault_free")

ModelHook = Callable[[], Tuple[Any, Any]]


@dataclasses.dataclass
class ScenarioResult:
    name: str
    ok: bool
    violations: List[str]
    details: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ChaosReport:
    results: List[ScenarioResult]
    elapsed_s: float

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    @property
    def corrupted_streams(self) -> int:
        return sum(r.details.get("corrupted_streams", 0)
                   for r in self.results)

    @property
    def crashes(self) -> int:
        return sum(r.details.get("crashed", 0) for r in self.results)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "crashes": self.crashes,
            "corrupted_streams": self.corrupted_streams,
            "elapsed_s": self.elapsed_s,
            "scenarios": [r.to_dict() for r in self.results],
        }


# ---------------------------------------------------------------------------
# Shared plumbing
# ---------------------------------------------------------------------------


class _Campaign:
    """The hooks of one campaign: the model (drawn once), the device and
    the truth rule."""

    def __init__(self, model: Optional[ModelHook] = None,
                 device: DeviceLike = None, truth: str = "ideal"):
        if truth not in TRUTHS:
            raise ValueError(f"unknown truth {truth!r}; known: {TRUTHS}")
        self.device = resolve_device(device)
        self.truth = truth
        self._hook = model
        self._model: Optional[Tuple[Any, Any]] = None

    def model(self) -> Tuple[Any, Any]:
        if self._model is None:
            if self._hook is not None:
                self._model = self._hook()
            else:
                from ..configs import get_config
                from ..models import model_api
                cfg = get_config("starcoder2-3b", smoke=True)
                api = model_api(cfg, device=self.device)
                self._model = (cfg, api.init_params(0))
        return self._model

    def expected(self, prompts: Sequence[Sequence[int]], max_new: int,
                 fault_free: Callable[[], Any]) -> tuple:
        """The tokens each completed stream must carry: the ideal backend's
        greedy decode of the workload, or (``truth="fault_free"``) the
        decode of ``fault_free()``'s engine, the scenario's own engine with
        no fault injected."""
        from ..serve import ServeEngine

        if self.truth == "ideal":
            cfg, params = self.model()
            eng = ServeEngine(cfg, params, slots=2, max_len=32,
                              device=self.device)
        else:
            eng, _ = fault_free()
        reqs = _submit_all(eng, prompts, max_new)
        eng.run_until_drained()
        return tuple(tuple(r.out_tokens) for r in reqs)


def _prompts(n: int, seed: int) -> List[List[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 64, size=int(rng.integers(2, 5))).tolist()
            for _ in range(n)]


def _guarded_engine(ctx: _Campaign, session=None, corruption: str = "bitflip",
                    guard_mode: str = "abft",
                    guard_policy: str = "fail_closed",
                    **engine_kw):
    """Continuous engine over a guarded emulated backend at nominal rails.
    Extra keywords go to the engine (``policy=``, ``max_pending=``, ...)."""
    from ..obs import ObsBus
    from ..serve import ServeEngine

    cfg, params = ctx.model()
    if session is not None:
        inner = EmulatedBackend(session.accel)
        engine_kw["hwloop"] = session
    else:
        inner = EmulatedBackend.nominal(corruption=corruption,
                                        device=ctx.device)
    guard = GuardedBackend(inner, mode=guard_mode, policy=guard_policy)
    # every chaos engine flies with a black box: the last 128 step/guard/
    # heal events, dumped into the scenario's details when it turns red
    engine_kw.setdefault("obs", ObsBus(recorder_capacity=128))
    eng = ServeEngine(cfg, params, slots=2, max_len=32, backend=guard,
                      device=ctx.device, **engine_kw)
    return eng, guard


def _watchdog_engine(ctx: _Campaign, patience: int = 5):
    """Guarded engine over the emulated array at the calibrated rails of a
    hwloop session whose watchdog waits ``patience`` flagged steps."""
    from ..flow import FlowConfig
    from ..hwloop import HwLoopSession

    session = HwLoopSession(
        FlowConfig(array_n=8, tech="vtr-22nm", max_trials=8, seed=2021),
        probe_rows=8, rail_margin=0.02, patience=patience,
        device=ctx.device)
    eng, guard = _guarded_engine(ctx, session=session)
    return eng, guard, session


def _flight(eng, violations: List[str]) -> Dict[str, Any]:
    """Failed scenarios ship the engine's flight-recorder ring in their
    details, so a red campaign is diagnosable from the report alone."""
    if not violations:
        return {}
    recorder = getattr(getattr(eng, "obs", None), "recorder", None)
    if recorder is None:
        return {}
    return {"flight_recorder": recorder.to_list()}


def _drain_scripted(eng, script: Optional[Callable[[int, Any], None]] = None,
                    max_steps: int = 2000):
    """Drive the engine step by step, invoking ``script(step, engine)``
    before each iteration (the fault-injection hook), then finalize stats."""
    steps = 0
    while not eng.scheduler.drained() and steps < max_steps:
        if script is not None:
            script(steps, eng)
        eng.step()
        steps += 1
    return eng.run_until_drained(max_steps=max_steps)


def _check_streams(reqs, ref, violations: List[str]) -> int:
    """Every completed request must match the truth bit for bit.  Returns
    the number of corrupted completed streams."""
    corrupted = 0
    for i, r in enumerate(reqs):
        if r.status != "completed":
            violations.append(f"request {r.uid} ended {r.status}, "
                              f"expected completed")
            continue
        if tuple(r.out_tokens) != ref[i]:
            corrupted += 1
            violations.append(f"request {r.uid} completed with corrupted "
                              f"tokens {r.out_tokens} != {list(ref[i])}")
    return corrupted


def _submit_all(eng, prompts: Sequence[Sequence[int]], max_new: int):
    from ..serve import Request

    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    return reqs


# ---------------------------------------------------------------------------
# Engine-level scenarios
# ---------------------------------------------------------------------------


def _scn_silent_burst(fast: bool, seed: int,
                      ctx: _Campaign) -> ScenarioResult:
    """Collapse every rail into the silent-corruption region repeatedly
    mid-serve.  The guard heals each burst; streams stay bit-clean."""
    n_req, max_new = (3, 4) if fast else (6, 8)
    prompts = _prompts(n_req, seed)
    ref = ctx.expected(prompts, max_new,
                       lambda: _guarded_engine(ctx, corruption="bitflip"))
    eng, guard = _guarded_engine(ctx, corruption="bitflip")
    reqs = _submit_all(eng, prompts, max_new)
    burst_steps = (1, 4)       # off the admission steps: hit DECODE GEMMs
    accel = guard.accel

    def script(step: int, _eng) -> None:
        if step in burst_steps:                      # repeated rail collapse
            accel.set_rails(np.full(accel.n_partitions, V_CRASH))

    violations: List[str] = []
    crashed = 0
    try:
        stats = _drain_scripted(eng, script)
    except Exception as e:          # noqa: BLE001 - the scenario's verdict
        crashed = 1
        violations.append(f"engine crashed: {type(e).__name__}: {e}")
        stats = eng.stats
    corrupted = _check_streams(reqs, ref, violations) if not crashed else 0
    tel = guard.total
    if not crashed:
        if tel.guard_detected == 0:
            violations.append("bursts injected but the guard detected "
                              "nothing")
        if tel.guard_heals == 0:
            violations.append("deterministic faults require rail heals; "
                              "none happened")
        if tel.guard_uncorrected:
            violations.append(f"{tel.guard_uncorrected} GEMMs left "
                              f"uncorrected under fail_closed")
        if not stats.guard_step_events:
            violations.append("decode-step guard telemetry is empty though "
                              "bursts hit decode steps")
    return ScenarioResult(
        name="silent_burst", ok=not violations, violations=violations,
        details={
            "crashed": crashed, "corrupted_streams": corrupted,
            "completed": stats.completed, "requests": n_req,
            "guard_checks": tel.guard_checks,
            "guard_detected": tel.guard_detected,
            "guard_corrected": tel.guard_corrected,
            "guard_retries": tel.guard_retries,
            "guard_heals": tel.guard_heals,
            "guard_uncorrected": tel.guard_uncorrected,
            "guard_step_events": len(stats.guard_step_events),
            **_flight(eng, violations),
        })


def _scn_watchdog_delay(fast: bool, seed: int,
                        ctx: _Campaign) -> ScenarioResult:
    """A high-patience watchdog delays recalibration.  The guard's heal loop
    feeds it corruption evidence until it acts — still within a single
    guarded GEMM — so streams stay clean despite the sluggish watchdog."""
    n_req, max_new = (3, 4) if fast else (5, 8)
    patience = 5
    prompts = _prompts(n_req, seed + 1)
    ref = ctx.expected(prompts, max_new,
                       lambda: _watchdog_engine(ctx, patience)[:2])
    eng, guard, session = _watchdog_engine(ctx, patience)
    reqs = _submit_all(eng, prompts, max_new)
    accel = guard.accel
    dropped = {"done": False}

    def script(step: int, _eng) -> None:
        if step == 2 and not dropped["done"]:        # one mid-serve collapse
            dropped["done"] = True
            accel.set_rails(np.full(accel.n_partitions, V_CRASH))

    violations: List[str] = []
    crashed = 0
    try:
        stats = _drain_scripted(eng, script)
    except Exception as e:          # noqa: BLE001 - the scenario's verdict
        crashed = 1
        violations.append(f"engine crashed: {type(e).__name__}: {e}")
        stats = eng.stats
    corrupted = _check_streams(reqs, ref, violations) if not crashed else 0
    tel = guard.total
    if not crashed:
        if tel.guard_heals == 0:
            violations.append("guard never healed through the watchdog")
        if session.recalibrations == 0:
            violations.append("watchdog never recalibrated despite "
                              "corruption evidence")
        if tel.guard_uncorrected:
            violations.append(f"{tel.guard_uncorrected} uncorrected GEMMs")
    return ScenarioResult(
        name="watchdog_delay", ok=not violations, violations=violations,
        details={
            "crashed": crashed, "corrupted_streams": corrupted,
            "completed": stats.completed, "requests": n_req,
            "watchdog_patience": patience,
            "recalibrations": session.recalibrations,
            "guard_detected": tel.guard_detected,
            "guard_heals": tel.guard_heals,
            "guard_uncorrected": tel.guard_uncorrected,
            **_flight(eng, violations),
        })


# ---------------------------------------------------------------------------
# HTTP scenarios
# ---------------------------------------------------------------------------


def _scn_rail_droop(fast: bool, seed: int,
                    ctx: _Campaign) -> ScenarioResult:
    """Full-stack: concurrent HTTP clients stream from a guarded emulated
    engine whose rails droop mid-serve.  Every stream must complete with
    bit-clean tokens and the pump must survive."""
    from ..server import ServeFrontend, get_json, stream_generate

    n_req, max_new = (3, 4) if fast else (6, 8)
    prompts = _prompts(n_req, seed + 2)
    ref = ctx.expected(prompts, max_new,
                       lambda: _guarded_engine(ctx, corruption="stale"))
    eng, guard = _guarded_engine(ctx, corruption="stale")
    accel = guard.accel
    real_step = eng.step
    dropped = {"at": 2, "count": 0, "steps": 0}

    def droop_step(*a, **kw):
        dropped["steps"] += 1
        if dropped["steps"] == dropped["at"]:
            dropped["count"] += 1
            accel.set_rails(np.full(accel.n_partitions, V_CRASH))
        return real_step(*a, **kw)

    eng.step = droop_step

    async def scenario():
        frontend = ServeFrontend(eng)
        host, port = await frontend.start()
        results = await asyncio.gather(*[
            stream_generate(host, port, p, max_new_tokens=max_new)
            for p in prompts])
        health = await get_json(host, port, "/healthz")
        await frontend.drain()
        await frontend.close()
        return results, health

    violations: List[str] = []
    crashed = 0
    results, health = [], {}
    try:
        results, health = asyncio.run(scenario())
    except Exception as e:          # noqa: BLE001 - the scenario's verdict
        crashed = 1
        violations.append(f"stack crashed: {type(e).__name__}: {e}")
    corrupted = 0
    if not crashed:
        if not health.get("pump_alive", False):
            violations.append("pump thread died")
        if dropped["count"] == 0:
            violations.append("the droop never fired (serve too short)")
        for i, res in enumerate(results):
            if not (res.ok and res.status == "completed"):
                violations.append(f"stream {i} ended "
                                  f"{res.status}/{res.http_status}")
            elif tuple(res.tokens) != ref[i]:
                corrupted += 1
                violations.append(f"stream {i} completed with corrupted "
                                  f"tokens")
    tel = guard.total
    if not crashed and tel.guard_detected == 0:
        violations.append("rails drooped but the guard saw nothing")
    return ScenarioResult(
        name="rail_droop", ok=not violations, violations=violations,
        details={
            "crashed": crashed, "corrupted_streams": corrupted,
            "requests": n_req, "droops": dropped["count"],
            "guard_detected": tel.guard_detected,
            "guard_heals": tel.guard_heals,
            "guard_uncorrected": tel.guard_uncorrected,
            **_flight(eng, violations),
        })


def _scn_slow_decode(fast: bool, seed: int,
                     ctx: _Campaign) -> ScenarioResult:
    """A stalled decode behind a server-side request timeout: the slow
    request is cancelled with a 503, the engine reaps its slot, and the
    server keeps serving afterwards."""
    from ..serve import Request
    from ..server import ServeFrontend, get_json, stream_generate

    eng, guard = _guarded_engine(ctx)
    real_step = eng.step
    stalling = {"on": False, "stall_s": 0.0}

    def stalled_step(*a, **kw):
        if stalling["on"]:
            time.sleep(stalling["stall_s"])         # a wedged model step
        return real_step(*a, **kw)

    eng.step = stalled_step

    # warm the engine (first launches load code; the frontend timeout must
    # not apply to that), then time a steady-state 1-token request so the
    # timeout/stall pair scales with this host's real step latency
    for uid in (10_000, 10_001):
        t0 = time.perf_counter()
        eng.submit(Request(uid=uid, prompt=[3, 4], max_new_tokens=1))
        eng.run_until_drained()
        warm_s = time.perf_counter() - t0
    timeout_s = max(0.1, 5.0 * warm_s)    # recovery fits with 5x margin...
    stall_s = max(0.3 if fast else 0.6,   # ...and the stall blows through it
                  3.0 * timeout_s)
    stalling["stall_s"] = stall_s

    async def scenario():
        frontend = ServeFrontend(eng, request_timeout_s=timeout_s)
        host, port = await frontend.start()
        stalling["on"] = True
        slow = await stream_generate(host, port, [3, 4], max_new_tokens=6)
        stalling["on"] = False                      # stall clears
        # wait for the engine to reap the cancelled request — the pump may
        # still be inside one last stalled step — then prove recovery: the
        # frontend timeout stays armed, and the request completes within it
        deadline = asyncio.get_running_loop().time() + 30.0
        while True:
            health = await get_json(host, port, "/healthz")
            if (health["active"] == 0 and health["pending"] == 0) \
                    or asyncio.get_running_loop().time() > deadline:
                break
            await asyncio.sleep(0.02)
        ok = await stream_generate(host, port, [5, 6], max_new_tokens=1)
        health = await get_json(host, port, "/healthz")
        await frontend.drain()
        await frontend.close()
        return slow, ok, health

    violations: List[str] = []
    crashed = 0
    try:
        slow, ok, health = asyncio.run(scenario())
    except Exception as e:          # noqa: BLE001 - the scenario's verdict
        crashed = 1
        violations.append(f"stack crashed: {type(e).__name__}: {e}")
        slow = ok = None
        health = {}
    if not crashed:
        timed_out = (slow.http_status == 503
                     and slow.summary.get("error") == "timeout") \
            or slow.summary.get("status") == "cancelled"
        if not timed_out:
            violations.append(f"stalled request was not timed out: "
                              f"{slow.http_status} {slow.summary}")
        if slow.http_status == 503 and "retry-after" not in slow.headers:
            violations.append("timeout 503 lacked Retry-After")
        if not (ok.ok and ok.status == "completed"):
            violations.append(f"server did not recover after the stall: "
                              f"{ok.http_status} {ok.summary}")
        if not health.get("pump_alive", False):
            violations.append("pump thread died")
        if health.get("cancelled", 0) < 1:
            violations.append("engine never reaped the cancelled request")
    return ScenarioResult(
        name="slow_decode", ok=not violations, violations=violations,
        details={
            "crashed": crashed, "corrupted_streams": 0,
            "stall_s": stall_s,
            "slow_status": None if crashed else slow.http_status,
            "cancelled": health.get("cancelled"),
            **_flight(eng, violations),
        })


def _scn_client_disconnect(fast: bool, seed: int,
                           ctx: _Campaign) -> ScenarioResult:
    """A client vanishes mid-stream.  The engine reaps the abandoned slot,
    ``on_finish`` fires exactly once, and other streams are unaffected."""
    import json as _json

    from ..server import ServeFrontend, get_json, stream_generate

    # long stream + pacing: wide runway for the RST to surface server-side
    # before the request could complete on its own
    max_new = 30 if fast else 60
    eng, guard = _guarded_engine(ctx)
    real_step = eng.step

    def paced_step(*a, **kw):       # give the client time to bail mid-stream
        time.sleep(0.01)
        return real_step(*a, **kw)

    eng.step = paced_step

    async def scenario():
        frontend = ServeFrontend(eng)
        host, port = await frontend.start()
        # hand-rolled request so the socket can be dropped after one token
        reader, writer = await asyncio.open_connection(host, port)
        body = _json.dumps({"prompt": [3, 4],
                            "max_new_tokens": max_new}).encode()
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: {host}\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        await writer.drain()
        await reader.readline()                     # status line arrived:
        writer.transport.abort()                    # ...and the client dies
        # (abort sends RST so the server's next stream write raises instead
        # of buffering into a half-closed socket)
        # a well-behaved client must still be served while the engine reaps
        # the abandoned request
        survivor = await stream_generate(host, port, [5, 6],
                                         max_new_tokens=3)
        deadline = asyncio.get_running_loop().time() + 30.0
        while True:                 # reap happens on a subsequent step
            health = await get_json(host, port, "/healthz")
            if health["cancelled"] >= 1 or not health["pump_alive"] \
                    or asyncio.get_running_loop().time() > deadline:
                break
            await asyncio.sleep(0.02)
        await frontend.drain()
        await frontend.close()
        return survivor, health

    violations: List[str] = []
    crashed = 0
    try:
        survivor, health = asyncio.run(scenario())
    except Exception as e:          # noqa: BLE001 - the scenario's verdict
        crashed = 1
        violations.append(f"stack crashed: {type(e).__name__}: {e}")
        survivor, health = None, {}
    if not crashed:
        if not health.get("pump_alive", False):
            violations.append("pump thread died after the disconnect")
        if health.get("cancelled", 0) < 1:
            violations.append("disconnected request was never reaped")
        if not (survivor.ok and survivor.status == "completed"
                and len(survivor.tokens) == 3):
            violations.append("survivor stream was damaged by the "
                              "disconnect")
    return ScenarioResult(
        name="client_disconnect", ok=not violations, violations=violations,
        details={
            "crashed": crashed, "corrupted_streams": 0,
            "cancelled": health.get("cancelled"),
            "survivor_tokens": None if crashed else len(survivor.tokens),
            **_flight(eng, violations),
        })


def _scn_overload_shed(fast: bool, seed: int,
                       ctx: _Campaign) -> ScenarioResult:
    """Burst into a bounded queue: sheds answer 503 + Retry-After, the
    retrying client backs off deterministically, and the terminal buckets
    balance exactly."""
    from ..server import (RetryPolicy, ServeFrontend, get_json,
                          stream_generate)

    n_req = 8 if fast else 16
    eng, guard = _guarded_engine(ctx, policy="priority", max_pending=2)
    real_step = eng.step

    def paced_step(*a, **kw):       # slow service rate so the burst sheds
        time.sleep(0.01)
        return real_step(*a, **kw)

    eng.step = paced_step
    prompts = _prompts(n_req, seed + 3)

    async def scenario():
        frontend = ServeFrontend(eng)
        host, port = await frontend.start()
        warm = await stream_generate(host, port, [3], max_new_tokens=1)
        burst_tasks = [asyncio.create_task(
            stream_generate(host, port, p, max_new_tokens=2))
            for p in prompts]
        await asyncio.sleep(0.05)   # let the burst fill the bounded queue
        # one retrying client arrives into the full queue: its 503s honour
        # Retry-After and back off until the burst clears
        retried_task = asyncio.create_task(stream_generate(
            host, port, [9, 9], max_new_tokens=1,
            retry=RetryPolicy(max_retries=6, backoff_s=0.05, seed=seed)))
        burst = await asyncio.gather(*burst_tasks)
        retried = await retried_task
        health = await get_json(host, port, "/healthz")
        await frontend.drain()
        await frontend.close()
        return warm, burst, retried, health

    violations: List[str] = []
    crashed = 0
    try:
        warm, burst, retried, health = asyncio.run(scenario())
    except Exception as e:          # noqa: BLE001 - the scenario's verdict
        crashed = 1
        violations.append(f"stack crashed: {type(e).__name__}: {e}")
        warm = retried = None
        burst, health = [], {}
    shed = [r for r in burst if r.http_status == 503]
    done = [r for r in burst if r.ok and r.status == "completed"]
    if not crashed:
        if not shed:
            violations.append("burst into a 2-deep queue never shed")
        for r in shed:
            if "retry-after" not in r.headers:
                violations.append("shed 503 lacked Retry-After")
                break
        if len(shed) + len(done) != len(burst):
            violations.append(
                f"terminal buckets do not balance: {len(shed)} shed + "
                f"{len(done)} completed != {len(burst)}")
        if retried is not None and not retried.ok:
            violations.append(f"retrying client never landed "
                              f"({retried.attempts} attempts)")
        if not health.get("pump_alive", False):
            violations.append("pump thread died")
    return ScenarioResult(
        name="overload_shed", ok=not violations, violations=violations,
        details={
            "crashed": crashed, "corrupted_streams": 0,
            "requests": n_req, "shed": len(shed), "completed": len(done),
            "retry_attempts": None if retried is None else retried.attempts,
            "health_shed": health.get("shed"),
            **_flight(eng, violations),
        })


# ---------------------------------------------------------------------------
# Campaign
# ---------------------------------------------------------------------------

SCENARIOS: Dict[str, Callable[[bool, int, _Campaign], ScenarioResult]] = {
    "silent_burst": _scn_silent_burst,
    "rail_droop": _scn_rail_droop,
    "watchdog_delay": _scn_watchdog_delay,
    "slow_decode": _scn_slow_decode,
    "client_disconnect": _scn_client_disconnect,
    "overload_shed": _scn_overload_shed,
}


def _scenario(name: str) -> Callable[[bool, int, _Campaign],
                                     ScenarioResult]:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; known: "
                       f"{sorted(SCENARIOS)}") from None


def run_scenario(name: str, fast: bool = True, seed: int = 0, *,
                 model: Optional[ModelHook] = None, device: DeviceLike = None,
                 truth: str = "ideal") -> ScenarioResult:
    """One scenario.  ``model``, ``device`` and ``truth`` are the campaign's
    hooks (module docstring)."""
    return _scenario(name)(fast, seed, _Campaign(model, device, truth))


def run_campaign(fast: bool = True, seed: int = 0,
                 only: Optional[Sequence[str]] = None, *,
                 model: Optional[ModelHook] = None, device: DeviceLike = None,
                 truth: str = "ideal") -> ChaosReport:
    """Run the fault campaign; every scenario runs even when an earlier one
    fails (the report carries all verdicts).  The model is drawn once for
    the whole campaign."""
    ctx = _Campaign(model, device, truth)
    scenarios = [_scenario(n) for n in (list(only) if only else SCENARIOS)]
    t0 = time.perf_counter()
    results = [fn(fast, seed, ctx) for fn in scenarios]
    return ChaosReport(results=results, elapsed_s=time.perf_counter() - t0)


if __name__ == "__main__":
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(description="Run the chaos campaign")
    ap.add_argument("--full", action="store_true",
                    help="full-size scenarios (default: fast smoke sizes)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None, metavar="NAME[,NAME...]",
                    help=f"subset of {', '.join(SCENARIOS)}")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the engines run (default: the GPU)")
    ns = ap.parse_args()
    only = ns.only.split(",") if ns.only else None
    report = run_campaign(fast=not ns.full, seed=ns.seed, only=only,
                          device=ns.device)
    # lint: allow=RP008 CLI entry point owns stdout; the report IS the output
    print(json.dumps(report.to_dict(), indent=2))
    sys.exit(0 if report.ok else 1)
