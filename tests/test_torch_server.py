"""The port's serving frontend (``repro_torch.server``) against
``repro.server``, on the CPU.

Traces from both generators are byte-equal; the retry policy draws the same
schedule; a virtual-time replay gives the same ``TrafficMetrics`` (all but
``wall_s``) through the JAX engine and the port's, fed the reference's
starcoder2 smoke weights; the cases of ``tests/server/test_http.py`` and
``test_client_retry.py`` run against the port's frontend and client; the
scrapes hold no tensor; and the launcher's ``--trace`` and ``--serve-http``
run as the JAX launcher's do.
"""

import asyncio
import io
import json
import signal
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.server as jserver
import repro_torch.server as tserver
from repro.configs import get_config as j_get_config
from repro.launch import serve as j_launch
from repro.models import model_api as j_model_api
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as t_launch
from repro_torch.models import model_api, params_from_numpy
from repro_torch.serve import Priority, Request, ServeEngine, SlotScheduler
from repro_torch.server.client import RETRYABLE_ERRORS
from repro_torch.server.frontend import _json_response, _unavailable
from test_torch_serve import _np_tree

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

#: trace configs: the defaults, a diurnal burst envelope, a skewed QoS mix
#: with short lengths, and another seed at a high rate
TRACE_CFGS = [
    dict(rate_rps=8.0, duration_s=5.0, seed=0),
    dict(rate_rps=40.0, duration_s=20.0, seed=7, diurnal_amplitude=1.0,
         diurnal_period_s=20.0),
    dict(rate_rps=20.0, duration_s=3.0, seed=3, max_prompt_len=6,
         max_gen_len=5, priority_weights=(0.5, 0.25, 0.25),
         deadline_s=(None, 30.0, 0.5), vocab_size=512),
    dict(rate_rps=15.8, duration_s=10.0, seed=11, diurnal_amplitude=0.4,
         diurnal_period_s=4.0),
]


@pytest.fixture(scope="module")
def dense():
    """starcoder2's smoke config with the reference's weights in both
    packages."""
    jcfg = j_get_config("starcoder2-3b", smoke=True)
    jparams = j_model_api(jcfg).init_params(jax.random.PRNGKey(0))
    tcfg = get_config("starcoder2-3b", smoke=True)
    tparams = params_from_numpy(
        _np_tree(jparams), model_api(tcfg, device="cpu").param_specs(), "cpu")
    return jcfg, jparams, tcfg, tparams


# ---- traffic -----------------------------------------------------------------


def test_exports_the_references_names():
    assert sorted(tserver.__all__) == sorted(jserver.__all__)
    assert len(tserver.__all__) == 14


@pytest.mark.parametrize("kw", TRACE_CFGS, ids=["default", "diurnal",
                                                "qos", "rate-15.8"])
def test_trace_bytes_equal_the_references(kw):
    got, want = io.StringIO(), io.StringIO()
    tserver.save_trace(
        tserver.TrafficGenerator(tserver.TrafficConfig(**kw)).events(), got)
    jserver.save_trace(
        jserver.TrafficGenerator(jserver.TrafficConfig(**kw)).events(), want)
    assert got.getvalue() and got.getvalue() == want.getvalue()
    got.seek(0)
    events = tserver.load_trace(got)
    assert [e.priority for e in events] == [
        Priority[e.priority.name] for e in jserver.load_trace(
            io.StringIO(want.getvalue()))]
    t_cfg, j_cfg = tserver.TrafficConfig(**kw), jserver.TrafficConfig(**kw)
    assert t_cfg.to_dict() == j_cfg.to_dict()
    for factor in (0.5, 1.5, 4.0):
        assert tserver.overload_rate_rps(factor, 4, 0.065, t_cfg) == \
            jserver.overload_rate_rps(factor, 4, 0.065, j_cfg)


def test_trace_cli_writes_the_references_file(tmp_path):
    flags = ["--rate", "12", "--duration", "4", "--seed", "5", "--burst",
             "0.5", "--burst-period", "2", "--max-gen-len", "9"]
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    for pkg, out in (("repro_torch.server", "t.ndjson"),
                     ("repro.server", "j.ndjson")):
        done = subprocess.run(
            [sys.executable, "-m", pkg, "--out", str(tmp_path / out)]
            + flags, env=env, capture_output=True, text=True, timeout=120)
        assert done.returncode == 0, done.stderr
        assert done.stdout.startswith("wrote ")
    assert (tmp_path / "t.ndjson").read_bytes() == \
        (tmp_path / "j.ndjson").read_bytes()


@pytest.mark.parametrize("bad", [dict(rate_rps=0.0), dict(duration_s=-1.0),
                                 dict(diurnal_amplitude=1.5),
                                 dict(priority_weights=(0.5, 0.5, 0.5))])
def test_config_validation(bad):
    with pytest.raises(ValueError):
        tserver.TrafficConfig(**bad)


def test_trace_event_to_request_carries_qos():
    ev = tserver.TraceEvent(t_s=0.5, uid=3, prompt=[4, 5], max_new_tokens=6,
                            priority=Priority.HIGH, deadline_s=0.25)
    req = ev.to_request()
    assert isinstance(req, Request)
    assert req.uid == 3 and req.prompt == [4, 5] and req.max_new_tokens == 6
    assert req.priority is Priority.HIGH and req.deadline_s == 0.25


# ---- retry policy ------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=42, jitter=0.3),
                                dict(seed=7, backoff_s=0.01, multiplier=3.0)])
def test_retry_schedule_equals_the_references(kw):
    t, j = tserver.RetryPolicy(**kw), jserver.RetryPolicy(**kw)
    for k, after in zip(range(8), (None, 0.5, None, 9.0, None, None, 0.001,
                                   None)):
        assert t.delay_s(k, after) == j.delay_s(k, after)


def test_policy_validation():
    with pytest.raises(ValueError):
        tserver.RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError):
        tserver.RetryPolicy(jitter=1.5)


# ---- virtual-time harness ----------------------------------------------------


def _traffic(pkg, factor):
    base = dict(duration_s=1.5, seed=0, max_prompt_len=8, max_gen_len=8,
                prompt_len_log_mean=0.8, prompt_len_log_sigma=0.5,
                gen_len_log_mean=1.0, gen_len_log_sigma=0.5)
    rate = pkg.overload_rate_rps(factor, 2, 0.02, pkg.TrafficConfig(**base))
    return pkg.TrafficConfig(rate_rps=rate, **base)


@pytest.mark.parametrize("factor", [0.5, 1.0, 2.0])
def test_replay_metrics_equal_the_references(dense, factor):
    jcfg, jparams, tcfg, tparams = dense
    out = {}
    for pkg, make in (
            (jserver, lambda clock: JServeEngine(
                jcfg, jparams, slots=2, max_len=32, clock=clock,
                policy="priority", max_pending=6)),
            (tserver, lambda clock: ServeEngine(
                tcfg, tparams, slots=2, max_len=32, clock=clock,
                policy="priority", max_pending=6, device="cpu"))):
        clock = pkg.VirtualClock()
        harness = pkg.LoadHarness(make(clock), clock, step_cost_s=0.02)
        m = harness.replay(pkg.TrafficGenerator(_traffic(pkg, factor))
                           .events()).to_dict()
        m.pop("wall_s")
        out[pkg] = m
    assert out[tserver] == out[jserver]
    assert out[tserver]["completed"] > 0
    if factor == 2.0:
        assert out[tserver]["shed"] > 0


def test_harness_requires_matching_clock(dense):
    *_, tcfg, tparams = dense
    eng = ServeEngine(tcfg, tparams, slots=1, max_len=16, device="cpu")
    with pytest.raises(ValueError):
        tserver.LoadHarness(eng, tserver.VirtualClock())


def test_engine_clock_injection_exact_ttft(dense):
    *_, tcfg, tparams = dense
    clock = tserver.VirtualClock()
    eng = ServeEngine(tcfg, tparams, slots=2, max_len=32, clock=clock,
                      device="cpu")
    req = Request(uid=0, prompt=[5, 6], max_new_tokens=3)
    eng.submit(req)
    clock.advance(1.5)
    eng.step()
    assert req.first_token_t == 1.5 and eng.stats.ttft_s == [1.5]
    clock.advance(0.25)
    eng.step()
    eng.run_until_drained()
    assert req.finish_t == 1.75


# ---- HTTP frontend (tests/server/test_http.py's cases) ------------------------


def _engine(dense, **kw):
    *_, tcfg, tparams = dense
    base = dict(slots=2, max_len=32, policy="priority", device="cpu")
    base.update(kw)
    return ServeEngine(tcfg, tparams, **base)


def _direct_tokens(dense, prompts, max_new):
    """The same requests through the engine alone, as one batch."""
    eng = _engine(dense)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return [r.out_tokens for r in reqs]


def test_concurrent_clients_stream_full_token_budget(dense):
    prompts = [[5 + i, 6, 7] for i in range(5)]
    max_new = [3 + i for i in range(5)]

    async def scenario():
        frontend = tserver.ServeFrontend(_engine(dense))
        host, port = await frontend.start()
        results = await asyncio.gather(*[
            tserver.stream_generate(host, port, p, max_new_tokens=m)
            for p, m in zip(prompts, max_new)])
        assert await frontend.drain()
        await frontend.close()
        return results

    results = asyncio.run(scenario())
    for i, res in enumerate(results):
        assert res.ok and res.status == "completed"
        assert len(res.tokens) == 3 + i == res.summary["n_tokens"]
        assert res.summary["ttft_s"] > 0
    # arrival order decides which rows share a step; every row's tokens
    # are those of the engine driven directly
    assert [r.tokens for r in results] == _direct_tokens(dense, prompts,
                                                         max_new)


def test_healthz_and_routing(dense):
    async def scenario():
        frontend = tserver.ServeFrontend(_engine(dense, max_pending=4))
        host, port = await frontend.start()
        health = await tserver.get_json(host, port, "/healthz")
        missing = await tserver.get_json(host, port, "/nope")
        bad = await tserver.stream_generate(host, port, ["not-a-token"])
        await frontend.close()
        return health, missing, bad

    health, missing, bad = asyncio.run(scenario())
    assert health["_http_status"] == 200
    assert health["status"] == "ok" and health["slots"] == 2
    assert health["policy"] == "priority" and health["max_pending"] == 4
    assert health["pump_alive"] is True
    assert missing["_http_status"] == 404
    assert bad.http_status == 400


def test_overload_sheds_low_tiers_and_drain_completes_admitted(dense):
    """2x-overload seeded trace over real sockets: lower tiers are shed,
    every admitted-and-completed stream keeps its full token budget, and
    graceful drain finishes all admitted requests."""
    gen = dict(gen_len_log_mean=1.0, gen_len_log_sigma=0.5)
    tcfg = tserver.TrafficConfig(
        rate_rps=tserver.overload_rate_rps(
            2.0, 2, 0.02, tserver.TrafficConfig(**gen)),
        duration_s=1.0, seed=11, max_prompt_len=6, max_gen_len=6,
        priority_weights=(0.5, 0.25, 0.25), deadline_s=(None, 30.0, 30.0),
        vocab_size=dense[2].vocab_size, **gen)
    events = tserver.TrafficGenerator(tcfg).events()
    assert len(events) >= 8
    n_high = sum(ev.priority is Priority.HIGH for ev in events)

    async def scenario():
        engine = _engine(dense, max_pending=n_high + 1)
        frontend = tserver.ServeFrontend(engine)
        host, port = await frontend.start()
        warm = await tserver.stream_generate(host, port, [3, 4],
                                             max_new_tokens=1)
        assert warm.status == "completed"
        real_step = engine.step

        def paced_step():
            time.sleep(0.004)
            return real_step()

        engine.step = paced_step

        async def fire(ev):
            res = await tserver.stream_generate(
                host, port, ev.prompt, max_new_tokens=ev.max_new_tokens,
                priority=ev.priority.name.lower(), deadline_s=ev.deadline_s)
            return ev, res

        tasks = [asyncio.create_task(fire(ev)) for ev in events]
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 60.0
        while True:
            h = await tserver.get_json(host, port, "/healthz")
            landed = (h["pending"] + h["active"] + h["completed"]
                      + h["truncated"] + h["shed"])
            if landed >= len(events) + 1:
                break
            assert loop.time() < deadline, "burst never fully arrived"
            await asyncio.sleep(0.01)
        drained = await frontend.drain(timeout_s=120.0)
        results = await asyncio.gather(*tasks)
        late = await tserver.stream_generate(host, port, [5],
                                             max_new_tokens=1)
        health = await tserver.get_json(host, port, "/healthz")
        await frontend.close()
        return drained, results, late, health

    drained, results, late, health = asyncio.run(scenario())
    assert drained
    statuses = {s: [ev for ev, r in results if r.status == s]
                for s in ("completed", "shed")}
    assert statuses["shed"], "2x overload against a bounded queue must shed"
    assert all(ev.priority is not Priority.HIGH for ev in statuses["shed"])
    for ev, res in results:
        if res.status == "completed":
            assert len(res.tokens) == ev.max_new_tokens
            assert res.summary["n_tokens"] == ev.max_new_tokens
            if ev.deadline_s is not None:
                assert res.summary["deadline_met"] is True
        elif res.status == "shed":
            assert res.http_status == 503 and res.tokens == []
            assert res.headers.get("retry-after") == "1"
    assert health["pending"] == 0 and health["active"] == 0
    assert health["status"] == "draining"
    assert late.http_status == 503
    assert late.summary.get("error") == "draining"
    assert health["completed"] == len(statuses["completed"]) + 1


def _tensors_in(obj, path="$"):
    """Every path in ``obj`` (dicts, lists, objects' attributes) that holds
    a tensor."""
    if isinstance(obj, torch.Tensor):
        return [path]
    if isinstance(obj, dict):
        return [p for k, v in obj.items()
                for p in _tensors_in(v, f"{path}.{k}")]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj)
                for p in _tensors_in(v, f"{path}[{i}]")]
    return []


def test_scrapes_hold_no_tensor(dense):
    """What the event-loop thread reads (``health``, ``metrics_text``,
    ``stats_json``, and ``EngineStats``' fields and registry cells behind
    them) holds Python numbers only, on the guarded emulated array with the
    hwloop session attached: no read of a device tensor off the pump."""
    from repro_torch.backend import EmulatedBackend
    from repro_torch.flow import FlowConfig
    from repro_torch.hwloop import HwLoopSession
    from repro_torch.resilience import GuardedBackend
    *_, tcfg, tparams = dense
    session = HwLoopSession(FlowConfig(array_n=8, tech="vtr-22nm",
                                       max_trials=8, seed=2021),
                            probe_rows=8, rail_margin=0.02, device="cpu")
    guard = GuardedBackend(EmulatedBackend(session.accel), mode="abft")
    eng = ServeEngine(tcfg, tparams, slots=2, max_len=32, backend=guard,
                      hwloop=session, device="cpu")

    async def scenario():
        frontend = tserver.ServeFrontend(eng)
        host, port = await frontend.start()
        res = await asyncio.gather(*[
            tserver.stream_generate(host, port, [3 + i, 4], max_new_tokens=3)
            for i in range(3)])
        await frontend.drain()
        await frontend.close()
        eng.run_until_drained()       # fills the lifetime summaries too
        return frontend, res

    frontend, res = asyncio.run(scenario())
    assert all(r.status == "completed" for r in res)
    stats = eng.stats
    raw = {k: v for k, v in vars(stats).items()
           if k not in ("obs", "_counters", "_ttft_hist")}
    assert stats.backend_telemetry and stats.hwloop
    assert stats.backend_step_flags and stats.hwloop_step_flags
    cells = {name: dict(m._values) for name, m in
             eng.obs.registry._metrics.items() if hasattr(m, "_values")}
    for what, obj in (("health", frontend.health()),
                      ("stats_json", frontend.stats_json()),
                      ("EngineStats", raw), ("registry", cells)):
        assert _tensors_in(obj) == [], what
    json.dumps(frontend.stats_json())
    text = frontend.metrics_text()
    assert "serve_tokens_generated_total" in text


# ---- the pump ----------------------------------------------------------------


class _FakeEngine:
    """Engine-shaped stub: every step holds the GIL for ``step_s`` (a busy
    model step) and emits one token to each active request; ``fail_at``
    makes that step raise as a CUDA error would."""

    device = torch.device("cpu")

    def __init__(self, step_s=0.002, fail_at=None):
        self.scheduler = SlotScheduler(2)
        self.step_s, self.fail_at, self.steps = step_s, fail_at, 0
        self.stats = types.SimpleNamespace(
            admitted=0, completed=0, truncated=0, cancelled=0,
            tokens_generated=0, decode_steps=0, backend=None)

    def submit(self, req):
        return self.scheduler.submit(req)

    def step(self):
        self.steps += 1
        if self.steps == self.fail_at:
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < self.step_s:
            pass
        self.scheduler.admit()
        for slot, req in list(self.scheduler.active.items()):
            req.out_tokens.append(7)
            if req.on_token is not None:
                req.on_token(req, 7)
            if len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                self.scheduler.evict(slot)
                req.fire_finish()
        return 1


class _ReferenceHandler(jserver.ServeFrontend):
    """The reference's frontend, its handler's submission as a method: the
    event loop takes the pump's lock, ``with self._lock: accepted =
    self.engine.submit(req)``."""

    async def _submit(self, req):
        with self._lock:
            return self.engine.submit(req)


def _submissions_under_a_long_stream(frontend_cls, stream_tokens):
    """20 submissions from the event loop, 13 ms apart, while a stream of
    ``stream_tokens`` keeps the pump busy with 20 ms steps of a stub engine.
    Returns per submission the steps the pump took between the submission
    and its ``engine.submit``, the ticks a 1 ms ticker on the loop made
    while the submission was awaited, and its wall seconds; then the
    stream."""
    eng = _FakeEngine(step_s=0.02)
    at_submit = {}
    submit = eng.submit

    def recording_submit(req):
        at_submit[req.uid] = eng.steps
        return submit(req)

    eng.submit = recording_submit
    stream = Request(uid=-1, prompt=[1], max_new_tokens=stream_tokens)
    eng.submit(stream)                 # before the pump starts: no race
    frontend = frontend_cls(eng)
    lags, ticks_during, waits = [], [], []
    ticks = [0]
    switch = sys.getswitchinterval()

    async def ticker():
        while True:
            await asyncio.sleep(0.001)
            ticks[0] += 1

    async def scenario():
        await frontend.start()
        ticking = asyncio.create_task(ticker())
        await asyncio.sleep(0.05)
        for i in range(20):
            before, ticked = eng.steps, ticks[0]
            t0 = time.perf_counter()
            assert await frontend._submit(Request(uid=i, prompt=[1],
                                                  max_new_tokens=1))
            waits.append(time.perf_counter() - t0)
            lags.append(at_submit[i] - before)
            ticks_during.append(ticks[0] - ticked)
            await asyncio.sleep(0.013)     # land at varied points of a step
        ticking.cancel()
        await frontend.close()

    sys.setswitchinterval(1e-5)
    try:
        asyncio.run(asyncio.wait_for(scenario(), 60))
    finally:
        sys.setswitchinterval(switch)
    assert frontend._thread is not None and not frontend._thread.is_alive()
    assert len(lags) == 20 and eng.steps >= 10
    return lags, ticks_during, waits, stream


def test_a_submit_waits_at_most_about_one_step():
    """While a long stream keeps the pump busy, a handler's submission
    reaches ``engine.submit`` at most one model step after it was made (the
    pump submits its inbox before every step), and the event loop runs on
    while the submission waits (a handler never waits on the step)."""
    lags, ticks_during, _, stream = _submissions_under_a_long_stream(
        tserver.ServeFrontend, 10_000)
    assert not stream.done             # the pump stayed busy throughout
    # one step of slack beyond the design's bound of one is for a
    # descheduled event-loop thread
    assert max(lags) <= 2, lags
    # a submission waits half a step on average: the 1 ms ticker ran on
    assert sum(ticks_during) >= 20, ticks_during


def test_the_references_handler_stops_the_event_loop_while_it_waits():
    """The same submissions through the reference's handler: the loop
    itself waits on the pump's lock, up to a step a submission, and no other
    coroutine runs meanwhile.  At times its pump keeps the lock for the rest
    of the stream (ROADMAP C10), so the stream is a short one here."""
    _, ticks_during, waits, _ = _submissions_under_a_long_stream(
        _ReferenceHandler, 300)
    # the loop waited for the rest of a step a submission (tens of ms in
    # all) and the 1 ms ticker never ran meanwhile
    assert sum(waits) >= 0.05, waits
    assert sum(ticks_during) == 0, ticks_during


def test_a_failed_step_ends_every_stream_and_close_reraises():
    """A CUDA error inside a step: the pump stops, every live stream ends,
    /healthz says pump_alive false, a later request gets a 503, and close()
    re-raises the error."""
    eng = _FakeEngine(fail_at=3)

    async def scenario():
        frontend = tserver.ServeFrontend(eng)
        host, port = await frontend.start()
        res = await asyncio.gather(*[
            tserver.stream_generate(host, port, [1, 2], max_new_tokens=50,
                                    timeout_s=30)
            for _ in range(3)])
        health = frontend.health()
        late = await tserver.stream_generate(host, port, [1, 2],
                                             max_new_tokens=5, timeout_s=30)
        with pytest.raises(RuntimeError, match="CUDA error"):
            await frontend.close()
        return res, health, late

    res, health, late = asyncio.run(asyncio.wait_for(scenario(), 60))
    assert health["pump_alive"] is False
    assert all(r.status == "truncated" and len(r.tokens) < 50 for r in res)
    # a request after the pump stopped is refused, not left waiting
    assert late.http_status == 503, late
    assert late.summary["error"] == "engine stopped"


# ---- the client against a scripted server (test_client_retry.py) -------------


def _ok_stream(tokens, summary):
    lines = [json.dumps({"token": t}) for t in tokens] + [json.dumps(summary)]
    body = b"".join(
        f"{len(line) + 1:x}\r\n".encode() + (line + "\n").encode() + b"\r\n"
        for line in lines) + b"0\r\n\r\n"
    return (b"HTTP/1.1 200 OK\r\nContent-Type: application/x-ndjson\r\n"
            b"Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n" + body)


OK = _ok_stream([5, 6], {"done": True, "status": "completed", "n_tokens": 2})
SHED = _unavailable({"error": "overloaded", "status": "shed"})
PLAIN_503 = _json_response(503, {"error": "overloaded", "status": "shed"})


class _FakeServer:
    """One scripted raw response per connection; ``None`` aborts the
    connection before answering (a retryable transport error)."""

    def __init__(self, script):
        self.script = list(script)
        self.hits = 0
        self._server = None
        self.addr = None

    async def _handle(self, reader, writer):
        head = await reader.readuntil(b"\r\n\r\n")
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-length:"):
                await reader.readexactly(int(line.split(b":")[1]))
        resp = self.script[min(self.hits, len(self.script) - 1)]
        self.hits += 1
        if resp is None:
            writer.transport.abort()
            return
        writer.write(resp)
        await writer.drain()
        writer.close()

    async def __aenter__(self):
        self._server = await asyncio.start_server(self._handle,
                                                  "127.0.0.1", 0)
        self.addr = self._server.sockets[0].getsockname()[:2]
        return self

    async def __aexit__(self, *exc):
        self._server.close()
        await self._server.wait_closed()


def _run(script, **kw):
    sleeps = []

    async def fake_sleep(s):
        sleeps.append(s)

    async def go():
        async with _FakeServer(script) as srv:
            res = await tserver.stream_generate(
                *srv.addr, [3, 4], max_new_tokens=2, sleep=fake_sleep, **kw)
            return res, srv.hits

    res, hits = asyncio.run(go())
    return res, hits, sleeps


def test_wire_format_equals_the_references():
    from repro.server.frontend import _json_response as j_json
    from repro.server.frontend import _unavailable as j_unavailable
    obj = {"error": "overloaded", "status": "shed", "uid": 3}
    assert _unavailable(obj) == j_unavailable(obj)
    assert _json_response(404, obj) == j_json(404, obj)


def test_503s_retried_until_success_honouring_retry_after():
    res, hits, sleeps = _run(
        [SHED, SHED, OK],
        retry=tserver.RetryPolicy(max_retries=3, backoff_s=0.01, seed=1))
    assert res.ok and res.tokens == [5, 6]
    assert res.attempts == 3 and hits == 3
    assert sleeps == [1.0, 1.0]


def test_backoff_used_when_503_lacks_retry_after():
    res, hits, sleeps = _run(
        [PLAIN_503, PLAIN_503, PLAIN_503, OK],
        retry=tserver.RetryPolicy(max_retries=5, backoff_s=0.05,
                                  multiplier=2.0, jitter=0.1, seed=9))
    assert res.ok and res.attempts == 4
    want = jserver.RetryPolicy(max_retries=5, backoff_s=0.05, multiplier=2.0,
                               jitter=0.1, seed=9)
    assert sleeps == [want.delay_s(k) for k in range(3)]


def test_transport_errors_retried_then_succeed():
    res, hits, sleeps = _run(
        [None, None, OK],
        retry=tserver.RetryPolicy(max_retries=3, backoff_s=0.01, seed=2))
    assert res.ok and res.attempts == 3 and hits == 3
    assert len(sleeps) == 2


def test_transport_error_propagates_without_retry_policy():
    async def go():
        async with _FakeServer([None]) as srv:
            await tserver.stream_generate(*srv.addr, [3], max_new_tokens=1)

    with pytest.raises(RETRYABLE_ERRORS):
        asyncio.run(go())


def test_exhausted_retries_return_last_503():
    res, hits, sleeps = _run(
        [SHED], retry=tserver.RetryPolicy(max_retries=2, backoff_s=0.01,
                                          seed=3))
    assert res.http_status == 503 and not res.ok
    assert res.status == "shed"
    assert res.attempts == 3 and hits == 3
    assert res.headers.get("retry-after") == "1"


def test_no_retry_by_default_on_503():
    res, hits, sleeps = _run([SHED, OK])
    assert res.http_status == 503
    assert res.attempts == 1 and hits == 1 and sleeps == []


# ---- the launcher ------------------------------------------------------------


def test_launcher_trace_writes_the_jax_launchers_json(tmp_path, monkeypatch,
                                                      capsys):
    trace = tmp_path / "trace.ndjson"
    jserver.save_trace(jserver.TrafficGenerator(jserver.TrafficConfig(
        rate_rps=12.0, duration_s=2.0, seed=4, max_prompt_len=5,
        max_gen_len=6)).events(), str(trace))
    flags = ["--arch", "phi4-mini-3.8b", "--smoke", "--backend", "reference",
             "--trace", str(trace), "--slots", "2", "--policy", "priority",
             "--max-pending", "3", "--step-cost", "0.05"]
    t_out, j_out = tmp_path / "torch.json", tmp_path / "jax.json"
    t_launch.main(flags + ["--device", "cpu", "--json-out", str(t_out)])
    monkeypatch.setattr(sys, "argv", ["serve"] + flags
                        + ["--json-out", str(j_out)])
    j_launch.main()
    capsys.readouterr()
    t, j = json.loads(t_out.read_text()), json.loads(j_out.read_text())
    assert list(t) == list(j)
    t.pop("wall_s"), j.pop("wall_s")
    assert t == j
    assert t["shed"] > 0 and t["completed"] > 0


def test_launcher_serves_http_and_drains_on_sigint(tmp_path):
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "phi4-mini-3.8b", "--smoke", "--device", "cpu", "--serve-http",
         "127.0.0.1:0", "--metrics", str(tmp_path / "m.prom")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = []
        reader = threading.Thread(
            target=lambda: first.append(proc.stdout.readline()), daemon=True)
        reader.start()
        reader.join(120)
        assert first and first[0].startswith("serving on http://"), \
            proc.stderr.read() if proc.poll() is not None else first
        host, port = first[0].split("http://")[1].split()[0].rsplit(":", 1)
        res = asyncio.run(tserver.stream_generate(host, int(port), [5, 6, 7],
                                                  max_new_tokens=4))
        health = asyncio.run(tserver.get_json(host, int(port), "/healthz"))
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert res.ok and res.status == "completed" and len(res.tokens) == 4
    assert health["pump_alive"] is True and health["backend"] is None
    assert proc.returncode == 0, err
    assert "drained=True; served 1 completed / 0 shed / 4 tokens" in out
    assert "serve_tokens_generated_total 4" in (tmp_path / "m.prom").read_text()
