"""Batched serving engines.

``ServeEngine`` is the production path: **continuous (per-slot) batching**.
A ``SlotScheduler`` admits a request into any free decode slot mid-flight;
its prompt is absorbed in one batched ``api.prefill`` call (SSM/hybrid
families, whose state is O(1), absorb token-by-token at batch 1) and the
resulting batch-1 state is scattered into the live batch with
``api.slot_update`` — no other slot recomputes anything.  Each model step
then decodes one token for every occupied slot; a finished request's slot is
refilled on the very next iteration.  Mixed prompt/output lengths therefore
never head-of-line block: per-request outputs are bit-identical to a
``slots=1`` reference decode while total model steps drop strictly below the
wave engine's on mixed workloads.

``WaveServeEngine`` is the legacy wave-scheduled static batcher, kept as the
benchmark baseline: it forms waves of up to ``slots`` requests, left-pads
prompts to a common length with BOS and decodes until the *whole wave*
finishes — the head-of-line blocking the continuous engine removes.

Both engines share ``EngineStats`` telemetry: prefill vs decode model calls,
per-request TTFT, per-slot occupancy, and honest completion accounting —
requests cut short by the step budget or ``max_len`` are reported as
``truncated`` (never ``completed``), and requests still queued when the
budget runs out are ``unserved``.

``ServeEngine(backend=...)`` selects the ``repro_torch.backend`` execution
target for ALL model GEMMs: ``backend="reference"`` runs every one of them
through the hand-written ``systolic_mac`` kernel, with per-step
per-partition Razor flags (``backend_step_flags``) and the backend's
lifetime call/MAC/flag summary (``backend_telemetry``) in ``EngineStats``.

Counterpart of ``repro.serve.engine``.  What differs: the engines run on
``device`` (``None`` means the GPU; without one they raise), model steps are
plain eager calls under ``torch.inference_mode()`` (nothing is compiled, so
a new prompt length costs nothing extra), the decode state is updated in
place, and the next token is the arg-max taken on the device — ``slots``
integers cross to the host per step, not the ``(slots, V)`` logits.

Both engines read wall-clock time through an injectable ``clock`` callable
(default ``time.monotonic``): every latency stamp — ``Request.submit_t`` /
``first_token_t`` / ``finish_t`` and therefore ``ttft_s`` — comes from it,
so tests and a traffic harness swap in a virtual clock
and get bit-deterministic latency telemetry.

``ServeEngine(policy="priority", max_pending=N)`` forwards QoS admission to
the ``SlotScheduler``: priority tiers, TTFT-deadline shedding, and
bounded-queue backpressure (``submit()`` then returns False for a shed
request, and ``EngineStats.shed`` counts every drop).  The default is
``policy="fifo"``, unbounded.

Every engine owns a ``repro_torch.obs.ObsBus`` sharing its clock:
``EngineStats`` scalar counters are registry-backed views (one source of
truth behind ``GET /metrics``), request lifecycle events
(submit/admit/prefill/decode-step/guard/finish) flow through the tracer
into the flight-recorder ring, and per-step backend telemetry lands as
flag/replay/energy counters + rate gauges.  Pass ``obs=ObsBus(
enabled=False)`` to disable tracing while keeping the stats registry.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ModelConfig, ShapeConfig
from ..models import model_api
from ..obs import ObsBus, to_plain
from .scheduler import Request, SlotScheduler

Pytree = Any

BOS = 2


# scalar EngineStats fields and the registry counters that back them
# (field -> (metric name, help)); declaration order pins to_dict()'s
# legacy key order
_STAT_COUNTERS = (
    ("prefill_steps", "serve_prefill_steps_total",
     "model calls spent absorbing prompts"),
    ("decode_steps", "serve_decode_steps_total",
     "batched one-token decode calls"),
    ("waves", "serve_waves_total", "wave-engine waves formed"),
    ("admitted", "serve_requests_admitted_total",
     "requests admitted into a decode slot"),
    ("completed", "serve_requests_completed_total",
     "requests served their full max_new_tokens"),
    ("truncated", "serve_requests_truncated_total",
     "requests cut short by budget or max_len"),
    ("unserved", "serve_requests_unserved_total",
     "requests still queued at drain"),
    ("shed", "serve_requests_shed_total",
     "requests dropped by admission (bounded queue / deadline)"),
    ("cancelled", "serve_requests_cancelled_total",
     "requests abandoned by the caller (disconnect/timeout)"),
    ("tokens_generated", "serve_tokens_generated_total",
     "tokens emitted to callers"),
)


class EngineStats:
    """Engine telemetry, now a *view* over an ``ObsBus`` registry.

    Scalar counters (``prefill_steps`` .. ``tokens_generated``) are
    properties backed by registry counters — ``stats.completed += 1``
    and a ``GET /metrics`` scrape read the same cell, so there is one
    source of truth and nothing to double-count.  Aggregate fields
    (per-slot occupancy lists, TTFT samples, hwloop/backend summaries)
    stay plain attributes.  ``to_dict()`` is bit-compatible with the
    pre-bus dataclass serialization (same keys, same order, same
    values).
    """

    def __init__(self, slot_busy_steps: Optional[List[int]] = None,
                 backend: Optional[str] = None, obs=None) -> None:
        self.obs = obs if obs is not None else ObsBus()
        reg = self.obs.registry
        self._counters = {
            field: reg.counter(metric, help)
            for field, metric, help in _STAT_COUNTERS}
        self._ttft_hist = reg.histogram(
            "serve_ttft_seconds", "submit to first emitted token (s)")
        self.slot_busy_steps: List[int] = list(slot_busy_steps or [])
        self.ttft_s: List[float] = []
        # hardware-in-the-loop emulation telemetry (continuous engine with
        # a hwloop loop attached; empty/None otherwise): per
        # decode step the per-partition Razor flags, plus its
        # final summary (flag rates, rails, recalibrations, energy/token)
        self.hwloop_step_flags: List[List[bool]] = []
        self.hwloop: Optional[Dict[str, Any]] = None
        # execution-backend telemetry (continuous engine with a non-ideal
        # repro_torch.backend attached): the backend's name, per-decode-step
        # per-partition Razor flags from the REAL model GEMMs, and the
        # backend's lifetime summary (flags, replays, energy/token)
        self.backend: Optional[str] = backend
        self.backend_step_flags: List[List[bool]] = []
        self.backend_telemetry: Optional[Dict[str, Any]] = None
        # ABFT guard events (GuardedBackend only): one entry per decode
        # step on which the guard did anything — {"step": decode step
        # index, plus the non-zero guard_* counters of that step's GEMMs}
        self.guard_step_events: List[Dict[str, int]] = []
        # closed-loop rail autoscaler summary (continuous engine with a
        # rail autoscaler attached; None otherwise): policy,
        # final ladder level/rails, transition + heal-preemption counts
        self.railscale: Optional[Dict[str, Any]] = None

    def record_ttft(self, ttft: float) -> None:
        """One TTFT sample: keeps the raw list (bit-compatible to_dict)
        and feeds the latency histogram behind ``/metrics``."""
        self.ttft_s.append(ttft)
        self._ttft_hist.observe(ttft)

    @property
    def model_steps(self) -> int:
        """Total model invocations — the cost both engines are compared on."""
        return self.prefill_steps + self.decode_steps

    def occupancy(self) -> List[float]:
        """Per-slot fraction of decode steps spent on a live request."""
        d = max(self.decode_steps, 1)
        return [b / d for b in self.slot_busy_steps]

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {field: getattr(self, field)
                               for field, _, _ in _STAT_COUNTERS}
        out.update(
            slot_busy_steps=self.slot_busy_steps,
            ttft_s=self.ttft_s,
            hwloop_step_flags=self.hwloop_step_flags,
            hwloop=self.hwloop,
            backend=self.backend,
            backend_step_flags=self.backend_step_flags,
            backend_telemetry=self.backend_telemetry,
            guard_step_events=self.guard_step_events,
            railscale=self.railscale,
            model_steps=self.model_steps,
            occupancy=self.occupancy(),
            ttft_mean_s=(sum(self.ttft_s) / len(self.ttft_s)
                         if self.ttft_s else None),
        )
        return to_plain(out)


def _counter_property(field: str) -> property:
    def fget(self) -> int:
        return int(self._counters[field].value())

    def fset(self, value) -> None:
        self._counters[field].set(float(value))

    return property(fget, fset)


for _field, _metric, _help in _STAT_COUNTERS:
    setattr(EngineStats, _field, _counter_property(_field))
del _field, _metric, _help


class ServeEngine:
    """Continuous-batching engine over a fixed number of decode slots."""

    def __init__(self, cfg: ModelConfig, params: Pytree, slots: int = 4,
                 max_len: int = 128, hwloop=None, backend=None,
                 clock: Callable[[], float] = time.monotonic,
                 policy: str = "fifo", max_pending: Optional[int] = None,
                 obs: Optional[ObsBus] = None, autoscaler=None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._clock = clock
        # one ObsBus per engine (never process-global: virtual-time runs
        # must replay bit-identically), sharing the engine clock so
        # latency histograms are deterministic under the load harness
        self.obs = obs if obs is not None else ObsBus(clock=clock)
        # execution backend for ALL model GEMMs (a repro_torch.backend name
        # or instance): "reference" runs every one of them through the
        # systolic_mac kernel with call/MAC/flag telemetry
        if backend is not None:
            from ..backend import MatmulBackend, get_backend
            if not isinstance(backend, MatmulBackend):
                backend = get_backend(backend, device=self.device)
        self.backend = backend
        self._track_backend = backend is not None and not backend.is_ideal
        self.api = model_api(cfg, backend=backend, device=self.device)
        self.params = params
        self.slots = slots
        self.max_len = max_len
        # optional hwloop object (duck-typed; the hwloop package is not
        # ported yet, so nothing constructs one).  Legacy mode (no emulated backend): each
        # decode step's emitted tokens drive one probe-traffic accelerator
        # step.  With an emulated backend it becomes a THIN ADAPTER:
        # no probe traffic — the backend's real per-step GEMM flags feed its
        # CalibrationWatchdog, and rail heals land on the serving device.
        self.hwloop = hwloop
        self._hwloop_adapter = (hwloop is not None
                                and hasattr(backend, "accel"))
        if self._hwloop_adapter:
            self.hwloop.attach_accelerator(backend.accel)
            if backend.is_guarded:
                # the guard's escalation ladder heals rails THROUGH the
                # watchdog rather than jumping straight to nominal
                backend.attach_session(hwloop)
        self.scheduler = SlotScheduler(slots, policy=policy,
                                       max_pending=max_pending, clock=clock,
                                       obs=self.obs)
        self.stats = EngineStats(
            slot_busy_steps=[0] * slots,
            backend=backend.name if backend is not None else None,
            obs=self.obs)
        reg = self.obs.registry
        self._g_queue_depth = reg.gauge(
            "serve_queue_depth", "requests waiting for a decode slot")
        self._g_active = reg.gauge(
            "serve_active_slots", "slots serving a live request")
        reg.gauge("serve_slots", "configured decode slots").set(slots)
        self._h_queue_wait = reg.histogram(
            "serve_queue_wait_seconds", "submit to slot admission (s)")
        if backend is not None and hasattr(backend, "attach_obs"):
            backend.attach_obs(self.obs)   # callback latency + guard events
        if hwloop is not None and hasattr(hwloop, "attach_obs"):
            hwloop.attach_obs(self.obs)    # recalibrations + rail gauges
        if self._track_backend:
            self._c_gemms = reg.counter(
                "backend_gemm_calls_total", "backend matmul invocations")
            self._c_macs = reg.counter(
                "backend_macs_total", "multiply-accumulates executed")
            self._c_flags = reg.counter(
                "backend_flags_total", "Razor DETECTED flags raised")
            self._c_replays = reg.counter(
                "backend_replays_total", "partition-cycle replays")
            self._c_energy = reg.counter(
                "backend_energy_joules_total", "emulated array energy (J)")
            self._g_flag_rate = reg.gauge(
                "serve_flag_rate",
                "lifetime flags per partition-step observation")
            self._g_replay_rate = reg.gauge(
                "serve_replay_rate", "lifetime replays per GEMM call")
            self._g_energy_per_token = reg.gauge(
                "serve_energy_per_token_joules",
                "lifetime backend energy / tokens generated (J)")
            self._c_guard = reg.counter(
                "guard_events_total",
                "ABFT guard escalation events by kind", labels=("kind",))
            self._flag_slots = 0   # partition-step observations seen
        # optional rail autoscaler (duck-typed; not ported yet): closed-loop
        # energy-aware rail control.  Attached last so it sees the fully
        # wired ObsBus/hwloop; ticked once per decode step AFTER that
        # step's telemetry (queue gauges, backend counters, hwloop
        # flags/heals) has been published — its decisions read only the
        # registry, so virtual-time runs stay bit-deterministic.
        self.autoscaler = autoscaler
        if autoscaler is not None:
            autoscaler.attach(self)
        self._shape = ShapeConfig("serve", max_len, slots, "decode")
        self._sub_shape = ShapeConfig("serve", max_len, 1, "decode")
        self._state = self.api.make_decode_state(self._shape)
        self._cur = np.full((slots,), BOS, np.int32)   # next token per slot
        self._step = self.api.decode_step
        # dense/moe/vlm/encdec absorb the whole prompt in ONE prefill call;
        # SSM/hybrid state is O(1) so the prompt is absorbed by decode steps
        # at batch 1.
        self._has_prefill = cfg.family in ("dense", "moe", "vlm", "encdec")

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        """Host token ids -> an int64 index tensor on the engine's device."""
        return torch.as_tensor(np.asarray(toks, np.int64), device=self.device)

    # ---- intake --------------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Queue a request.  Returns False when the scheduler shed it on
        admission (bounded queue under the priority policy) — the request
        never decodes and ``EngineStats.shed`` counts it."""
        req.submit_t = self._clock()
        accepted = self.scheduler.submit(req)
        self.stats.shed = self.scheduler.n_shed
        self._g_queue_depth.set(self.scheduler.n_pending)
        self.obs.event("request_submitted", uid=req.uid,
                       priority=getattr(req.priority, "name",
                                        str(req.priority)),
                       accepted=accepted,
                       queue_depth=self.scheduler.n_pending)
        return accepted

    # for callers poking at the backlog (launchers, tests)
    @property
    def queue(self):
        return self.scheduler.pending

    # ---- prompt absorption ---------------------------------------------------

    def _absorb(self, req: Request):
        """Absorb one request's prompt at batch 1.

        Returns (last-position logits (1, V), batch-1 decode state, model
        calls spent)."""
        prompt = req.prompt if req.prompt else [BOS]
        toks = self._tokens(np.asarray(prompt)[None, :])
        if self._has_prefill:
            logits, sub = self.api.prefill(self.params, {"tokens": toks},
                                           max_len=self.max_len)
            return logits, sub, 1
        sub = self.api.make_decode_state(self._sub_shape)
        logits = None
        for t in range(toks.shape[1]):
            logits, sub = self._step(self.params, sub, toks[:, t:t + 1])
        return logits, sub, toks.shape[1]

    # ---- engine loop ---------------------------------------------------------

    def _emit(self, slot: int, req: Request, tok: int) -> None:
        req.out_tokens.append(tok)
        if req.first_token_t is None:
            req.first_token_t = self._clock()
            if req.submit_t is not None:
                self.stats.record_ttft(req.first_token_t - req.submit_t)
        self._cur[slot] = tok
        self.stats.tokens_generated += 1
        if req.on_token is not None:
            req.on_token(req, tok)

    def _finished(self, req: Request) -> None:
        """Terminal-state bookkeeping shared by every finish site.

        ``fire_finish`` is idempotent, so a request that reaches several
        terminal paths (e.g. cancelled by the client while the drain loop
        truncates it) still delivers ``on_finish`` exactly once."""
        req.finish_t = self._clock()
        self.obs.event("request_finished", uid=req.uid, status=req.status,
                       n_tokens=len(req.out_tokens))
        req.fire_finish()

    def _reap_cancelled(self) -> None:
        """Release slots (and queue positions) of requests their caller
        abandoned — client disconnect / request timeout.  A cancelled request
        is terminal but neither completed nor truncated."""
        for slot, req in list(self.scheduler.active.items()):
            if req.cancelled and not req.done:
                req.done = True
                self.stats.cancelled += 1
                self.scheduler.evict(slot)
                self._cur[slot] = BOS
                self._finished(req)
        if any(r.cancelled for r in self.scheduler.pending):
            keep: List[Request] = []
            for req in self.scheduler.pending:
                if req.cancelled and not req.done:
                    req.done = True
                    self.stats.cancelled += 1
                    self._finished(req)
                else:
                    keep.append(req)
            self.scheduler.pending = collections.deque(keep)

    def _maybe_finish(self, slot: int, req: Request) -> None:
        # generating n tokens writes n-1 of them into the cache (positions
        # plen .. plen+n-2), so n <= max_len - plen keeps a safety margin
        cap = self.max_len - max(len(req.prompt), 1)
        if len(req.out_tokens) >= req.max_new_tokens:
            req.done = True
            self.stats.completed += 1
            self.scheduler.evict(slot)
            self._cur[slot] = BOS          # idle slots are fed BOS
            self._finished(req)
        elif len(req.out_tokens) >= cap:
            req.done = req.truncated = True
            self.stats.truncated += 1
            self.scheduler.evict(slot)
            self._cur[slot] = BOS
            self._finished(req)

    def _admit(self, budget: int) -> int:
        """Fill free slots until the queue, the slots, or the budget run out.
        Absorption is atomic per request, so the budget can overshoot by at
        most one prompt's absorption cost.  Returns model calls used."""
        used = 0
        while used < budget:
            admissions = self.scheduler.admit()
            if not admissions:
                break
            deferred = []
            for slot, req in admissions:
                if used >= budget:
                    deferred.append((slot, req))
                    continue
                if len(req.prompt) >= self.max_len:
                    # cannot absorb at all: report, never serve garbage
                    req.done = req.truncated = True
                    self.stats.truncated += 1
                    self.scheduler.evict(slot)
                    self._finished(req)
                    continue
                wait_s = (self._clock() - req.submit_t
                          if req.submit_t is not None else 0.0)
                self._h_queue_wait.observe(wait_s)
                self.obs.event("request_admitted", uid=req.uid, slot=slot,
                               queue_wait_s=wait_s)
                with self.obs.span("prefill", uid=req.uid, slot=slot,
                                   prompt_len=len(req.prompt)):
                    logits, sub, n = self._absorb(req)
                used += n
                self.stats.prefill_steps += n
                self.stats.admitted += 1
                self._state = self.api.slot_update(self._shape, self._state,
                                                   slot, sub)
                self._emit(slot, req, int(logits[0].argmax()))
                self._maybe_finish(slot, req)   # max_new_tokens == 1
            if deferred:
                # out of budget mid-batch: hand the slots back and restore
                # the requests to the FRONT of the queue in FIFO order
                for slot, req in reversed(deferred):
                    self.scheduler.evict(slot)
                    self.scheduler.pending.appendleft(req)
                break
        return used

    def _publish_backend_step(self, tel, step_flags: List[bool]) -> None:
        """Fold one decode step's backend telemetry into the registry:
        cumulative counters plus the derived rate/energy gauges the
        autoscaler reads as control inputs."""
        self._c_gemms.inc(max(float(tel.calls), 0.0))
        self._c_macs.inc(max(float(tel.macs), 0.0))
        self._c_flags.inc(max(float(tel.flags), 0.0))
        self._c_replays.inc(max(float(tel.replays), 0.0))
        self._c_energy.inc(max(float(tel.energy_j), 0.0))
        self._flag_slots += len(step_flags)
        if self._flag_slots:
            self._g_flag_rate.set(
                self._c_flags.value() / self._flag_slots)
        calls = self._c_gemms.value()
        if calls:
            self._g_replay_rate.set(self._c_replays.value() / calls)
        tokens = self.stats.tokens_generated
        if tokens:
            self._g_energy_per_token.set(
                self._c_energy.value() / tokens)

    def step(self, budget: int = 2 ** 31) -> int:
        """One engine iteration: admit into free slots, then one batched
        decode step.  Idle slots are fed BOS and skipped in argmax/token
        bookkeeping.  Returns model calls used."""
        self._reap_cancelled()
        used = self._admit(budget)
        self.stats.shed = self.scheduler.n_shed
        self._reap_cancelled()
        if not self.scheduler.active or used >= budget:
            return used
        if self._track_backend:
            # prefill GEMM telemetry stays in the backend totals but must not
            # pollute the next decode step's flag vector
            self.backend.pop_telemetry()
        span = self.obs.span("decode_step", step=self.stats.decode_steps,
                             active=len(self.scheduler.active))
        logits, self._state = self._step(self.params, self._state,
                                         self._tokens(self._cur[:, None]))
        self.stats.decode_steps += 1
        used += 1
        next_tok = logits.argmax(dim=-1).tolist()   # `slots` ints to the host
        step_tokens: List[int] = []
        for slot, req in list(self.scheduler.active.items()):
            self.stats.slot_busy_steps[slot] += 1
            tok = next_tok[slot]
            self._emit(slot, req, tok)
            step_tokens.append(tok)
            self._maybe_finish(slot, req)
        step_flags: Optional[List[bool]] = None
        if self._track_backend:
            tel = self.backend.pop_telemetry()   # this decode step's GEMMs
            step_flags = [bool(f) for f in (tel.partition_flags or [])]
            self.stats.backend_step_flags.append(step_flags)
            self.backend.add_tokens(len(step_tokens))
            self._publish_backend_step(tel, step_flags)
            if self.backend.is_guarded:
                ev = {k: int(getattr(tel, k)) for k in (
                    "guard_detected", "guard_corrected", "guard_retries",
                    "guard_heals", "guard_uncorrected")
                    if getattr(tel, k)}
                if ev:
                    self.stats.guard_step_events.append(
                        {"step": self.stats.decode_steps - 1, **ev})
                    self.obs.event("guard_step",
                                   step=self.stats.decode_steps - 1, **ev)
                    for k, v in ev.items():
                        self._c_guard.inc(v, kind=k[len("guard_"):])
        span.set(tokens=len(step_tokens),
                 flags=sum(step_flags) if step_flags else 0)
        span.end()
        self._g_queue_depth.set(self.scheduler.n_pending)
        self._g_active.set(len(self.scheduler.active))
        if self.hwloop is not None and step_tokens:
            if self._hwloop_adapter:
                # thin adapter: real GEMM flags -> watchdog -> rail heal
                self.hwloop.observe_flags(step_flags or [])
                self.stats.hwloop_step_flags.append(step_flags or [])
            else:
                tel = self.hwloop.step(step_tokens, n_tokens=len(step_tokens))
                self.stats.hwloop_step_flags.append(
                    [bool(f) for f in np.asarray(tel.flags)])
        if self.autoscaler is not None:
            self.autoscaler.on_decode_step()
        return used

    def run_until_drained(self, max_steps: int = 10_000) -> EngineStats:
        budget = max_steps
        while not self.scheduler.drained() and budget > 0:
            used = self.step(budget)
            if used == 0:        # no admissible work fit in the budget
                break
            budget -= used
        # honest accounting on exhaustion: in-flight requests are truncated,
        # queued ones unserved — neither is "completed"
        for slot in list(self.scheduler.active):
            req = self.scheduler.evict(slot)
            req.done = req.truncated = True
            self.stats.truncated += 1
            self._finished(req)
        self.stats.unserved = self.scheduler.n_pending
        self.stats.shed = self.scheduler.n_shed
        if self.hwloop is not None:
            self.stats.hwloop = self.hwloop.summary()
        if self._track_backend:
            self.stats.backend_telemetry = self.backend.summary()
        if self.autoscaler is not None:
            self.stats.railscale = self.autoscaler.summary()
        return self.stats


class WaveServeEngine:
    """Legacy wave-scheduled static batching (benchmark baseline).

    Forms waves of up to ``slots`` requests, left-pads prompts to a common
    length with BOS (a *valid* model input — no masking surgery needed, so
    the engine is correct for every family including SSM/hybrid states),
    absorbs the prompt teacher-forced, then decodes greedily until every
    request in the wave completes — the head-of-line blocking that
    ``ServeEngine`` removes.
    """

    def __init__(self, cfg: ModelConfig, params: Pytree, slots: int = 4,
                 max_len: int = 128,
                 clock: Callable[[], float] = time.monotonic,
                 obs: Optional[ObsBus] = None, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._clock = clock
        self.obs = obs if obs is not None else ObsBus(clock=clock)
        self.api = model_api(cfg, device=self.device)
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.queue: Deque[Request] = collections.deque()   # O(1) pops
        self.stats = EngineStats(slot_busy_steps=[0] * slots, obs=self.obs)
        self._shape = ShapeConfig("serve", max_len, slots, "decode")
        self._step = self.api.decode_step

    def _tokens(self, toks: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(toks, np.int64), device=self.device)

    def submit(self, req: Request) -> None:
        req.submit_t = self._clock()
        self.queue.append(req)

    def run_until_drained(self, max_steps: int = 10_000) -> EngineStats:
        budget = max_steps
        while self.queue and budget > 0:
            wave = [self.queue.popleft()
                    for _ in range(min(self.slots, len(self.queue)))]
            budget -= self._run_wave(wave, budget)
        self.stats.unserved = len(self.queue)
        return self.stats

    def _run_wave(self, wave: List[Request], budget: int) -> int:
        self.stats.waves += 1
        n = len(wave)
        plen = max(max(len(r.prompt) for r in wave), 1)
        toks = np.full((self.slots, plen), BOS, np.int32)
        for i, r in enumerate(wave):
            if r.prompt:
                toks[i, plen - len(r.prompt):] = r.prompt   # BOS-prefix pad
        state = self.api.make_decode_state(self._shape)
        steps = 0

        # absorb prompt (teacher-forced): feed all plen prompt positions; the
        # logits from the last feed predict each request's first new token
        logits = None
        for t in range(plen):
            logits, state = self._step(self.params, state,
                                       self._tokens(toks[:, t:t + 1]))
            self.stats.prefill_steps += 1
            steps += 1

        cur = np.full((self.slots,), BOS, np.int32)
        cur[:n] = logits[:n].argmax(dim=-1).tolist()   # idle rows skipped
        max_new = max(r.max_new_tokens for r in wave)
        self.stats.admitted += n
        for _ in range(min(max_new, self.max_len - plen - 1,
                           max(budget - steps, 0))):
            for i, r in enumerate(wave):
                if not r.done:
                    r.out_tokens.append(int(cur[i]))
                    if r.first_token_t is None:
                        r.first_token_t = self._clock()
                        if r.submit_t is not None:
                            self.stats.record_ttft(
                                r.first_token_t - r.submit_t)
                    self.stats.tokens_generated += 1
                    if len(r.out_tokens) >= r.max_new_tokens:
                        r.done = True
                        r.finish_t = self._clock()
                        self.stats.completed += 1
                        r.fire_finish()
            if all(r.done for r in wave):
                break
            logits, state = self._step(self.params, state,
                                       self._tokens(cur[:, None]))
            self.stats.decode_steps += 1
            steps += 1
            for i, r in enumerate(wave):
                if not r.done:
                    self.stats.slot_busy_steps[i] += 1
            cur[:n] = logits[:n].argmax(dim=-1).tolist()
        for r in wave:
            if not r.done:
                # ran out of budget or cache length: this request did NOT
                # receive its max_new_tokens — report it truncated
                r.done = r.truncated = True
                r.finish_t = self._clock()
                self.stats.truncated += 1
                r.fire_finish()
        return steps
