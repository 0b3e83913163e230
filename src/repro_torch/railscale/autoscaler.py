"""Autoscaler driver: the closed loop between the ObsBus and the rails.

The port's counterpart of ``repro.railscale.autoscaler``, carried over
unchanged.

``ServeEngine(autoscaler=Autoscaler(table, "threshold"))`` hooks
:meth:`Autoscaler.on_decode_step` into the engine's decode loop, right
after the step's telemetry (queue gauges, backend counters, hwloop
flags) lands in the registry.  Every ``decide_every`` decode steps the
driver samples :class:`~repro_torch.railscale.policy.RailSignals` off the
registry — plain float reads, no tensor anywhere on the decision path —
asks the policy for a target ladder level, and actuates through the
:class:`~repro_torch.railscale.clamp.GuardbandClamp` onto the engine's
``HwLoopSession``.  Virtual-time harness runs are therefore
bit-deterministic: decisions depend only on step counts and telemetry,
never on wall-clock.

Watchdog coordination: the driver watches ``session.recalibrations``
every step.  A heal (the watchdog rewriting rails after persistent
flags) re-anchors the policy at the ladder level nearest the healed
rails, preempts the clamp's dwell timer, and opens a
``heal_holdoff_steps`` window during which the policy may boost toward
nominal but may not undervolt again — the just-healed partition gets
time to prove itself clean before the loop leans on it.

Everything observable is published: ``railscale_level`` /
``railscale_target_volts{partition}`` gauges,
``railscale_transitions_total{direction}``, and a ``railscale_decision``
trace event per window into the flight recorder.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from .clamp import GuardbandClamp
from .points import OperatingPointTable
from .policy import RailSignals, get_policy


class Autoscaler:
    """Closed-loop rail controller for one ``ServeEngine``.

    ``table``        — the operating-point ladder (level 0 = nominal).
    ``policy``       — name (``static``/``threshold``/``pid``) or a
                       ``RailPolicy`` instance.
    ``decide_every`` — decode steps per decision window.
    ``slo_ttft_s``   — TTFT SLO used to derive the headroom signal
                       (``None`` disables the SLO term).
    ``start_level``  — ladder level to snap the rails to at attach
                       (``None`` anchors at the level nearest the
                       device's current rails).
    """

    def __init__(self, table: OperatingPointTable, policy: Any = "threshold",
                 *, decide_every: int = 4, slo_ttft_s: Optional[float] = None,
                 start_level: Optional[int] = None,
                 max_step_v: float = 0.1, dwell_steps: int = 8,
                 heal_holdoff_steps: int = 16, **policy_kwargs: Any):
        if decide_every < 1:
            raise ValueError(f"decide_every must be >= 1, got {decide_every}")
        self.table = table
        self.policy = get_policy(policy, **policy_kwargs)
        self.decide_every = int(decide_every)
        self.slo_ttft_s = None if slo_ttft_s is None else float(slo_ttft_s)
        self.start_level = start_level
        self.heal_holdoff_steps = int(heal_holdoff_steps)
        self.clamp = GuardbandClamp(table.floor_v(), table.ceil_v(),
                                    max_step_v=max_step_v,
                                    dwell_steps=dwell_steps)
        self.level = 0
        self.session = None
        self._engine = None
        self._obs = None
        self._steps = 0
        self._decisions = 0
        self._transitions = {"up": 0, "down": 0}
        self._heal_preemptions = 0
        self._holdoff_until = -1
        self._recal_seen = 0
        # windowed-counter baselines (flags/calls and TTFT sum/count)
        self._prev_flags = 0.0
        self._prev_calls = 0.0
        self._prev_ttft_sum = 0.0
        self._prev_ttft_n = 0

    @property
    def is_static(self) -> bool:
        return getattr(self.policy, "name", None) == "static"

    # -- wiring ----------------------------------------------------------------

    def attach(self, engine) -> None:
        """Bind to a ``ServeEngine`` (called by the engine constructor).

        Non-static policies require the engine's ``HwLoopSession`` —
        that is the only sanctioned actuation path (its watchdog heals
        and the clamp share the same rails), and its partition count
        must match the table's."""
        if self._engine is not None:
            raise RuntimeError("Autoscaler is already attached to an engine; "
                               "build one Autoscaler per ServeEngine")
        session = getattr(engine, "hwloop", None)
        if session is None and not self.is_static:
            raise ValueError(
                f"the {self.policy.name!r} rail policy needs a hwloop "
                "session to actuate rails — construct the engine with "
                "ServeEngine(hwloop=HwLoopSession(...), ...)")
        if session is not None and (session.n_partitions
                                    != self.table.n_partitions):
            raise ValueError(
                f"operating-point table has {self.table.n_partitions} "
                f"partitions but the session device has "
                f"{session.n_partitions}")
        self._engine = engine
        self.session = session
        self._obs = engine.obs
        reg = self._obs.registry
        self._c_transitions = reg.counter(
            "railscale_transitions_total",
            "rail operating-point transitions by direction "
            "(down = deeper undervolt)", labels=("direction",))
        self._g_level = reg.gauge(
            "railscale_level",
            "current rail ladder level (0 = nominal rails)")
        self._g_target = reg.gauge(
            "railscale_target_volts",
            "autoscaler per-partition target rail voltage (V)",
            labels=("partition",))
        # engine-side metrics the signals sample (get-or-create: the
        # engine registered the real ones before attaching us)
        self._g_queue = reg.gauge(
            "serve_queue_depth", "requests waiting for a decode slot")
        self._g_active = reg.gauge(
            "serve_active_slots", "slots serving a live request")
        self._g_slots = reg.gauge("serve_slots", "configured decode slots")
        self._g_replay_rate = reg.gauge(
            "serve_replay_rate", "lifetime replays per GEMM call")
        self._g_energy = reg.gauge(
            "serve_energy_per_token_joules",
            "lifetime backend energy / tokens generated (J)")
        self._c_flags = reg.counter(
            "backend_flags_total", "Razor DETECTED flags raised")
        self._c_gemms = reg.counter(
            "backend_gemm_calls_total", "backend matmul invocations")
        self._h_ttft = reg.histogram(
            "serve_ttft_seconds", "submit to first emitted token (s)")
        if session is not None:
            self._recal_seen = int(session.recalibrations)
            if self.start_level is not None and not self.is_static:
                self.level = int(self.start_level)
                self.clamp.snap(session, self.table.rails(self.level))
            else:
                self.level = self.table.nearest_level(session.rails)
        self._publish_level()

    def _publish_level(self) -> None:
        self._g_level.set(float(self.level))
        for p, v in enumerate(self.table.rails(self.level)):
            self._g_target.set(float(v), partition=str(p))

    # -- sensing ---------------------------------------------------------------

    def read_signals(self) -> RailSignals:
        """Sample one decision window's control inputs off the registry.
        Counter-backed signals (flag rate, TTFT) are windowed deltas
        since the previous decision, so the policy reacts to *recent*
        behavior rather than lifetime averages."""
        flags = self._c_flags.value()
        calls = self._c_gemms.value()
        d_flags = flags - self._prev_flags
        d_calls = calls - self._prev_calls
        self._prev_flags, self._prev_calls = flags, calls
        flag_rate = d_flags / d_calls if d_calls > 0 else 0.0

        headroom: Optional[float] = None
        _, ttft_sum, ttft_n = self._h_ttft.snapshot()
        if self.slo_ttft_s and ttft_n > self._prev_ttft_n:
            recent = ((ttft_sum - self._prev_ttft_sum)
                      / (ttft_n - self._prev_ttft_n))
            headroom = 1.0 - recent / self.slo_ttft_s
        self._prev_ttft_sum, self._prev_ttft_n = ttft_sum, ttft_n

        slots = max(self._g_slots.value(), 1.0)
        energy = self._g_energy.value()
        return RailSignals(
            step=self._steps,
            queue_depth=self._g_queue.value(),
            active_frac=self._g_active.value() / slots,
            flag_rate=flag_rate,
            replay_rate=self._g_replay_rate.value(),
            energy_per_token_j=energy if energy > 0 else None,
            ttft_headroom=headroom)

    # -- the loop --------------------------------------------------------------

    def _check_heal(self) -> None:
        """A watchdog recalibration rewrote the rails: re-anchor at the
        healed level, preempt the dwell timer, and open the holdoff
        window that blocks immediate re-undervolting."""
        recals = int(self.session.recalibrations)
        if recals == self._recal_seen:
            return
        self._recal_seen = recals
        self._heal_preemptions += 1
        self._holdoff_until = self._steps + self.heal_holdoff_steps
        self.level = self.table.nearest_level(self.session.rails)
        self.clamp.notify_heal(self._steps)
        self._publish_level()
        self._obs.event("railscale_heal_preempt", step=self._steps,
                        level=self.level,
                        holdoff_until=self._holdoff_until)

    def on_decode_step(self) -> None:
        """Engine hook: called once per decode step, after that step's
        telemetry has been published."""
        self._steps += 1
        if self.is_static or self.session is None:
            return
        self._check_heal()
        if self._steps % self.decide_every:
            return
        signals = self.read_signals()
        self._decisions += 1
        target = int(self.policy.decide(signals, self.level, self.table))
        target = min(max(target, 0), len(self.table) - 1)
        held_off = target > self.level and self._steps < self._holdoff_until
        if held_off:
            target = self.level
        action = "hold"
        if target != self.level:
            boost = target < self.level   # toward nominal: urgent
            applied = self.clamp.apply(self.session,
                                       self.table.rails(target),
                                       self._steps, urgent=boost)
            if applied is None:
                action = "dwell"
            else:
                direction = "up" if boost else "down"
                self._transitions[direction] += 1
                self._c_transitions.inc(direction=direction)
                self.level = target
                self._publish_level()
                action = direction
        elif held_off:
            action = "holdoff"
        self._obs.event(
            "railscale_decision", step=self._steps, action=action,
            level=self.level, policy=self.policy.name,
            queue_depth=signals.queue_depth,
            active_frac=round(signals.active_frac, 4),
            flag_rate=round(signals.flag_rate, 6),
            ttft_headroom=(None if signals.ttft_headroom is None
                           else round(signals.ttft_headroom, 4)),
            rails_v=[float(v) for v in np.asarray(self.session.rails)])

    # -- telemetry -------------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Plain-JSON lifetime summary for ``EngineStats.railscale``."""
        out: Dict[str, Any] = {
            "policy": getattr(self.policy, "name", "custom"),
            "levels": len(self.table),
            "level": self.level,
            "steps": self._steps,
            "decisions": self._decisions,
            "transitions": dict(self._transitions),
            "heal_preemptions": self._heal_preemptions,
            "slo_ttft_s": self.slo_ttft_s,
            "decide_every": self.decide_every,
        }
        if self.session is not None:
            out["rails_v"] = [float(v)
                              for v in np.asarray(self.session.rails)]
            out["target_rails_v"] = [float(v)
                                     for v in self.table.rails(self.level)]
        return out
