"""Rail policies: pure decision functions from telemetry to a ladder level.

The port's counterpart of ``repro.railscale.policy``, carried over
unchanged.

A policy sees one :class:`RailSignals` snapshot per decision window —
plain floats sampled off the ObsBus registry (queue depth, slot
occupancy, windowed flag/replay rates, energy/token, TTFT-SLO headroom).
No tensors, no device handles, no clocks: ``decide()`` maps (signals,
current level, table) -> target level, deterministically.  Actuation,
rate limiting, and watchdog coordination live in
:class:`~repro_torch.railscale.autoscaler.Autoscaler` +
:class:`~repro_torch.railscale.clamp.GuardbandClamp`; a policy can *request*
any level and the clamp still bounds what reaches the device.

Three built-ins (select by name via :func:`get_policy`):

``static``     hold the current level forever — bit-compatible with
               today's fixed-rail serving path.
``threshold``  hysteresis bands: boost one level toward nominal under
               pressure (deep queue, flag rate above the ceiling, thin
               TTFT headroom), descend one level toward NTC only when
               *comfortably* idle — the gap between the boost and
               descend bands is the hysteresis that prevents flapping.
``pid``        proportional-integral controller on a scalar load/SLO
               pressure term: zero pressure converges to the deepest
               (greenest) level, sustained pressure drives the operating
               point continuously back toward nominal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Type

try:  # Protocol is 3.8+; keep a runtime fallback for exotic interpreters
    from typing import Protocol
except ImportError:  # pragma: no cover
    Protocol = object  # type: ignore[assignment]


@dataclasses.dataclass(frozen=True)
class RailSignals:
    """One decision window's control inputs, all plain floats sampled
    from the ObsBus registry (never tensors)."""

    step: int                            # decode steps elapsed
    queue_depth: float                   # requests waiting for a slot
    active_frac: float                   # active slots / configured slots
    flag_rate: float                     # window flags per GEMM call
    replay_rate: float                   # lifetime replays per GEMM call
    energy_per_token_j: Optional[float]  # lifetime backend energy / tokens
    ttft_headroom: Optional[float]       # 1 - recent_ttft/SLO; None = no data


class RailPolicy(Protocol):
    """Anything with a ``name`` and a pure ``decide()`` is a policy."""

    name: str

    def decide(self, signals: RailSignals, level: int,
               table) -> int: ...


class StaticPolicy:
    """Hold whatever level the rails are at — today's behavior."""

    name = "static"

    def decide(self, signals: RailSignals, level: int, table) -> int:
        return level


class ThresholdPolicy:
    """Hysteresis bands on queue depth, flag rate, and TTFT headroom.

    Boost (one level toward nominal) when ANY pressure signal trips:
    ``queue_depth > queue_high``, ``flag_rate >= flag_high``, or TTFT
    headroom below ``headroom_low``.  Descend (one level deeper) only
    when EVERY idle condition holds: ``queue_depth <= queue_low``,
    flags clear, headroom at least ``2 * headroom_low`` (or no recent
    TTFT samples at all), and slot occupancy at most ``active_high``.
    Signals between the bands hold the current level — the hysteresis
    gap that keeps the rails from flapping on noisy load.
    """

    name = "threshold"

    def __init__(self, *, queue_low: float = 0.0,
                 queue_high: Optional[float] = None,
                 flag_high: float = 0.25,
                 headroom_low: float = 0.25,
                 active_high: float = 1.0):
        if queue_high is not None and queue_high < queue_low:
            raise ValueError(f"queue_high {queue_high} below queue_low "
                             f"{queue_low}: bands must not cross")
        self.queue_low = float(queue_low)
        self.queue_high = queue_high if queue_high is None else float(queue_high)
        self.flag_high = float(flag_high)
        self.headroom_low = float(headroom_low)
        self.active_high = float(active_high)

    def decide(self, signals: RailSignals, level: int, table) -> int:
        queue_high = (self.queue_high if self.queue_high is not None
                      else max(self.queue_low, 1.0))
        pressured = (signals.queue_depth > queue_high
                     or signals.flag_rate >= self.flag_high
                     or (signals.ttft_headroom is not None
                         and signals.ttft_headroom < self.headroom_low))
        if pressured:
            return max(level - 1, 0)
        idle = (signals.queue_depth <= self.queue_low
                and signals.flag_rate < self.flag_high
                and (signals.ttft_headroom is None
                     or signals.ttft_headroom >= 2 * self.headroom_low)
                and signals.active_frac <= self.active_high)
        if idle:
            return min(level + 1, len(table) - 1)
        return level


class PIDPolicy:
    """PI controller on a scalar pressure term.

    ``pressure = queue_depth/queue_ref + flag_rate/flag_ref +
    max(0, headroom_low - ttft_headroom)/headroom_low``.  The control
    output ``u = kp*(pressure - setpoint) + ki*integral`` maps linearly
    onto the ladder: ``u <= 0`` requests the deepest (greenest) level,
    ``u >= 1`` requests nominal.  The integral term (clamped to
    ``[0, i_max]``) accumulates sustained pressure so a persistent
    near-threshold queue eventually forces a boost even when no single
    window trips a threshold.
    """

    name = "pid"

    def __init__(self, *, kp: float = 1.0, ki: float = 0.25,
                 setpoint: float = 0.1, queue_ref: float = 4.0,
                 flag_ref: float = 0.25, headroom_low: float = 0.25,
                 i_max: float = 4.0):
        self.kp = float(kp)
        self.ki = float(ki)
        self.setpoint = float(setpoint)
        self.queue_ref = float(queue_ref)
        self.flag_ref = float(flag_ref)
        self.headroom_low = float(headroom_low)
        self.i_max = float(i_max)
        self._integral = 0.0

    def pressure(self, signals: RailSignals) -> float:
        p = (signals.queue_depth / self.queue_ref
             + signals.flag_rate / self.flag_ref)
        if signals.ttft_headroom is not None and self.headroom_low > 0:
            p += max(0.0, self.headroom_low
                     - signals.ttft_headroom) / self.headroom_low
        return p

    def decide(self, signals: RailSignals, level: int, table) -> int:
        error = self.pressure(signals) - self.setpoint
        self._integral = min(max(self._integral + error, 0.0), self.i_max)
        u = self.kp * error + self.ki * self._integral
        depth_frac = min(max(1.0 - u, 0.0), 1.0)
        return int(round(depth_frac * (len(table) - 1)))


POLICIES: Dict[str, Type] = {
    StaticPolicy.name: StaticPolicy,
    ThresholdPolicy.name: ThresholdPolicy,
    PIDPolicy.name: PIDPolicy,
}


def get_policy(policy: Any, **kwargs: Any):
    """Resolve a policy name (``static`` / ``threshold`` / ``pid``) or
    pass an instance through unchanged (kwargs then disallowed)."""
    if isinstance(policy, str):
        try:
            return POLICIES[policy](**kwargs)
        except KeyError:
            raise KeyError(f"unknown rail policy {policy!r}; available: "
                           f"{sorted(POLICIES)}") from None
    if kwargs:
        raise TypeError("kwargs only apply when selecting a policy by name")
    if not hasattr(policy, "decide"):
        raise TypeError(f"{policy!r} is not a RailPolicy (no .decide)")
    return policy
