"""Guardband clamp: the one sanctioned rail-write path in the scaler.

Every voltage the policy wants to apply passes through
:class:`GuardbandClamp`, which enforces the three safety properties the
watchdog relies on:

* **envelope** — each partition's voltage is clamped to the calibrated
  safe band ``[floor_v, ceil_v]`` (taken from the operating-point table,
  i.e. the Salami-et-al. guardband characterization); non-finite targets
  are rejected outright;
* **max step** — one transition moves each rail at most ``max_step_v``,
  so a misbehaving policy cannot slam a partition from nominal into the
  crash region in one decision;
* **dwell** — after a transition (or a watchdog heal, via
  :meth:`notify_heal`) no further transition lands for ``dwell_steps``
  decode steps, so the policy and the watchdog's heals never fight over
  the rails.

Lint rule RP009 flags any direct ``set_rails`` /
``set_partition_voltage`` call in ``railscale``/``serve`` scope outside
this module — the clamp is the only writer.  The port's counterpart of
``repro.railscale.clamp``, carried over unchanged.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


class GuardbandClamp:
    """Envelope + rate-limit guard between a rail policy and the device."""

    def __init__(self, floor_v: Sequence[float], ceil_v: Sequence[float], *,
                 max_step_v: float = 0.1, dwell_steps: int = 8):
        self.floor_v = np.asarray(floor_v, dtype=np.float64).copy()
        self.ceil_v = np.asarray(ceil_v, dtype=np.float64).copy()
        if self.floor_v.shape != self.ceil_v.shape or self.floor_v.ndim != 1:
            raise ValueError(f"floor/ceil must be matching 1-D vectors, got "
                             f"{self.floor_v.shape} vs {self.ceil_v.shape}")
        if (not np.isfinite(self.floor_v).all()
                or not np.isfinite(self.ceil_v).all()):
            raise ValueError("guardband envelope must be finite")
        if (self.floor_v > self.ceil_v).any():
            raise ValueError("guardband floor above ceiling: "
                             f"{self.floor_v} > {self.ceil_v}")
        if not math.isfinite(max_step_v) or max_step_v <= 0:
            raise ValueError(f"max_step_v must be positive, got {max_step_v}")
        self.max_step_v = float(max_step_v)
        self.dwell_steps = int(dwell_steps)
        self._last_transition_step: Optional[int] = None

    @property
    def n_partitions(self) -> int:
        return int(self.floor_v.shape[0])

    # -- pure voltage math ----------------------------------------------------

    def clamp(self, rails: Sequence[float]) -> np.ndarray:
        """Bound a target rail vector to the calibrated envelope.  Raises
        on NaN/inf or shape mismatch — a policy emitting garbage must
        fail loudly, never reach the device."""
        rails = np.asarray(rails, dtype=np.float64)
        if rails.shape != self.floor_v.shape:
            raise ValueError(f"expected {self.n_partitions} rail voltages, "
                             f"got shape {rails.shape}")
        if not np.isfinite(rails).all():
            raise ValueError(f"non-finite rail target: {rails}")
        return np.clip(rails, self.floor_v, self.ceil_v)

    def dwell_active(self, step: int) -> bool:
        """True while the dwell timer blocks a new transition."""
        return (self._last_transition_step is not None
                and step - self._last_transition_step < self.dwell_steps)

    # -- actuation ------------------------------------------------------------

    def apply(self, session, target_v: Sequence[float], step: int, *,
              urgent: bool = False) -> Optional[np.ndarray]:
        """Move the session's rails toward ``target_v``, rate-limited.

        Returns the rails actually written, or ``None`` when nothing was
        (dwell timer active, or already at target).  ``urgent=True``
        bypasses the dwell timer — reserved for boosts toward nominal
        under error/SLO pressure; descents always respect it.
        """
        if not urgent and self.dwell_active(step):
            return None
        target = self.clamp(target_v)
        current = np.asarray(session.rails, dtype=np.float64)
        delta = np.clip(target - current, -self.max_step_v, self.max_step_v)
        new_rails = current + delta
        if np.allclose(new_rails, current, atol=1e-12):
            return None
        for p in range(self.n_partitions):
            if new_rails[p] != current[p]:
                # the clamp is the sanctioned writer
                session.set_partition_voltage(  # lint: allow=RP009 GuardbandClamp.apply IS the clamp helper every other rail write must route through
                    p, float(new_rails[p]))
        self._last_transition_step = int(step)
        return new_rails

    def snap(self, session, target_v: Sequence[float]) -> np.ndarray:
        """Envelope-clamped full jump, ignoring max-step and dwell —
        initialization only (anchoring a freshly attached engine onto a
        ladder level before traffic starts).  Steady-state transitions
        must go through :meth:`apply`."""
        target = self.clamp(target_v)
        current = np.asarray(session.rails, dtype=np.float64)
        for p in range(self.n_partitions):
            if target[p] != current[p]:
                session.set_partition_voltage(  # lint: allow=RP009 init-time snap inside the clamp helper itself
                    p, float(target[p]))
        return target

    def notify_heal(self, step: int) -> None:
        """A watchdog heal rewrote the rails underneath the policy: the
        heal preempts any pending dwell window (the policy re-evaluates
        from the healed rails immediately) and itself starts a fresh
        dwell, so the very next decision cannot push right back down."""
        self._last_transition_step = int(step)
