"""Online hardware-in-the-loop session: emulate, observe, recalibrate.

:class:`HwLoopSession` is the piece that makes the paper's claim *operational*
inside the serving stack: per decode step it runs data-dependent probe
traffic through the :class:`~repro_torch.hwloop.device.EmulatedAccelerator`,
feeds the observed per-partition Razor flags into the
:class:`~repro_torch.runtime.monitor.CalibrationWatchdog`, and — when flags
persist past the watchdog's patience — re-runs the cached
``runtime_calibration`` stage of :mod:`repro_torch.flow` mid-serve (the
shared :class:`~repro_torch.flow.artifacts.ArtifactStore` keeps the
timing/cluster/floorplan prefix as cache hits) and swaps the fresh rails
onto the live device.  Lowering a rail below its safe point therefore
raises that partition's DETECTED rate for a few steps and then heals.

The session also owns token attribution for the energy ledger, so
``energy_per_token_j`` is meaningful to the serve engine's telemetry.

The port's counterpart of ``repro.hwloop.session``: the session's
accelerator lives on ``device`` (``None`` means the GPU; without one it
raises).  The probe traffic is drawn with numpy exactly as the reference
draws it, then put on that device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .._device import DeviceLike, resolve_device
from ..flow.config import FlowConfig
from ..runtime.monitor import CalibrationWatchdog
from .device import EmulatedAccelerator


@dataclasses.dataclass
class StepTelemetry:
    """What one ``step()`` observed — the serve engine's per-step payload."""

    flags: np.ndarray               # (P,) bool DETECTED flags this step
    detected_p: np.ndarray          # (P,) DETECTED counts
    silent_p: np.ndarray            # (P,) SILENT counts (oracle-only view)
    rel_error: float
    recalibrated: bool              # the watchdog re-ran Algorithm 2


class HwLoopSession:
    """Voltage-aware emulation loop bound to one CAD-flow operating point.

    ``flow_config``  — the operating point; the session's watchdog runs the
    full Fig. 9 flow once up front (cached in ``store``).
    ``probe_rows``   — streamed activation rows per probe matmul.
    ``rail_margin``  — guard band added on top of the calibrated rails (both
    at init and after every recalibration); 0 runs exactly at the
    Algorithm-2 rails, which sit at the edge of the clean region by
    construction.
    ``device``       — where the accelerator runs the probe traffic.
    """

    def __init__(self, flow_config: FlowConfig, *,
                 corruption: str = "stale",
                 patience: int = 3,
                 store=None,
                 probe_rows: int = 16,
                 rail_margin: float = 0.0,
                 leak_frac: float = 0.05,
                 seed: int = 0,
                 device: DeviceLike = None):
        device = resolve_device(device)       # before the flow runs
        self.config = flow_config
        self.rail_margin = float(rail_margin)
        self.watchdog = CalibrationWatchdog(flow_config, patience=patience,
                                            store=store)
        self.accel = EmulatedAccelerator.from_flow(
            self.watchdog.report, flow_config, corruption=corruption,
            leak_frac=leak_frac, seed=seed, device=device)
        self.accel.set_rails(self._guarded(self.watchdog.runtime_v))
        self.probe_rows = int(probe_rows)
        self._seed = int(seed)
        self.steps = 0
        self.recalibrations = 0
        self.flag_history: List[np.ndarray] = []
        self._obs = None   # ObsBus, when a serve engine attaches

    def _guarded(self, rails: np.ndarray) -> np.ndarray:
        return np.asarray(rails, dtype=np.float64) + self.rail_margin

    # -- experiment knobs -----------------------------------------------------

    @property
    def n_partitions(self) -> int:
        return self.accel.n_partitions

    @property
    def rails(self) -> np.ndarray:
        return self.accel.rails

    @property
    def rail_envelope(self) -> tuple:
        """``(floor_v, ceil_v)``: the tech node's physical rail band —
        threshold voltage up to the top of the paper's scaling range.
        Wider than the *calibrated* clean region on purpose: undervolt
        experiments (and the railscale policies probing toward NTC) may
        dip below the safe point — that is what the watchdog heals — but
        never below V_th into electrically meaningless territory."""
        node = self.config.node
        return float(node.v_th), float(max(node.v_nom, node.v_min))

    def set_partition_voltage(self, partition: int, v: float) -> None:
        """Lower (or raise) one rail live — the undervolting experiment.  A
        rail below the partition's safe point raises its DETECTED rate and,
        after the watchdog's patience, triggers a mid-serve recalibration
        that restores safe rails.

        Hardened: non-finite voltages are rejected, the write is clamped
        to the tech node's :attr:`rail_envelope`, and the
        ``hwloop_rail_volts`` gauge republishes immediately so a manual
        rail write can never leave the exported telemetry stale."""
        v = float(v)
        if not np.isfinite(v):
            raise ValueError(f"non-finite rail voltage {v!r} for partition "
                             f"{partition}")
        if not 0 <= int(partition) < self.n_partitions:
            raise IndexError(f"partition {partition} out of range "
                             f"[0, {self.n_partitions})")
        lo, hi = self.rail_envelope
        self.accel.set_partition_voltage(int(partition), min(max(v, lo), hi))
        self._publish_rails()

    # -- backend adapter -------------------------------------------------------

    def attach_accelerator(self, accel) -> None:
        """Bind the session to an external device — the serve engine's
        ``EmulatedBackend`` accelerator.  The session then stops generating
        probe traffic and instead acts as the watchdog adapter: real GEMM
        flags arrive via :meth:`observe_flags` and rail heals land on the
        live serving device (whose ledger also owns the energy accounting).

        A *foreign* device (not the session's own accel) gets the session's
        guarded calibrated rails applied — ``from_flow`` devices carry raw
        Algorithm-2 rails, which sit at the edge of the clean region and
        would trip spurious flags without the ``rail_margin`` band.
        Re-attaching the session's own accel is a no-op, so deliberate rail
        experiments (undervolting) survive engine reconstruction."""
        if accel is self.accel:
            return
        if accel.n_partitions != self.n_partitions:
            raise ValueError(
                f"attached device has {accel.n_partitions} partitions; the "
                f"session calibrated {self.n_partitions}")
        self.accel = accel
        accel.set_rails(self._guarded(np.asarray(self.watchdog.runtime_v)))

    def attach_obs(self, bus) -> None:
        """Attach a ``repro_torch.obs.ObsBus``: recalibrations count into
        ``hwloop_recalibrations_total``, live rail voltages export as
        ``hwloop_rail_volts{partition=...}`` gauges, and every rail heal
        emits a ``rail_heal`` trace event into the flight recorder."""
        self._obs = bus
        self._c_recal = bus.registry.counter(
            "hwloop_recalibrations_total",
            "watchdog-triggered mid-serve rail recalibrations")
        self._g_rails = bus.registry.gauge(
            "hwloop_rail_volts", "live per-partition rail voltage (V)",
            labels=("partition",))
        self._publish_rails()

    def _publish_rails(self) -> None:
        if self._obs is None:
            return
        for p, v in enumerate(np.asarray(self.rails, dtype=np.float64)):
            self._g_rails.set(float(v), partition=str(p))

    def observe_flags(self, flags, n_tokens: int = 0) -> bool:
        """Feed one serving step's observed per-partition Razor flags into
        the watchdog; returns True when a recalibration fired (fresh rails
        are already swapped onto the attached device).  ``n_tokens`` > 0
        additionally attributes tokens to the device's energy ledger (the
        probe path does this; the backend adapter attributes its own)."""
        flags = np.asarray(flags, dtype=bool)
        if flags.shape != (self.n_partitions,):
            raise ValueError(f"expected {self.n_partitions} partition flags, "
                             f"got shape {flags.shape}")
        if n_tokens:
            self.accel.ledger.add_tokens(n_tokens)
        self.flag_history.append(flags)
        report = self.watchdog.observe(flags)
        recalibrated = report is not None
        if recalibrated:
            self.recalibrations += 1
            self.accel.set_rails(self._guarded(np.asarray(report.runtime_v)))
            if self._obs is not None:
                self._c_recal.inc()
                self._publish_rails()
                self._obs.event(
                    "rail_heal", step=self.steps,
                    rails_v=[float(v) for v in np.asarray(self.rails)])
        self.steps += 1
        return recalibrated

    # -- the loop --------------------------------------------------------------

    def step(self, tokens: Sequence[int],
             n_tokens: Optional[int] = None) -> StepTelemetry:
        """Emulate one serving step's accelerator traffic.

        ``tokens`` are the token ids the model emitted this step; the probe
        activations are derived from them deterministically, so the
        switching-activity term (and hence the failure probability at NTC)
        is data-dependent, as in the paper.  ``n_tokens`` (default
        ``len(tokens)``) is attributed to the energy ledger.
        """
        toks = np.atleast_1d(np.asarray(tokens, dtype=np.int64))
        n_tokens = len(toks) if n_tokens is None else int(n_tokens)
        n = self.accel.timing.n
        rng = np.random.default_rng(
            (self._seed * 1_000_003 + self.steps * 7919
             + int(toks.sum() % (2 ** 31))) & 0x7FFFFFFF)
        a = rng.normal(size=(self.probe_rows, n))
        w = rng.normal(size=(n, n))
        _, tel = self.accel.matmul(a, w)
        flags = np.asarray(tel.partition_flags, dtype=bool)
        recalibrated = self.observe_flags(flags, n_tokens=n_tokens)
        return StepTelemetry(flags=flags, detected_p=tel.detected_p,
                             silent_p=tel.silent_p, rel_error=tel.rel_error,
                             recalibrated=recalibrated)

    # -- telemetry -------------------------------------------------------------

    def flag_rate(self) -> np.ndarray:
        """(P,) fraction of steps on which each partition's flag fired."""
        if not self.flag_history:
            return np.zeros(self.n_partitions)
        return np.mean(np.asarray(self.flag_history, dtype=np.float64), axis=0)

    def summary(self) -> Dict[str, Any]:
        """Plain-JSON telemetry: flag rates, rails, recalibrations, energy."""
        return {
            "steps": self.steps,
            "flag_rate": self.flag_rate().tolist(),
            "recalibrations": self.recalibrations,
            "watchdog_recalibrations": self.watchdog.recalibrations,
            "rails_v": self.rails.tolist(),
            "rail_margin_v": self.rail_margin,
            "corruption": self.accel.corruption,
            **self.accel.ledger.summary(),
        }
