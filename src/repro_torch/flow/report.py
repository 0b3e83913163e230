"""Flat report view over the pipeline's artifacts.

``FlowReport`` is the stable result object callers have always received from
``repro_torch.core.cadflow.run_flow``; it now lives here and is assembled from a
:class:`~repro_torch.flow.artifacts.Artifacts` value via :func:`report_from`.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np

from ..core.partition import Floorplan
from .artifacts import Artifacts

if TYPE_CHECKING:  # avoid a circular import with repro_torch.core.cadflow's shim
    from .config import FlowConfig


@dataclasses.dataclass
class FlowReport:
    array_n: int
    tech: str
    algo: str
    n_partitions: int
    labels: np.ndarray                   # (n*n,) cluster id per MAC
    min_slack: np.ndarray                # (n*n,)
    floorplan: Floorplan
    static_v: np.ndarray                 # (P,) Algorithm-1 voltages per partition
    runtime_v: np.ndarray                # (P,) after Algorithm-2 calibration
    baseline_mw: float
    static_mw: float
    runtime_mw: float
    static_reduction_pct: float
    runtime_reduction_pct: float
    xdc: str
    sdc: str
    razor_trials: int
    calibrated_fail_free: bool
    # requested cluster count (None when the algorithm picks its own — the
    # density-based ones) vs the actual n_partitions above
    n_partitions_requested: Optional[int] = None
    # (P,) bool — False where Algorithm-2 never saw a clean trial and the
    # rail was pinned at V_ceil (see voltage.CalibrationResult)
    calibration_converged: Optional[np.ndarray] = None
    # hardware-in-the-loop emulation observables (the opt-in "hwloop" stage;
    # None when the stage did not run)
    hwloop_energy_per_token_j: Optional[float] = None
    hwloop_energy_per_mac_j: Optional[float] = None
    hwloop_replay_rate: Optional[float] = None
    hwloop_flag_rate: Optional[list] = None          # (P,) per-partition
    hwloop_silent_rate: Optional[float] = None
    hwloop_rel_error: Optional[float] = None         # accuracy proxy

    def summary(self) -> str:
        part = (f"P={self.n_partitions}"
                if self.n_partitions_requested in (None, self.n_partitions)
                else f"P={self.n_partitions}"
                     f"(req {self.n_partitions_requested})")
        return (f"{self.array_n}x{self.array_n} {self.tech} {self.algo} "
                f"{part} static {self.static_reduction_pct:.2f}% "
                f"runtime {self.runtime_reduction_pct:.2f}% "
                f"(baseline {self.baseline_mw:.0f} mW)")


def report_from(art: Artifacts, cfg: "FlowConfig") -> FlowReport:
    """Assemble the flat report from pipeline artifacts.

    Tolerates skipped stages: without the calibration stage, runtime numbers
    mirror the static scheme; without the constraints stage, ``xdc``/``sdc``
    are empty strings.
    """
    static_v = art.static_v
    runtime_v = art.get("runtime_v", static_v)
    fp = art.get("floorplan_runtime",
                 art.get("floorplan_static", art.floorplan))
    return FlowReport(
        array_n=cfg.array_n, tech=cfg.tech, algo=cfg.algo,
        n_partitions=art.n_partitions,
        labels=art.labels, min_slack=art.slack, floorplan=fp,
        static_v=static_v, runtime_v=runtime_v,
        baseline_mw=art.baseline_mw, static_mw=art.static_mw,
        runtime_mw=art.runtime_mw,
        static_reduction_pct=art.static_reduction_pct,
        runtime_reduction_pct=art.runtime_reduction_pct,
        xdc=art.get("xdc", ""), sdc=art.get("sdc", ""),
        razor_trials=art.get("razor_trials", 0),
        calibrated_fail_free=art.get("calibrated_fail_free", True),
        n_partitions_requested=art.get("n_partitions_requested"),
        calibration_converged=art.get("calibration_converged"),
        hwloop_energy_per_token_j=art.get("hwloop_energy_per_token_j"),
        hwloop_energy_per_mac_j=art.get("hwloop_energy_per_mac_j"),
        hwloop_replay_rate=art.get("hwloop_replay_rate"),
        hwloop_flag_rate=art.get("hwloop_flag_rate"),
        hwloop_silent_rate=art.get("hwloop_silent_rate"),
        hwloop_rel_error=art.get("hwloop_rel_error"),
    )
