"""DEPRECATED shim over :mod:`repro_torch.flow` — the staged CAD-flow pipeline.

The paper's flow (Fig. 9: timing -> clustering -> floorplan -> static
Algorithm-1 voltages -> Razor runtime calibration -> power report) used to
live here as the monolithic ``run_flow()``.  It is now the composable
``repro_torch.flow`` pipeline::

    from repro_torch.flow import FlowConfig, run, sweep

    report = run(FlowConfig(array_n=16, tech="vivado-28nm", algo="dbscan"))
    result = sweep({"tech": ["vivado-28nm", "vtr-22nm"],
                    "algo": ["kmeans", "dbscan"]})

``run_flow()`` and ``FlowReport`` remain as thin, bit-for-bit-compatible
wrappers so existing callers keep working; new code should import from
``repro_torch.flow`` (declarative ``FlowConfig``, pluggable stages, artifact
caching, multi-scenario sweeps).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# NOTE: only ..flow.report is imported at module scope — importing the full
# ..flow package here would be circular (repro_torch.flow's stages import the core
# submodules, which triggers this module via repro_torch.core.__init__).
from ..flow.report import FlowReport
from .power import model_for

__all__ = ["FlowReport", "run_flow", "paper_table2_flow"]


def _cluster(slack: np.ndarray, algo: str, n_clusters: Optional[int],
             seed: int) -> np.ndarray:
    """Deprecated alias of :func:`repro_torch.flow.cluster_slack`."""
    from ..flow.stages import cluster_slack
    return cluster_slack(slack, algo, n_clusters, seed)


def run_flow(array_n: int = 16, tech: str = "vivado-28nm", algo: str = "dbscan",
             n_clusters: Optional[int] = 4, clock_ns: float = 10.0,
             seed: int = 2021, v_min: Optional[float] = None,
             v_crash: Optional[float] = None, freq_mhz: float = 100.0,
             calibrate: bool = True, max_trials: int = 48) -> FlowReport:
    """Execute the full flow of Fig. 9 and return every artifact.

    Deprecated: equivalent to ``repro_torch.flow.run(FlowConfig(...))``, which also
    exposes stage composition, artifact caching and sweeps.
    """
    from ..flow import FlowConfig, run
    # legacy behaviour: falsy n_clusters (0/None) meant "use the default 4"
    return run(FlowConfig(
        array_n=array_n, tech=tech, algo=algo, n_clusters=n_clusters or None,
        clock_ns=clock_ns, seed=seed, v_min=v_min, v_crash=v_crash,
        freq_mhz=freq_mhz, calibrate=calibrate, max_trials=max_trials))


def paper_table2_flow(array_n: int, tech: str) -> Dict[str, float]:
    """The exact Table II configuration: 4 equal partitions at the paper's
    rounded voltages {0.96, 0.97, 0.98, 0.99} against a 1.0 V baseline."""
    pm = model_for(tech)
    v = np.array([0.96, 0.97, 0.98, 0.99])
    base = pm.baseline_mw(array_n, 1.0)
    scaled = pm.partitioned_mw(array_n, v, v_ref=1.0)
    return {"baseline_mw": base, "scaled_mw": scaled,
            "reduction_pct": 100.0 * (1 - scaled / base)}
