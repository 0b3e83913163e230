"""repro_torch.flow — the paper's Fig. 9 CAD flow as a composable stage pipeline.

Quickstart::

    from repro_torch.flow import FlowConfig, run, sweep

    report = run(FlowConfig(array_n=16, tech="vivado-28nm", algo="dbscan"))
    print(report.summary())

    result = sweep({"tech": ["vivado-28nm", "vtr-22nm"],
                    "algo": ["kmeans", "dbscan"]})
    print(result.table())

Layers:

* :class:`FlowConfig` — declarative, validated, serializable operating point.
* :class:`Stage` subclasses + :data:`STAGE_REGISTRY` — pluggable pipeline
  steps, each a pure ``(Artifacts, FlowConfig) -> Artifacts`` function.
* :class:`Pipeline` — ordered stage chain with ``replace`` / ``without`` /
  ``insert_after`` composition and artifact-prefix caching via
  :class:`ArtifactStore`.
* :func:`sweep` — multi-scenario fan-out with shared prefix caching and a
  tidy comparison table.

``repro_torch.core.cadflow.run_flow`` remains as a thin, deprecated wrapper.

CLI: ``PYTHONPATH=src python -m repro_torch.flow {run,sweep} ...``

The port's copy of ``repro.flow``: numpy and the standard library only, and
bit-identical to it (``tests/test_torch_flow.py``).  The ``hwloop`` stage
runs its backend on the stage instance's device
(``repro_torch.hwloop.hwloop_pipeline(device=...)``; the GPU by default).
The CLI's ``--points-out`` writes the reference CLI's operating-point
ladder file, characterized on ``--device`` (the GPU unless ``--device cpu``;
without a GPU and without the flag it stops before the flow runs).
"""

from .artifacts import Artifacts, ArtifactStore, StoreStats
from .config import KNOWN_ALGOS, FlowConfig
from .pipeline import Pipeline, execute
from .report import FlowReport, report_from
from .stages import (DEFAULT_STAGE_NAMES, STAGE_REGISTRY, ClusterStage,
                     ConstraintsStage, FloorplanStage, FunctionStage,
                     HwLoopStage, PowerStage, RuntimeCalibrationStage, Stage,
                     StaticVoltageStage, TimingStage, cluster_slack,
                     default_stages, get_stage, register_stage)
from .sweep import (HWLOOP_COLUMNS, ROW_COLUMNS, SweepResult, expand_grid,
                    sweep)


def run(cfg: "FlowConfig | None" = None, *, pipeline: "Pipeline | None" = None,
        store: "ArtifactStore | None" = None, **overrides) -> FlowReport:
    """Execute the flow for ``cfg`` (or keyword overrides of the default
    config) and return the flat :class:`FlowReport`."""
    if cfg is None:
        cfg = FlowConfig(**overrides)
    elif overrides:
        cfg = cfg.replace(**overrides)
    art = execute(cfg, pipeline=pipeline, store=store)
    return report_from(art, cfg)


__all__ = [
    "Artifacts", "ArtifactStore", "StoreStats", "FlowConfig", "KNOWN_ALGOS",
    "Pipeline", "execute", "FlowReport", "report_from", "Stage",
    "FunctionStage", "TimingStage", "ClusterStage", "FloorplanStage",
    "StaticVoltageStage", "RuntimeCalibrationStage", "PowerStage",
    "ConstraintsStage", "HwLoopStage", "STAGE_REGISTRY",
    "DEFAULT_STAGE_NAMES", "default_stages", "get_stage", "register_stage",
    "cluster_slack", "sweep", "SweepResult", "expand_grid", "ROW_COLUMNS",
    "HWLOOP_COLUMNS", "run",
]
