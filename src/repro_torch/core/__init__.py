"""Core reproduction of *Towards Power Efficient DNN Accelerator Design on
Reconfigurable Platform* — slack-clustered voltage-island partitioning of a
systolic MAC array, with static (Algorithm 1) + Razor-runtime (Algorithm 2)
V_ccint calibration and the calibrated power model (Table II / Figs. 15-16).

The port's copy of ``repro.core``: numpy and the standard library, and
bit-identical to it (``tests/test_torch_core.py``); ``razor`` also holds the
torch forms of its classification, which the hwloop tiled form runs on a GPU.  ``cadflow`` is imported
first and reaches ``flow.report`` from there, in the reference's order."""

from .cadflow import FlowReport, paper_table2_flow, run_flow
from .clustering import (cluster, dbscan, hierarchical, hierarchical_dendrogram,
                         kmeans, meanshift, relabel_by_feature_mean,
                         attach_noise_to_nearest, silhouette)
from .partition import (Floorplan, Partition, grid_floorplan, partition_min_slack,
                        quadrant_floorplan)
from .power import PAPER_TABLE2, PowerModel, fit_power_exponent, model_for, \
    validate_against_table2
from .precision import (ENERGY_PER_MAC, TIERS, PrecisionController, energy_ratio,
                        static_tier_assignment, tile_headroom)
from .razor import (DETECTED, OK, SILENT, RazorConfig, RazorMac, classify_arrival,
                    effective_arrival, streamed_activity, switching_activity)
from .systolic import SimStats, SystolicSim, fast_fault_matmul
from .timing import TECH_NODES, TechNode, TimingModel, TimingPath, delay_scale, \
    render_report_table
from .voltage import (CalibrationResult, RuntimeScheme,
                      assign_partition_voltages, runtime_voltage_scaling,
                      static_voltage_scaling)

__all__ = [name for name in dir() if not name.startswith("_")]
