"""Core of *Towards Power Efficient DNN Accelerator Design on Reconfigurable
Platform*: the parts of the CAD flow the port holds so far — the static
(Algorithm 1) and runtime (Algorithm 2) voltage schemes and the
precision-island tier controller."""

from .precision import (ENERGY_PER_MAC, TIERS, PrecisionController, energy_ratio,
                        static_tier_assignment, tile_headroom)
from .voltage import (CalibrationResult, RuntimeScheme,
                      assign_partition_voltages, runtime_voltage_scaling,
                      static_voltage_scaling)

__all__ = [name for name in dir() if not name.startswith("_")]
