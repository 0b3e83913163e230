"""repro_torch.railscale — closed-loop energy-aware rail autoscaling.

The paper's green-computing loop, operational: an operating-point table
distilled from the CAD flow (:mod:`repro_torch.railscale.points`), pure rail
policies over ObsBus telemetry (:mod:`repro_torch.railscale.policy`), a
guardband clamp that is the only sanctioned rail writer
(:mod:`repro_torch.railscale.clamp`), and the :class:`Autoscaler` driver that
``ServeEngine(autoscaler=...)`` ticks once per decode step
(:mod:`repro_torch.railscale.autoscaler`).
"""

from .autoscaler import Autoscaler
from .clamp import GuardbandClamp
from .points import (OperatingPoint, OperatingPointTable, load_tables,
                     save_tables)
from .policy import (PIDPolicy, POLICIES, RailPolicy, RailSignals,
                     StaticPolicy, ThresholdPolicy, get_policy)

__all__ = [
    "Autoscaler",
    "GuardbandClamp",
    "OperatingPoint",
    "OperatingPointTable",
    "PIDPolicy",
    "POLICIES",
    "RailPolicy",
    "RailSignals",
    "StaticPolicy",
    "ThresholdPolicy",
    "get_policy",
    "load_tables",
    "save_tables",
]
