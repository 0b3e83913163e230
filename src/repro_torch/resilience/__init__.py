"""`repro_torch.resilience`: surviving silent errors on the undervolted array.

Two pieces:

* :mod:`repro_torch.resilience.guard` — :class:`GuardedBackend`, an ABFT
  wrapper over any :class:`~repro_torch.backend.base.MatmulBackend`
  (row/column checksums or a Freivalds probe, locate-and-correct, and a
  retry -> rail-heal -> policy escalation ladder).  Importing this package
  registers it as the ``"guarded"`` backend.
* :mod:`repro_torch.resilience.chaos` — the seeded fault-scenario campaign
  that drives the guarded stack end-to-end through ``ServeEngine`` and the
  HTTP frontend and asserts graceful degradation
  (``python -m repro_torch.resilience.chaos --device cpu``).
"""

from .chaos import (ChaosReport, ScenarioResult, SCENARIOS, V_CRASH,
                    run_campaign, run_scenario)
from .guard import GuardedBackend, GuardError

__all__ = [
    "GuardedBackend", "GuardError", "V_CRASH",
    "ChaosReport", "ScenarioResult", "SCENARIOS",
    "run_campaign", "run_scenario",
]
