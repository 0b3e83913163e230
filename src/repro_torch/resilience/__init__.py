"""`repro_torch.resilience`: surviving silent errors on the undervolted array.

:mod:`repro_torch.resilience.guard` — :class:`GuardedBackend`, an ABFT
wrapper over any :class:`~repro_torch.backend.base.MatmulBackend` (row/column
checksums or a Freivalds probe, locate-and-correct, and a retry -> rail-heal
-> policy escalation ladder).  Importing this package registers it as the
``"guarded"`` backend.

The reference's second piece, ``repro.resilience.chaos`` (the seeded
fault-scenario campaign over the serving stack and its HTTP frontend), is not
ported yet: it waits for ``server/`` (ROADMAP.md queue A, A11).  Its crash
voltage is kept here as :data:`V_CRASH`.
"""

from .guard import GuardedBackend, GuardError

#: Rail voltage deep in the crash region of the vtr-22nm node — every
#: partition produces SILENT corruption there (``repro.resilience.chaos``'s
#: constant, kept for the port's own chaos scenarios).
V_CRASH = 0.58

__all__ = ["GuardedBackend", "GuardError", "V_CRASH"]
