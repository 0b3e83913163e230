"""repro_torch.analysis — static guards for the port's cross-cutting
invariants.  Counterpart of ``repro.analysis``.

Two layers:

* **Invariant linter** (:mod:`.rules` + :mod:`.checker`): AST-based rules
  RP001..RP009 with the JAX package's codes and scopes, reworded for the
  port — every dense GEMM in ``models/`` routes through ``backend.matmul``,
  only the pump thread touches torch in the server, wall-clock reads go
  through the injectable ``clock=``, random draws take an explicit
  generator, kernel block/chunk sizes come from ``kernels/tuning.py`` or a
  launch plan.  Violations carry a fix-hint and can be silenced inline
  (``# lint: allow=RP001 <reason>``) or via ``lint_baseline_torch.json``.

* **Dispatch census** (:mod:`.census`, in place of the reference's
  ``jaxpr``): runs each config's ``ModelAPI`` prefill / decode step under a
  ``TorchDispatchMode`` and inventories routed GEMMs, kernel calls, matrix
  products and host synchronisations per model call — the worklist of a
  CUDA-graph capture of the served step, pinned in
  ``census_baseline_torch.json``.

CLI: ``python -m repro_torch.analysis lint`` and
``python -m repro_torch.analysis census --device cpu``.
"""

from .findings import Finding, load_baseline, write_baseline  # noqa: F401
from .checker import lint_file, lint_paths  # noqa: F401
from .rules import RULES, rule_codes  # noqa: F401
# the submodule ``census`` keeps its name here (its function of the same
# name is ``census.census``)
from .census import (  # noqa: F401
    CENSUS_ARCHS,
    CENSUS_BACKENDS,
    census_config,
    check_census,
    count_call,
)
