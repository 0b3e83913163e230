"""Declarative, serializable configuration for the staged CAD flow.

``FlowConfig`` captures every knob of the paper's Fig. 9 pipeline — array
size, technology node, clustering algorithm + parameters, voltage scheme
bounds, Razor/runtime calibration settings and the power model — as one
validated, hashable-by-value dataclass with ``to_dict``/``from_dict``
round-tripping, so configs can be stored, diffed and swept.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Mapping, Optional, Tuple

from ..core.timing import TECH_NODES, TechNode

#: Clustering algorithms the paper evaluates (Sec. IV), canonical spellings.
KNOWN_ALGOS: Tuple[str, ...] = ("kmeans", "hierarchical", "meanshift", "dbscan")

_ALGO_ALIASES = {
    "k-means": "kmeans", "kmeans": "kmeans",
    "hierarchy": "hierarchical", "hierarchical": "hierarchical",
    "mean-shift": "meanshift", "meanshift": "meanshift",
    "dbscan": "dbscan",
}


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """One operating point of the Fig. 9 flow.

    ``v_min``/``v_crash`` default to the tech node's values when ``None``
    (use :meth:`resolved_v_min`/:meth:`resolved_v_crash` for the effective
    numbers).  ``algo_params`` overrides the paper-consistent clustering
    defaults (e.g. ``{"bandwidth": 0.3}`` for mean-shift, ``{"eps": 0.2,
    "min_pts": 8}`` for DBSCAN, ``{"linkage": "complete"}`` for
    hierarchical).
    """

    array_n: int = 16
    tech: str = "vivado-28nm"
    algo: str = "dbscan"
    n_clusters: Optional[int] = 4
    clock_ns: float = 10.0
    seed: int = 2021
    v_min: Optional[float] = None
    v_crash: Optional[float] = None
    freq_mhz: float = 100.0
    calibrate: bool = True
    max_trials: int = 48
    # Razor trial-run RNG seed; None -> use ``seed``.  Kept separate so a
    # production recalibration can re-roll the trials without invalidating
    # the cached timing/clustering prefix (which keys on ``seed``).
    calibration_seed: Optional[int] = None
    flag_reduce: str = "or"              # Razor per-partition flag reduction
    activity: float = 0.5                # power-model toggle rate
    algo_params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    # Hot-path implementation: "vectorized" (default) uses the array-programming
    # clustering + simulator; "reference" runs the bit-exact loop oracles
    # (clustering_ref / SystolicSim reference propagation) — the perf baseline
    # of benchmarks/run.py's ``flow`` scenario.
    impl: str = "vectorized"
    # Razor calibration: "anneal" = the paper's Algorithm-2 trial-run walk;
    # "bisect" = batched per-partition bisection (fewer trials, same rails up
    # to the step/tolerance difference)
    calibration_method: str = "anneal"
    # hwloop emulation stage (opt-in via the "hwloop" stage, not ported yet:
    # ROADMAP.md A7): probe-traffic steps, streamed activation rows per step,
    # and the silent-failure corruption model (repro.hwloop.inject in the
    # JAX package)
    hwloop_steps: int = 8
    hwloop_rows: int = 32
    hwloop_corruption: str = "stale"
    # execution backend (repro_torch.backend registry) the hwloop stage runs its
    # inference traffic on: "emulated" (default — the calibrated
    # fault-injecting accelerator with energy accounting), "simulated"
    # (cycle-level SystolicSim at the calibrated rails), or
    # "ideal"/"reference" (exact baselines: zero flags, no energy model)
    backend: str = "emulated"

    def __post_init__(self) -> None:
        object.__setattr__(self, "algo",
                           _ALGO_ALIASES.get(str(self.algo).lower(),
                                             str(self.algo).lower()))
        # freeze algo_params into a plain dict copy so the config is stable
        object.__setattr__(self, "algo_params", dict(self.algo_params))
        self.validate()

    # -- validation ----------------------------------------------------------

    def validate(self) -> None:
        if self.tech not in TECH_NODES:
            raise ValueError(f"unknown tech node {self.tech!r}; "
                             f"known: {sorted(TECH_NODES)}")
        if self.algo not in KNOWN_ALGOS:
            raise ValueError(f"unknown clustering algorithm {self.algo!r}; "
                             f"known: {KNOWN_ALGOS}")
        if self.array_n <= 0:
            raise ValueError("array_n must be positive")
        if self.n_clusters is not None and self.n_clusters <= 0:
            raise ValueError("n_clusters must be positive (or None)")
        if self.clock_ns <= 0:
            raise ValueError("clock_ns must be positive")
        if self.freq_mhz <= 0:
            raise ValueError("freq_mhz must be positive")
        if self.max_trials < 0:
            raise ValueError("max_trials must be >= 0")
        if self.flag_reduce not in ("or", "and"):
            raise ValueError("flag_reduce must be 'or' or 'and'")
        if self.impl not in ("vectorized", "reference"):
            raise ValueError("impl must be 'vectorized' or 'reference'")
        if self.calibration_method not in ("anneal", "bisect"):
            raise ValueError("calibration_method must be 'anneal' or 'bisect'")
        if not 0.0 < self.activity <= 1.0:
            raise ValueError("activity must be in (0, 1]")
        if self.hwloop_steps <= 0:
            raise ValueError("hwloop_steps must be positive")
        if self.hwloop_rows <= 0:
            raise ValueError("hwloop_rows must be positive")
        if self.backend not in ("ideal", "reference", "simulated", "emulated"):
            # user backends registered in repro_torch.backend are accepted too;
            # the import is deferred (repro_torch.backend is a heavier package)
            try:
                from ..backend import available_backends
                known = available_backends()
            except ImportError:  # pragma: no cover - mid-import edge only
                known = ["ideal", "reference", "simulated", "emulated"]
            if self.backend not in known:
                raise ValueError(f"unknown backend {self.backend!r}; "
                                 f"known: {known}")
        if self.hwloop_corruption not in ("stale", "tedrop", "bitflip"):
            # beyond the built-ins, accept anything in the hwloop registry
            # (user models added via register_corruption).  The import is
            # deferred to here — never at module scope — because hwloop
            # itself imports flow.  Until hwloop/ is ported (ROADMAP.md A7)
            # the import fails and the built-ins are the known models.
            try:
                from ..hwloop.inject import CORRUPTION_MODELS
                known = sorted(CORRUPTION_MODELS)
            except ImportError:
                known = ["stale", "tedrop", "bitflip"]
            if self.hwloop_corruption not in known:
                raise ValueError(f"unknown hwloop_corruption "
                                 f"{self.hwloop_corruption!r}; known: {known}")
        if self.resolved_v_min() <= self.resolved_v_crash():
            raise ValueError("V_min must exceed V_crash")

    # -- derived -------------------------------------------------------------

    @property
    def node(self) -> TechNode:
        return TECH_NODES[self.tech]

    def resolved_v_min(self) -> float:
        return self.node.v_min if self.v_min is None else float(self.v_min)

    def resolved_v_crash(self) -> float:
        return self.node.v_crash if self.v_crash is None else float(self.v_crash)

    def resolved_calibration_seed(self) -> int:
        return self.seed if self.calibration_seed is None else int(self.calibration_seed)

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON-serializable dict (round-trips via :meth:`from_dict`)."""
        out = dataclasses.asdict(self)
        out["algo_params"] = dict(self.algo_params)
        return out

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "FlowConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown FlowConfig fields: {sorted(unknown)}")
        return cls(**dict(d))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FlowConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **changes: Any) -> "FlowConfig":
        """A copy with ``changes`` applied (re-validated)."""
        return dataclasses.replace(self, **changes)

    # -- cache fingerprinting ------------------------------------------------

    def fingerprint(self, keys: Tuple[str, ...]) -> Tuple[Tuple[str, str], ...]:
        """Stable, hashable digest of the named fields — the artifact-store
        cache key component (see :mod:`repro_torch.flow.pipeline`)."""
        out = []
        for k in sorted(keys):
            v = getattr(self, k)
            if isinstance(v, Mapping):
                v = json.dumps({str(a): v[a] for a in sorted(v)}, sort_keys=True)
            out.append((k, repr(v)))
        return tuple(out)
