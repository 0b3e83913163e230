"""The pluggable stages of the paper's Fig. 9 flow.

Each stage is a pure ``(Artifacts, FlowConfig) -> Artifacts`` step that only
*adds* named artifacts; ``requires``/``provides`` declare its dataflow and
``config_keys`` names the config fields that can change its output (the
basis of artifact-prefix caching — see :mod:`repro_torch.flow.pipeline`).

The default stage chain reproduces ``repro_torch.core.cadflow.run_flow`` bit for
bit: TimingStage -> ClusterStage -> FloorplanStage -> StaticVoltageStage ->
RuntimeCalibrationStage -> PowerStage -> ConstraintsStage.  Users may
replace, insert or skip stages via :class:`repro_torch.flow.Pipeline`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Type

import numpy as np

from ..core import clustering as cl
from ..core import clustering_ref as cl_ref
from ..core.constraints import generate_sdc, generate_xdc
from ..core.partition import grid_floorplan, partition_min_slack
from ..core.power import model_for
from ..core.razor import RazorConfig
from ..core.systolic import SystolicSim
from ..core.timing import TimingModel
from ..core.voltage import (RuntimeScheme, assign_partition_voltages,
                            static_voltage_scaling)
from .artifacts import Artifacts
from .config import FlowConfig


class Stage:
    """Base class: a named, pure pipeline step.

    Subclasses set the class attributes and implement :meth:`run`.  A stage
    must only read artifacts named in ``requires`` and config fields named in
    ``config_keys`` — the caching layer relies on those declarations.
    """

    name: str = "stage"
    requires: Tuple[str, ...] = ()
    provides: Tuple[str, ...] = ()
    config_keys: Tuple[str, ...] = ()
    # opt-in: cache this stage's output on the *values* of its required
    # artifacts (+ its own config fields) instead of the upstream config
    # prefix — sound exactly because of the requires/config_keys contract
    # above.  See Pipeline._store_key.
    content_cache: bool = False

    def run(self, art: Artifacts, cfg: FlowConfig) -> Artifacts:
        raise NotImplementedError

    def __call__(self, art: Artifacts, cfg: FlowConfig) -> Artifacts:
        return self.run(art, cfg)

    def cache_token(self) -> str:
        """Identity of this stage *implementation* for artifact caching.

        Two stages sharing a name but differing in behaviour (e.g. the
        default ``cluster`` vs a user replacement) must not share cached
        outputs; the token is folded into the store key of this stage and
        every stage downstream of it."""
        return f"{type(self).__module__}.{type(self).__qualname__}"

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class FunctionStage(Stage):
    """Wrap a plain ``(Artifacts, config) -> Artifacts`` function as a stage —
    the one-liner way to inject custom behaviour into a pipeline."""

    def __init__(self, name: str, fn: Callable[[Artifacts, Any], Artifacts],
                 requires: Tuple[str, ...] = (),
                 provides: Tuple[str, ...] = (),
                 config_keys: Tuple[str, ...] = ()):
        self.name = name
        self._fn = fn
        self.requires = tuple(requires)
        self.provides = tuple(provides)
        self.config_keys = tuple(config_keys)

    def run(self, art: Artifacts, cfg: Any) -> Artifacts:
        return self._fn(art, cfg)

    def cache_token(self) -> str:
        # qualnames collide for distinct lambdas, so pin the exact function
        # object; an id() is only unique within this process, which matches
        # the in-memory lifetime of an ArtifactStore
        fn = self._fn
        return f"{fn.__module__}.{fn.__qualname__}@{id(fn)}"


# ---------------------------------------------------------------------------
# Stage registry
# ---------------------------------------------------------------------------

STAGE_REGISTRY: Dict[str, Type[Stage]] = {}


def register_stage(cls: Type[Stage]) -> Type[Stage]:
    """Class decorator: make a stage constructible by name via
    :func:`get_stage` (and hence from the CLI / saved configs)."""
    STAGE_REGISTRY[cls.name] = cls
    return cls


def get_stage(name: str) -> Stage:
    try:
        return STAGE_REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown stage {name!r}; registered: "
                       f"{sorted(STAGE_REGISTRY)}") from None


# ---------------------------------------------------------------------------
# Default stages (paper Fig. 9, in order)
# ---------------------------------------------------------------------------


@register_stage
class TimingStage(Stage):
    """Synthesis timing (Sec. II-A/II-B): build the slack model."""

    name = "timing"
    provides = ("timing_model", "slack")
    config_keys = ("array_n", "tech", "clock_ns", "seed")

    def run(self, art: Artifacts, cfg: FlowConfig) -> Artifacts:
        tm = TimingModel(n=cfg.array_n, clock_ns=cfg.clock_ns, tech=cfg.node,
                         seed=cfg.seed)
        return art.with_(timing_model=tm, slack=tm.min_slack_flat())


def cluster_slack(slack: np.ndarray, algo: str, n_clusters: Optional[int],
                  seed: int, params: Optional[Dict[str, Any]] = None,
                  impl: str = "vectorized") -> np.ndarray:
    """Run the chosen algorithm with paper-consistent defaults and fold noise.

    ``params`` overrides the defaults (bandwidth / eps / min_pts / linkage /
    k).  Labels are relabelled so cluster 0 has the highest slack.
    ``impl`` selects the vectorized implementations (default) or the loop
    oracles in :mod:`repro_torch.core.clustering_ref` — bit-identical labels,
    orders of magnitude apart in wall clock.
    """
    mod = cl if impl == "vectorized" else cl_ref
    algo = algo.lower()
    params = dict(params or {})
    spread = float(slack.max() - slack.min()) or 1.0
    if algo in ("kmeans", "k-means"):
        labels = mod.kmeans(slack, k=params.pop("k", n_clusters or 4),
                            seed=params.pop("seed", seed), **params)
    elif algo in ("hierarchical", "hierarchy"):
        labels = mod.hierarchical(slack, n_clusters=params.pop("k", n_clusters or 4),
                                  **params)
    elif algo in ("meanshift", "mean-shift"):
        # the paper's radius 0.4 on its ~2.4 ns 16x16 slack spread, rescaled
        labels = mod.meanshift(slack,
                               bandwidth=params.pop("bandwidth", 0.17 * spread),
                               **params)
    elif algo == "dbscan":
        labels = mod.dbscan(slack, eps=params.pop("eps", spread / 12.0),
                            min_pts=params.pop("min_pts",
                                               max(4, len(slack) // 64)),
                            **params)
        labels = mod.attach_noise_to_nearest(slack, labels)
    else:
        raise ValueError(f"unknown algorithm {algo!r}")
    return mod.relabel_by_feature_mean(slack, labels)   # 0 = highest slack


@register_stage
class ClusterStage(Stage):
    """Min-slack clustering (Sec. IV).  Density-based algorithms (mean-shift,
    DBSCAN) choose their own partition count, so the stage reports both the
    *requested* count (``n_partitions_requested`` — what the config asked
    for, possibly None) and the *actual* one (``n_partitions``) instead of
    silently diverging."""

    name = "cluster"
    requires = ("slack",)
    provides = ("labels", "n_partitions", "n_partitions_requested")
    config_keys = ("algo", "n_clusters", "seed", "algo_params", "impl")
    # the synthesized slack structure is tech-independent, so content keying
    # shares one clustering per algorithm across every tech node of a sweep
    content_cache = True

    def run(self, art: Artifacts, cfg: FlowConfig) -> Artifacts:
        labels = cluster_slack(art.slack, cfg.algo, cfg.n_clusters, cfg.seed,
                               dict(cfg.algo_params), impl=cfg.impl)
        return art.with_(labels=labels,
                         n_partitions=int(labels.max()) + 1,
                         n_partitions_requested=cfg.n_clusters)


@register_stage
class FloorplanStage(Stage):
    """Cluster -> voltage-island placement (Sec. II-C, Fig. 8)."""

    name = "floorplan"
    requires = ("labels",)
    provides = ("floorplan",)
    config_keys = ("array_n",)
    content_cache = True                 # same labels -> same floorplan

    def run(self, art: Artifacts, cfg: FlowConfig) -> Artifacts:
        return art.with_(floorplan=grid_floorplan(art.labels, cfg.array_n))


@register_stage
class StaticVoltageStage(Stage):
    """Algorithm 1: ascending band-midpoint voltages; the highest-slack
    cluster (label 0) takes the lowest rail."""

    name = "static_voltage"
    requires = ("slack", "labels", "n_partitions", "floorplan")
    provides = ("static_v", "partition_slack", "floorplan_static")
    config_keys = ("tech", "v_min", "v_crash")

    def run(self, art: Artifacts, cfg: FlowConfig) -> Artifacts:
        v_bands = static_voltage_scaling(cfg.resolved_v_min(),
                                         cfg.resolved_v_crash(),
                                         art.n_partitions)
        part_slack = partition_min_slack(art.labels, art.slack)
        static_v = assign_partition_voltages(part_slack, v_bands)
        return art.with_(static_v=static_v, partition_slack=part_slack,
                         floorplan_static=art.floorplan.with_voltages(static_v))


@register_stage
class RuntimeCalibrationStage(Stage):
    """Algorithm 2 + Razor trial runs on the fault-injecting simulator.

    Adds ``calibration_converged`` (per-partition bool: False where no clean
    trial was ever observed and the rail was pinned at V_ceil) alongside the
    calibrated ``runtime_v``.  With ``calibrate=False`` the stage passes the
    static voltages through unchanged (zero trials).
    """

    name = "runtime_calibration"
    requires = ("timing_model", "static_v", "n_partitions", "floorplan_static")
    provides = ("runtime_v", "razor_trials", "calibrated_fail_free",
                "calibration_converged", "floorplan_runtime")
    config_keys = ("tech", "v_min", "v_crash", "clock_ns", "seed",
                   "calibration_seed", "calibrate", "max_trials",
                   "flag_reduce", "impl", "calibration_method")

    def run(self, art: Artifacts, cfg: FlowConfig) -> Artifacts:
        v_min, v_crash = cfg.resolved_v_min(), cfg.resolved_v_crash()
        cal_seed = cfg.resolved_calibration_seed()
        sim = SystolicSim(art.timing_model, art.floorplan_static,
                          RazorConfig(clock_ns=cfg.clock_ns), impl=cfg.impl)
        static_v = art.static_v
        runtime_v = static_v.copy()
        converged = np.ones(art.n_partitions, dtype=bool)
        trials = 0
        fail_free = True
        if cfg.calibrate:
            scheme = RuntimeScheme(
                v_s=(v_min - v_crash) / art.n_partitions,
                v_floor=v_crash, v_ceil=max(v_min, cfg.node.v_nom),
                flag_reduce=cfg.flag_reduce)

            def trial(v: np.ndarray) -> np.ndarray:
                nonlocal trials
                trials += 1
                return sim.trial_run(v, seed=cal_seed + trials)

            if cfg.calibration_method == "bisect":
                result = scheme.calibrate_bisect(static_v, trial,
                                                 max_trials=cfg.max_trials)
            else:
                result = scheme.calibrate(static_v, trial,
                                          max_trials=cfg.max_trials)
            runtime_v = np.asarray(result)
            converged = result.converged
            fail_free = not sim.trial_run(runtime_v,
                                          seed=cal_seed + 10_000).any()
        return art.with_(
            runtime_v=runtime_v, razor_trials=trials,
            calibrated_fail_free=bool(fail_free),
            calibration_converged=converged,
            floorplan_runtime=art.floorplan.with_voltages(runtime_v))


@register_stage
class PowerStage(Stage):
    """Calibrated power model (Sec. V-C / Table II): baseline vs static vs
    runtime.  When the calibration stage was skipped, the runtime numbers
    fall back to the static voltages."""

    name = "power"
    requires = ("labels", "n_partitions", "static_v")
    provides = ("baseline_mw", "static_mw", "runtime_mw",
                "static_reduction_pct", "runtime_reduction_pct")
    config_keys = ("array_n", "tech", "freq_mhz", "activity", "impl")

    def run(self, art: Artifacts, cfg: FlowConfig) -> Artifacts:
        if cfg.impl == "reference":
            # seed-faithful baseline: per-run interpreted exponent fit
            from ..core.power import fit_power_exponent_ref
            pm = model_for(cfg.tech, k=fit_power_exponent_ref(cfg.tech),
                           freq_mhz=cfg.freq_mhz, activity=cfg.activity)
        else:
            pm = model_for(cfg.tech, freq_mhz=cfg.freq_mhz,
                           activity=cfg.activity)
        runtime_v = art.get("runtime_v", art.static_v)
        frac = np.bincount(art.labels, minlength=art.n_partitions) / art.labels.size
        baseline = pm.baseline_mw(cfg.array_n, cfg.node.v_nom)
        static_mw = pm.partitioned_mw(cfg.array_n, art.static_v, frac,
                                      v_ref=cfg.node.v_nom)
        runtime_mw = pm.partitioned_mw(cfg.array_n, runtime_v, frac,
                                       v_ref=cfg.node.v_nom)
        return art.with_(
            baseline_mw=baseline, static_mw=static_mw, runtime_mw=runtime_mw,
            static_reduction_pct=100.0 * (1 - static_mw / baseline),
            runtime_reduction_pct=100.0 * (1 - runtime_mw / baseline))


@register_stage
class ConstraintsStage(Stage):
    """Constraint-file artifacts (Sec. II-C step 3).  Matches the monolith:
    XDC/SDC are rendered from the *static*-voltage floorplan (the files the
    flow hands to the vendor tool before runtime tuning exists)."""

    name = "constraints"
    requires = ("floorplan_static",)
    provides = ("xdc", "sdc")
    config_keys = ("clock_ns",)

    def run(self, art: Artifacts, cfg: FlowConfig) -> Artifacts:
        return art.with_(xdc=generate_xdc(art.floorplan_static, cfg.clock_ns),
                         sdc=generate_sdc(art.floorplan_static, cfg.clock_ns))


@register_stage
class HwLoopStage(Stage):
    """Hardware-in-the-loop emulation: execute probe inference traffic on
    the calibrated voltage islands through the ``repro_torch.backend``
    execution protocol, yielding the voltage→(accuracy-proxy, energy/token,
    replay-rate) observables that close the loop between the CAD flow and
    real inference.

    ``cfg.backend`` selects the execution target: ``"emulated"`` (default)
    is the fault-injecting accelerator with the energy ledger;
    ``"simulated"`` runs the cycle-level :class:`SystolicSim` at the same
    calibrated rails (flags/silent observables, no energy model);
    ``"ideal"``/``"reference"`` are the exact baselines (zero flags).

    Opt-in: not part of :data:`DEFAULT_STAGE_NAMES`; insert it after
    ``power`` (``repro_torch.hwloop.hwloop_pipeline()`` does exactly that)
    so ``sweep()`` produces Pareto tables across tech nodes.

    The backend runs on the stage's ``device`` (``None``, the default,
    means the GPU; without one :meth:`run` raises): it is the instance's,
    not a config field, because :class:`FlowConfig` and its cache keys stay
    the reference's.  The probe traffic is drawn with numpy as the
    reference draws it, then put on that device.
    """

    name = "hwloop"
    requires = ("timing_model", "floorplan_runtime", "n_partitions")
    provides = ("hwloop_energy_per_token_j", "hwloop_energy_per_mac_j",
                "hwloop_replay_rate", "hwloop_flag_rate",
                "hwloop_silent_rate", "hwloop_rel_error")
    config_keys = ("array_n", "tech", "clock_ns", "freq_mhz", "activity",
                   "seed", "calibration_seed", "hwloop_steps", "hwloop_rows",
                   "hwloop_corruption", "backend")

    def __init__(self, device=None):
        self.device = device

    def _backend(self, art: Artifacts, cfg: FlowConfig):
        # imported lazily: the emulated backend reaches into hwloop, which
        # imports flow at package level
        from .._device import resolve_device
        from ..backend import get_backend
        from ..backend.impls import EmulatedBackend, SimulatedBackend
        device = resolve_device(self.device)
        if cfg.backend == "emulated":
            from ..hwloop.device import EmulatedAccelerator
            return EmulatedBackend(EmulatedAccelerator(
                art.timing_model, art.floorplan_runtime,
                razor=RazorConfig(clock_ns=cfg.clock_ns),
                power=model_for(cfg.tech, freq_mhz=cfg.freq_mhz,
                                activity=cfg.activity),
                corruption=cfg.hwloop_corruption, device=device))
        if cfg.backend == "simulated":
            return SimulatedBackend(SystolicSim(
                art.timing_model, art.floorplan_runtime,
                RazorConfig(clock_ns=cfg.clock_ns)), device=device)
        return get_backend(cfg.backend, device=device)

    def run(self, art: Artifacts, cfg: FlowConfig) -> Artifacts:
        be = self._backend(art, cfg)
        rng = np.random.default_rng(cfg.resolved_calibration_seed() + 99_991)
        n = cfg.array_n
        flags = np.zeros(art.n_partitions, dtype=np.float64)
        silent = 0
        rel_errors = []
        for _ in range(cfg.hwloop_steps):
            a = rng.normal(size=(cfg.hwloop_rows, n))
            w = rng.normal(size=(n, n))
            _, tel = be.matmul(a, w)
            if tel.partition_flags is not None:
                flags += np.asarray(tel.partition_flags, dtype=np.float64)
            silent += tel.silent
            rel_errors.append(tel.rel_error)
        be.add_tokens(cfg.hwloop_steps)  # one probe step ~ one served token
        led = getattr(be, "ledger", None)
        total_macs = max(be.total.macs, 1)
        return art.with_(
            hwloop_energy_per_token_j=(led.energy_per_token_j
                                       if led is not None else None),
            hwloop_energy_per_mac_j=(led.energy_per_mac_j
                                     if led is not None else None),
            hwloop_replay_rate=(led.replay_rate if led is not None
                                else be.total.replays / total_macs),
            hwloop_flag_rate=(flags / cfg.hwloop_steps).tolist(),
            hwloop_silent_rate=silent / total_macs,
            hwloop_rel_error=float(np.mean(rel_errors)))


#: Canonical stage order of the paper's flow.
DEFAULT_STAGE_NAMES: Tuple[str, ...] = (
    "timing", "cluster", "floorplan", "static_voltage",
    "runtime_calibration", "power", "constraints")


def default_stages() -> Tuple[Stage, ...]:
    """Fresh instances of the canonical Fig. 9 stage chain."""
    return tuple(get_stage(n) for n in DEFAULT_STAGE_NAMES)
