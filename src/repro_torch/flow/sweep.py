"""Multi-scenario sweeps.

``sweep()`` fans a grid of :class:`~repro_torch.flow.config.FlowConfig` operating
points (tech node x clustering algorithm x array size x ...) through one
pipeline with a *shared* artifact store, so expensive prefixes — above all
the timing stage — are computed once per distinct ``(tech, array_n,
clock_ns, seed)`` and reused by every config that shares them.  The result
is a tidy comparison table (list-of-dicts + text rendering).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Union

from .artifacts import ArtifactStore
from .config import FlowConfig
from .pipeline import Pipeline
from .report import FlowReport, report_from

#: The tidy columns every sweep row carries.
ROW_COLUMNS = ("tech", "algo", "array_n", "seed", "n_partitions",
               "n_partitions_requested", "baseline_mw", "static_mw",
               "runtime_mw", "static_reduction_pct", "runtime_reduction_pct",
               "razor_trials", "calibrated_fail_free")

#: Extra columns added when the opt-in ``hwloop`` emulation stage ran — the
#: voltage→(energy/token, replay-rate, accuracy-proxy) Pareto observables.
HWLOOP_COLUMNS = ("hwloop_energy_per_token_j", "hwloop_replay_rate",
                  "hwloop_flag_rate", "hwloop_silent_rate",
                  "hwloop_rel_error")


def expand_grid(grid: Mapping[str, Sequence[Any]],
                base: Optional[FlowConfig] = None) -> List[FlowConfig]:
    """Cartesian product of ``{config_field: [values...]}`` over ``base``.

    Axis insertion order is preserved; the *last* axis varies fastest — put
    cheap-to-vary fields (algo) after expensive ones (tech, array_n) so
    consecutive runs share cached prefixes.
    """
    base = base or FlowConfig()
    axes = [(k, list(v)) for k, v in grid.items()]
    for k, vals in axes:
        if not hasattr(base, k):
            raise ValueError(f"unknown FlowConfig field {k!r} in sweep grid")
        if not vals:
            raise ValueError(f"sweep axis {k!r} is empty")
    out = []
    for combo in itertools.product(*(v for _, v in axes)):
        out.append(base.replace(**dict(zip((k for k, _ in axes), combo))))
    return out


@dataclasses.dataclass
class SweepResult:
    configs: List[FlowConfig]
    reports: List[FlowReport]
    store: ArtifactStore
    # wall-clock seconds per config, in ``configs`` order (cache hits show up
    # as near-zero entries) — the raw data behind benchmarks' BENCH_flow.json
    elapsed_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def total_elapsed_s(self) -> float:
        return float(sum(self.elapsed_s))

    def _has_hwloop(self) -> bool:
        return any(r.hwloop_energy_per_token_j is not None
                   for r in self.reports)

    def rows(self) -> List[Dict[str, Any]]:
        """Tidy comparison rows, one per config (stable column set; the
        hwloop columns join when the emulation stage ran)."""
        out = []
        hwloop = self._has_hwloop()
        for cfg, rep in zip(self.configs, self.reports):
            row = {
                "tech": rep.tech, "algo": rep.algo, "array_n": rep.array_n,
                "seed": cfg.seed, "n_partitions": rep.n_partitions,
                "n_partitions_requested": rep.n_partitions_requested,
                "baseline_mw": rep.baseline_mw, "static_mw": rep.static_mw,
                "runtime_mw": rep.runtime_mw,
                "static_reduction_pct": rep.static_reduction_pct,
                "runtime_reduction_pct": rep.runtime_reduction_pct,
                "razor_trials": rep.razor_trials,
                "calibrated_fail_free": rep.calibrated_fail_free,
            }
            if hwloop:
                for c in HWLOOP_COLUMNS:
                    row[c] = getattr(rep, c)
            out.append(row)
        return out

    def best(self, key: str = "runtime_reduction_pct") -> Dict[str, Any]:
        return max(self.rows(), key=lambda r: r[key])

    def table(self, columns: Optional[Sequence[str]] = None) -> str:
        """Fixed-width text table of the tidy rows (hwloop columns appear
        automatically when the emulation stage ran)."""
        if columns is None:
            columns = ROW_COLUMNS + (HWLOOP_COLUMNS if self._has_hwloop()
                                     else ())
        rows = self.rows()
        cells = [[_fmt(r[c]) for c in columns] for r in rows]
        widths = [max(len(c), *(len(row[i]) for row in cells)) if cells
                  else len(c) for i, c in enumerate(columns)]
        lines = ["  ".join(c.ljust(w) for c, w in zip(columns, widths))]
        lines.append("  ".join("-" * w for w in widths))
        for row in cells:
            lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
        return "\n".join(lines)

    def timing_stage_runs(self) -> int:
        """How many times the timing stage actually executed across the sweep
        (== number of distinct (tech, array_n, clock_ns, seed) prefixes)."""
        return self.store.runs_of("timing")


def sweep(grid: Union[Mapping[str, Sequence[Any]], Iterable[FlowConfig]],
          base: Optional[FlowConfig] = None, *,
          pipeline: Optional[Pipeline] = None,
          store: Optional[ArtifactStore] = None) -> SweepResult:
    """Run every config of ``grid`` through the pipeline with shared caching.

    ``grid`` is either ``{field: [values...]}`` (expanded as a cartesian
    product over ``base``) or an explicit iterable of ``FlowConfig``s.
    """
    if isinstance(grid, Mapping):
        configs = expand_grid(grid, base)
    else:
        configs = list(grid)
        if base is not None:
            raise ValueError("base is only meaningful with a grid mapping")
    pipeline = pipeline or Pipeline()
    store = store or ArtifactStore()
    reports = []
    elapsed: List[float] = []
    for cfg in configs:
        t0 = time.perf_counter()
        art = pipeline.run(cfg, store=store)
        reports.append(report_from(art, cfg))
        elapsed.append(time.perf_counter() - t0)
    return SweepResult(configs=configs, reports=reports, store=store,
                       elapsed_s=elapsed)


def _fmt(v: Any) -> str:
    if isinstance(v, bool) or v is None:
        return str(v)
    if isinstance(v, float):
        # sub-centi values (energies in joules, rates) need sig-figs, not 0.00
        return f"{v:.3g}" if 0.0 < abs(v) < 0.01 else f"{v:.2f}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_fmt(float(x)) for x in v) + "]"
    return str(v)
