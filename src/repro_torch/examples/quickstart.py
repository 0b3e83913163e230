"""Quickstart: the paper's full CAD flow on the staged repro_torch.flow
pipeline — config -> pipeline -> report, then a multi-scenario sweep.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

Counterpart of ``examples/quickstart.py``.  The flow is host code (numpy), so
this example takes no ``--device``: it is the same on every machine.
:func:`run` returns what :func:`main` prints.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..core import TimingModel, render_report_table
from ..flow import (ArtifactStore, FlowConfig, FlowReport, Pipeline,
                    SweepResult, report_from, sweep)

#: the sweep's grid: two tech nodes x two clustering algorithms
SWEEP_GRID = {"tech": ["vivado-28nm", "vtr-22nm"],
              "algo": ["kmeans", "dbscan"]}
SWEEP_COLUMNS = ("tech", "algo", "n_partitions", "static_reduction_pct",
                 "runtime_reduction_pct")


@dataclasses.dataclass
class QuickstartResult:
    """What the example computes: the stage chain, the flow's report, the
    worst synthesis paths and the sweep (which shares the report's store)."""
    cfg: FlowConfig
    stages: List[str]
    report: FlowReport
    timing_table: str
    result: SweepResult


def run() -> QuickstartResult:
    """The paper's pipeline (Fig. 9) on a 16 x 16 vivado-28nm array
    (DBSCAN, seed 2021), the timing report of that array, and the 2 x 2
    sweep over tech x algo on the same artifact store."""
    cfg = FlowConfig(array_n=16, tech="vivado-28nm", algo="dbscan",
                     seed=2021)
    pipe = Pipeline()                  # the default Fig. 9 stage chain
    store = ArtifactStore()            # caches stage outputs across runs
    report = report_from(pipe.run(cfg, store=store), cfg)
    tm = TimingModel(n=cfg.array_n, seed=cfg.seed)
    # the timing stage runs once per tech, not once per config
    result = sweep(SWEEP_GRID, cfg, store=store)
    return QuickstartResult(cfg=cfg, stages=[s.name for s in pipe.stages],
                            report=report,
                            timing_table=render_report_table(tm.report(5)),
                            result=result)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    out = run()
    report = out.report
    print("stages:", out.stages)
    print(report.summary())
    print()

    print("worst 5 synthesis paths (cf. paper Table I):")
    print(out.timing_table)
    print()

    print("static  V_ccint per partition:", np.round(report.static_v, 4))
    print("runtime V_ccint per partition:", np.round(report.runtime_v, 4))
    print(f"razor trial runs used: {report.razor_trials}; "
          f"fail-free after calibration: {report.calibrated_fail_free}; "
          f"converged: {report.calibration_converged.tolist()}")
    print()

    print("first 6 lines of the generated XDC:")
    print("\n".join(report.xdc.splitlines()[:6]))
    print()

    print(f"power: baseline {report.baseline_mw:.0f} mW -> static "
          f"{report.static_mw:.0f} mW ({report.static_reduction_pct:.2f}% "
          f"saved, paper reports 6.37%) -> runtime {report.runtime_mw:.0f} mW "
          f"({report.runtime_reduction_pct:.2f}%)")
    print()

    result = out.result
    print(result.table(columns=SWEEP_COLUMNS))
    print(f"(timing stage executed {result.timing_stage_runs()}x "
          f"for {len(result.configs)} configs)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
