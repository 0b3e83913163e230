"""Paper-technique power report for every (arch x shape) cell.  Counterpart
of ``repro.roofline.power_report``, on the port's ``flow``, ``core`` and
``analytic``.

Each cell's MODEL_FLOPS are converted to MAC counts and 'executed' on the
paper's virtual partitioned systolic array: the paper's flow (slack model
-> DBSCAN clusters -> Algorithm 1 -> Algorithm 2 calibration) assigns
per-partition rail voltages, and the calibrated PowerModel turns MAC counts
into energy — with and without voltage scaling, plus the beyond-paper
precision-island variant.  No device constant enters a row.

CLI (writes the rows as JSON only where asked):

    PYTHONPATH=src python -m repro_torch.roofline.power_report \
        [--tech vtr-22nm] [--json-out BENCH_power_report.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

import numpy as np

from ..configs import ARCHS, SHAPES, cell_is_runnable, get_config
from ..core import model_for
from ..core.precision import ENERGY_PER_MAC, TIERS
from ..core.timing import TECH_NODES
from ..flow import ArtifactStore, FlowConfig, FlowReport, Pipeline, run
from .analytic import model_flops


@dataclasses.dataclass
class PowerRow:
    arch: str
    shape: str
    macs: float
    baseline_j: float                 # all partitions at nominal V
    static_j: float                   # Algorithm-1 voltages
    runtime_j: float                  # Algorithm-2 calibrated voltages
    precision_j: float                # beyond-paper int4/int8/bf16 islands
    static_saving_pct: float
    runtime_saving_pct: float
    precision_saving_pct: float


# Shared artifact store + pipeline: repeated power_row() calls (any tech)
# reuse every cached stage output instead of re-running the Fig. 9 flow per
# call, and the content-addressed cluster/floorplan stages are computed once
# and shared across tech nodes (the slack structure is tech-independent —
# the same sharing PR 3's sweep caching exploits).
_STORE = ArtifactStore()
_PIPELINE = Pipeline()


def _flow(tech: str = "vtr-22nm") -> FlowReport:
    # the paper's flow with DBSCAN on a 64 x 64 virtual array
    return run(FlowConfig(array_n=64, tech=tech, algo="dbscan",
                          seed=2021, max_trials=24),
               pipeline=_PIPELINE, store=_STORE)


def power_row(arch: str, shape_name: str, tech: str = "vtr-22nm") -> PowerRow:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    macs = model_flops(cfg, shape) / 2.0
    flow = _flow(tech)
    pm = model_for(tech)
    n_part = flow.n_partitions
    frac = np.bincount(flow.labels, minlength=n_part) / flow.labels.size

    nominal_v = [pm.tech.v_nom] * n_part
    base = pm.macs_energy_j(macs, nominal_v, frac)
    static = pm.macs_energy_j(macs, flow.static_v, frac)
    runtime = pm.macs_energy_j(macs, flow.runtime_v, frac)
    # beyond-paper: precision islands using the same cluster fractions;
    # cheapest tier on the highest-slack cluster
    tier_energy = np.array([ENERGY_PER_MAC[TIERS[min(i, len(TIERS) - 1)]]
                            for i in range(n_part)])
    precision = float(base * np.sum(frac * tier_energy))
    return PowerRow(
        arch=arch, shape=shape_name, macs=macs,
        baseline_j=base, static_j=static, runtime_j=runtime,
        precision_j=precision,
        static_saving_pct=100 * (1 - static / base),
        runtime_saving_pct=100 * (1 - runtime / base),
        precision_saving_pct=100 * (1 - precision / base),
    )


def all_rows(tech: str = "vtr-22nm") -> List[PowerRow]:
    out = []
    for arch in ARCHS:
        for shape_name, shape in SHAPES.items():
            ok, _ = cell_is_runnable(get_config(arch), shape)
            if ok:
                out.append(power_row(arch, shape_name, tech))
    return out


def render_markdown(rows: List[PowerRow]) -> str:
    hdr = ("| arch | shape | MACs | baseline J | static J | runtime J | "
           "precision J | runtime saving | precision saving |")
    out = [hdr, "|" + "---|" * 9]
    for r in rows:
        out.append(f"| {r.arch} | {r.shape} | {r.macs:.2e} | "
                   f"{r.baseline_j:.3g} | {r.static_j:.3g} | "
                   f"{r.runtime_j:.3g} | {r.precision_j:.3g} | "
                   f"{r.runtime_saving_pct:.1f}% | "
                   f"{r.precision_saving_pct:.1f}% |")
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tech", default="vtr-22nm", choices=sorted(TECH_NODES),
                    help="technology node for the virtual arrays")
    ap.add_argument("--json-out", default=None,
                    help="also write the rows as a JSON file "
                         "(e.g. BENCH_power_report.json)")
    args = ap.parse_args(argv)
    rows = all_rows(args.tech)
    print(render_markdown(rows))
    if args.json_out:
        payload = {
            "tech": args.tech,
            "rows": [dataclasses.asdict(r) for r in rows],
            "flow_cache": {
                "timing_stage_runs": _STORE.runs_of("timing"),
                "cluster_stage_runs": _STORE.runs_of("cluster"),
            },
        }
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"wrote {args.json_out}")


if __name__ == "__main__":
    main()
