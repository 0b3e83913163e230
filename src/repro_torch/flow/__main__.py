"""CLI for the staged CAD flow.

    PYTHONPATH=src python -m repro_torch.flow run [--tech vivado-28nm] [--algo dbscan]
    PYTHONPATH=src python -m repro_torch.flow sweep --tech vivado-28nm,vtr-22nm \
        --algo kmeans,dbscan --array-n 16

``run`` executes one config and prints the report (summary, voltages,
power); ``sweep`` fans a grid through the shared-cache pipeline and prints
the tidy comparison table plus cache statistics.  ``--config file.json``
loads a serialized ``FlowConfig`` (CLI flags override it).

``--points-out`` (and its ``--points-levels``/``--points-probe-steps``) is
accepted as in ``repro.flow`` but stops with the ROADMAP item: the railscale
operating-point tables it writes are not ported yet (ROADMAP.md A10).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from . import FlowConfig, run, sweep
from .config import KNOWN_ALGOS
from ..core.timing import TECH_NODES


def _csv(kind):
    def parse(s: str) -> List:
        return [kind(x) for x in s.split(",") if x]
    return parse


def _add_config_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--config", type=str, default=None,
                    help="JSON file with a serialized FlowConfig")
    ap.add_argument("--clock-ns", type=float, default=None)
    ap.add_argument("--n-clusters", type=int, default=None)
    ap.add_argument("--max-trials", type=int, default=None)
    ap.add_argument("--no-calibrate", action="store_true",
                    help="skip the Razor runtime-calibration stage")
    ap.add_argument("--points-out", type=str, default=None, metavar="FILE",
                    help="distill each report into a railscale operating-"
                         "point table (nominal down to calibrated rails) "
                         "and write the JSON ladder file here")
    ap.add_argument("--points-levels", type=int, default=4,
                    help="rungs per operating-point ladder (default 4)")
    ap.add_argument("--points-probe-steps", type=int, default=6,
                    help="probe matmuls per rung when characterizing "
                         "energy/flag rates (default 6)")


def _base_config(args: argparse.Namespace,
                 extra: Optional[Dict[str, Any]] = None) -> FlowConfig:
    d: Dict[str, Any] = {}
    if args.config:
        with open(args.config) as f:
            d.update(json.load(f))
    for field, flag in (("clock_ns", "clock_ns"), ("n_clusters", "n_clusters"),
                        ("max_trials", "max_trials")):
        v = getattr(args, flag)
        if v is not None:
            d[field] = v
    if args.no_calibrate:
        d["calibrate"] = False
    d.update(extra or {})
    return FlowConfig.from_dict(d)


def _cmd_run(args: argparse.Namespace) -> int:
    cfg = _base_config(args, {"array_n": args.array_n, "tech": args.tech,
                              "algo": args.algo, "seed": args.seed})
    rep = run(cfg)
    print(rep.summary())
    req = rep.n_partitions_requested
    print(f"partitions: {rep.n_partitions}"
          + ("" if req in (None, rep.n_partitions) else f" (requested {req})"))
    print("static  V_ccint:", np.round(rep.static_v, 4).tolist())
    print("runtime V_ccint:", np.round(rep.runtime_v, 4).tolist())
    if rep.calibration_converged is not None:
        print("converged:      ", rep.calibration_converged.tolist())
    print(f"razor trials: {rep.razor_trials}  "
          f"fail-free: {rep.calibrated_fail_free}")
    print(f"power: baseline {rep.baseline_mw:.1f} mW  "
          f"static {rep.static_mw:.1f} mW ({rep.static_reduction_pct:.2f}%)  "
          f"runtime {rep.runtime_mw:.1f} mW ({rep.runtime_reduction_pct:.2f}%)")
    if args.emit_xdc:
        print(rep.xdc)
    return 0


def _cmd_sweep(args: argparse.Namespace) -> int:
    base = _base_config(args, {"seed": args.seed})
    grid = {"tech": args.tech, "array_n": args.array_n, "algo": args.algo}
    result = sweep(grid, base)
    print(result.table())
    print()
    print(f"# {len(result.configs)} configs; timing stage executed "
          f"{result.timing_stage_runs()}x; cache: {result.store.summary()}")
    best = result.best()
    print(f"# best runtime reduction: {best['tech']} {best['algo']} "
          f"{best['array_n']}x{best['array_n']} "
          f"-> {best['runtime_reduction_pct']:.2f}%")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.flow",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="execute one flow config")
    p_run.add_argument("--array-n", type=int, default=16)
    p_run.add_argument("--tech", choices=sorted(TECH_NODES), default="vivado-28nm")
    p_run.add_argument("--algo", choices=KNOWN_ALGOS, default="dbscan")
    p_run.add_argument("--seed", type=int, default=2021)
    p_run.add_argument("--emit-xdc", action="store_true",
                       help="print the generated XDC constraints")
    _add_config_flags(p_run)
    p_run.set_defaults(fn=_cmd_run)

    p_sweep = sub.add_parser("sweep", help="fan a config grid through the "
                                           "pipeline with shared caching")
    p_sweep.add_argument("--tech", type=_csv(str),
                         default=list(sorted(TECH_NODES)))
    p_sweep.add_argument("--algo", type=_csv(str), default=list(KNOWN_ALGOS))
    p_sweep.add_argument("--array-n", type=_csv(int), default=[16])
    p_sweep.add_argument("--seed", type=int, default=2021)
    _add_config_flags(p_sweep)
    p_sweep.set_defaults(fn=_cmd_sweep)

    args = ap.parse_args(argv)
    if args.points_out:
        ap.error("not ported to repro_torch yet (ROADMAP.md A10: railscale/) "
                 "— --points-out")
    try:
        return args.fn(args)
    except BrokenPipeError:        # e.g. `... | head` closed the pipe
        return 0


if __name__ == "__main__":
    sys.exit(main())
