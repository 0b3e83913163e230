"""CLI for the port's static-analysis subsystem.

::

    python -m repro_torch.analysis lint [paths] [--baseline lint_baseline_torch.json]
    python -m repro_torch.analysis lint --write-baseline   # absorb current
    python -m repro_torch.analysis rules                   # list rule codes
    python -m repro_torch.analysis census [--device cpu] [--json out.json] \\
        [--check census_baseline_torch.json]
    python -m repro_torch.analysis census --device cpu --write-baseline

``lint`` (default: ``src/repro_torch``) exits 1 on any finding not covered
by an inline ``# lint: allow=RPxxx`` marker or the baseline.  ``census``
runs on the GPU unless ``--device cpu`` asks for the CPU (with no GPU and no
``--device`` it raises, as every entry point of the port does); ``--check``
exits 1 when a call's ``host_syncs`` rose above its pin or its
``backend_gemms``, ``dots`` or ``kernel_calls`` changed.  Counterpart of
``python -m repro.analysis``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .census import (CENSUS_ARCHS, CENSUS_BACKENDS, census, census_advice,
                     check_census, load_census, write_census)
from .checker import DEFAULT_BASELINE, lint_paths
from .findings import write_baseline
from .rules import RULES

CENSUS_BASELINE = "census_baseline_torch.json"


def _repo_root() -> Path:
    # src/repro_torch/analysis/__main__.py -> repo root is three levels up
    return Path(__file__).resolve().parents[3]


def _cmd_lint(args: argparse.Namespace) -> int:
    root = _repo_root()
    paths = [Path(p) for p in args.paths] or [root / "src" / "repro_torch"]
    baseline = None if args.no_baseline else Path(args.baseline)
    if args.write_baseline:
        all_findings, _ = lint_paths(paths, root=root, baseline_path=None)
        write_baseline(all_findings, Path(args.baseline))
        print(f"wrote {len(all_findings)} finding(s) to {args.baseline}")
        return 0
    fresh, absorbed = lint_paths(paths, root=root, baseline_path=baseline)
    for f in fresh:
        print(f.format())
    tail = f" ({absorbed} baselined)" if absorbed else ""
    if fresh:
        print(f"\n{len(fresh)} finding(s){tail}")
        return 1
    print(f"clean{tail}")
    return 0


def _cmd_rules(_args: argparse.Namespace) -> int:
    for r in RULES:
        scope = "/".join(r.scopes) or "src"
        print(f"{r.code}  [{scope}]  {r.description}\n    fix: {r.fix_hint}")
    return 0


def _cmd_census(args: argparse.Namespace) -> int:
    archs = args.arch or list(CENSUS_ARCHS)
    backends = args.backend or list(CENSUS_BACKENDS)
    report = census(archs, backends, device=args.device)
    if args.json:
        write_census(report, Path(args.json))
        print(f"census written to {args.json}")
    if args.write_baseline:
        write_census(report, Path(args.baseline))
        print(f"baseline repinned at {args.baseline}")
        return 0
    for be, run in report["backends"].items():
        for arch, cfg in run["configs"].items():
            for phase in ("prefill", "decode"):
                c = cfg.get(phase)
                if c is None:
                    continue
                print(f"{be:9s} {arch:24s} {phase:7s} "
                      f"gemms={c['backend_gemms']:4d} dots={c['dots']:4d} "
                      f"flops={c['flops']:.3e} syncs={c['host_syncs']:3d} "
                      f"kernels={c['kernel_calls']} "
                      f"dtypes={c['dot_dtypes']}")
    if args.check:
        baseline = load_census(Path(args.check))
        for note in census_advice(report, baseline):
            print(f"census advice (stale pin): {note}")
        problems = check_census(report, baseline)
        for p in problems:
            print(f"CENSUS GATE: {p}")
        if problems:
            return 1
        print("census gate: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    lint = sub.add_parser("lint", help="run the invariant linter")
    lint.add_argument("paths", nargs="*",
                      help="files or trees (default src/repro_torch)")
    lint.add_argument("--baseline",
                      default=str(_repo_root() / DEFAULT_BASELINE))
    lint.add_argument("--no-baseline", action="store_true")
    lint.add_argument("--write-baseline", action="store_true",
                      help="absorb every current finding into the baseline")
    lint.set_defaults(fn=_cmd_lint)

    rules = sub.add_parser("rules", help="list rule codes and fix hints")
    rules.set_defaults(fn=_cmd_rules)

    cen = sub.add_parser("census", help="dispatch census of each model call")
    cen.add_argument("--arch", action="append",
                     help="config name (repeatable; default: one per family)")
    cen.add_argument("--backend", action="append",
                     help="backend to run under (repeatable; default "
                          "reference and ideal)")
    cen.add_argument("--device", choices=("cuda", "cpu"), default=None,
                     help="where the census runs (default: the GPU)")
    cen.add_argument("--json", help="write the full census report here")
    cen.add_argument("--check", help="baseline to gate against")
    cen.add_argument("--baseline",
                     default=str(_repo_root() / CENSUS_BASELINE))
    cen.add_argument("--write-baseline", action="store_true")
    cen.set_defaults(fn=_cmd_census)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
