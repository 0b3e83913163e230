#!/usr/bin/env python3
"""Readings that set a cell's correctness limits, on the chip.

    python3 bench/control.py --workload <cell> --seeds <a,b,c>
        [--seconds s] [--stand-ins program,control.fp8,...]

For each seed, at the cell's own size: the cell's window (``--seconds``),
then the cell's own check (its driver's ``check()``, at the limits of the
cell's file) once for each stand-in, each put in the program's place on
the window's requests or batches:

* ``program``: the program's own outputs, as a run judges them;
* ``control.fp8``, ``control.int8``: the plain reference one precision
  below the configurations' bf16 (every GEMM's operands rounded to fp8
  e4m3, or to int8, grids).  fp8 is the control and has to come out not
  correct; int8 is read beside it;
* ``half_batch`` (scored and trained cells): the reference on the first
  half of each batch, its mean taken over that half alone.

One JSON line a seed, each stand-in's numbers with its ``correct``; then
one line with each number's least and largest reading and each stand-in's
count of correct seeds.  Exits 1 where the program was not correct on a
seed, or the control was correct on one.  The benchmark's runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[1]
#: the precisions one step below the configurations' bf16
LOW = ("fp8", "int8")
CONTROL = "control.fp8"
STAND_INS = ("program",) + tuple(f"control.{p}" for p in LOW) \
    + ("half_batch",)


def stand_ins(ctx) -> Dict[str, Callable[[], List]]:
    """Runs the cell's window; returns, by stand-in, a function giving the
    checks of the cell's driver with that stand-in judged."""
    from bench.harness import common
    drv = common.driver(ctx)
    kind = ctx.traffic["driver"]
    half = int(ctx.traffic.get("batch", 0)) // 2
    if kind == "serve":
        _, served = drv.measure(ctx)
        out = {"program": lambda: drv.check(ctx, served)}
        for p in LOW:
            out[f"control.{p}"] = lambda p=p: drv.check(ctx, served, p)
        return out
    if kind == "score":
        _, values = drv.measure(ctx)
        out = {"program": lambda: drv.check(ctx, values),
               "half_batch": lambda: drv.check(
                   ctx, values,
                   lambda picks: drv.reference_losses(ctx, picks, rows=half))}
        for p in LOW:
            out[f"control.{p}"] = lambda p=p: drv.check(
                ctx, values,
                lambda picks: drv.reference_losses(ctx, picks, p))
        return out
    if kind == "train":
        _, first = drv.measure(ctx)
        ref: List = []

        def judged(steps) -> List:
            if not ref:
                ref.append(drv.reference_steps(ctx))
            return drv.check(ctx, *steps, ref=ref[0])
        out = {"program": lambda: judged(first),
               "half_batch": lambda: judged(
                   drv.reference_steps(ctx, rows=half))}
        for p in LOW:
            out[f"control.{p}"] = lambda p=p: judged(
                drv.reference_steps(ctx, p))
        return out
    raise ValueError(f"no stand-ins for driver {kind!r}")


def readings(ctx, names) -> Dict[str, Dict]:
    """Each named stand-in's numbers and ``correct`` for one seed."""
    from bench.harness import common
    found = {}
    for name, checks_of in stand_ins(ctx).items():
        if name not in names:
            continue
        checks = checks_of()
        common.free_device()
        found[name] = {**{c.name: c.value for c in checks},
                       "correct": bool(checks) and all(c.ok for c in checks)}
    return found


def summary(rows: List[Dict[str, Dict]]) -> Dict[str, Dict]:
    """Each number's [least, largest] and each stand-in's correct seeds."""
    out: Dict[str, Dict] = {}
    for name in rows[0]:
        got = [r[name] for r in rows]
        out[name] = {k: [min(g[k] for g in got), max(g[k] for g in got)]
                     for k in got[0] if k != "correct"}
        out[name]["correct_seeds"] = sum(g["correct"] for g in got)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--stand-ins", default=",".join(STAND_INS))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench.harness import common
    common.setup_environment(ROOT)
    common.require_cuda(1)
    names = args.stand_ins.split(",")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = common.build_context(args.workload, seed, args.seconds)
        rows.append(readings(ctx, names))
        common.free_device()
        print(json.dumps({"seed": seed, **rows[-1]}), flush=True)
    total = summary(rows)
    print(json.dumps(total), flush=True)
    sound = total.get("program", {}).get("correct_seeds", len(rows))
    caught = total.get(CONTROL, {}).get("correct_seeds", 0) == 0
    return 0 if sound == len(rows) and caught else 1


if __name__ == "__main__":
    sys.exit(main())
