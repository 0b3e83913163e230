#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA devices.
The cell is an entry of ``BENCHMARK.json``; its configuration, traffic,
limits, driver and per-layer readers are files under ``bench/`` found by
name (``bench/harness/manifest.py``).  The run loads the program
(``repro_torch``, under ``src/``), makes its inputs and weights from the
seed, warms up, measures for ``--seconds`` and checks what the timed path
produced against the plain reference.

The last lines of standard error are the numbers compared, each beside its
limit; the last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``.  Without a CUDA device, or with a JAX
module loaded when the run ends, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(rec, ctx, e2e, layer, chips: int) -> dict:
    """The run's JSON object, from its record."""
    import torch
    from bench.harness.manifest import load_module
    out_metrics = {}
    if ctx.trace:
        for m in layer:
            v = load_module("metrics", m["name"]).read(rec)
            if v is not None:
                out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in e2e:
            v = rec.setup_s if m["name"] == "setup_s" else rec.e2e[m["name"]]
            out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": rec.memory_peak_bytes}
    line = {"correct": bool(rec.checks) and all(c.ok for c in rec.checks),
            "attempted": rec.attempted, "failed": rec.failed,
            "metrics": out_metrics, "device": device}
    if ctx.trace:
        if rec.trace is None:
            raise RuntimeError("the profiler saw no device record in the "
                               "traced slice")
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in rec.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in rec.trace.idle_gaps]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in rec.checks}
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from bench.harness import common, manifest as mf
    common.setup_environment(ROOT)
    entry = mf.workload_entry(mf.load_manifest(), args.workload)
    e2e, layer = mf.cell_metrics(mf.load_manifest(), args.workload)
    common.require_cuda(int(entry["chips"]))
    ctx = common.build_context(args.workload, args.seed, args.seconds,
                               trace=bool(args.trace), t_start=T_START)
    rec = common.driver(ctx).run(ctx)
    line = result_line(rec, ctx, e2e, layer, int(entry["chips"]))
    found = common.forbidden_loaded()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"card: {common.power_limit()}; setup_s {rec.setup_s:.3f}, "
          f"window_s {rec.window_s:.3f}, counters {rec.counters}",
          file=sys.stderr)
    for c in rec.checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
