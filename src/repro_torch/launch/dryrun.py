"""Multi-pod dry run: trace every (architecture x input-shape x mesh) cell on
the production meshes without data, record each rank's memory, cost and
collective schedule, and write one JSON artifact per cell for the roofline.
Counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell with XLA on 512 fake host
devices.  The port starts a ``fake`` process group of 256 (``pod_16x16``)
or 512 (``multipod_2x16x16``) ranks in this process and traces the step
once under ``FakeTensorMode`` (``BuiltStep.lower()``), as rank 0: no memory
is allocated and nothing is sent.  Each cell runs in a process group of its
own mesh's size.  A record has the reference's keys, with ``trace_s`` in
place of ``lower_s`` / ``compile_s`` and no ``hlo_bytes``.  Artifacts go to
``artifacts/torch/dryrun/``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-110b \\
        --shape train_4k [--multi-pod] [--set moe_impl=ep_a2a] [--tag name]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

ARTIFACT_DIR = (Path(__file__).resolve().parents[3] / "artifacts" / "torch"
                / "dryrun")


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             overrides: Optional[Dict[str, Any]] = None, tag: str = "",
             verbose: bool = True, smoke: bool = False) -> dict:
    """Trace one cell on a fresh ``fake`` process group of the production
    mesh's size (stopped before this returns) and return its record
    (``smoke``: the arch's smoke config on that mesh)."""
    from ..configs import SHAPES, cell_is_runnable, get_config
    from ..roofline.comms import (summarize_collectives,
                                  total_collective_bytes)
    from .mesh import chips, make_production_mesh, start_mesh, stop_mesh
    from .steps import build_cell

    shape = SHAPES[shape_name]
    ok, why = cell_is_runnable(get_config(arch, smoke=smoke), shape)
    mesh_kind = "multipod_2x16x16" if multi_pod else "pod_16x16"
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "overrides": overrides or {}, "tag": tag}
    if not ok:
        record.update(status="skipped", reason=why)
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {why}")
        return record

    shape_of = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    start_mesh(shape_of, axes, backend="fake")
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.monotonic()
        step = build_cell(arch, shape, mesh, smoke=smoke,
                          overrides=overrides)
        lowered = step.lower()
        trace_s = time.monotonic() - t0
        colls = lowered.collectives
        op_b, wire_b = total_collective_bytes(colls)
        mem = lowered.memory
        record.update(
            status="ok", kind=step.kind, chips=chips(mesh),
            trace_s=round(trace_s, 2),
            memory=dict(mem),
            cost=dict(lowered.cost),
            collectives=summarize_collectives(colls),
            collective_operand_bytes=int(op_b),
            collective_wire_bytes=int(wire_b),
        )
        if verbose:
            print(f"[ok]   {arch} x {shape_name} x {mesh_kind} ({step.kind}): "
                  f"args {mem['argument_bytes'] / 2**30:.2f} GiB/rank, "
                  f"temp {mem['temp_bytes'] / 2**30:.2f} GiB/rank, "
                  f"flops/rank {lowered.cost['flops']:.3e}, "
                  f"colls {record['collectives']}, trace {trace_s:.1f}s")
    except Exception as e:                                  # noqa: BLE001
        # a failed cell is recorded and the sweep goes on
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {mesh_kind}: {e}")
    finally:
        stop_mesh()
    return record


def save(record: dict, directory: Optional[Path] = None) -> Path:
    directory = ARTIFACT_DIR if directory is None else Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tag = f"_{record['tag']}" if record.get("tag") else ""
    name = f"{record['arch']}_{record['shape']}_{record['mesh']}{tag}.json"
    name = name.replace("/", "-")
    path = directory / name
    path.write_text(json.dumps(record, indent=1))
    return path


def parse_overrides(pairs) -> Dict[str, Any]:
    """``key=value`` strings -> a config override dict (ints and floats
    cast)."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        overrides[k] = v
    return overrides


def main() -> None:
    from ..configs import ARCHS, SHAPES
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="every (arch x shape)")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. moe_impl=ep_a2a)")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--out-dir", default=None,
                    help=f"artifact directory (default {ARTIFACT_DIR})")
    args = ap.parse_args()

    overrides = parse_overrides(args.set)
    if args.all:
        cells = [(arch, shape) for arch in ARCHS for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, multi_pod=mp,
                           overrides=overrides or None, tag=args.tag)
            save(rec, args.out_dir)
            n_fail += rec["status"] == "error"
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
