"""Unroll-delta cost estimator.  Counterpart of
``repro.roofline.estimate``.

The reference compiles each cell with 1 and 2 python-unrolled layer units
(``lax.scan`` hides its trip count from ``cost_analysis``) and extrapolates

    total(L) = fixed + L * per_unit,   per_unit = c(2) - c(1)

The port's eager trace (``launch.dryrun``) already counts every layer, so
the delta of two short traces gives the full depth's cost directly; it is
kept so the records compare one for one with the reference's (and the tests
hold it against a direct trace).  Layer units: 1 layer (LM/SSM/enc-dec
pairs) or one shared-attention group (zamba2).  Artifacts go to
``artifacts/torch/roofline/``.

Usage:
    PYTHONPATH=src python -m repro_torch.roofline.estimate --arch X --shape Y
    PYTHONPATH=src python -m repro_torch.roofline.estimate --all
"""

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

from ..configs import ARCHS, SHAPES, cell_is_runnable, get_config

ARTIFACT_DIR = (Path(__file__).resolve().parents[3] / "artifacts" / "torch"
                / "roofline")


def _unit(cfg) -> Dict[str, int]:
    """Layer-unit size and the config overrides for k units."""
    if cfg.family == "hybrid":
        return {"unit_layers": cfg.shared_attn_period,
                "units": cfg.n_layers // cfg.shared_attn_period}
    return {"unit_layers": 1, "units": cfg.n_layers}


def _overrides_for_units(cfg, k: int) -> Dict[str, int]:
    u = _unit(cfg)
    ov = {"n_layers": k * u["unit_layers"], "unroll_layers": True}
    if cfg.family == "encdec":
        ov["n_enc_layers"] = k            # unit = (1 dec + 1 enc) pair
    return ov


def _collect_costs(arch: str, shape_name: str, multi_pod: bool,
                   overrides: Dict, smoke: bool = False) -> Dict[str, float]:
    from ..launch.dryrun import run_cell
    rec = run_cell(arch, shape_name, multi_pod=multi_pod, overrides=overrides,
                   verbose=False, smoke=smoke)
    if rec["status"] != "ok":
        raise RuntimeError(rec.get("error", rec.get("reason", "failed")))
    out = {
        "flops": rec["cost"].get("flops", 0.0),
        "bytes": rec["cost"].get("bytes accessed", 0.0),
        "coll_operand": float(rec["collective_operand_bytes"]),
        "coll_wire": float(rec["collective_wire_bytes"]),
    }
    return out


def estimate_cell(arch: str, shape_name: str, multi_pod: bool = False,
                  extra_overrides: Optional[Dict] = None,
                  tag: str = "", smoke: bool = False) -> Dict:
    cfg = get_config(arch, smoke=smoke)
    shape = SHAPES[shape_name]
    ok, why = cell_is_runnable(cfg, shape)
    mesh_kind = "multipod_2x16x16" if multi_pod else "pod_16x16"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        t0 = time.time()
        ov1 = _overrides_for_units(cfg, 1)
        ov2 = _overrides_for_units(cfg, 2)
        if extra_overrides:
            ov1.update(extra_overrides)
            ov2.update(extra_overrides)
        c1 = _collect_costs(arch, shape_name, multi_pod, ov1, smoke)
        c2 = _collect_costs(arch, shape_name, multi_pod, ov2, smoke)
        units = _unit(cfg)["units"]
        est = {}
        for k in c1:
            per_unit = max(c2[k] - c1[k], 0.0)
            fixed = max(c1[k] - per_unit, 0.0)
            est[k] = fixed + units * per_unit
            est[k + "_per_unit"] = per_unit
            est[k + "_fixed"] = fixed
        rec.update(status="ok", estimate=est, units=units,
                   l1_raw=c1, l2_raw=c2, wall_s=round(time.time() - t0, 1))
    except Exception as e:                                 # noqa: BLE001
        # a failed cell is recorded and the sweep goes on
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-1500:])
    return rec


def save(rec: Dict, directory: Optional[Path] = None) -> Path:
    directory = ARTIFACT_DIR if directory is None else Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tag = f"_{rec['tag']}" if rec.get("tag") else ""
    name = (f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{tag}.json"
            .replace("/", "-"))
    path = directory / name
    path.write_text(json.dumps(rec, indent=1))
    return path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS))
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    from ..launch.dryrun import parse_overrides
    overrides = parse_overrides(args.set)

    cells = ([(a, s) for a in ARCHS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    fails = 0
    for arch, shape in cells:
        rec = estimate_cell(arch, shape, multi_pod=args.multi_pod,
                            extra_overrides=overrides or None, tag=args.tag)
        save(rec)
        status = rec["status"]
        extra = ""
        if status == "ok":
            extra = (f"flops {rec['estimate']['flops']:.3e}/dev "
                     f"wire {rec['estimate']['coll_wire']:.3e} "
                     f"({rec['wall_s']}s)")
        elif status == "error":
            extra = rec["error"][:120]
            fails += 1
        print(f"[{status}] {arch} x {shape}: {extra}", flush=True)
    raise SystemExit(1 if fails else 0)


if __name__ == "__main__":
    main()
