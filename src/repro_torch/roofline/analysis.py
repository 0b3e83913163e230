"""Three-term roofline per (arch x shape x mesh) from the dry-run
artifacts, on one NVIDIA H100 SXM's constants (``launch.mesh``).
Counterpart of ``repro.roofline.analysis``.

    compute term    = traced FLOPs per rank / peak bf16 FLOP/s
    memory term     = traced bytes per rank / HBM bandwidth
    collective term = ring-modeled wire bytes per rank / NVLink rate (one
                      direction)

The dry run's numbers are per rank, so each term is the per-rank quantity
over the per-GPU capability.  FLOPs/bytes come from the unroll-delta
estimate where there is one; the collective term uses the ring-modeled
wire bytes (``roofline.comms``; one-level: an axis of more than 8 GPUs
would cross the node, which the model does not see), with the operand-byte
variant reported alongside.  ``art`` names the artifact root
(``artifacts/torch``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional

from ..configs import ARCHS, SHAPES, get_config
from ..launch.mesh import HBM_BW, NVLINK_BW_PER_DIRECTION, PEAK_FLOPS_BF16
from .analytic import hbm_bytes_per_device, model_flops

ART = Path(__file__).resolve().parents[3] / "artifacts" / "torch"


@dataclasses.dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    kind: str
    chips: int
    status: str
    reason: str = ""
    # per-device totals
    hlo_flops: float = 0.0
    hlo_bytes: float = 0.0
    coll_wire: float = 0.0
    coll_operand: float = 0.0
    # terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0            # traced bytes (unfused upper bound)
    t_memory_fused: float = 0.0      # analytic fused lower bound
    t_collective: float = 0.0
    t_collective_spec: float = 0.0       # operand-bytes variant
    dominant: str = ""
    model_flops_global: float = 0.0
    hlo_over_model: float = 0.0
    roofline_fraction: float = 0.0       # useful-compute / dominant term
    args_gib: float = 0.0
    temp_gib: float = 0.0
    note: str = ""


def _load(path: Path) -> Optional[Dict]:
    if not path.exists():
        return None
    return json.loads(path.read_text())


def _note(row: RooflineRow) -> str:
    if row.dominant == "collective":
        return ("collective-bound: overlap/shrink the per-layer all-reduce "
                "(reduce-scatter + all-gather fusion, or larger per-device "
                "batch to amortize)")
    if row.dominant == "memory":
        if row.kind == "decode":
            return ("memory-bound (KV/weight streaming): int8 KV cache or "
                    "wider batch to re-use streamed weights")
        return ("memory-bound: fuse elementwise chains / raise arithmetic "
                "intensity (bigger per-chip tiles)")
    if row.hlo_over_model > 2.0:
        return (f"compute-bound but {row.hlo_over_model:.1f}x model flops: "
                "cut remat recompute or dispatch waste (MoE dense -> EP)")
    return "compute-bound near useful flops: increase per-chip utilization"


def build_row(arch: str, shape: str, mesh: str,
              art: Optional[Path] = None) -> RooflineRow:
    art = ART if art is None else Path(art)
    cell = _load(art / "dryrun" / f"{arch}_{shape}_{mesh}.json")
    est = _load(art / "roofline" / f"{arch}_{shape}_{mesh}.json")
    cfg = get_config(arch)
    sh = SHAPES[shape]
    if cell is None:
        return RooflineRow(arch, shape, mesh, sh.kind, 0, "missing")
    if cell.get("status") == "skipped":
        return RooflineRow(arch, shape, mesh, sh.kind, 0, "skipped",
                           reason=cell.get("reason", ""))
    if cell.get("status") != "ok":
        return RooflineRow(arch, shape, mesh, sh.kind, 0, "error",
                           reason=cell.get("error", "?"))

    chips = cell["chips"]
    if est and est.get("status") == "ok":
        flops = est["estimate"]["flops"]
        bytes_ = est["estimate"]["bytes"]
        wire = est["estimate"]["coll_wire"]
        operand = est["estimate"]["coll_operand"]
        src = "unroll-delta"
    else:  # the dry run's own trace (it counts every layer)
        flops = cell["cost"].get("flops", 0.0)
        bytes_ = cell["cost"].get("bytes accessed", 0.0)
        wire = cell["collective_wire_bytes"]
        operand = cell["collective_operand_bytes"]
        src = "trace"

    t_c = flops / PEAK_FLOPS_BF16
    t_m = bytes_ / HBM_BW
    t_mf = hbm_bytes_per_device(cfg, sh, chips) / HBM_BW
    t_x = wire / NVLINK_BW_PER_DIRECTION
    t_x_spec = operand / NVLINK_BW_PER_DIRECTION
    # dominance judged with the fused memory bound (the spec-literal unfused
    # bytes are reported alongside; see analytic.hbm_bytes_per_device)
    dominant = max(("compute", t_c), ("memory", t_mf), ("collective", t_x),
                   key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, sh)
    useful_t = mf / chips / PEAK_FLOPS_BF16
    dom_t = max(t_c, t_mf, t_x)
    row = RooflineRow(
        arch=arch, shape=shape, mesh=mesh, kind=cell.get("kind", sh.kind),
        chips=chips, status="ok",
        hlo_flops=flops, hlo_bytes=bytes_, coll_wire=wire,
        coll_operand=operand,
        t_compute=t_c, t_memory=t_m, t_memory_fused=t_mf, t_collective=t_x,
        t_collective_spec=t_x_spec, dominant=dominant,
        model_flops_global=mf,
        hlo_over_model=(flops * chips / mf) if mf else 0.0,
        roofline_fraction=useful_t / dom_t if dom_t else 0.0,
        args_gib=cell["memory"]["argument_bytes"] / 2**30,
        temp_gib=cell["memory"]["temp_bytes"] / 2**30,
        reason=src,
    )
    row.note = _note(row)
    return row


def all_rows(mesh: str = "pod_16x16",
             art: Optional[Path] = None) -> List[RooflineRow]:
    return [build_row(a, s, mesh, art) for a in ARCHS for s in SHAPES]


def render_markdown(rows: List[RooflineRow]) -> str:
    hdr = ("| arch | shape | kind | compute s | mem s (UB) | mem s (fused) | "
           "collective s | dominant | traced/model | roofline frac | note |")
    sep = "|" + "---|" * 11
    out = [hdr, sep]
    for r in rows:
        if r.status != "ok":
            out.append(f"| {r.arch} | {r.shape} | {r.kind} | - | - | - | - | "
                       f"{r.status} | - | - | {r.reason[:70]} |")
            continue
        out.append(
            f"| {r.arch} | {r.shape} | {r.kind} | {r.t_compute:.2e} | "
            f"{r.t_memory:.2e} | {r.t_memory_fused:.2e} | "
            f"{r.t_collective:.2e} | **{r.dominant}** | "
            f"{r.hlo_over_model:.2f}x | {r.roofline_fraction:.1%} | "
            f"{r.note[:80]} |")
    return "\n".join(out)


def main() -> None:
    rows = all_rows()
    print(render_markdown(rows))
    ok = [r for r in rows if r.status == "ok"]
    print(f"\n{len(ok)} cells analysed; dominants: " + ", ".join(
        f"{d}={sum(r.dominant == d for r in ok)}"
        for d in ("compute", "memory", "collective")))


if __name__ == "__main__":
    main()
