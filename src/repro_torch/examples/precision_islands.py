"""Beyond-paper example: the voltage-island control loop running on
precision tiers, expressed as a *custom* ``repro_torch.flow`` pipeline — the
same Stage/Artifacts machinery that runs the paper's CAD flow, with every
step swapped for its precision analogue: headroom extraction ~ timing,
static tier assignment ~ Algorithm 1, Razor shadow flags + calibration ~
Algorithm 2, and an energy report.

    PYTHONPATH=src python -m repro_torch.examples.precision_islands [--device cpu]

Counterpart of ``examples/precision_islands.py``.  The calibration stage runs
the ``razor_matmul`` kernel (1 + up to 16 launches: its ``trial`` re-runs the
product on the same operands and ignores the tiers it is given, as the
reference's does), the execute stage the ``precision_island`` kernel (one
launch).  On the CPU both take their plain versions.  :func:`build_pipeline`
and :func:`run` take other products (the plain versions, for a comparison on
the card) through ``razor`` and ``precision``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..core.precision import (PrecisionController, energy_ratio,
                              static_tier_assignment, tier_names,
                              tile_headroom)
from ..flow import Artifacts, FunctionStage, Pipeline
from ..kernels.ops import precision_mm, razor_mm


@dataclasses.dataclass(frozen=True)
class IslandConfig:
    """Config for the precision-island pipeline (any object works — stages
    only read the fields they declare).  ``m`` is the number of activation
    rows, which sets the tier grid's height."""
    block: int = 128
    tol: float = 0.02
    m: int = 256


def build_pipeline(razor: Callable = razor_mm,
                   precision: Callable = precision_mm) -> Pipeline:
    """The four stages: headroom, static tiers, Razor-driven calibration,
    execute + energy report.  ``razor`` and ``precision`` are the products
    the last two run (the kernels by default)."""

    # 1. "timing extraction": per-tile quantization headroom == min slack
    def extract_headroom(art: Artifacts, cfg: IslandConfig) -> Artifacts:
        w = art.weights.detach().to(torch.float32).cpu().numpy()
        head = tile_headroom(w, tile=cfg.block)
        return art.with_(headroom=head)

    # 2. Algorithm-1 analogue: band headroom -> static tiers
    def assign_static_tiers(art: Artifacts, cfg: IslandConfig) -> Artifacts:
        gm, gn = cfg.m // cfg.block, art.headroom.shape[1]
        tiers = np.zeros((gm, gn), np.int64)
        tiers[:] = static_tier_assignment(
            np.broadcast_to(art.headroom.mean(0), (gm, gn)))
        return art.with_(static_tiers=tiers)

    # 3+4. Algorithm-2 analogue: Razor shadow flags drive tier calibration
    def calibrate_tiers(art: Artifacts, cfg: IslandConfig) -> Artifacts:
        _, flags, _ = razor(art.activations, art.weights, tol=cfg.tol)
        ctrl = PrecisionController()

        def trial(t):
            _, f, _ = razor(art.activations, art.weights, tol=cfg.tol)
            # a tile flags iff it's running below the tier its headroom needs
            need = np.where(f.cpu().numpy() > 0, 2, 0)
            return t < need

        calibrated = ctrl.calibrate(art.static_tiers, trial)
        return art.with_(razor_flags=flags.cpu().numpy(), tiers=calibrated)

    # 5. execute on the precision-island kernel + energy report
    def execute_and_report(art: Artifacts, cfg: IslandConfig) -> Artifacts:
        a, w = art.activations, art.weights
        c = precision(a, w, torch.as_tensor(art.tiers, dtype=torch.int32,
                                            device=a.device))
        exact = a.to(torch.float32) @ w.to(torch.float32)
        err = float(torch.linalg.norm(c - exact) / torch.linalg.norm(exact))
        return art.with_(product=c, rel_error=err,
                         energy_vs_bf16=energy_ratio(art.tiers),
                         static_energy_vs_bf16=energy_ratio(art.static_tiers))

    return Pipeline([
        FunctionStage("headroom", extract_headroom,
                      requires=("weights",), provides=("headroom",)),
        FunctionStage("static_tiers", assign_static_tiers,
                      requires=("headroom",), provides=("static_tiers",)),
        FunctionStage("calibrate", calibrate_tiers,
                      requires=("activations", "weights", "static_tiers"),
                      provides=("razor_flags", "tiers")),
        FunctionStage("execute", execute_and_report,
                      requires=("activations", "weights", "tiers"),
                      provides=("product", "rel_error", "energy_vs_bf16")),
    ])


def run(activations: torch.Tensor, weights: torch.Tensor, block: int = 128,
        tol: float = 0.02, *, razor: Callable = razor_mm,
        precision: Callable = precision_mm) -> Artifacts:
    """The pipeline on one (M, K) x (K, N) product; every artifact."""
    cfg = IslandConfig(block=block, tol=tol, m=activations.shape[0])
    return build_pipeline(razor, precision).run(
        cfg, initial=Artifacts({"activations": activations,
                                "weights": weights}))


def example_operands(m: int = 256, k: int = 256, n: int = 256, seed: int = 0,
                     device=None):
    """The example's inputs: bf16 activations and weights, one weight row
    with heavy outliers (row 0, columns from 128 on, times 40: low
    quantization headroom), drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[0, 128:] *= 40.0
    dev = resolve_device(device)
    return (torch.from_numpy(a).to(dev, torch.bfloat16),
            torch.from_numpy(w).to(dev, torch.bfloat16))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)
    a, w = example_operands(device=args.device)
    pipe = build_pipeline()
    print("custom pipeline:", [s.name for s in pipe.stages])
    art = run(a, w, block=128, tol=0.02)
    print("tile headroom (higher = more slack):\n", art.headroom.round(2))
    print("static tiers:\n", tier_names(art.static_tiers))
    print("razor mismatch flags:\n", art.razor_flags)
    print("calibrated tiers:\n", tier_names(art.tiers))
    print(f"\nresult rel-error vs f32: {art.rel_error:.4f}")
    print(f"energy vs all-bf16: {art.energy_vs_bf16:.2f}x "
          f"(static would be {art.static_energy_vs_bf16:.2f}x, "
          f"all-bf16 = 1.00x)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
