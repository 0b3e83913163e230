"""Hardware-in-the-loop quickstart: serve a smoke model with ALL decode
GEMMs on the emulated voltage-scaled accelerator, undervolt one rail
mid-serve, and watch the real traffic's Razor flags drive a live
recalibration.

    PYTHONPATH=src python -m repro_torch.examples.hwloop_serve \
        [--arch starcoder2-3b] [--backend emulated|probe] [--device cpu]

Counterpart of ``examples/hwloop_serve.py``.  Walkthrough (``--backend
emulated``, the default):

  1. the CAD flow (``repro_torch.flow``) calibrates per-partition rails for
     an 8x8 array on vtr-22nm;
  2. an HwLoopSession wraps those rails in an EmulatedAccelerator on the
     serving device and a CalibrationWatchdog, and an EmulatedBackend turns
     that same accelerator into the serving execution target;
  3. the continuous-batching ServeEngine decodes real requests with
     ``backend=emulated`` — every dense GEMM of every decode step runs on
     the voltage-scaled array (on a GPU its tiled form), with per-step
     flags and energy/token in EngineStats; the session rides along as a
     thin watchdog adapter over those real flags;
  4. partition 0 is then undervolted below its safe point and the same
     traffic served again: the model's own GEMMs trip DETECTED flags, the
     watchdog re-runs the cached runtime_calibration stage, and the rails
     heal.

``--backend probe`` keeps the legacy side-channel mode: the engine decodes
on the ideal path and the session emulates per-step probe traffic instead.
:func:`run` returns both served batches and the rails around them,
:func:`report_lines` what the reference example prints of them.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np

from .._device import DeviceLike, resolve_device
from ..backend import EmulatedBackend
from ..configs import ARCHS, get_config
from ..configs.base import ModelConfig
from ..flow import FlowConfig
from ..hwloop import HwLoopSession
from ..models import model_api
from ..serve import EngineStats, Request, ServeEngine

BACKENDS = ("emulated", "probe")
SLOTS, MAX_LEN = 2, 48
#: how far below partition 0's safe point the undervolt goes (V)
UNDERVOLT_V = 0.02


@dataclasses.dataclass
class ServedBatch:
    """One served batch: its requests, the engine's stats and the line the
    example prints for it."""
    tag: str
    reqs: List[Request]
    stats: EngineStats
    line: str


@dataclasses.dataclass
class HwLoopServeResult:
    backend: str
    calibrated_rails: np.ndarray
    v_safe: float
    undervolt_v: float
    batches: List[ServedBatch]
    healed_rails: np.ndarray
    session: HwLoopSession


def batch_line(tag: str, stats: EngineStats) -> str:
    """The reference example's summary line of one served batch."""
    hw = stats.hwloop
    rates = ", ".join(f"{x:.2f}" for x in hw["flag_rate"])
    e = hw["energy_per_token_j"]            # None when no decode step ran
    line = (f"[{tag}] {stats.tokens_generated} tokens, flag rates [{rates}], "
            f"{hw['recalibrations']} recalibrations, "
            f"{'n/a' if e is None else f'{e:.3g}'} J/token, "
            f"replay rate {hw['replay_rate']:.2e}")
    if stats.backend_telemetry:
        bt = stats.backend_telemetry
        line += (f" | backend:{stats.backend} {bt['calls']} GEMMs, "
                 f"{bt['macs']} MACs, {bt['flags']} flags")
    return line


def serve_batch(cfg: ModelConfig, params: Any, session: HwLoopSession,
                backend: Optional[EmulatedBackend], tag: str, requests: int,
                max_new: int) -> ServedBatch:
    """``requests`` requests from ``default_rng(0)`` through a fresh engine
    that shares the session (and its rails) with every other batch."""
    engine = ServeEngine(cfg, params, slots=SLOTS, max_len=MAX_LEN,
                         hwloop=session, backend=backend,
                         device=session.accel.device)
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(requests):
        reqs.append(Request(
            uid=uid,
            prompt=rng.integers(3, cfg.vocab_size, rng.integers(2, 6)).tolist(),
            max_new_tokens=max_new))
        engine.submit(reqs[-1])
    stats = engine.run_until_drained()
    return ServedBatch(tag=tag, reqs=reqs, stats=stats,
                       line=batch_line(tag, stats))


def run(cfg: ModelConfig, params: Any, backend: str = "emulated",
        requests: int = 4, max_new: int = 5,
        device: DeviceLike = None) -> HwLoopServeResult:
    """Calibrate an 8 x 8 vtr-22nm array (12 Razor trials), serve a batch,
    undervolt partition 0 by ``UNDERVOLT_V`` below its safe point, serve
    again."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    flow_cfg = FlowConfig(array_n=8, tech="vtr-22nm", max_trials=12,
                          seed=2021)
    session = HwLoopSession(flow_cfg, probe_rows=8, rail_margin=0.02,
                            patience=2, device=device)
    calibrated = session.rails.copy()
    # the session's calibrated device doubles as the serving backend: real
    # decode GEMMs and watchdog healing share one set of rails
    be = EmulatedBackend(session.accel) if backend == "emulated" else None
    batches = [serve_batch(cfg, params, session, be, "calibrated", requests,
                           max_new)]

    # undervolt partition 0 below its safe point: the serving traffic's own
    # flags fire, the watchdog re-runs the (cached-prefix) calibration and
    # restores safe rails mid-serve
    v_safe = float(session.accel.timing.min_safe_voltage()
                   [session.accel._part_grid == 0].max())
    undervolt = v_safe - UNDERVOLT_V
    session.set_partition_voltage(0, undervolt)
    batches.append(serve_batch(cfg, params, session, be, "undervolted",
                               requests, max_new))
    return HwLoopServeResult(backend=backend, calibrated_rails=calibrated,
                             v_safe=v_safe, undervolt_v=undervolt,
                             batches=batches,
                             healed_rails=session.rails.copy(),
                             session=session)


def report_lines(out: HwLoopServeResult) -> List[str]:
    """The lines the reference example prints, in its order."""
    calibrated, undervolted = out.batches
    return [f"calibrated rails: {np.round(out.calibrated_rails, 3).tolist()}",
            calibrated.line,
            f"undervolting partition 0 to {out.undervolt_v:.3f} V "
            f"(safe point {out.v_safe:.3f} V)",
            undervolted.line,
            f"healed rails: {np.round(out.healed_rails, 3).tolist()}"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="starcoder2-3b", choices=sorted(ARCHS))
    ap.add_argument("--backend", default="emulated", choices=BACKENDS,
                    help="emulated: serve all decode GEMMs on the "
                         "voltage-scaled array; probe: legacy probe-traffic "
                         "side channel")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    params = model_api(cfg, device=dev).init_params(0)
    out = run(cfg, params, args.backend, args.requests, args.max_new,
              device=dev)
    print("\n".join(report_lines(out)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
