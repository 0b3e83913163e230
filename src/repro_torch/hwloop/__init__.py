"""repro_torch.hwloop — voltage-aware fault-injection & energy-accounting
emulation.

The missing loop between the CAD flow and real inference: a
:class:`FlowReport`'s calibrated voltage islands become an
:class:`EmulatedAccelerator` that executes matmuls with data-dependent
Razor fault injection and a cycle/energy ledger; :class:`HwLoopSession`
runs it online under the serve engine, feeding observed flag rates back
into the flow's ``runtime_calibration`` stage (via
:class:`~repro_torch.runtime.monitor.CalibrationWatchdog`) so rails re-tune
mid-serve.

Quickstart::

    from repro_torch.flow import FlowConfig
    from repro_torch.hwloop import HwLoopSession

    session = HwLoopSession(FlowConfig(array_n=8, tech="vtr-22nm",
                                       max_trials=8))     # on the GPU
    tel = session.step(tokens=[17, 42])        # one serving step's traffic
    print(session.summary()["energy_per_token_j"])

Pipeline integration: the ``hwloop`` stage (``repro_torch.flow``'s
registry) adds voltage→(energy/token, replay-rate, accuracy-proxy)
artifacts to any flow run; :func:`hwloop_pipeline` returns the default
chain with it inserted, so ``sweep(..., pipeline=hwloop_pipeline())``
produces Pareto tables across tech nodes.

The port's counterpart of ``repro.hwloop``.  The accelerator, the session
and the stage take ``device=`` (``None`` means the GPU; without one they
raise).  On CPU operands the accelerator runs the reference's tile loop in
numpy; on a GPU the tiled form (:mod:`repro_torch.hwloop.tiled`).
"""

from .device import EmulatedAccelerator, MatmulTelemetry, quantized_activity
from .energy import EnergyLedger
from .inject import (CORRUPTION_MODELS, TILE_MODELS, bit_flip,
                     get_corruption, get_tile_corruption, register_corruption,
                     stale_psum, te_drop)
from .session import HwLoopSession, StepTelemetry


def hwloop_pipeline(device=None, **pipeline_kw):
    """The canonical Fig. 9 stage chain with the ``hwloop`` emulation stage
    inserted after ``power`` — ready for :func:`repro_torch.flow.sweep`.
    The stage runs its probe traffic on ``device`` (``None``: the GPU)."""
    from ..flow import HwLoopStage, Pipeline
    return Pipeline(**pipeline_kw).insert_after("power",
                                                HwLoopStage(device=device))


__all__ = [
    "EmulatedAccelerator", "MatmulTelemetry", "quantized_activity",
    "EnergyLedger", "CORRUPTION_MODELS", "register_corruption",
    "get_corruption", "stale_psum", "te_drop", "bit_flip",
    "HwLoopSession", "StepTelemetry", "hwloop_pipeline",
    "TILE_MODELS", "get_tile_corruption",
]
