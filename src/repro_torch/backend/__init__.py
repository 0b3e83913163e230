"""repro_torch.backend — one execution-backend protocol over ideal /
reference / simulated / emulated voltage-scaled arrays.

Quickstart::

    from repro_torch import backend

    be = backend.get_backend("emulated")          # nominal rails, on the GPU
    out, tel = be.matmul(a, b)                    # telemetry per call

    with backend.use_backend(be):                 # scope model GEMMs
        logits, state = api.decode_step(params, state, tokens)
    print(be.summary()["energy_per_token_j"])

The serve engine threads this end to end: ``ServeEngine(cfg, params,
backend="emulated")`` (or ``launch.serve --backend emulated``) runs every
model GEMM on the fault-injecting voltage-scaled array and surfaces
per-step flag/replay/energy telemetry in ``EngineStats``;
``backend="reference"`` runs every one of them through the ``systolic_mac``
kernel.
"""

from .base import (PRECISIONS, BackendTelemetry, MatmulBackend,
                   available_backends, current_backend,
                   ensure_host_callback_capacity, get_backend, matmul,
                   quantize_sym_i8, register_backend, set_default,
                   use_backend)
from .impls import (EmulatedBackend, IdealBackend, ReferenceBackend,
                    SimulatedBackend)

__all__ = [
    "PRECISIONS", "BackendTelemetry", "MatmulBackend", "available_backends",
    "current_backend", "ensure_host_callback_capacity", "get_backend",
    "matmul", "quantize_sym_i8",
    "register_backend", "set_default", "use_backend",
    "IdealBackend", "ReferenceBackend", "SimulatedBackend", "EmulatedBackend",
]
