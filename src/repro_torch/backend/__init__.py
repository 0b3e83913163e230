"""repro_torch.backend — one execution-backend protocol over the ideal
library path and the ``systolic_mac`` kernel.

Quickstart::

    from repro_torch import backend

    be = backend.get_backend("reference")         # on the GPU
    out, tel = be.matmul(a, b)                    # telemetry per call

    with backend.use_backend(be):                 # scope model GEMMs
        logits, state = api.decode_step(params, state, tokens)
    print(be.summary()["calls"])

The serve engine threads this end to end: ``ServeEngine(cfg, params,
backend="reference")`` (or ``launch.serve --backend reference``) runs every
model GEMM through the kernel and surfaces the backend's lifetime
call/MAC/flag summary in ``EngineStats``.
"""

from .base import (PRECISIONS, BackendTelemetry, MatmulBackend,
                   available_backends, current_backend,
                   ensure_host_callback_capacity, get_backend, matmul,
                   quantize_sym_i8, register_backend, set_default,
                   use_backend)
from .impls import IdealBackend, ReferenceBackend

__all__ = [
    "PRECISIONS", "BackendTelemetry", "MatmulBackend", "available_backends",
    "current_backend", "ensure_host_callback_capacity", "get_backend",
    "matmul", "quantize_sym_i8",
    "register_backend", "set_default", "use_backend",
    "IdealBackend", "ReferenceBackend",
]
