"""The execution backends ported so far.

| name        | machinery                              | fidelity                |
|-------------|----------------------------------------|-------------------------|
| `ideal`     | ``torch.matmul``                       | exact, fastest          |
| `reference` | the ``systolic_mac`` kernel at nominal | exact, kernel-semantics |

``simulated`` and ``emulated`` (``core.SystolicSim``,
``hwloop.EmulatedAccelerator``) are not registered yet:
``get_backend("emulated")`` raises the registry's ``KeyError``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels.systolic_mac import systolic_mac
from .base import (BackendTelemetry, MatmulBackend, largest_common_block,
                   register_backend)


class IdealBackend(MatmulBackend):
    """The production library path: a plain ``torch.matmul`` (the JAX
    package leaves this product to XLA, outside any kernel).  The router
    never enters the backend for it — ``matmul()`` stays ``a @ b``."""

    name = "ideal"
    is_ideal = True

    def _execute(self, a, b, count_flags):
        res = torch.promote_types(a.dtype, b.dtype)
        if not res.is_floating_point:
            res = torch.float32
        out = torch.matmul(a.to(res), b.to(res))
        m, k = a.shape
        tel = BackendTelemetry(calls=1, macs=m * k * b.shape[1])
        return out, tel, None


class ReferenceBackend(MatmulBackend):
    """The ``systolic_mac`` kernel with a uniformly nominal voltage map, so
    no cell ever trips the corruption model and the product is the exact
    f32-accumulated matmul.  On a GPU every model GEMM is one launch of the
    hand-written kernel, on the operands where and as they lie (bf16 weights
    are read as bf16, a transposed view through its strides); on the CPU it
    is the kernel's plain version, which is what ``repro``'s reference
    backend computes."""

    name = "reference"

    def __init__(self, device=None) -> None:
        super().__init__(device)
        # nominal rails per flag grid, made once: a decode step would
        # otherwise fill two maps per GEMM
        self._rails: Dict[Tuple[int, int, torch.device],
                          Tuple[torch.Tensor, torch.Tensor]] = {}

    def _nominal(self, grid: Tuple[int, int], device: torch.device):
        key = (*grid, device)
        if key not in self._rails:
            self._rails[key] = (
                torch.ones(grid, dtype=torch.float32, device=device),
                torch.zeros(grid, dtype=torch.float32, device=device))
        return self._rails[key]

    def _execute(self, a, b, count_flags):
        m, k = a.shape
        n = b.shape[1]
        if a.dtype != b.dtype or a.dtype not in (torch.float32,
                                                 torch.bfloat16):
            # exact up-cast of the narrower operand (never on the model's
            # path, where activations and weights are both bf16)
            a, b = a.to(torch.float32), b.to(torch.float32)
        block = largest_common_block(m, n)
        v_map, v_safe = self._nominal((m // block, n // block), a.device)
        tel = BackendTelemetry(calls=1, macs=m * k * n)
        if not count_flags:
            c, _ = systolic_mac(a, b, v_map, v_safe, block_m=block,
                                block_n=block)
            return c, tel, None
        c, _, fired = systolic_mac(a, b, v_map, v_safe, block_m=block,
                                   block_n=block, count_flags=True)
        if fired.device.type == "cpu":
            tel.flags = int(fired)
            return c, tel, None
        return c, tel, fired


register_backend("ideal", IdealBackend)
register_backend("reference", ReferenceBackend)
