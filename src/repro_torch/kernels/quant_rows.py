"""quant_rows on Hopper: the symmetric per-row quantization that
razor_matmul and precision_island take once per operand before their
products (CUDA source ``csrc/quant_rows.cu``).

Replaces the per-tile ``_quant_rows`` of ``src/repro/kernels/razor_matmul.py``
and ``src/repro/kernels/precision_island.py``: the scales run over the whole
of K, so they do not depend on the output cell and are taken once.  Its plain
version is :func:`repro_torch.kernels.ref.quantize_sym_i8` (levels 127) and
``quantize_sym_i4`` (levels 7), which it equals bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: k tile of the products (csrc/tile_products.cuh BK): the quantized rows
#: are padded with zeros to a multiple of it
K_TILE = 32


def padded_k(k: int) -> int:
    return -(-k // K_TILE) * K_TILE


def quant_rows(x: torch.Tensor, levels: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 (R, Kp), scale f32 (R,)) of the rows of a CUDA tensor ``x``
    (R, K) of any strides: ``scale = max(max|row|, 1e-12) / levels``,
    ``q = clamp(rint(x / scale), -levels, levels)``, zero in the columns
    K..Kp-1.  Pass ``b.T`` (a view) to quantize the columns of ``b``."""
    if x.device.type != "cuda":
        raise ValueError(f"quant_rows launches a CUDA kernel; got a tensor "
                         f"on {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPE_CODE or min(x.shape) == 0:
        raise ValueError(f"quant_rows takes a non-empty 2-D float32 or "
                         f"bfloat16 tensor; got {x.dtype} {tuple(x.shape)}")
    r, k = x.shape
    kp = padded_k(k)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        q = torch.empty((r, kp), dtype=torch.int8, device=x.device)
        scale = torch.empty((r,), dtype=torch.float32, device=x.device)
        amax = torch.empty((r,), dtype=torch.int32, device=x.device)
        err = lib.quant_rows_launch(
            x.data_ptr(), r, k, kp, x.stride(0), x.stride(1), float(levels),
            _DTYPE_CODE[x.dtype], amax.data_ptr(), q.data_ptr(),
            scale.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant_rows launch failed: CUDA error {err} for "
                           f"({r}, {k}) at levels {levels}")
    return q, scale
