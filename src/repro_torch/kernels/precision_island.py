"""precision_island on Hopper: a matmul in which each output cell computes
at its assigned tier (0 = int4, 1 = int8, 2 = f32), the numerics analogue of
per-partition V_ccint rails.

Replaces the Pallas kernel ``src/repro/kernels/precision_island.py::_kernel``
(wrappers ``_precision_island_call`` / ``precision_island``).  The CUDA
sources are ``csrc/quant_rows.cu`` (per-row quantization of both operands
at levels 127 and 7, once each), ``csrc/precision_island.cu`` and
``csrc/tile_products.cuh``.  The tier map plays the role of the voltage map
produced by the static scheme; the runtime ``PrecisionController`` re-tiers
from razor_matmul flags.

What bounds it on an H100: the arithmetic of the tiers the map asks for,
issued on the CUDA cores in this first version.  The Pallas body computes
all three products for every tile; here a block computes only those its
cells need, since a tier is uniform over a cell.  Integer cells are exact
int32 products and equal :func:`precision_island_plain` bit for bit.

:func:`precision_island` launches the kernels for CUDA tensors (or raises)
and computes :func:`precision_island_plain` for CPU tensors; there is no
other route between the two.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .quant_rows import _DTYPE_CODE, padded_k, quant_rows
from .razor_matmul import _MAX_K
from .ref import precision_island_tiles

#: rows per block of the product (csrc/tile_products.cuh BM); bounds grid.y,
#: which CUDA limits to 65535
_TILE_M = 64
_MAX_GRID_Y = 65535


def precision_island_plain(a: torch.Tensor, b: torch.Tensor,
                           tiers: torch.Tensor, *, block_m: int,
                           block_n: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: C f32 (M, N).  Same as
    ``kernels.ref.precision_island`` with independent cell edges; the
    integer products are exact on any device."""
    return precision_island_tiles(a, b, tiers, block_m, block_n)


def _check(a, b, tiers):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"precision_island expects (M, K) @ (K, N); got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"precision_island takes a and b both float32 or both "
                        f"bfloat16; got {a.dtype} and {b.dtype}")
    if tiers.dim() != 2 or tiers.dtype.is_floating_point:
        raise TypeError(f"tiers must be a 2-D integer grid; got {tiers.dtype} "
                        f"{tuple(tiers.shape)}")
    for t in (b, tiers):
        if t.device != a.device:
            raise ValueError(f"precision_island operands lie on different "
                             f"devices: {a.device} and {t.device}")
    if min(*a.shape, b.shape[1], *tiers.shape) == 0:
        raise ValueError(f"precision_island needs non-empty operands; got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}, tiers "
                         f"{tuple(tiers.shape)}")


def precision_island(a: torch.Tensor, b: torch.Tensor, tiers: torch.Tensor,
                     *, block_m: Optional[int] = None,
                     block_n: Optional[int] = None) -> torch.Tensor:
    """Tiered matmul: C f32 (M, N).  Block sizes default to the island shape
    ``tiers`` (gm, gn) implies.

    a: (M, K); b: (K, N), both float32 or both bfloat16, any strides; tiers
    an integer grid on the same device.  CUDA tensors go to the kernel, CPU
    tensors to :func:`precision_island_plain`.
    """
    _check(a, b, tiers)
    (m, k), n = a.shape, b.shape[1]
    gm, gn = tiers.shape
    block_m = m // gm if block_m is None else block_m
    block_n = n // gn if block_n is None else block_n
    if block_m <= 0 or block_n <= 0 or block_m * gm != m or block_n * gn != n:
        raise ValueError(f"tiers ({gm}, {gn}) with cells {block_m}x{block_n} "
                         f"do not tile a ({m}, {n}) output")
    if a.device.type == "cpu":
        return precision_island_plain(a, b, tiers, block_m=block_m,
                                      block_n=block_n)
    if a.device.type != "cuda":
        raise ValueError(f"precision_island has no kernel for device "
                         f"{a.device}")

    if k > _MAX_K or m * n > 2 ** 62 or -(-m // _TILE_M) > _MAX_GRID_Y:
        raise ValueError(f"precision_island: problem ({m}, {k}, {n}) exceeds "
                         f"the kernel's extents")
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        tiers = tiers.to(torch.int32).contiguous()
        qa8, sa8 = quant_rows(a, 127)
        qb8, sb8 = quant_rows(b.T, 127)
        qa4, sa4 = quant_rows(a, 7)
        qb4, sb4 = quant_rows(b.T, 7)
        c = torch.empty((m, n), dtype=torch.float32, device=a.device)
        err = lib.precision_island_launch(
            a.data_ptr(), b.data_ptr(), qa8.data_ptr(), sa8.data_ptr(),
            qb8.data_ptr(), sb8.data_ptr(), qa4.data_ptr(), sa4.data_ptr(),
            qb4.data_ptr(), sb4.data_ptr(), tiers.data_ptr(), c.data_ptr(),
            m, n, k, padded_k(k), a.stride(0), a.stride(1), b.stride(0),
            b.stride(1), block_m, block_n, _DTYPE_CODE[a.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"precision_island launch failed: CUDA error {err} "
                           f"for ({m}, {k}) @ ({k}, {n}), cells "
                           f"{block_m}x{block_n}")
    precision_island.launches += 1
    return c


#: kernel launches made by :func:`precision_island` in this process (one per
#: call: the quantization prologue and the product together)
precision_island.launches = 0
