"""razor_matmul on Hopper: the Razor double-sampled matmul (the paper's
runtime timing sensor as one GEMM).

Replaces the Pallas kernel ``src/repro/kernels/razor_matmul.py::_kernel``
(wrappers ``_razor_matmul_call`` / ``razor_matmul``).  The CUDA sources are
``csrc/quant_rows.cu`` (the per-row int8 quantization of A's rows and B's
columns, once per operand), ``csrc/razor_matmul.cu`` and
``csrc/tile_products.cuh``.

Main path = int8 x int8 -> int32 (the cheap near-threshold path); shadow
path = f32 (the delayed shadow register).  Per partition cell the kernel
emits a mismatch flag (relative Frobenius error > tol) and — like Razor's
replay — *corrects* flagged cells to the shadow value.  The flags feed
``core.precision.PrecisionController`` (Algorithm 2 on precision tiers).

What bounds it on an H100: the arithmetic of its two products (2MNK in f32
and 2MNK in int8), which this first version issues on the CUDA cores
(``fmaf`` and ``__dp4a``), not the tensor cores.  The integer product is
exact int32, as the oracle's is, so a main-path cell equals
:func:`razor_matmul_plain` bit for bit; the Pallas body multiplies the
integer values in f32, which stops being exact once partial sums pass 2^24.

:func:`razor_matmul` launches the kernels for CUDA tensors (or raises) and
computes :func:`razor_matmul_plain` for CPU tensors; there is no other route
between the two.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .quant_rows import _DTYPE_CODE, padded_k, quant_rows
from .ref import razor_matmul_tiles
from .tuning import select_blocks

_INT_MAX = 2 ** 31 - 1
#: rows per block of the product pass (csrc/tile_products.cuh BM); bounds
#: grid.y, which CUDA limits to 65535
_TILE_M = 64
_MAX_GRID_Y = 65535
#: the int32 accumulator holds K * 127^2 while K stays below this
_MAX_K = _INT_MAX // 127 ** 2


def razor_matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                       tol: float = 0.05, block_m: int, block_n: int):
    """The kernel's function in plain PyTorch: (C f32 (M, N), flags int32
    (gm, gn), rel f32 (gm, gn)).  Same as ``kernels.ref.razor_matmul`` with
    independent cell edges; the integer product is exact on any device."""
    return razor_matmul_tiles(a, b, tol, block_m, block_n)


def _check(a, b, block_m, block_n):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"razor_matmul expects (M, K) @ (K, N); got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"razor_matmul takes a and b both float32 or both "
                        f"bfloat16; got {a.dtype} and {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"razor_matmul operands lie on different devices: "
                         f"{a.device} and {b.device}")
    m, k = a.shape
    n = b.shape[1]
    if min(m, n, k) == 0:
        raise ValueError(f"razor_matmul needs non-empty operands; got "
                         f"({m}, {k}) @ ({k}, {n})")
    if block_m <= 0 or block_n <= 0 or m % block_m or n % block_n:
        raise ValueError(f"cells {block_m}x{block_n} do not tile a "
                         f"({m}, {n}) output")


def razor_matmul(a: torch.Tensor, b: torch.Tensor, *, tol: float = 0.05,
                 block_m: Optional[int] = None, block_n: Optional[int] = None,
                 count_flags: bool = False):
    """Returns (C f32 (M, N) corrected, flags int32 (gm, gn), rel f32
    (gm, gn)); with ``count_flags=True`` additionally the fused int32
    fired-cell total as a 0-d tensor on the inputs' device.  Cells default
    to :func:`~repro_torch.kernels.tuning.select_blocks`.

    a: (M, K); b: (K, N), both float32 or both bfloat16, any strides.
    CUDA tensors go to the kernel, CPU tensors to :func:`razor_matmul_plain`.
    """
    bm, bn = select_blocks(a.shape[0], b.shape[-1])
    block_m = bm if block_m is None else block_m
    block_n = bn if block_n is None else block_n
    _check(a, b, block_m, block_n)
    (m, k), n = a.shape, b.shape[1]
    if a.device.type == "cpu":
        c, flags, rel = razor_matmul_plain(a, b, tol=tol, block_m=block_m,
                                           block_n=block_n)
        if not count_flags:
            return c, flags, rel
        return c, flags, rel, flags.sum().to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"razor_matmul has no kernel for device {a.device}")

    if k > _MAX_K or m * n > 2 ** 62 or -(-m // _TILE_M) > _MAX_GRID_Y:
        raise ValueError(f"razor_matmul: problem ({m}, {k}, {n}) exceeds the "
                         f"kernel's extents")
    lib = _build.load_library()
    gm, gn = m // block_m, n // block_n
    with torch.cuda.device(a.device):
        qa, scale_a = quant_rows(a, 127)
        qb, scale_b = quant_rows(b.T, 127)
        main = torch.empty((m, n), dtype=torch.float32, device=a.device)
        shadow = torch.empty_like(main)
        c = torch.empty_like(main)
        flags = torch.empty((gm, gn), dtype=torch.int32, device=a.device)
        rel = torch.empty((gm, gn), dtype=torch.float32, device=a.device)
        count = (torch.zeros((), dtype=torch.int32, device=a.device)
                 if count_flags else None)
        err = lib.razor_matmul_launch(
            a.data_ptr(), b.data_ptr(), qa.data_ptr(), scale_a.data_ptr(),
            qb.data_ptr(), scale_b.data_ptr(), main.data_ptr(),
            shadow.data_ptr(), c.data_ptr(), flags.data_ptr(), rel.data_ptr(),
            count.data_ptr() if count is not None else None,
            m, n, k, padded_k(k), a.stride(0), a.stride(1), b.stride(0),
            b.stride(1), block_m, block_n, float(tol), _DTYPE_CODE[a.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"razor_matmul launch failed: CUDA error {err} "
                           f"for ({m}, {k}) @ ({k}, {n}), cells "
                           f"{block_m}x{block_n}")
    razor_matmul.launches += 1
    if not count_flags:
        return c, flags, rel
    return c, flags, rel, count


#: kernel launches made by :func:`razor_matmul` in this process (one per
#: call: the quantization prologue, product pass and cell pass together)
razor_matmul.launches = 0
