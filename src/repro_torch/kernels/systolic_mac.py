"""systolic_mac on Hopper: voltage-island partitioned matmul with
timing-fault injection and Razor flags (the paper's partitioned MAC array as
one GEMM).

Replaces the Pallas kernel ``src/repro/kernels/systolic_mac.py::_kernel``
(wrappers ``_systolic_mac_call`` / ``systolic_mac``).  The CUDA source is
``csrc/systolic_mac.cu``.

Each (i, j) cell of the ``v_map`` grid is one partition with a rail voltage
``v_map[i, j]`` and a minimum safe voltage ``v_safe[i, j]``.  Under-volted
cells have the low mantissa bits of their f32 accumulators masked off (the
model shared with :func:`repro_torch.kernels.ref.corrupt_low_bits`) and raise
a flag — the per-partition Razor flag the runtime scheme consumes.  With
``count_flags=True`` the kernel also accumulates the number of fired cells
(an integer ``atomicAdd``), so callers that only need "how many partitions
failed" read one integer instead of the flag map.

What bounds it on an H100: at the serving shapes (M = 1..8 rows against a
(K, N) bf16 weight) the bytes of ``b``, ``K * N * 2``; at large M the f32
FMA rate, because this first version accumulates with ``fmaf`` in registers
and leaves the tensor cores idle.  What the design does about the first:
``b`` is read once, in place through its strides (a transposed view of the
embedding is never copied or up-cast), coalesced along whichever of its axes
is contiguous, with the next K tile's loads started before the current tile's
arithmetic.  The partition cell (``block_m x block_n``, as small as 1x1 on
the serving path) is independent of the launch tile, which is chosen in the
CUDA source from M alone: 8x32 for M <= 8, else 64x64.  Every output element
is summed over k in ascending order in both, so a row's value does not depend
on how many rows share the call.

:func:`systolic_mac` launches the kernel for CUDA tensors (or raises) and
computes :func:`systolic_mac_plain` for CPU tensors; there is no other
route between the two.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .ref import keep_mask, systolic_mac_tiles

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
#: rows per block of the wide launch tile (csrc/systolic_mac.cu); bounds
#: grid.y, which CUDA limits to 65535
_WIDE_TILE_M = 64
_MAX_GRID_Y = 65535


def systolic_mac_plain(a: torch.Tensor, b: torch.Tensor, v_map: torch.Tensor,
                       v_safe: torch.Tensor, *, block_m: int, block_n: int,
                       keep_bits: int = 8):
    """The kernel's function in plain PyTorch: (C f32 (M, N), flags int32
    (M/block_m, N/block_n)).  Same as ``kernels.ref.systolic_mac`` with
    independent cell edges."""
    return systolic_mac_tiles(a, b, v_map, v_safe, block_m, block_n,
                              keep_bits)


def _check(a, b, v_map, v_safe, block_m, block_n, keep_bits):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"systolic_mac expects (M, K) @ (K, N); got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"systolic_mac takes a and b both float32 or both "
                        f"bfloat16; got {a.dtype} and {b.dtype}")
    if v_map.dim() != 2 or v_map.shape != v_safe.shape:
        raise ValueError(f"v_map and v_safe must be equal-shaped 2-D grids; "
                         f"got {tuple(v_map.shape)} / {tuple(v_safe.shape)}")
    m, n = a.shape[0], b.shape[1]
    gm, gn = v_map.shape
    if m == 0 or n == 0 or gm == 0 or gn == 0:
        raise ValueError(f"systolic_mac needs non-empty M, N and grid; got "
                         f"M={m}, N={n}, grid=({gm}, {gn})")
    block_m = m // gm if block_m is None else block_m
    block_n = n // gn if block_n is None else block_n
    if block_m <= 0 or block_n <= 0 or block_m * gm != m or block_n * gn != n:
        raise ValueError(f"grid ({gm}, {gn}) with cells {block_m}x{block_n} "
                         f"does not tile a ({m}, {n}) output")
    keep_mask(keep_bits)                        # range check
    for t in (b, v_map, v_safe):
        if t.device != a.device:
            raise ValueError(f"systolic_mac operands lie on different "
                             f"devices: {a.device} and {t.device}")
    return block_m, block_n


def systolic_mac(a: torch.Tensor, b: torch.Tensor, v_map: torch.Tensor,
                 v_safe: torch.Tensor, *, block_m: Optional[int] = None,
                 block_n: Optional[int] = None, keep_bits: int = 8,
                 count_flags: bool = False):
    """C = a @ b with per-cell voltage-island fault semantics.

    a: (M, K); b: (K, N), both float32 or both bfloat16, any strides;
    v_map/v_safe: (M/block_m, N/block_n).  Returns (C f32 (M, N), flags
    int32 (gm, gn)); with ``count_flags=True`` additionally the fused int32
    total of fired cells as a 0-d tensor on the inputs' device (reading it is
    the caller's synchronisation, not this function's).  ``block_m`` /
    ``block_n`` default to the cell shape ``v_map`` implies.

    CUDA tensors go to the kernel, CPU tensors to :func:`systolic_mac_plain`.
    """
    block_m, block_n = _check(a, b, v_map, v_safe, block_m, block_n,
                              keep_bits)
    if a.device.type == "cpu":
        c, flags = systolic_mac_plain(a, b, v_map, v_safe, block_m=block_m,
                                      block_n=block_n, keep_bits=keep_bits)
        if not count_flags:
            return c, flags
        return c, flags, flags.sum().to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"systolic_mac has no kernel for device {a.device}")

    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) > _INT_MAX or m * n > 2 ** 62:
        raise ValueError(f"systolic_mac: problem ({m}, {k}, {n}) exceeds the "
                         f"kernel's 32-bit extents")
    if -(-m // _WIDE_TILE_M) > _MAX_GRID_Y:
        raise ValueError(f"systolic_mac: M={m} needs more than "
                         f"{_MAX_GRID_Y} row blocks")
    lib = _build.load_library()
    v_map = v_map.to(torch.float32).contiguous()
    v_safe = v_safe.to(torch.float32).contiguous()
    gm, gn = v_map.shape
    with torch.cuda.device(a.device):
        c = torch.empty((m, n), dtype=torch.float32, device=a.device)
        flags = torch.empty((gm, gn), dtype=torch.int32, device=a.device)
        count = (torch.zeros((), dtype=torch.int32, device=a.device)
                 if count_flags else None)
        err = lib.systolic_mac_launch(
            a.data_ptr(), b.data_ptr(), v_map.data_ptr(), v_safe.data_ptr(),
            c.data_ptr(), flags.data_ptr(),
            count.data_ptr() if count is not None else None,
            m, n, k, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
            block_m, block_n, keep_bits, _DTYPE_CODE[a.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"systolic_mac launch failed: CUDA error {err} "
                           f"for ({m}, {k}) @ ({k}, {n}), cells "
                           f"{block_m}x{block_n}")
    systolic_mac.launches += 1
    if not count_flags:
        return c, flags
    return c, flags, count


#: kernel launches made by :func:`systolic_mac` in this process
systolic_mac.launches = 0
