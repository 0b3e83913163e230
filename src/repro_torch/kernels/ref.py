"""Plain-PyTorch oracles for the ported kernels (the allclose targets).

Semantics shared between kernel and oracle are defined HERE; a kernel must
reproduce them bit for bit up to dtype tolerance.  Counterpart of
``repro.kernels.ref``; the oracles of the kernels not ported yet
(razor_matmul, precision_island, wkv6, ssd) arrive with their kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .tuning import select_square_block


# ---------------------------------------------------------------------------
# systolic_mac: voltage-island partitioned matmul with timing-fault injection
# ---------------------------------------------------------------------------


def keep_mask(keep_bits: int) -> int:
    """The uint32 mask that keeps sign, exponent and the top ``keep_bits``
    mantissa bits of an f32."""
    if not 0 <= keep_bits <= 23:
        raise ValueError(f"keep_bits must be in [0, 23]; got {keep_bits}")
    return (0xFFFFFFFF << (23 - keep_bits)) & 0xFFFFFFFF


def corrupt_low_bits(x: torch.Tensor, keep_bits: int = 8) -> torch.Tensor:
    """Timing-failure corruption model: the accumulator's low mantissa bits
    miss the clock edge — emulated by mantissa truncation of the f32 result."""
    mask = keep_mask(keep_bits)
    signed = mask - (1 << 32) if mask >= (1 << 31) else mask   # as int32
    xi = x.to(torch.float32).contiguous().view(torch.int32)
    return (xi & signed).view(torch.float32)


def systolic_mac_tiles(a: torch.Tensor, b: torch.Tensor, v_map: torch.Tensor,
                       v_safe: torch.Tensor, block_m: int, block_n: int,
                       keep_bits: int = 8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """C = a @ b on a grid of (block_m x block_n) voltage-island cells.

    v_map / v_safe: (M/block_m, N/block_n) per-cell rail voltage and minimum
    safe voltage.  Cells with v < v_safe suffer the corruption model and
    raise their Razor flag.  Returns (C (M, N) f32, flags (gm, gn) int32).
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or m % block_m or n % block_n:
        raise ValueError(f"systolic_mac: {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"does not tile into {block_m}x{block_n} cells")
    gm, gn = m // block_m, n // block_n
    if tuple(v_map.shape) != (gm, gn) or tuple(v_safe.shape) != (gm, gn):
        raise ValueError(f"v_map/v_safe must be ({gm}, {gn}); got "
                         f"{tuple(v_map.shape)} / {tuple(v_safe.shape)}")
    c = a.to(torch.float32) @ b.to(torch.float32)
    fail = v_map.to(torch.float32) < v_safe.to(torch.float32)
    c_t = c.reshape(gm, block_m, gn, block_n)
    out = torch.where(fail[:, None, :, None],
                      corrupt_low_bits(c_t, keep_bits), c_t)
    return out.reshape(m, n), fail.to(torch.int32)


def systolic_mac(a: torch.Tensor, b: torch.Tensor, v_map: torch.Tensor,
                 v_safe: torch.Tensor, block: Optional[int] = None,
                 keep_bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Square-cell form of :func:`systolic_mac_tiles` (``block`` defaults to
    the tuning table's choice for (M, N))."""
    m, n = a.shape[0], b.shape[1]
    block = select_square_block(m, n) if block is None else block
    return systolic_mac_tiles(a, b, v_map, v_safe, block, block, keep_bits)


# ---------------------------------------------------------------------------
# shared symmetric int8 quantizer
# ---------------------------------------------------------------------------


def quantize_sym_i8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization (row = last-axis vectors), f32
    throughout, round-half-even."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale
