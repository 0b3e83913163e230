"""Plain-PyTorch oracles for the ported kernels (the allclose targets).

Semantics shared between kernel and oracle are defined HERE; a kernel must
reproduce them bit for bit up to dtype tolerance.  Counterpart of
``repro.kernels.ref``; the oracles of the kernels not ported yet (wkv6,
ssd) arrive with their kernels.

The integer products of razor_matmul and precision_island are exact, as the
JAX oracle's int32 products are: on the CPU in int32, on a GPU (where PyTorch
has no integer matmul) as a float64 product of the int8 values, which is
exact while K * 127^2 < 2^53 and rounds to float32 as int32 -> float32 does.
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


def _quantize_sym(x: torch.Tensor, levels: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row quantization over the last axis, f32 throughout,
    round-half-even: ``scale = max(amax, 1e-12) / levels``, ``q =
    clamp(round(x / scale), -levels, levels)``.  Both divisions are true
    divisions: the divisor of the first is a tensor, because PyTorch on a
    GPU turns a division by a Python number into a multiplication by its
    reciprocal, which rounds differently."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    clamped = torch.clamp(amax, min=1e-12)
    scale = clamped / torch.full_like(clamped, levels)
    q = torch.clamp(torch.round(xf / scale), -levels, levels)
    return q.to(torch.int8), scale


def quantize_sym_i8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization (row = last-axis vectors)."""
    return _quantize_sym(x, 127.0)


def int_matmul_f32(qa: torch.Tensor, qb_t: torch.Tensor) -> torch.Tensor:
    """``(qa @ qb_t.T)`` of int8 operands, exact, as float32: int32 on the
    CPU (the JAX oracle's product), float64 elsewhere (exact for
    K * 127^2 < 2^53; the one rounding, to float32, is the one int32 ->
    float32 makes)."""
    if qa.device.type == "cpu":
        return (qa.to(torch.int32) @ qb_t.to(torch.int32).T).to(torch.float32)
    if qa.shape[-1] * 127 ** 2 >= 2 ** 53:
        raise ValueError(f"K={qa.shape[-1]} is too long for an exact float64 "
                         f"integer product")
    return (qa.to(torch.float64) @ qb_t.to(torch.float64).T).to(torch.float32)


def _dequant_product(a: torch.Tensor, b: torch.Tensor, quantize):
    """The integer path of one operand pair: per-row quantization of ``a``
    and of ``b``'s columns over K, exact product, dequantized in the
    oracle's order ``(acc * sa) * sb^T``."""
    qa, sa = quantize(a)                          # (m, k), (m, 1)
    qb, sb = quantize(b.T)                        # (n, k), (n, 1)
    return int_matmul_f32(qa, qb) * sa * sb.T


# ---------------------------------------------------------------------------
# razor_matmul: low-precision main path + full-precision shadow + flags
# ---------------------------------------------------------------------------


def razor_matmul_tiles(a: torch.Tensor, b: torch.Tensor, tol: float,
                       block_m: int, block_n: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Razor-style double-sampled matmul on (block_m x block_n) cells.

    Main path: int8 x int8 -> int32 (the near-threshold 'fast but risky'
    path).  Shadow path: f32 (the delayed-clock shadow register).  Per cell:
    flag = relative Frobenius error > tol; flagged cells are *corrected* to
    the shadow value (razor replay semantics).  Returns (C (M, N) f32
    corrected, flags (gm, gn) int32, rel_err (gm, gn) f32).
    """
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or m % block_m or n % block_n:
        raise ValueError(f"razor_matmul: {tuple(a.shape)} @ {tuple(b.shape)} "
                         f"does not tile into {block_m}x{block_n} cells")
    main = _dequant_product(a, b, quantize_sym_i8)
    shadow = a.to(torch.float32) @ b.to(torch.float32)
    gm, gn = m // block_m, n // block_n
    mt = main.reshape(gm, block_m, gn, block_n)
    st = shadow.reshape(gm, block_m, gn, block_n)
    err = torch.sqrt(torch.sum((mt - st) ** 2, dim=(1, 3)))
    ref = torch.sqrt(torch.sum(st ** 2, dim=(1, 3))) + 1e-12
    rel = err / ref
    flags = (rel > tol).to(torch.int32)
    out = torch.where(flags[:, None, :, None] == 1, st, mt)
    return out.reshape(m, n), flags, rel


def razor_matmul(a: torch.Tensor, b: torch.Tensor, tol: float = 0.05,
                 block: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Square-cell form of :func:`razor_matmul_tiles` (``block`` defaults
    to the tuning table's choice for (M, N))."""
    m, n = a.shape[0], b.shape[1]
    block = select_square_block(m, n) if block is None else block
    return razor_matmul_tiles(a, b, tol, block, block)


# ---------------------------------------------------------------------------
# precision_island: per-tile precision-tier matmul
# ---------------------------------------------------------------------------


def quantize_sym_i4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int4 quantization (levels -7..7, stored as int8)."""
    return _quantize_sym(x, 7.0)


def _tile_matmul_at_tier(at: torch.Tensor, bt: torch.Tensor,
                         tier: torch.Tensor) -> torch.Tensor:
    """at: (bm, k); bt: (k, bn); tier scalar 0=int4 1=int8 2=bf16/f32."""
    f32 = at.to(torch.float32) @ bt.to(torch.float32)
    i8 = _dequant_product(at, bt, quantize_sym_i8)
    i4 = _dequant_product(at, bt, quantize_sym_i4)
    return torch.where(tier == 0, i4, torch.where(tier == 1, i8, f32))


def precision_island_tiles(a: torch.Tensor, b: torch.Tensor,
                           tiers: torch.Tensor, block_m: int, block_n: int
                           ) -> torch.Tensor:
    """C = a @ b where each (block_m x block_n) output cell computes at its
    assigned tier (0=int4, 1=int8, 2=full f32) — the numerics analogue of
    per-partition V_ccint.  Each operand is quantized once: the per-row
    scales run over the whole of K, so they do not depend on the cell, and
    a cell equals :func:`_tile_matmul_at_tier` on its slices."""
    m, k = a.shape
    k2, n = b.shape
    gm, gn = m // block_m, n // block_n
    if k != k2 or m % block_m or n % block_n or tuple(tiers.shape) != (gm, gn):
        raise ValueError(f"precision_island: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} with tiers {tuple(tiers.shape)} "
                         f"does not tile into {block_m}x{block_n} cells")
    t = tiers.to(a.device).repeat_interleave(block_m, 0).repeat_interleave(
        block_n, 1)
    f32 = a.to(torch.float32) @ b.to(torch.float32)
    i8 = _dequant_product(a, b, quantize_sym_i8)
    i4 = _dequant_product(a, b, quantize_sym_i4)
    return torch.where(t == 0, i4, torch.where(t == 1, i8, f32))


def precision_island(a: torch.Tensor, b: torch.Tensor, tiers: torch.Tensor,
                     block: Optional[int] = None) -> torch.Tensor:
    """Square-cell form of :func:`precision_island_tiles` (``block``
    defaults to the tuning table's choice for (M, N))."""
    m, n = a.shape[0], b.shape[1]
    block = select_square_block(m, n) if block is None else block
    return precision_island_tiles(a, b, tiers, block, block)
