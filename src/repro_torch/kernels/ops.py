"""Wrappers over the ported kernels + the composed paper-flow op.

``voltage_scaled_matmul`` is the paper on one GEMM: static tier/voltage
assignment over weight tiles -> partitioned kernel execution -> Razor flags
-> one runtime (Algorithm 2) adjustment step — usable as a drop-in matmul
for experiments.  Counterpart of ``repro.kernels.ops``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.precision import static_tier_assignment, tile_headroom
from ..core.voltage import static_voltage_scaling
from .precision_island import precision_island
from .razor_matmul import razor_matmul
from .ssd_chunk import ssd_chunk
from .systolic_mac import systolic_mac
from .tuning import select_square_block
from .wkv6 import wkv6


def systolic_matmul(a, b, v_map, v_safe, **kw):
    return systolic_mac(a, b, v_map, v_safe, **kw)


def razor_mm(a, b, tol: float = 0.05, **kw):
    return razor_matmul(a, b, tol=tol, **kw)


def precision_mm(a, b, tiers, **kw):
    return precision_island(a, b, tiers, **kw)


def wkv6_op(r, k, v, w_log, u, state, chunk: Optional[int] = None, **kw):
    return wkv6(r, k, v, w_log, u, state, chunk=chunk, **kw)


def ssd_op(x, dt, A_log, B, C, D, state, chunk: Optional[int] = None, **kw):
    return ssd_chunk(x, dt, A_log, B, C, D, state, chunk=chunk, **kw)


# ---------------------------------------------------------------------------
# Composed paper flow on one GEMM
# ---------------------------------------------------------------------------


def voltage_scaled_matmul(a: torch.Tensor, b: torch.Tensor, *,
                          block: Optional[int] = None,
                          n_partitions: int = 4,
                          v_min: float = 1.0, v_crash: float = 0.7,
                          mac=systolic_mac) -> Tuple[torch.Tensor, dict]:
    """Paper flow on a single GEMM.

    1. 'Timing extraction': per-tile quantization headroom of ``b`` (the
       resident weights — the slack analogue).
    2. Clustering/static scheme: Algorithm 1 bands headroom into
       ``n_partitions`` voltages.
    3. Partitioned execution: systolic_mac with the derived voltage map;
       min-safe voltage per tile derived from headroom (less headroom ->
       needs more voltage).
    4. Razor flags -> one Algorithm-2 adjustment -> corrected rerun.

    Returns (C, info) where info carries voltages, flags and the modeled
    energy ratio vs an all-nominal run.  The headroom analysis and the two
    scheme steps run on the host in numpy, as in the JAX package; the two
    products run where ``a`` and ``b`` lie.  ``mac`` is the partitioned
    product to use (a test or a check can pass the plain version).
    """
    m, k = a.shape
    _, n = b.shape
    block = select_square_block(m, n) if block is None else block
    gm, gn = m // block, n // block

    head_cols = tile_headroom(b.detach().to(torch.float32).cpu().numpy().T,
                              tile=block)
    # per output tile: headroom of the b-column block feeding it
    h_tile = np.tile(head_cols[:, :1].T if head_cols.shape[1] == 1 else
                     head_cols.mean(1, keepdims=True).T, (gm, 1))
    h_tile = np.broadcast_to(h_tile[:gm, :gn], (gm, gn))

    bands = static_voltage_scaling(v_min, v_crash, n_partitions)
    tiers = static_tier_assignment(h_tile, n_tiers=n_partitions)
    # tier 0 = most headroom -> lowest voltage
    v_map = np.asarray(bands)[tiers]
    lo, hi = h_tile.min(), h_tile.max()
    frac = (h_tile - lo) / max(hi - lo, 1e-9)
    v_safe = v_crash + (1 - frac) * (v_min - v_crash) * 0.9

    def on_device(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=a.device)

    v_safe_t = on_device(v_safe)
    c, flags, n_fired = mac(a, b, on_device(v_map), v_safe_t, block_m=block,
                            block_n=block, count_flags=True)
    flags_np = flags.cpu().numpy()
    # Algorithm 2: bump failed partitions one step, clean ones down one step
    v_s = (v_min - v_crash) / n_partitions
    v_adj = np.where(flags_np > 0, v_map + v_s,
                     np.maximum(v_map - v_s, v_crash))
    c2, flags2, n_fired2 = mac(a, b, on_device(v_adj), v_safe_t,
                               block_m=block, block_n=block, count_flags=True)
    energy_ratio = float(np.mean((v_adj / v_min) ** 2))
    return c2, {
        "v_static": v_map, "v_runtime": v_adj,
        "flags_static": flags_np, "flags_runtime": flags2.cpu().numpy(),
        # fused in-kernel flag reductions
        "n_fired_static": int(n_fired), "n_fired_runtime": int(n_fired2),
        "energy_ratio_vs_nominal": energy_ratio,
    }
