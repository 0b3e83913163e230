"""Precision-island controller: the numerics analogue of voltage islands
(DESIGN.md Sec. 2b, beyond-paper layer).

On a fixed-voltage accelerator the per-tile energy knob is numerics, not
V_ccint.  The mapping:

    min-slack            -> quantization headroom of a weight tile
    V_ccint rail         -> precision tier (int4 < int8 < bf16 "voltage")
    Algorithm 1 (static) -> band the headroom range, assign tiers
    Razor shadow FF      -> shadow high-precision recompute + mismatch flag
                            (kernels/razor_matmul.py)
    Algorithm 2 (runtime)-> promote tile on mismatch, demote when clean

Energy per MAC by tier is anchored to the paper's PowerModel so the framework
reports a single consistent simulated-power number (roofline/power_report).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .voltage import RuntimeScheme

# precision tiers, ordered like ascending voltage: cheapest/most fragile first
TIERS: Tuple[str, ...] = ("int4", "int8", "bf16")

# relative energy per MAC (bf16 MXU pass = 1.0; int8 ~ 1/4 of bf16 multiply
# energy, int4 ~ 1/8 — standard accelerator energy ratios).  The ladder is
# monotone in BOTH energy and accuracy, mirroring the paper's voltage axis.
ENERGY_PER_MAC: Dict[str, float] = {"int4": 0.12, "int8": 0.25, "bf16": 1.00}


def tile_headroom(w: np.ndarray, tile: int = 128) -> np.ndarray:
    """Quantization headroom per (tile x tile) weight tile.

    Headroom = how well int8 quantization preserves the tile, measured as the
    negative log of relative quantization error — the 'min slack' analogue:
    larger headroom tolerates a cheaper tier.
    """
    r, c = w.shape
    tr, tc = (r + tile - 1) // tile, (c + tile - 1) // tile
    out = np.zeros((tr, tc))
    for i in range(tr):
        for j in range(tc):
            blk = w[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
            scale = np.max(np.abs(blk)) or 1.0
            q = np.round(blk / scale * 127.0) / 127.0 * scale
            rel = float(np.linalg.norm(q - blk) / (np.linalg.norm(blk) or 1.0))
            out[i, j] = -np.log10(max(rel, 1e-12))
    return out


def static_tier_assignment(headroom: np.ndarray,
                           n_tiers: int = len(TIERS)) -> np.ndarray:
    """Algorithm-1 analogue: band the headroom range into ``n_tiers`` equal
    bands; highest-headroom band gets the cheapest tier (index 0 = int8)."""
    h = np.asarray(headroom, dtype=np.float64)
    lo, hi = float(h.min()), float(h.max())
    if hi - lo < 1e-12:
        return np.zeros(h.shape, dtype=np.int64)
    band = (hi - lo) / n_tiers
    # highest headroom -> tier 0 (cheapest); lowest -> tier n-1 (bf16)
    idx = np.clip(((hi - h) / band).astype(np.int64), 0, n_tiers - 1)
    return idx


@dataclasses.dataclass
class PrecisionController:
    """Algorithm-2 verbatim on tier indices instead of volts.

    ``step(tiers, mismatch)``: a tile whose shadow-recompute flag fired is
    promoted one tier (toward bf16); a clean tile is demoted one tier.
    """

    n_tiers: int = len(TIERS)
    history: List[np.ndarray] = dataclasses.field(default_factory=list)

    def step(self, tiers: np.ndarray, mismatch: np.ndarray) -> np.ndarray:
        t = np.asarray(tiers, dtype=np.int64)
        nt = np.where(np.asarray(mismatch, bool), t + 1, t - 1)
        nt = np.clip(nt, 0, self.n_tiers - 1)
        self.history.append(nt.copy())
        return nt

    def calibrate(self, tiers0: np.ndarray, trial, max_trials: int = 16) -> np.ndarray:
        """Anneal to the cheapest clean tier per tile; ``trial(tiers) ->
        mismatch flags``. Locks the lowest tier that ran clean."""
        t = np.asarray(tiers0, dtype=np.int64).copy()
        best_clean = np.full(t.shape, self.n_tiers - 1, dtype=np.int64)
        seen_clean = np.zeros(t.shape, dtype=bool)
        for _ in range(max_trials):
            flags = np.asarray(trial(t), bool)
            clean = ~flags
            best_clean = np.where(clean & (t < best_clean), t, best_clean)
            seen_clean |= clean
            t = self.step(t, flags)
            if seen_clean.all() and (t >= best_clean).all():
                break
        return np.where(seen_clean, best_clean, self.n_tiers - 1)


def energy_ratio(tiers: np.ndarray) -> float:
    """Mean per-MAC energy of a tier map relative to all-bf16."""
    t = np.asarray(tiers, dtype=np.int64)
    e = np.array([ENERGY_PER_MAC[TIERS[i]] for i in t.reshape(-1)])
    return float(e.mean())


def tier_names(tiers: np.ndarray) -> np.ndarray:
    return np.asarray(TIERS, dtype=object)[np.asarray(tiers, dtype=np.int64)]
