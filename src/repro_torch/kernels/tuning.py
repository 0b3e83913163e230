"""Block-size selection for the flag grids of the kernels.

``select_blocks`` / ``select_square_block`` / ``select_chunk`` size the
*partition grid* a kernel reports on (one Razor flag, one rail voltage per
cell).  The grid is part of a kernel's result, so these tables return exactly
what ``repro.kernels.tuning`` returns for the same problem.  They do not size
the CUDA launch: each kernel module keeps its own launch-tile constants.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

#: Preferred block sizes per grid axis, best first.  The first entry that
#: divides the axis wins; if none divides it, the full axis is used (the
#: kernels check divisibility, so a whole axis is always valid).
BLOCK_TABLE: Dict[str, Tuple[int, ...]] = {
    "m": (128, 64, 32, 16, 8),
    "n": (128, 64, 32, 16, 8),
    "k": (128, 64, 32, 16, 8),
}

#: Preferred sequence-chunk lengths for the scan kernels (wkv6 / ssd_chunk).
CHUNK_TABLE: Tuple[int, ...] = (128, 64, 32, 16, 8)


def _pick(size: int, prefs: Sequence[int]) -> int:
    for b in prefs:
        if b <= size and size % b == 0:
            return b
    return size


def select_blocks(m: int, n: int, k: Optional[int] = None,
                  table: Optional[Dict[str, Sequence[int]]] = None
                  ) -> Tuple[int, ...]:
    """(block_m, block_n[, block_k]) for an (m, n[, k]) problem.

    Every returned block divides its axis.
    """
    t = dict(BLOCK_TABLE)
    if table:
        t.update(table)
    out = (_pick(m, t["m"]), _pick(n, t["n"]))
    return out if k is None else out + (_pick(k, t["k"]),)


def select_chunk(seq_len: int, prefs: Sequence[int] = CHUNK_TABLE) -> int:
    """Largest preferred chunk length dividing ``seq_len``."""
    return _pick(seq_len, prefs)


def select_square_block(*dims: int,
                        prefs: Optional[Sequence[int]] = None) -> int:
    """Largest preferred block edge dividing *every* given dim.

    The square-tile analogue of :func:`select_blocks` for callers whose tile
    grid must share one edge across axes (voltage maps, flag grids, the
    plain-PyTorch oracles).  Falls back to the gcd of the dims when no table
    entry divides them all, so the result always tiles exactly.
    """
    prefs = BLOCK_TABLE["m"] if prefs is None else prefs
    for b in prefs:
        if all(b <= d and d % b == 0 for d in dims):
            return b
    g = 0
    for d in dims:
        g = math.gcd(g, d)
    return max(g, 1)


def assert_divides(block: int, dim: int, what: str) -> None:
    """Fail fast (and informatively) when a block does not tile its axis."""
    if block <= 0 or dim % block != 0:
        raise ValueError(
            f"{what}: block {block} does not divide axis of size {dim} — "
            f"pass block/chunk=None to pick from the tuning tables")
