"""Floorplanning: clusters of MACs -> rectangular FPGA voltage islands.

Implements the paper's 'Cluster Generation' -> partition-placement step
(Sec. II-C / Fig. 8): each cluster of MACs becomes one FPGA partition bounded
by slice coordinates (X0,Y0)-(X1,Y1); the partition's V_ccint rail feeds every
MAC inside it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Partition:
    """One voltage island on the FPGA floor."""

    index: int
    mac_ids: Tuple[int, ...]            # row-major MAC indices in this island
    x0: int
    y0: int
    x1: int
    y1: int
    v_ccint: float = float("nan")

    @property
    def n_macs(self) -> int:
        return len(self.mac_ids)

    def slice_range(self) -> str:
        """Xilinx-style slice range for the XDC pblock."""
        return f"SLICE_X{self.x0}Y{self.y0}:SLICE_X{self.x1}Y{self.y1}"


@dataclasses.dataclass
class Floorplan:
    array_n: int
    partitions: List[Partition]

    def partition_of_mac(self) -> np.ndarray:
        """(n*n,) partition index per MAC (row-major)."""
        out = np.full(self.array_n * self.array_n, -1, dtype=np.int64)
        for p in self.partitions:
            out[list(p.mac_ids)] = p.index
        if (out < 0).any():
            raise ValueError("floorplan does not cover every MAC")
        return out

    def voltage_map(self) -> np.ndarray:
        """(n, n) per-MAC voltage from partition rails."""
        part = self.partition_of_mac()
        v = np.array([p.v_ccint for p in self.partitions])
        return v[part].reshape(self.array_n, self.array_n)

    def with_voltages(self, v: Sequence[float]) -> "Floorplan":
        ps = [dataclasses.replace(p, v_ccint=float(v[p.index]))
              for p in self.partitions]
        return Floorplan(self.array_n, ps)


def grid_floorplan(labels: np.ndarray, array_n: int,
                   slices_per_mac: int = 4) -> Floorplan:
    """Place clusters on the floor as horizontal slabs of rows.

    The paper observes (Sec. V-C) that min-slack is strongly row-correlated
    (partial sums ripple toward the bottom rows), so clusters map naturally to
    contiguous row bands; the 16x16 example in Fig. 8 uses quadrants, which is
    the special case of 4 equal slabs re-split in x when cluster sizes allow.

    ``labels`` is the (n*n,) cluster id per MAC (no -1 allowed here).  MACs are
    *re-ordered* into their cluster's slab; the mac_ids of each partition
    record which logical MACs live there, exactly like the paper's XDC flow
    pins clustered MACs into a pblock.
    """
    labels = np.asarray(labels)
    if labels.min() < 0:
        raise ValueError("attach noise points to clusters before floorplanning")
    n_part = int(labels.max()) + 1
    total = array_n * array_n
    if len(labels) != total:
        raise ValueError("labels must cover the full array")

    # rows of the floor are dealt out proportionally to cluster sizes
    sizes = np.bincount(labels, minlength=n_part)
    rows = np.maximum(1, np.round(sizes / total * array_n).astype(int))
    while rows.sum() > array_n:
        rows[int(np.argmax(rows))] -= 1
    while rows.sum() < array_n:
        rows[int(np.argmin(rows))] += 1

    parts: List[Partition] = []
    y = 0
    for c in range(n_part):
        ids = tuple(int(i) for i in np.flatnonzero(labels == c))
        y1 = y + int(rows[c]) * slices_per_mac - 1
        parts.append(Partition(
            index=c, mac_ids=ids,
            x0=0, y0=y * 1,
            x1=array_n * slices_per_mac - 1, y1=y1,
        ))
        y = y1 + 1
    return Floorplan(array_n, parts)


def quadrant_floorplan(array_n: int) -> Floorplan:
    """The paper's simplified Fig. 8 layout: 4 equal quadrants (n/2 x n/2),
    partition order: top-left, top-right, bottom-left, bottom-right."""
    h = array_n // 2
    s = 4  # slices per MAC edge
    quads = [(0, 0), (0, h), (h, 0), (h, h)]   # (row0, col0)
    parts = []
    for idx, (r0, c0) in enumerate(quads):
        ids = tuple(int((r0 + r) * array_n + (c0 + c))
                    for r in range(h) for c in range(h))
        parts.append(Partition(
            index=idx, mac_ids=ids,
            x0=c0 * s, y0=(array_n - (r0 + h)) * s,
            x1=(c0 + h) * s - 1, y1=(array_n - r0) * s - 1,
        ))
    return Floorplan(array_n, parts)


def partition_min_slack(labels: np.ndarray, min_slack_flat: np.ndarray) -> np.ndarray:
    """Representative (minimum) slack per cluster — drives voltage assignment."""
    n_part = int(labels.max()) + 1
    return np.array([min_slack_flat[labels == c].min() for c in range(n_part)])
