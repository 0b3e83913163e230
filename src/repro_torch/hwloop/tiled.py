"""The voltage-scaled array's GEMM over all of its tiles at once.

The emulated accelerator and the simulated backend walk an ``(M, K) @ (K,
N)`` product over the ``n x n`` array in Python: one iteration per (K-tile,
column tile), each classifying, counting and multiplying one tile.  That is
the plain version (``EmulatedAccelerator._matmul_loop``,
``SimulatedBackend._execute_loop``).  At a served model's width it is tens
of millions of iterations a decode step, so on a GPU both run this tiled
form instead, which computes the same results from the same rules:

* **Classification.**  A tile's Razor status depends only on its K-tile's
  activations and the rails, never on the weights, so it is one
  ``(Kt, M, n, n)`` tensor shared by every column tile, computed with the
  ``*_torch`` forms of :mod:`repro_torch.core.razor` (bit for bit the numpy
  functions').  Under the ``emulated`` rule the rows a ragged last K-tile
  lacks are not classified; under the ``simulated`` rule they are (the
  simulator zero-pads the tile, and its padded MACs exist on the die).
* **Counts** are closed forms of the per-cell sums :class:`TileScan` carries
  to the host in one read: a cell's count over the column tiles is its
  count in one tile times the number of column tiles that hold its column.
* **Products.**  Tiles with no ``SILENT`` cycle contribute the exact float64
  product, one ``torch.matmul`` per column chunk.  A K-tile with a ``SILENT``
  cycle makes its whole row band of column tiles silent (the status is
  shared); those bands go through the corruption model's tile form in
  chunks of K-tiles that bound the ``(T, M, n, N)`` term tensor.
* **Summation order.**  The float64 sums are taken in another order than the
  loop's tile-by-tile sums, so on real-valued operands the products agree to
  rounding (``1e-12 x max|C|``), and bit for bit on integer-valued ones.

Everything here runs on the operands' device; nothing falls back to the
host.  On CPU tensors it runs too, which is how the tests hold it against
the plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.razor import (RazorConfig, effective_arrival_torch,
                          razor_windows_torch, streamed_activity_torch)
from .inject import TileCorruptionFn

RULES = ("emulated", "simulated")
#: bytes of one column chunk's float64 weight copy
WEIGHT_CHUNK_BYTES = 512 << 20
#: bytes of one chunk of silent K-tiles' float64 term tensor
TERMS_CHUNK_BYTES = 256 << 20


@dataclasses.dataclass
class TileScan:
    """What the classification of one GEMM hands the host (one read).  The
    per-cell counts are summed over the rows and the K-tiles: one column
    tile's worth."""

    detected: np.ndarray            # (n, n) int64 DETECTED cycles per cell
    silent: np.ndarray              # (n, n) int64 SILENT cycles per cell
    silent_tiles: np.ndarray        # (Kt,) bool: a SILENT cycle in the K-tile

    def column_weights(self, n_dim: int) -> np.ndarray:
        """(n,) column tiles holding each array column: the full ones, and
        the ragged last one for its first ``n_dim % n`` columns."""
        n = self.detected.shape[1]
        return n_dim // n + (np.arange(n) < n_dim % n)


class DelayCache:
    """A timing model's (n, n) per-cell delays at a voltage map: the host
    array, and a float64 tensor on each device it was asked for.  Rails move
    rarely, and a decode step has hundreds of GEMMs."""

    def __init__(self, timing) -> None:
        self.timing = timing
        self._at = b""
        self._on: Dict[Optional[torch.device], object] = {}

    def __call__(self, v_map: np.ndarray,
                 device: Optional[torch.device] = None):
        key = np.asarray(v_map, dtype=np.float64).tobytes()
        if key != self._at:
            self._at = key
            self._on = {None: self.timing.delays_at(v_map)}
        if device not in self._on:
            self._on[device] = torch.as_tensor(
                self._on[None], dtype=torch.float64).to(device)
        return self._on[device]


def route(a: torch.Tensor, w: torch.Tensor, loop: Callable, tiles: Callable,
          what: str):
    """``a @ w`` by the plain version on CPU operands (``loop`` on float64
    host arrays, its product returned as a tensor) or by the tiled form on
    CUDA operands (``tiles`` on the tensors); any other device raises."""
    if a.device.type == "cpu":
        c, tel = loop(a.detach().to(torch.float64).numpy(),
                      w.detach().to(torch.float64).numpy())
        return torch.from_numpy(c), tel
    if a.device.type != "cuda":
        raise ValueError(f"no {what} route for {a.device} tensors")
    return tiles(a.detach(), w.detach())


def classify(a64: torch.Tensor, delays: torch.Tensor, razor: RazorConfig,
             quant_bits: int, n: int, rule: str
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The K-tiles of the float64 ``a64`` (M, K), zero-padded to whole
    tiles, as (Kt, M, n), and their Razor windows against the per-cell
    ``delays`` (n, n) float64: ``late`` and ``lost`` (Kt, M, n, n) bool —
    DETECTED where late and not lost, SILENT where lost."""
    if rule not in RULES:
        raise ValueError(f"unknown tiling rule {rule!r}; known: {RULES}")
    if razor.t_del_ns < 0:
        raise ValueError("the tiled form counts DETECTED as late minus lost, "
                         "which needs t_del_ns >= 0")
    m_rows, k_dim = a64.shape
    kt = -(-k_dim // n)
    if kt * n != k_dim:
        a64 = torch.nn.functional.pad(a64, (0, kt * n - k_dim))
    blocks = a64.reshape(m_rows, kt, n).transpose(0, 1)       # (Kt, M, n)
    act = streamed_activity_torch(blocks, quant_bits)           # (Kt, M, n)
    arrival = effective_arrival_torch(delays.view(1, 1, n, n),
                                      act.unsqueeze(-1), razor)
    late, lost = razor_windows_torch(arrival, razor)            # (Kt,M,n,n)
    if rule == "emulated" and kt * n != k_dim:
        # the ragged last K-tile's missing rows are no MACs of the loop
        rows = (torch.arange(kt * n, device=a64.device) < k_dim) \
            .view(kt, 1, n, 1)
        late, lost = late & rows, lost & rows
    return blocks, late, lost


def scan_pack(late: torch.Tensor, lost: torch.Tensor) -> torch.Tensor:
    """The int64 vector one read carries: per-cell late and lost counts
    (n * n each) and each K-tile's lost count (Kt)."""
    return torch.cat([late.sum(dim=(0, 1)).flatten(),
                      lost.sum(dim=(0, 1)).flatten(),
                      lost.flatten(1).sum(dim=1)])


def unpack_scan(host: np.ndarray, n: int) -> TileScan:
    nn = n * n
    late = host[:nn].reshape(n, n).astype(np.int64)
    lost = host[nn:2 * nn].reshape(n, n).astype(np.int64)
    return TileScan(detected=late - lost, silent=lost,
                    silent_tiles=host[2 * nn:] > 0)


def column_chunks(k_dim: int, n_dim: int, n: int):
    """Column ranges, each a whole number of array columns wide, whose
    float64 weight copy fits ``WEIGHT_CHUNK_BYTES``."""
    cols = max(n, (WEIGHT_CHUNK_BYTES // (8 * max(k_dim, 1))) // n * n)
    return [(c0, min(c0 + cols, n_dim)) for c0 in range(0, n_dim, cols)]


def _clean_product(a64: torch.Tensor, w: torch.Tensor, n: int
                   ) -> torch.Tensor:
    m_rows, k_dim = a64.shape
    n_dim = w.shape[1]
    chunks = column_chunks(k_dim, n_dim, n)
    if len(chunks) == 1:
        return torch.matmul(a64, w.to(torch.float64))
    c = torch.empty((m_rows, n_dim), dtype=torch.float64, device=a64.device)
    for c0, c1 in chunks:
        c[:, c0:c1] = torch.matmul(a64, w[:, c0:c1].to(torch.float64))
    return c


def _silent_product(a64, blocks, w, c_true, lost, silent_tiles, corrupt, n,
                    rule):
    """The product with the silent K-tiles' bands through ``corrupt``, and
    its ``rel_error`` as a 0-d float64 tensor: against the clean product
    ``c_true`` (``emulated``) or the largest of the silent tiles'
    (``simulated``)."""
    m_rows, k_dim = a64.shape
    n_dim = w.shape[1]
    kt = blocks.shape[0]
    dev = a64.device
    idx_all = np.flatnonzero(silent_tiles)
    keep = torch.from_numpy(np.repeat(~silent_tiles, n)[:k_dim]).to(dev)
    a_clean = torch.where(keep, a64, torch.zeros((), dtype=torch.float64,
                                                 device=dev))
    c = torch.empty((m_rows, n_dim), dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    one = torch.ones((), dtype=torch.float64, device=dev)
    diff2, true2, worst = zero.clone(), zero.clone(), zero.clone()
    for c0, c1 in column_chunks(k_dim, n_dim, n):
        cols = c1 - c0
        w64 = w[:, c0:c1].to(torch.float64)
        c_chunk = torch.matmul(a_clean, w64)
        if kt * n != k_dim:
            w64 = torch.nn.functional.pad(w64, (0, 0, 0, kt * n - k_dim))
        w_tiles = w64.reshape(kt, n, cols)
        step = max(1, TERMS_CHUNK_BYTES // (8 * m_rows * n * cols))
        reps = -(-cols // n)
        for s0 in range(0, len(idx_all), step):
            idx = torch.from_numpy(idx_all[s0:s0 + step]).to(dev)
            terms = (blocks[idx].unsqueeze(-1)
                     * w_tiles[idx].unsqueeze(1))            # (T, M, n, cols)
            sil = lost[idx].repeat(1, 1, 1, reps)[..., :cols]
            out = corrupt(terms, sil, None)                  # (T, M, cols)
            c_chunk += out.sum(dim=0)
            if rule == "simulated":
                true = terms.sum(dim=2)
                pad = reps * n - cols
                d2 = torch.nn.functional.pad((out - true) ** 2, (0, pad))
                t2 = torch.nn.functional.pad(true ** 2, (0, pad))
                shape = (d2.shape[0], m_rows, reps, n)
                dn = d2.view(shape).sum(dim=(1, 3)).sqrt()
                tn = t2.view(shape).sum(dim=(1, 3)).sqrt()
                rel = dn / torch.where(tn == 0, one, tn)
                worst = torch.maximum(worst, rel.max())
        c[:, c0:c1] = c_chunk
        if rule == "emulated":
            true = c_true[:, c0:c1]
            diff2 += ((c_chunk - true) ** 2).sum()
            true2 += (true ** 2).sum()
    if rule == "emulated":
        denom = true2.sqrt()
        worst = diff2.sqrt() / torch.where(denom == 0, one, denom)
    return c, worst


def tiled_matmul(a: torch.Tensor, w: torch.Tensor, *, delays: torch.Tensor,
                 razor: RazorConfig, quant_bits: int,
                 corrupt: TileCorruptionFn, rule: str
                 ) -> Tuple[torch.Tensor, TileScan, Optional[float]]:
    """``a @ w`` on the ``n x n`` array, all tiles at once, on the operands'
    device; ``delays`` is the (n, n) float64 per-cell delay at the rails,
    on that device.

    Returns the float64 product, the classification's :class:`TileScan`
    and, where a K-tile had a ``SILENT`` cycle, the call's ``rel_error``
    (``None`` otherwise; the caller decides what a clean call reports).
    Silent K-tiles share a term tensor as many as fit
    ``TERMS_CHUNK_BYTES``."""
    n = int(delays.shape[0])
    m_rows, k_dim = a.shape
    if k_dim == 0 or w.shape[1] == 0:
        return (torch.zeros((m_rows, w.shape[1]), dtype=torch.float64,
                            device=a.device),
                TileScan(np.zeros((n, n), np.int64), np.zeros((n, n),
                                                              np.int64),
                         np.zeros(0, bool)), None)
    a64 = a.to(torch.float64)
    blocks, late, lost = classify(a64, delays, razor, quant_bits, n, rule)
    pack = scan_pack(late, lost)
    tiled_matmul.calls += 1
    ready = None
    if a.is_cuda:
        # the counts travel while the clean product runs: one read, waited
        # on by an event, not by the whole stream
        host = torch.empty(pack.shape, dtype=torch.int64, pin_memory=True)
        host.copy_(pack, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        pack = host
    c = _clean_product(a64, w, n)
    if ready is not None:
        ready.synchronize()
    tiled_matmul.reads += 1
    scan = unpack_scan(pack.numpy(), n)
    if not scan.silent_tiles.any():
        return c, scan, None
    c, rel = _silent_product(a64, blocks, w, c, lost, scan.silent_tiles,
                             corrupt, n, rule)
    tiled_matmul.reads += 1
    return c, scan, float(rel)


#: calls of :func:`tiled_matmul` in this process, and the reads of their
#: results by the host (one per call, a second where a tile was silent)
tiled_matmul.calls = 0
tiled_matmul.reads = 0


def partition_sums(cells: np.ndarray, part_grid: np.ndarray,
                   n_partitions: int) -> np.ndarray:
    """(P,) int64 sums of an (n, n) per-cell count over each partition."""
    return np.bincount(part_grid.reshape(-1), weights=cells.reshape(-1),
                       minlength=n_partitions).astype(np.int64)


def emulated_macs(m_rows: int, k_dim: int, n_dim: int,
                  part_grid: np.ndarray, n_partitions: int) -> np.ndarray:
    """(P,) MACs the emulated loop executes on each partition: every
    tile's ``part[:kb, :nb]`` cells, ``m_rows`` times."""
    n = part_grid.shape[0]
    rows = k_dim // n + (np.arange(n) < k_dim % n)
    cols = n_dim // n + (np.arange(n) < n_dim % n)
    return m_rows * partition_sums(np.outer(rows, cols), part_grid,
                                   n_partitions)


def emulated_cycles(m_rows: int, k_dim: int, n_dim: int, n: int) -> int:
    """Sum over the loop's tiles of ``m + kb + nb - 1``."""
    kt, nt = -(-k_dim // n), -(-n_dim // n)
    return kt * nt * (m_rows - 1) + nt * k_dim + kt * n_dim

