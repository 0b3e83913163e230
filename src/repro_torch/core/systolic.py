"""Functional weight-stationary systolic-array simulator with voltage-dependent
timing-fault injection (paper Secs. II-E, III-B, V-B).

Computes C = A @ W on an N x N MAC grid.  MAC (i, j) multiplies the streamed
activation A[m, i] with the resident weight W[i, j] and adds the partial sum
flowing down from row i-1.  Each MAC runs at the voltage of its floorplan
partition; its effective path arrival time (data-dependent, Sec. II-E) is
classified by the Razor model into OK / DETECTED (flag + corrected, one replay
cycle) / SILENT (stale register value leaks through and propagates — the crash
region).

The simulator returns both the (possibly corrupted) product and per-partition
Razor statistics; the runtime scheme (Algorithm 2) calibrates voltages against
``trial_run``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .partition import Floorplan
from .razor import (DETECTED, OK, SILENT, RazorConfig, classify_arrival,
                    effective_arrival, streamed_activity)
from .timing import TimingModel


@dataclasses.dataclass
class SimStats:
    detected: np.ndarray            # (n, n) replay counts per MAC
    silent: np.ndarray              # (n, n) silent-failure counts per MAC
    partition_fail: np.ndarray      # (P,) OR of detected flags per partition
    replay_cycles: int
    rel_error: float                # ||C_sim - C_true|| / ||C_true||

    def partition_detected(self, partition_of_mac: np.ndarray) -> np.ndarray:
        return _or_by_partition(self.detected.reshape(-1) > 0, partition_of_mac)


def _or_by_partition(mac_flags: np.ndarray, partition_of_mac: np.ndarray,
                     n_part: Optional[int] = None) -> np.ndarray:
    """(P,) any-of reduction of per-MAC booleans in one bincount pass."""
    n_part = int(partition_of_mac.max()) + 1 if n_part is None else n_part
    hits = np.bincount(partition_of_mac,
                       weights=np.asarray(mac_flags, dtype=np.float64),
                       minlength=n_part)
    return hits > 0


@dataclasses.dataclass
class SystolicSim:
    timing: TimingModel
    floorplan: Floorplan
    razor: RazorConfig = dataclasses.field(default_factory=RazorConfig)
    quant_bits: int = 16            # operand width for switching activity
    # "vectorized" (default): array-programming partial-sum propagation;
    # "reference": the original per-row / per-silent-element Python loops,
    # kept as the bit-exact oracle for tests and perf baselines
    impl: str = "vectorized"

    def __post_init__(self) -> None:
        if self.impl not in ("vectorized", "reference"):
            raise ValueError(f"unknown impl {self.impl!r}")
        # partition membership is fixed by the floorplan's structure (only the
        # rail voltages vary across trials), so resolve it once
        self._part = self.floorplan.partition_of_mac()
        self._n_part = int(self._part.max()) + 1

    def _arrival(self, v_map: np.ndarray, activity_m: np.ndarray) -> np.ndarray:
        """(M, n, n) effective arrival times: per-MAC nominal delay at its rail
        voltage, scaled by the per-cycle activation switching activity."""
        d = self.timing.delays_at(v_map)                      # (n, n)
        return effective_arrival(d[None, :, :],
                                 activity_m[:, :, None], self.razor)

    def _activity(self, a: np.ndarray) -> np.ndarray:
        """(M, n) per-cycle input toggle fraction on each row's activation bus."""
        return streamed_activity(a, self.quant_bits)

    def matmul(self, a: np.ndarray, w: np.ndarray,
               v_map: Optional[np.ndarray] = None) -> Tuple[np.ndarray, SimStats]:
        """Simulate C = a @ w with fault injection.

        a: (M, n) activations; w: (n, n) resident weights.
        """
        n = self.timing.n
        if a.shape[1] != n or w.shape != (n, n):
            raise ValueError(f"expected a:(M,{n}) w:({n},{n})")
        v_map = self.floorplan.voltage_map() if v_map is None else v_map
        act = self._activity(a)                               # (M, n)
        arrival = self._arrival(v_map, act)                   # (M, n, n)
        status = classify_arrival(arrival, self.razor)        # (M, n, n)

        c_true = a @ w
        if self.impl == "reference":
            c_sim, detected, silent = self._propagate_ref(a, w, status)
        else:
            c_sim, detected, silent = self._propagate_vec(a, w, status)

        det_flags = _or_by_partition(detected.reshape(-1) > 0, self._part,
                                     self._n_part)
        denom = float(np.linalg.norm(c_true)) or 1.0
        stats = SimStats(
            detected=detected, silent=silent, partition_fail=det_flags,
            replay_cycles=int(detected.sum()),
            rel_error=float(np.linalg.norm(c_sim - c_true)) / denom,
        )
        return c_sim, stats

    def _propagate_vec(self, a: np.ndarray, w: np.ndarray, status: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized partial-sum propagation, bit-identical to the reference.

        Silent failures re-emit the stale previous-cycle register value; the
        chained "silent rows inherit from the last clean row above" semantics
        of the reference's element loop is a per-column forward fill, done
        with ``np.maximum.accumulate`` over the last-clean row index.
        """
        n = self.timing.n
        m_rows = a.shape[0]
        detected = (status == DETECTED).sum(axis=0)           # (n, n)
        sil_all = status == SILENT                            # (M, n, n)
        silent = sil_all.sum(axis=0)
        terms = a[:, :, None] * w[None, :, :]                 # (M, n, n)
        if not sil_all.any():
            # cumsum matches the reference's sequential row accumulation order
            c_sim = terms.cumsum(axis=1)[:, -1, :]
            return c_sim, detected, silent
        row_ix = np.arange(m_rows)[:, None]
        out = np.zeros((m_rows, n), dtype=np.float64)
        for i in range(n):
            out = out + terms[:, i, :]
            sil = sil_all[:, i, :]                            # (M, n)
            if sil.any():
                last = np.maximum.accumulate(
                    np.where(sil, -1, row_ix), axis=0)        # last clean row
                filled = np.take_along_axis(out, np.maximum(last, 0), axis=0)
                out = np.where(sil, np.where(last >= 0, filled, 0.0), out)
        return out, detected, silent

    def _propagate_ref(self, a: np.ndarray, w: np.ndarray, status: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Original per-row / per-silent-element loop (the oracle)."""
        n = self.timing.n
        m_rows = a.shape[0]
        out_prev_rows = np.zeros((m_rows, n), dtype=np.float64)
        detected = np.zeros((n, n), dtype=np.int64)
        silent = np.zeros((n, n), dtype=np.int64)
        for i in range(n):
            term = a[:, i:i + 1] * w[i, :][None, :]           # (M, n)
            out = out_prev_rows + term
            st = status[:, i, :]                              # (M, n)
            detected[i] += (st == DETECTED).sum(axis=0)
            sil = st == SILENT
            silent[i] += sil.sum(axis=0)
            if sil.any():
                # stale register: MAC (i, j) re-emits its previous-cycle output
                for mi, j in zip(*np.nonzero(sil)):
                    out[mi, j] = out[mi - 1, j] if mi > 0 else 0.0
            out_prev_rows = out
        return out_prev_rows, detected, silent

    # -- runtime-scheme hook ---------------------------------------------------------

    def trial_run(self, partition_v: np.ndarray, seed: int = 0,
                  m_rows: int = 32, fail_on_silent: bool = True) -> np.ndarray:
        """One Algorithm-2 trial: random traffic at the given partition
        voltages; returns per-partition timing_fail flags.

        Razor can only *see* DETECTED errors; SILENT ones are invisible to the
        runtime scheme (crash region).  ``fail_on_silent=True`` folds them in
        only to let tests assert what an oracle would see.
        """
        rng = np.random.default_rng(seed)
        n = self.timing.n
        v_map = np.asarray(partition_v, dtype=np.float64)[self._part] \
            .reshape(n, n)
        a = rng.normal(size=(m_rows, n))
        w = rng.normal(size=(n, n))
        if self.impl == "reference":
            _, stats = self.matmul(a, w, v_map=v_map)
            flags = stats.partition_fail.copy()
            if fail_on_silent:
                flags |= _or_by_partition(stats.silent.reshape(-1) > 0,
                                          self._part, self._n_part)
            return flags
        # flags-only fast path: a trial consumes nothing but the Razor flags,
        # so skip the product/psum propagation entirely — classification of
        # the arrival tensor is all Algorithm 2 observes
        act = self._activity(a)
        status = classify_arrival(self._arrival(v_map, act), self.razor)
        fail = status == DETECTED
        if fail_on_silent:
            fail |= status == SILENT
        return _or_by_partition(fail.any(axis=0).reshape(-1), self._part,
                                self._n_part)


def fast_fault_matmul(a: np.ndarray, w: np.ndarray, fail_mask: np.ndarray,
                      mode: str = "drop") -> np.ndarray:
    """Vectorized large-array approximation: rank-1 terms of failing MACs are
    dropped ("drop") or halved ("attenuate").  Used for big sweeps where the
    cycle-level simulator is unnecessary."""
    n = w.shape[0]
    keep = (~fail_mask).astype(a.dtype) if mode == "drop" else (
        1.0 - 0.5 * fail_mask.astype(a.dtype))
    # C[m, j] = sum_i a[m, i] * w[i, j] * keep[i, j]
    return np.einsum("mi,ij->mj", a, w * keep)
