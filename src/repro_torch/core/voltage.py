"""Static and runtime voltage-scaling schemes (paper Sec. III, Algorithms 1-2).

Algorithm 1 (static): split the critical range [V_crash, V_min] into n bands,
partition i gets the band midpoint (ascending).  The paper's n=4 Artix-7
example [0.95, 1.00] yields 0.95625/0.96875/0.98125/0.99375 — printed in the
paper (rounded) as 0.96/0.97/0.98/0.99.

Algorithm 2 (runtime): per trial run, a partition whose Razor flag fired steps
its V_ccint up by V_s, otherwise down by V_s.  We add the convergence wrapper
("trial run" loop of Sec. III-B): anneal until every partition oscillates
around its lowest safe voltage, then lock the upper rail of the oscillation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np


def static_voltage_scaling(v_min: float, v_crash: float, n: int) -> np.ndarray:
    """Algorithm 1, verbatim. Returns ascending V_ccint_i (partition 0 lowest).

    V_s = (V_min - V_crash) / n ; V_ccint_i = midpoint of band i.
    """
    if n <= 0:
        raise ValueError("need at least one partition")
    if v_min <= v_crash:
        raise ValueError("V_min must exceed V_crash")
    v_s = (v_min - v_crash) / n
    v_l = v_crash
    out = []
    for _ in range(n):
        out.append((v_l + v_l + v_s) / 2.0)
        v_l += v_s
    return np.asarray(out)


def assign_partition_voltages(cluster_mean_slack: Sequence[float],
                              voltages_ascending: np.ndarray) -> np.ndarray:
    """Map clusters to voltages: higher min-slack -> lower V_ccint (Sec. I).

    ``cluster_mean_slack[c]`` is the representative (mean or min) slack of
    cluster ``c``; returns ``v[c]`` per cluster.
    """
    slack = np.asarray(cluster_mean_slack, dtype=np.float64)
    if len(slack) != len(voltages_ascending):
        raise ValueError("one voltage per cluster required")
    order = np.argsort(-slack)           # highest slack first
    v = np.empty_like(slack)
    v[order] = np.sort(np.asarray(voltages_ascending))
    return v


class CalibrationResult(np.ndarray):
    """Calibrated per-partition voltages with an explicit convergence flag.

    Behaves exactly like the ``(P,)`` float array of voltages (it *is* one),
    plus ``converged``: a ``(P,)`` bool array that is False for partitions
    that never produced a clean trial run within ``max_trials`` — those rails
    are pinned at ``v_ceil`` as a safe fallback, and callers should treat
    them as uncalibrated rather than trusting the substituted value.
    """

    converged: np.ndarray

    @classmethod
    def wrap(cls, v: np.ndarray, converged: np.ndarray) -> "CalibrationResult":
        out = np.asarray(v, dtype=np.float64).view(cls)
        out.converged = np.asarray(converged, dtype=bool)
        return out

    def __array_finalize__(self, obj) -> None:
        if obj is None:
            return
        self.converged = getattr(obj, "converged", None)

    @property
    def all_converged(self) -> bool:
        return bool(np.all(self.converged))


@dataclasses.dataclass
class RuntimeScheme:
    """Algorithm 2 with the trial-run convergence wrapper.

    ``flag_reduce`` — the paper's text is self-contradictory ("ANDed value of
    all error detection flags" vs "if any timing failure flag ... is high");
    Algorithm 2's semantics require OR, which is the default.  AND is kept as
    an option; tests show it fails to protect individual MACs.
    """

    v_s: float
    v_floor: float
    v_ceil: float
    flag_reduce: str = "or"              # "or" | "and"
    history: List[np.ndarray] = dataclasses.field(default_factory=list)

    def partition_flags(self, mac_flags: np.ndarray,
                        partition_of_mac: np.ndarray) -> np.ndarray:
        """Reduce per-MAC Razor flags to per-partition timing_fail flags.

        One ``np.bincount`` pass instead of a per-partition mask scan; empty
        partitions reduce to False under both semantics.  Flags are
        binarized first so integer inputs (e.g. per-MAC detected *counts*)
        keep the original truthiness semantics of ``any()``/``all()``.
        """
        part = np.asarray(partition_of_mac)
        n_part = int(part.max()) + 1
        truthy = np.asarray(mac_flags).astype(bool)
        hits = np.bincount(part, weights=truthy.astype(np.float64),
                           minlength=n_part)
        if self.flag_reduce == "or":
            return hits > 0
        size = np.bincount(part, minlength=n_part)
        return (size > 0) & (hits == size)

    def step(self, v: np.ndarray, fail_flags: np.ndarray) -> np.ndarray:
        """One Algorithm-2 update: +V_s on failure else -V_s, clamped."""
        v = np.asarray(v, dtype=np.float64)
        nv = np.where(fail_flags, v + self.v_s, v - self.v_s)
        nv = np.clip(nv, self.v_floor, self.v_ceil)
        self.history.append(nv.copy())
        return nv

    def calibrate(self, v0: np.ndarray,
                  trial: Callable[[np.ndarray], np.ndarray],
                  max_trials: int = 64) -> CalibrationResult:
        """Run trial runs until each partition oscillates (paper's pre-run
        tuning).  ``trial(v) -> per-partition fail flags``.

        Locks each partition at the upper rail of its final oscillation, i.e.
        the lowest voltage that produced a clean run.  Returns a
        :class:`CalibrationResult` — an ndarray of voltages whose
        ``converged`` attribute is False for partitions that never saw a
        clean trial (their rail is pinned at ``v_ceil``, explicitly flagged
        instead of silently substituted).
        """
        v = np.asarray(v0, dtype=np.float64).copy()
        last_clean = np.full(len(v), np.nan)
        seen_fail = np.zeros(len(v), dtype=bool)
        for _ in range(max_trials):
            flags = trial(v)
            seen_fail |= flags
            last_clean = np.where(~flags & (np.isnan(last_clean) | (v < last_clean)),
                                  v, last_clean)
            # converged once every partition has a clean voltage and has either
            # bounced off a failing one or sits clean on the floor
            at_floor_clean = (~flags) & (v <= self.v_floor + 1e-12)
            if np.all((~np.isnan(last_clean)) & (seen_fail | at_floor_clean)):
                break
            v = self.step(v, flags)
        converged = ~np.isnan(last_clean)
        out = np.where(np.isnan(last_clean), self.v_ceil, last_clean)
        return CalibrationResult.wrap(out, converged)

    def calibrate_bisect(self, v0: np.ndarray,
                         trial: Callable[[np.ndarray], np.ndarray],
                         max_trials: int = 16,
                         tol: float = 1e-3) -> CalibrationResult:
        """Batched bisection alternative to the Algorithm-2 anneal.

        The whole rail vector converges in one loop: every trial evaluates all
        partitions at once, each partition halving its own [failing, clean]
        bracket.  ~log2(range/tol) trials instead of the anneal's walk — use
        it when only the converged rails matter, not the paper-faithful
        oscillation trajectory.  Partitions that fail even at ``v_ceil`` are
        reported unconverged and pinned there, like :meth:`calibrate`.
        ``v0`` only fixes the rail count (the bracket is [v_floor, v_ceil]).
        """
        p = len(np.asarray(v0, dtype=np.float64))
        if max_trials <= 0:                    # no trial budget: like anneal,
            return CalibrationResult.wrap(     # pin at ceil, unconverged
                np.full(p, self.v_ceil), np.zeros(p, dtype=bool))
        lo = np.full(p, self.v_floor)
        hi = np.full(p, self.v_ceil)
        converged = ~trial(hi.copy())          # clean at the ceiling?
        for _ in range(max(max_trials - 1, 0)):
            if float(np.max(hi - lo)) <= tol:
                break
            mid = 0.5 * (lo + hi)
            flags = trial(mid)
            lo = np.where(flags, mid, lo)
            hi = np.where(flags, hi, mid)
        out = np.where(converged, hi, self.v_ceil)
        return CalibrationResult.wrap(out, converged)


def runtime_voltage_scaling(v: np.ndarray, fail_flags: np.ndarray, v_s: float,
                            v_floor: float = 0.0, v_ceil: float = np.inf) -> np.ndarray:
    """Stateless single step of Algorithm 2 (verbatim form)."""
    scheme = RuntimeScheme(v_s=v_s, v_floor=v_floor, v_ceil=v_ceil)
    return scheme.step(np.asarray(v, dtype=np.float64), np.asarray(fail_flags, bool))
