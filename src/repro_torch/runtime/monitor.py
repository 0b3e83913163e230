"""Fault tolerance for 1000+-node runs: heartbeats, straggler detection and
elastic remapping.  The hosts are simulated; the *logic* (what production
agents would execute) is real and tested with injected failures.

Control flow at scale:
  * every host heartbeats each step; the monitor marks a host dead after
    ``timeout_steps`` silent steps;
  * per-step durations feed a robust z-score; persistent outliers are flagged
    as stragglers (candidates for preemptive replacement);
  * on failure, ``ElasticPlan`` recomputes the largest usable mesh from the
    survivors, remaps data shards, and the trainer restores the last
    checkpoint (the deterministic data pipeline replays exactly);
  * :class:`CalibrationWatchdog` extends the same pattern to the paper's
    voltage islands: persistent Razor fail flags on a partition in
    production trigger a re-run of the :mod:`repro_torch.flow`
    runtime-calibration stage (with cached upstream artifacts) to re-tune
    the rails.

The port's copy of ``repro.runtime.monitor``: numpy and the standard
library over the port's ``flow`` (imported lazily, which avoids the cycle
``flow`` -> ``hwloop`` -> ``runtime`` -> ``flow``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat_step: int = -1
    durations: List[float] = dataclasses.field(default_factory=list)
    alive: bool = True


@dataclasses.dataclass
class StragglerReport:
    host_id: int
    z_score: float
    median_s: float
    host_s: float


class HeartbeatMonitor:
    def __init__(self, num_hosts: int, timeout_steps: int = 3,
                 straggler_z: float = 3.0, straggler_patience: int = 3,
                 window: int = 16):
        self.hosts = {h: HostState(h) for h in range(num_hosts)}
        self.timeout_steps = timeout_steps
        self.straggler_z = straggler_z
        self.straggler_patience = straggler_patience
        self.window = window
        self._flag_counts: Dict[int, int] = {}

    def beat(self, host_id: int, step: int, duration_s: float) -> None:
        h = self.hosts[host_id]
        h.last_beat_step = step
        h.durations.append(duration_s)
        if len(h.durations) > self.window:
            h.durations.pop(0)

    def check_dead(self, step: int) -> List[int]:
        """Hosts that missed ``timeout_steps`` consecutive heartbeats."""
        dead = []
        for h in self.hosts.values():
            if h.alive and step - h.last_beat_step > self.timeout_steps:
                h.alive = False
                dead.append(h.host_id)
        return dead

    def stragglers(self) -> List[StragglerReport]:
        """Hosts whose recent step time is a persistent robust outlier."""
        live = [h for h in self.hosts.values() if h.alive and h.durations]
        if len(live) < 3:
            return []
        recents = {h.host_id: sum(h.durations[-4:]) / len(h.durations[-4:])
                   for h in live}
        vals = sorted(recents.values())
        med = vals[len(vals) // 2]
        mad = sorted(abs(v - med) for v in vals)[len(vals) // 2] or 1e-9
        out = []
        for hid, v in recents.items():
            z = 0.6745 * (v - med) / mad
            if z > self.straggler_z:
                self._flag_counts[hid] = self._flag_counts.get(hid, 0) + 1
                if self._flag_counts[hid] >= self.straggler_patience:
                    out.append(StragglerReport(hid, z, med, v))
            else:
                self._flag_counts[hid] = 0
        return out

    def alive_hosts(self) -> List[int]:
        return [h.host_id for h in self.hosts.values() if h.alive]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Result of an elastic remap: the new mesh shape and shard assignment."""

    data_parallel: int                  # new size of the data axis
    model_parallel: int                 # unchanged (TP groups must be whole)
    host_to_shard: Dict[int, int]
    dropped_hosts: Tuple[int, ...]

    @property
    def world(self) -> int:
        return self.data_parallel * self.model_parallel


def plan_elastic_remap(alive: Sequence[int], model_parallel: int,
                       hosts_per_dp_group: int = 1) -> ElasticPlan:
    """Largest data-parallel width that the surviving hosts can populate.

    TP groups are atomic (a dead host kills its whole model-parallel group);
    the data axis shrinks to the number of complete surviving groups.  At
    least one complete group must survive.
    """
    groups: Dict[int, List[int]] = {}
    for h in alive:
        groups.setdefault(h // hosts_per_dp_group, []).append(h)
    complete = [g for g, members in sorted(groups.items())
                if len(members) == hosts_per_dp_group]
    if not complete:
        raise RuntimeError("no complete model-parallel group survives")
    dp = len(complete)
    mapping = {}
    for shard, g in enumerate(complete):
        for h in sorted(groups[g]):
            mapping[h] = shard
    dropped = tuple(h for h in alive if h not in mapping)
    return ElasticPlan(data_parallel=dp, model_parallel=model_parallel,
                       host_to_shard=mapping, dropped_hosts=dropped)


# ---------------------------------------------------------------------------
# Voltage-island calibration watchdog (repro_torch.flow integration)
# ---------------------------------------------------------------------------


class CalibrationWatchdog:
    """Heartbeat-style guard for the flow's runtime voltage scheme.

    In production the calibrated rails from the
    ``runtime_calibration`` stage can drift out of date (temperature,
    ageing, workload shift).  This watchdog consumes per-partition Razor
    fail flags each serving step — the same signal Algorithm 2 uses — and,
    when a partition fails ``patience`` consecutive steps (or its initial
    calibration never converged), re-runs the calibration stage through
    :mod:`repro_torch.flow` with a bumped trial seed.  The shared artifact store
    means only calibration + downstream stages re-execute; the timing /
    clustering / floorplan prefix is reused from cache.
    """

    def __init__(self, config, patience: int = 3, store=None,
                 max_unconverged_retries: int = 3):
        from ..flow import ArtifactStore
        self.config = config
        self.patience = patience
        self.max_unconverged_retries = max_unconverged_retries
        self.store = store if store is not None else ArtifactStore()
        self.recalibrations = 0
        self._unconverged_retries = 0
        self.report = self._run(seed_bump=0)
        self._streak = np.zeros(self.report.n_partitions, dtype=np.int64)

    def _run(self, seed_bump: int):
        from ..flow import run
        cfg = self.config
        if seed_bump:
            # re-roll only the Razor trials: the timing/clustering prefix
            # stays cache-valid because ``seed`` itself is untouched
            cfg = cfg.replace(
                calibration_seed=cfg.resolved_calibration_seed() + seed_bump)
        return run(cfg, store=self.store)

    @property
    def runtime_v(self) -> np.ndarray:
        return np.asarray(self.report.runtime_v)

    def needs_recalibration(self) -> np.ndarray:
        """(P,) bool: partitions whose initial calibration never converged."""
        conv = self.report.calibration_converged
        if conv is None:
            return np.zeros(self.report.n_partitions, dtype=bool)
        return ~np.asarray(conv, dtype=bool)

    def observe(self, partition_fail_flags: Sequence[bool]):
        """Feed one serving step's per-partition Razor flags.

        Returns the fresh ``FlowReport`` when a recalibration was triggered
        (persistent failures or an unconverged initial calibration), else
        ``None`` — mirroring ``HeartbeatMonitor.check_dead``'s "act only on
        persistent signals" contract.
        """
        flags = np.asarray(partition_fail_flags, dtype=bool)
        if flags.shape != self._streak.shape:
            raise ValueError(
                f"expected {self._streak.shape[0]} partition flags, "
                f"got {flags.shape}")
        self._streak = np.where(flags, self._streak + 1, 0)
        persistent_fail = bool((self._streak >= self.patience).any())
        # an unconverged initial calibration warrants a bounded number of
        # re-rolls — not one per serving step, or a config that can never
        # converge would pay a full calibration every observe()
        retry_unconverged = (self.needs_recalibration().any()
                             and self._unconverged_retries
                             < self.max_unconverged_retries)
        if not (persistent_fail or retry_unconverged):
            return None
        if not persistent_fail:
            self._unconverged_retries += 1
        self.recalibrations += 1
        self.report = self._run(seed_bump=self.recalibrations)
        self._streak = np.zeros(self.report.n_partitions, dtype=np.int64)
        return self.report
