"""Cycle/energy ledger for the emulated voltage-scaled accelerator.

Accounts three components per partition, on top of the calibrated
:class:`repro_torch.core.power.PowerModel`:

* **dynamic** — every executed MAC costs ``E_mac(V_p)`` (the CVf² law fit to
  the paper's Table II, via :meth:`PowerModel.energy_per_mac_pj`);
* **replay**  — every DETECTED Razor flag re-executes its MAC one cycle
  later (Sec. II-E's one-cycle penalty), paying the same per-MAC energy
  again plus a cycle of latency;
* **leakage** — a rail-independent static floor, modelled as a fixed
  fraction of the array's nominal dynamic power integrated over the elapsed
  cycles (tool power reports mix in exactly such a component — see
  ``core/power.py``'s discussion of why reductions don't track a pure V²
  law).

The ledger is the accumulation point the serve engine, the ``hwloop`` flow
stage and the benchmarks all read: ``energy_per_token_j`` /
``energy_per_mac_j`` / ``replay_rate``.

The port's copy of ``repro.hwloop.energy``: numpy, on the host, and
bit-equal to it for the same sequence of records
(``tests/test_torch_hwloop.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np

from ..core.power import PowerModel


@dataclasses.dataclass
class EnergyLedger:
    power: PowerModel
    clock_ns: float
    array_n: int
    n_partitions: int
    leak_frac: float = 0.05          # static leakage as a fraction of nominal dynamic power

    macs_p: np.ndarray = dataclasses.field(init=False)
    replays_p: np.ndarray = dataclasses.field(init=False)
    cycles: int = dataclasses.field(default=0, init=False)
    tokens: int = dataclasses.field(default=0, init=False)
    dynamic_j: float = dataclasses.field(default=0.0, init=False)
    replay_j: float = dataclasses.field(default=0.0, init=False)

    def __post_init__(self) -> None:
        self.macs_p = np.zeros(self.n_partitions, dtype=np.int64)
        self.replays_p = np.zeros(self.n_partitions, dtype=np.int64)

    # -- accumulation --------------------------------------------------------

    def record(self, macs_p: np.ndarray, rails: np.ndarray,
               replays_p: np.ndarray, cycles: int) -> None:
        """Account one emulated matmul: per-partition MAC counts at the
        current rail voltages, per-partition replay counts, elapsed cycles
        (including the replay cycles)."""
        macs_p = np.asarray(macs_p, dtype=np.int64)
        replays_p = np.asarray(replays_p, dtype=np.int64)
        e_mac_j = np.array([self.power.energy_per_mac_pj(float(v))
                            for v in np.asarray(rails)]) * 1e-12
        self.dynamic_j += float((macs_p * e_mac_j).sum())
        self.replay_j += float((replays_p * e_mac_j).sum())
        self.macs_p += macs_p
        self.replays_p += replays_p
        self.cycles += int(cycles)

    def add_tokens(self, n: int) -> None:
        """Attribute the energy recorded so far to ``n`` more served tokens."""
        self.tokens += int(n)

    # -- derived -------------------------------------------------------------

    @property
    def leakage_j(self) -> float:
        """Static floor: ``leak_frac`` of nominal dynamic power over the
        elapsed emulated wall-clock."""
        p_leak_w = self.leak_frac * self.power.baseline_mw(self.array_n) * 1e-3
        return float(p_leak_w * self.cycles * self.clock_ns * 1e-9)

    @property
    def total_j(self) -> float:
        return self.dynamic_j + self.replay_j + self.leakage_j

    @property
    def total_macs(self) -> int:
        return int(self.macs_p.sum())

    @property
    def replay_cycles(self) -> int:
        return int(self.replays_p.sum())

    @property
    def replay_rate(self) -> float:
        """DETECTED replays per executed MAC (0 when nothing ran yet)."""
        return float(self.replay_cycles / max(self.total_macs, 1))

    @property
    def energy_per_mac_j(self) -> Optional[float]:
        if self.total_macs == 0:
            return None
        return float(self.total_j / self.total_macs)

    @property
    def energy_per_token_j(self) -> Optional[float]:
        if self.tokens == 0:
            return None
        return float(self.total_j / self.tokens)

    def summary(self) -> Dict[str, Any]:
        """Plain-JSON-serializable snapshot (the telemetry payload)."""
        return {
            "dynamic_j": self.dynamic_j,
            "replay_j": self.replay_j,
            "leakage_j": self.leakage_j,
            "total_j": self.total_j,
            "cycles": self.cycles,
            "tokens": self.tokens,
            "macs": self.total_macs,
            "macs_per_partition": self.macs_p.tolist(),
            "replays_per_partition": self.replays_p.tolist(),
            "replay_cycles": self.replay_cycles,
            "replay_rate": self.replay_rate,
            "energy_per_mac_j": self.energy_per_mac_j,
            "energy_per_token_j": self.energy_per_token_j,
        }
