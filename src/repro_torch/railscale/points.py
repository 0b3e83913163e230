"""Operating-point table: the autoscaler's menu of rail voltage vectors.

The closed loop needs a discrete ladder of operating points to move along:
level 0 is the nominal rails (today's static behavior, safest, most
expensive) and the deepest level is the calibrated near-threshold rails
from ``runtime_calibration`` (Algorithm 2) plus the session's guard
margin — the paper's green-computing target.  Intermediate levels
interpolate per partition, so low-slack partitions keep proportionally
more margin all the way down, exactly as the sweep()'s Pareto points do.

:meth:`OperatingPointTable.characterize` distills the table from a
:class:`~repro_torch.flow.report.FlowReport`: each level is probed on a seeded
:class:`~repro_torch.hwloop.device.EmulatedAccelerator` (same emulator the
serving backend runs on) to attach *measured* energy/token, flag rate,
replay rate, and a throughput proxy to the predicted voltages — the
reduced-voltage guardband characterization of Salami et al. (PAPERS.md),
in miniature.  Tables serialize to JSON (``flow`` CLI ``--points-out``)
so the serving policy can load them without rerunning the CAD flow.

The port's counterpart of ``repro.railscale.points``.  ``characterize``
takes ``device=`` for the probe emulator (``None``: the GPU, where the probes
run the tiled form of :mod:`repro_torch.hwloop.tiled`; ``"cpu"``: the
reference's tile loop).  Both give the same counts, flags and ledger, so the
ladder, and its JSON, come out the same from either device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .._device import DeviceLike

SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One rung of the rail ladder, with its probed characteristics."""

    level: int                       # 0 = nominal (safest), higher = deeper undervolt
    rails_v: List[float]             # (P,) per-partition rail voltage
    energy_per_token_j: float        # probed on the emulator at these rails
    flag_rate: float                 # probe steps with >=1 DETECTED flag / steps
    replay_rate: float               # DETECTED replays per executed MAC
    throughput_scale: float          # probe throughput relative to level 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "level": self.level,
            "rails_v": [float(v) for v in self.rails_v],
            "energy_per_token_j": float(self.energy_per_token_j),
            "flag_rate": float(self.flag_rate),
            "replay_rate": float(self.replay_rate),
            "throughput_scale": float(self.throughput_scale),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OperatingPoint":
        return cls(level=int(d["level"]),
                   rails_v=[float(v) for v in d["rails_v"]],
                   energy_per_token_j=float(d["energy_per_token_j"]),
                   flag_rate=float(d["flag_rate"]),
                   replay_rate=float(d["replay_rate"]),
                   throughput_scale=float(d["throughput_scale"]))


class OperatingPointTable:
    """Ordered ladder of operating points for one (tech, algo, array_n).

    ``points[0]`` is nominal rails; each successive level undervolts
    further toward the calibrated floor.  ``meta`` carries the flow
    coordinates the table was characterized at, so a multi-table file
    (one per sweep config) can be filtered on load.
    """

    def __init__(self, points: Sequence[OperatingPoint],
                 meta: Optional[Dict[str, Any]] = None):
        pts = sorted(points, key=lambda p: p.level)
        if not pts:
            raise ValueError("operating-point table needs at least one point")
        if [p.level for p in pts] != list(range(len(pts))):
            raise ValueError("operating-point levels must be 0..n-1 with no "
                             f"gaps, got {[p.level for p in pts]}")
        widths = {len(p.rails_v) for p in pts}
        if len(widths) != 1:
            raise ValueError(f"inconsistent partition counts across levels: "
                             f"{sorted(widths)}")
        means = [float(np.mean(p.rails_v)) for p in pts]
        if any(b > a + 1e-12 for a, b in zip(means, means[1:])):
            raise ValueError("mean rail voltage must be non-increasing with "
                             "level (level 0 is nominal, deeper = undervolt)")
        self.points: List[OperatingPoint] = list(pts)
        self.meta: Dict[str, Any] = dict(meta or {})

    # -- basic access ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.points)

    def __getitem__(self, level: int) -> OperatingPoint:
        return self.points[level]

    @property
    def n_partitions(self) -> int:
        return len(self.points[0].rails_v)

    def rails(self, level: int) -> np.ndarray:
        return np.asarray(self.points[level].rails_v, dtype=np.float64)

    def floor_v(self) -> np.ndarray:
        """(P,) per-partition lowest voltage anywhere in the table."""
        return np.min([p.rails_v for p in self.points], axis=0)

    def ceil_v(self) -> np.ndarray:
        """(P,) per-partition highest voltage anywhere in the table."""
        return np.max([p.rails_v for p in self.points], axis=0)

    def nearest_level(self, rails: Sequence[float]) -> int:
        """The level whose rail vector is closest (L2) to ``rails`` —
        used to re-anchor the policy after a watchdog heal rewrites the
        device rails underneath it."""
        rails = np.asarray(rails, dtype=np.float64)
        dists = [float(np.linalg.norm(rails - self.rails(lv)))
                 for lv in range(len(self))]
        return int(np.argmin(dists))

    # -- characterization from the CAD flow -----------------------------------

    @classmethod
    def characterize(cls, report, cfg, *, n_levels: int = 4,
                     probe_steps: int = 6, probe_rows: int = 16,
                     rail_margin: float = 0.02,
                     seed: int = 0,
                     device: DeviceLike = None) -> "OperatingPointTable":
        """Distill the ladder from one flow operating point.

        Levels interpolate per partition from nominal rails (level 0)
        down to the report's calibrated ``runtime_v`` plus
        ``rail_margin`` — the same guard band ``HwLoopSession`` applies,
        so the deepest level matches what a watchdog heal would restore.
        Each level runs ``probe_steps`` seeded probe matmuls on a fresh
        emulator to measure energy/token, flag rate, replay rate, and
        relative throughput.  Deterministic in (report, cfg, seed), and
        the same on every ``device`` (``None``: the GPU).
        """
        from ..hwloop.device import EmulatedAccelerator

        if n_levels < 1:
            raise ValueError(f"n_levels must be >= 1, got {n_levels}")
        if getattr(report, "runtime_v", None) is None:
            raise ValueError("report has no calibrated rails (runtime_v); "
                             "run the flow with calibrate=True to "
                             "characterize an operating-point ladder")
        node = cfg.node
        floor = np.asarray(report.runtime_v, dtype=np.float64) + rail_margin
        ceil = np.maximum(np.full_like(floor, float(node.v_nom)), floor)
        points: List[OperatingPoint] = []
        base_cycles: Optional[int] = None
        for level in range(n_levels):
            frac = level / max(n_levels - 1, 1)
            rails = (1.0 - frac) * ceil + frac * floor
            accel = EmulatedAccelerator.from_flow(report, cfg, rails=rails,
                                                  seed=seed, device=device)
            rng = np.random.default_rng(seed * 1_000_003 + level * 7919 + 11)
            n = accel.timing.n
            flagged_steps = 0
            for _ in range(probe_steps):
                a = rng.normal(size=(probe_rows, n))
                w = rng.normal(size=(n, n))
                _, tel = accel.matmul(a, w)
                if np.asarray(tel.partition_flags).any():
                    flagged_steps += 1
            accel.ledger.add_tokens(probe_steps)
            cycles = max(accel.ledger.cycles, 1)
            if base_cycles is None:
                base_cycles = cycles
            points.append(OperatingPoint(
                level=level,
                rails_v=[float(v) for v in rails],
                energy_per_token_j=float(accel.ledger.energy_per_token_j
                                         or 0.0),
                flag_rate=flagged_steps / max(probe_steps, 1),
                replay_rate=float(accel.ledger.replay_rate),
                throughput_scale=base_cycles / cycles))
        meta = {
            "tech": cfg.tech,
            "algo": cfg.algo,
            "array_n": int(cfg.array_n),
            "seed": int(seed),
            "rail_margin_v": float(rail_margin),
            "probe_steps": int(probe_steps),
            "probe_rows": int(probe_rows),
            "runtime_v": [float(v) for v in np.asarray(report.runtime_v)],
            "v_nom": float(node.v_nom),
            "v_th": float(node.v_th),
        }
        return cls(points, meta=meta)

    # -- serialization --------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"meta": dict(self.meta),
                "points": [p.to_dict() for p in self.points]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "OperatingPointTable":
        return cls([OperatingPoint.from_dict(p) for p in d["points"]],
                   meta=d.get("meta"))

    def save(self, path: str) -> None:
        save_tables(path, [self])

    @classmethod
    def load(cls, path: str, **selectors: Any) -> "OperatingPointTable":
        """Load one table from a ``--points-out`` file.  ``selectors``
        filter on ``meta`` keys (e.g. ``tech="vtr-22nm"``, ``algo=
        "dbscan"``, ``array_n=16``); exactly one table must match."""
        tables = load_tables(path)
        matches = [t for t in tables
                   if all(t.meta.get(k) == v for k, v in selectors.items())]
        if not matches:
            available = [{k: t.meta.get(k)
                          for k in ("tech", "algo", "array_n")}
                         for t in tables]
            raise KeyError(f"no operating-point table matches {selectors}; "
                           f"available: {available}")
        if len(matches) > 1:
            raise KeyError(f"{len(matches)} tables match {selectors}; "
                           "narrow with tech=/algo=/array_n=")
        return matches[0]


def save_tables(path: str, tables: Sequence[OperatingPointTable]) -> None:
    """Write one or more characterized tables as a versioned JSON file —
    the ``flow`` CLI's ``--points-out`` format (one table per sweep
    config)."""
    payload = {"version": SCHEMA_VERSION,
               "tables": [t.to_dict() for t in tables]}
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def load_tables(path: str) -> List[OperatingPointTable]:
    with open(path) as fh:
        payload = json.load(fh)
    version = payload.get("version")
    if version != SCHEMA_VERSION:
        raise ValueError(f"unsupported operating-point file version "
                         f"{version!r} (expected {SCHEMA_VERSION})")
    return [OperatingPointTable.from_dict(d) for d in payload["tables"]]
