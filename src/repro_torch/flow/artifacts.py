"""Immutable artifact store for the staged flow.

``Artifacts`` is the value that moves through the pipeline: a named,
append-only mapping of every intermediate the Fig. 9 flow produces (timing
model, slack vector, cluster labels, floorplan, voltages, constraint files,
power numbers).  Stages never mutate it — they return a new ``Artifacts``
with their outputs added — which is what makes stage outputs cacheable.

``ArtifactStore`` is the cross-run cache: it maps ``(stage name, config
fingerprint)`` keys to the artifact *delta* a stage produced, so a pipeline
re-run (or a :func:`repro_torch.flow.sweep`) can short-circuit any prefix of
stages whose relevant config fields did not change — e.g. the timing stage
runs once per ``(tech, array_n, clock_ns, seed)`` no matter how many
clustering algorithms are swept on top of it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple


class Artifacts(Mapping[str, Any]):
    """Read-only mapping of named flow intermediates with attribute access."""

    __slots__ = ("_data",)

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        object.__setattr__(self, "_data", dict(data or {}))

    # -- mapping protocol ----------------------------------------------------

    def __getitem__(self, name: str) -> Any:
        try:
            return self._data[name]
        except KeyError:
            raise KeyError(
                f"artifact {name!r} not produced yet; available: "
                f"{sorted(self._data)}") from None

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, name: object) -> bool:
        return name in self._data

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._data[name]
        except KeyError:
            raise AttributeError(
                f"artifact {name!r} not produced yet; available: "
                f"{sorted(self._data)}") from None

    def __repr__(self) -> str:
        return f"Artifacts({sorted(self._data)})"

    # -- functional updates --------------------------------------------------

    def with_(self, **named: Any) -> "Artifacts":
        """A new ``Artifacts`` with the given artifacts added/replaced."""
        data = dict(self._data)
        data.update(named)
        return Artifacts(data)

    def merged(self, other: Mapping[str, Any]) -> "Artifacts":
        return self.with_(**dict(other))

    def delta_from(self, base: "Artifacts") -> Dict[str, Any]:
        """Artifacts added or replaced relative to ``base`` (what a stage
        produced — the unit the :class:`ArtifactStore` caches)."""
        return {k: v for k, v in self._data.items()
                if k not in base._data or base._data[k] is not v}

    def asdict(self) -> Dict[str, Any]:
        return dict(self._data)


#: Cache key: (stage name, (upstream stage-implementation chain, fingerprint
#: of every config field that can affect the stage output, including all
#: upstream stages' fields)).  Hashable; built by Pipeline.run.
StoreKey = Tuple[str, Tuple[Tuple[str, ...], Tuple[Tuple[str, str], ...]]]


@dataclasses.dataclass
class StoreStats:
    hits: int = 0
    misses: int = 0

    def __str__(self) -> str:
        return f"hits={self.hits} misses={self.misses}"


class ArtifactStore:
    """Cross-run cache of per-stage artifact deltas (see module docstring)."""

    def __init__(self) -> None:
        self._cache: Dict[StoreKey, Dict[str, Any]] = {}
        self.stats: Dict[str, StoreStats] = {}

    def _stat(self, stage: str) -> StoreStats:
        return self.stats.setdefault(stage, StoreStats())

    def get(self, key: StoreKey) -> Optional[Dict[str, Any]]:
        delta = self._cache.get(key)
        if delta is None:
            self._stat(key[0]).misses += 1
            return None
        self._stat(key[0]).hits += 1
        return delta

    def put(self, key: StoreKey, delta: Dict[str, Any]) -> None:
        self._cache[key] = delta

    def __len__(self) -> int:
        return len(self._cache)

    def runs_of(self, stage: str) -> int:
        """How many distinct times ``stage`` actually executed (cache misses)."""
        return self._stat(stage).misses

    def summary(self) -> str:
        return ", ".join(f"{name}: {s}" for name, s in sorted(self.stats.items()))
