"""Flight recorder: a bounded ring buffer of the most recent trace
events, dumped as NDJSON for post-mortems.

The recorder is the black box of the serving stack — it rides along as
a tracer sink, keeps only the last ``capacity`` events (decode steps,
guard escalations, rail heals), and is dumped when something goes
wrong: a chaos scenario turns red, or a :class:`~repro_torch.resilience.
guard.GuardError` aborts a fail-closed serve. Recording is O(1)
(``deque`` append) and touches no torch, so it is safe from the decode
hot loop and from exception handlers.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Dict, IO, List, Union

from .serialize import to_plain

__all__ = ["FlightRecorder"]


class FlightRecorder:
    def __init__(self, capacity: int = 256) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self.total_recorded = 0  # lifetime count, survives wraparound

    def record(self, event: Dict) -> None:
        """Tracer-sink compatible: append one event, evicting the oldest
        once the ring is full."""
        self._ring.append(event)
        self.total_recorded += 1

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def dropped(self) -> int:
        return self.total_recorded - len(self._ring)

    def to_list(self) -> List[Dict]:
        """Chronological (oldest-first) plain-JSON copy of the ring."""
        return [to_plain(ev) for ev in self._ring]

    def dump_ndjson(self, dest: Union[str, os.PathLike, IO[str]]) -> int:
        """Write the ring as NDJSON (one event per line, oldest first).
        Returns the number of events written."""
        events = self.to_list()
        if hasattr(dest, "write"):
            for ev in events:
                dest.write(json.dumps(ev) + "\n")
        else:
            with open(dest, "w") as fh:
                for ev in events:
                    fh.write(json.dumps(ev) + "\n")
        return len(events)

    def clear(self) -> None:
        self._ring.clear()
