"""Collectives of a traced step: each one's per-rank result bytes, group
size and modeled wire traffic (ring schedules).  Counterpart of
``repro.roofline.hlo``.

The reference parses them out of XLA's post-SPMD HLO text.  The port has
no HLO: ``BuiltStep.lower()`` (``repro_torch.launch.steps``) records each
``_c10d_functional`` collective that ``torch.distributed.tensor`` issues
while the step is traced on a ``fake`` process group, and this module
holds the same ring models over those records.  The model is one-level: a
group's ring runs at one link rate, whatever nodes it spans.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: ``_c10d_functional`` op name -> the reference's HLO collective kind
FUNCTIONAL_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int            # per-rank result size
    group: int                   # participants
    line: str                    # where it came from (the op's name)

    @property
    def operand_bytes(self) -> int:
        """Per-rank operand (input) size."""
        if self.kind == "all-gather":
            return max(self.result_bytes // max(self.group, 1), 1)
        if self.kind == "reduce-scatter":
            return self.result_bytes * self.group
        return self.result_bytes

    @property
    def wire_bytes(self) -> int:
        """Ring-schedule traffic in/out of one rank."""
        g = max(self.group, 1)
        if self.kind == "all-reduce":
            return int(2 * self.result_bytes * (g - 1) / g)
        if self.kind == "all-gather":
            return int(self.result_bytes * (g - 1) / g)
        if self.kind == "reduce-scatter":
            return int(self.operand_bytes * (g - 1) / g)
        if self.kind == "all-to-all":
            return int(self.result_bytes * (g - 1) / g)
        return self.result_bytes     # collective-permute, broadcast: one hop


def functional_kind(op_name: str) -> Optional[str]:
    """The collective kind of a ``_c10d_functional`` (or legacy
    ``c10d_functional``) op name such as ``"all_reduce"``, else None."""
    return FUNCTIONAL_KINDS.get(op_name)


def summarize_collectives(ops: Iterable[CollectiveOp]
                          ) -> Dict[str, Dict[str, int]]:
    summary: Dict[str, Dict[str, int]] = {}
    for op in ops:
        s = summary.setdefault(op.kind, {"count": 0, "operand_bytes": 0,
                                         "wire_bytes": 0})
        s["count"] += 1
        s["operand_bytes"] += op.operand_bytes
        s["wire_bytes"] += op.wire_bytes
    return summary


def total_collective_bytes(ops: List[CollectiveOp]) -> Tuple[int, int]:
    """(sum of per-rank operand bytes, sum of modeled wire bytes)."""
    return (sum(o.operand_bytes for o in ops),
            sum(o.wire_bytes for o in ops))
