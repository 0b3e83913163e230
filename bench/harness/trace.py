"""A traced slice of a run: ``torch.profiler`` over the host and the device,
reduced to the numbers the per-layer metrics read.

The slice starts and ends with the device idle (a synchronisation on each
side), so every kernel of the work issued inside it runs inside it.  From
the profiler's raw records (``kineto_results.events()``):

* ``kernels``: every device record (kernels, copies, memsets) as (name,
  start ns, end ns);
* ``busy_s``: the length of the union of their intervals;
* ``window_s``: the length of the annotation ``MARK`` that spans the
  slice, from its start to the synchronisation that ends it;
* ``device_ops``: the ten names with the most device time;
* ``idle_gaps``: the ten longest stretches between device records, each
  named by what the host was doing in its middle (the shortest host record
  that spans it, behind the outermost user annotation that does).

Tracing the host slows it, so a host-bound run's idle share is an upper
bound of an untraced run's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

TOP = 10
#: the user annotation that spans the traced work
MARK = "bench.traced_slice"


def short_name(name: str, width: int = 80) -> str:
    """A kernel's name without its template arguments' clutter."""
    name = name.replace("void ", "", 1) if name.startswith("void ") else name
    return name if len(name) <= width else name[:width]


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, int, int]]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]

    def seconds_of(self, pred: Callable[[str], bool]) -> float:
        return sum(e - s for n, s, e in self.kernels if pred(n)) / 1e9

    def count_of(self, pred: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.kernels if pred(n))

    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(events) -> Optional[TraceSummary]:
    """Reduce the profiler's raw records to those inside the ``MARK``
    annotation; None where it saw no device record there (not
    measured)."""
    from torch.autograd import DeviceType
    kernels, host = [], []
    mark = None
    for e in events:
        s = e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # an annotation's copy on the device's timeline is no work
            if not e.is_user_annotation() and e.name() != MARK:
                kernels.append((e.name(), s, end))
        elif e.device_type() == DeviceType.CPU:
            if e.name() == MARK:
                mark = (s, end)
            else:
                host.append((e.name(), s, end, e.is_user_annotation()))
    if mark is None:
        return None
    kernels = [k for k in kernels if mark[0] <= k[1] and k[2] <= mark[1]]
    window_s = (mark[1] - mark[0]) / 1e9
    if not kernels:
        return None
    merged = _union([(s, e) for _, s, e in kernels])
    busy = sum(e - s for s, e in merged) / 1e9
    by_name: Dict[str, float] = {}
    for n, s, e in kernels:
        key = short_name(n)
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(merged, merged[1:])), reverse=True)[:TOP]
    idle = []
    for length, g0, g1 in gaps:
        mid = (g0 + g1) // 2
        spans = [(e - s, n, user) for n, s, e, user in host if s <= mid <= e]
        inner = min((x for x in spans if not x[2]), default=None)
        outer = max((x for x in spans if x[2]), default=None)
        label = " / ".join(x[1] for x in (outer, inner) if x is not None)
        idle.append((label or "host", length / 1e9))
    return TraceSummary(window_s=window_s, busy_s=busy, kernels=kernels,
                        device_ops=ops, idle_gaps=idle)


class Slice:
    """``with Slice() as sl: ...`` traces the block; ``sl.summary`` is the
    reduction (None where the profiler saw no device record)."""

    def __init__(self) -> None:
        self.summary: Optional[TraceSummary] = None
        self._prof = None
        self._mark = None

    def __enter__(self) -> "Slice":
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        # a session's first device records can be lost: one small kernel
        # before the slice, outside the annotation
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.stop()
        if exc_type is None:
            self.summary = summarize(
                self._prof.profiler.kineto_results.events())
        self._prof = self._mark = None
