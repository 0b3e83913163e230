"""What the per-layer metrics' readers (``bench/metrics/<name>.py``) share.

Each reader takes the run's :class:`~bench.harness.common.Record` and
returns a number, or None where the run holds nothing for it to read (the
metric is then left out of the run's line).  A share of a roofline or of
the peak is never made up: without a device time there is no share.
"""

from __future__ import annotations

from typing import Optional

from .common import Record
from .yardstick import PEAK_BF16


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def span_mean_ms(rec: Record, kind: str, name: str) -> Optional[float]:
    """Mean length of the program's ``name`` spans in the window."""
    if rec.kind != kind:
        return None
    durs = [s["dur_s"] for s in rec.spans if s["name"] == name]
    return 1e3 * sum(durs) / len(durs) if durs else None


def window_value(rec: Record, kind: str, name: str) -> Optional[float]:
    """A number the driver took over the window (an end-to-end candidate
    that the cell reports as a per-layer metric)."""
    if rec.kind != kind:
        return None
    v = rec.e2e.get(name)
    return None if v is None or v != v else v


def counter_mean_ms(rec: Record, kind: str, total: str,
                    count: str) -> Optional[float]:
    """A counted histogram's mean in the window (its sum over its count)."""
    n = rec.counters.get(count, 0)
    if rec.kind != kind or not n:
        return None
    return 1e3 * rec.counters[total] / n


def launches_per_call(rec: Record, kind: str) -> Optional[float]:
    """Device kernels of the traced slice (copies and memsets left out)
    over the model calls the slice made."""
    if rec.kind != kind or rec.trace is None or not rec.calls_in_slice:
        return None
    return rec.trace.count_of(lambda n: not _is_copy(n)) \
        / len(rec.calls_in_slice)


def b1_roofline(rec: Record, kind: str) -> Optional[float]:
    """B1's bound over the slice's GEMMs over the device time of its
    ``systolic_mac`` kernels, in %."""
    if rec.kind != kind or rec.trace is None or not rec.calls_in_slice:
        return None
    device = rec.trace.seconds_of(lambda n: "systolic_mac" in n)
    if device <= 0:
        return None
    return 100.0 * rec.yard.b1_bound_s(rec.calls_in_slice) / device


def mfu(rec: Record, kind: str) -> Optional[float]:
    """The model's FLOPs of the window's work over the window's seconds at
    the bf16 peak, in %."""
    if rec.kind != kind or rec.window_s <= 0 or rec.flops_in_window <= 0:
        return None
    return 100.0 * rec.flops_in_window / (rec.window_s * PEAK_BF16)


def device_idle(rec: Record, kind: str) -> Optional[float]:
    """Share of the traced slice in which no device record ran, in %."""
    if rec.kind != kind or rec.trace is None:
        return None
    return 100.0 * rec.trace.idle_share()
