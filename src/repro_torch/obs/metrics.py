"""Dependency-free metrics registry: counters, gauges, fixed-bucket
histograms, with label support and deterministic renderers.

Design constraints (they shape everything below):

* **Never touch torch.** Every operation is plain-python float arithmetic
  under a small lock, so the serve frontend can render a scrape on the
  asyncio thread while the pump thread is inside a jitted step.
* **Injectable clock.** The registry carries the same clock the engine
  uses (``time.monotonic`` in production, :class:`~repro_torch.server.harness.
  VirtualClock` under the load harness), so latency histograms are
  replayable: two identical virtual-time runs produce *bit-identical*
  renders.
* **Deterministic renders.** No timestamps, no ids, no wall-clock leaks
  in the exposition output; metrics sort by name, children by label
  tuple, so ``render_prometheus()`` is a pure function of the recorded
  observations.

The exposition format follows the Prometheus text format (cumulative
``le`` buckets, ``+Inf``, ``_sum``/``_count`` series); ``render_json``
gives the same data as a plain dict for ``/v1/stats``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_LATENCY_BUCKETS",
]

# Latency buckets (seconds) sized for both virtual-time harness steps
# (tens of ms) and real TTFTs on the interpreter-speed emulated backend.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _fmt(v: float) -> str:
    """Prometheus sample value: integers without a trailing ``.0``."""
    if v != v:  # NaN
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(key: _LabelKey, extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = list(key) + ([extra] if extra else [])
    if not pairs:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, v.replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in pairs)
    return "{" + inner + "}"


class _Metric:
    """Shared plumbing: name/help/label validation and child lookup."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 lock: threading.RLock) -> None:
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._lock = lock

    def _key(self, labels: Dict[str, str]) -> _LabelKey:
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                "metric %r expects labels %r, got %r"
                % (self.name, self.labelnames, tuple(labels)))
        return tuple((k, str(labels[k])) for k in self.labelnames)


class Counter(_Metric):
    """Monotonic counter. ``labels(**kv)`` returns a bound child."""

    kind = "counter"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 lock: threading.RLock) -> None:
        super().__init__(name, help, labelnames, lock)
        self._values: Dict[_LabelKey, float] = {}

    def labels(self, **labels: str) -> "_BoundCounter":
        return _BoundCounter(self, self._key(labels))

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counter %r cannot decrease" % self.name)
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set(self, value: float, **labels: str) -> None:
        """Absolute set — used by stat views that assign snapshots
        (``stats.shed = scheduler.n_shed``). Still monotonic in spirit:
        callers own the invariant."""
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def _samples(self) -> List[str]:
        return ["%s%s %s" % (self.name, _fmt_labels(k), _fmt(v))
                for k, v in sorted(self._values.items())]

    def _json(self):
        return [{"labels": dict(k), "value": v}
                for k, v in sorted(self._values.items())]


class _BoundCounter:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: Counter, key: _LabelKey) -> None:
        self._metric = metric
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counter %r cannot decrease" % self._metric.name)
        with self._metric._lock:
            vals = self._metric._values
            vals[self._key] = vals.get(self._key, 0.0) + amount

    def set(self, value: float) -> None:
        with self._metric._lock:
            self._metric._values[self._key] = float(value)

    def value(self) -> float:
        with self._metric._lock:
            return self._metric._values.get(self._key, 0.0)


class Gauge(_Metric):
    """Settable instantaneous value (queue depth, rail volts, rates)."""

    kind = "gauge"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 lock: threading.RLock) -> None:
        super().__init__(name, help, labelnames, lock)
        self._values: Dict[_LabelKey, float] = {}

    def labels(self, **labels: str) -> "_BoundGauge":
        return _BoundGauge(self, self._key(labels))

    def set(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    _samples = Counter._samples
    _json = Counter._json


class _BoundGauge:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: Gauge, key: _LabelKey) -> None:
        self._metric = metric
        self._key = key

    def set(self, value: float) -> None:
        with self._metric._lock:
            self._metric._values[self._key] = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._metric._lock:
            vals = self._metric._values
            vals[self._key] = vals.get(self._key, 0.0) + amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def value(self) -> float:
        with self._metric._lock:
            return self._metric._values.get(self._key, 0.0)


class Histogram(_Metric):
    """Fixed-bucket histogram with Prometheus ``le`` semantics: an
    observation lands in every bucket whose upper bound is >= the value
    (rendered cumulatively; stored per-bucket)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> None:
        super().__init__(name, help, labelnames, lock)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram %r needs at least one bucket" % name)
        if bounds[-1] != math.inf:
            bounds = bounds + (math.inf,)
        self.buckets = bounds
        # key -> (per-bucket counts, sum, count)
        self._values: Dict[_LabelKey, List] = {}

    def labels(self, **labels: str) -> "_BoundHistogram":
        return _BoundHistogram(self, self._key(labels))

    def _cell(self, key: _LabelKey):
        cell = self._values.get(key)
        if cell is None:
            cell = [[0] * len(self.buckets), 0.0, 0]
            self._values[key] = cell
        return cell

    def observe(self, value: float, **labels: str) -> None:
        key = self._key(labels)
        self._observe(key, value)

    def _observe(self, key: _LabelKey, value: float) -> None:
        v = float(value)
        with self._lock:
            counts, _, _ = cell = self._cell(key)
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    counts[i] += 1
                    break
            cell[1] += v
            cell[2] += 1

    def snapshot(self, **labels: str):
        """(cumulative bucket counts, sum, count) for tests/JSON."""
        key = self._key(labels)
        with self._lock:
            counts, total, n = self._cell(key)
            cum, acc = [], 0
            for c in counts:
                acc += c
                cum.append(acc)
            return list(zip(self.buckets, cum)), total, n

    def _samples(self) -> List[str]:
        out: List[str] = []
        with self._lock:
            for key, (counts, total, n) in sorted(self._values.items()):
                acc = 0
                for bound, c in zip(self.buckets, counts):
                    acc += c
                    le = "+Inf" if bound == math.inf else _fmt(bound)
                    out.append("%s_bucket%s %s" % (
                        self.name, _fmt_labels(key, ("le", le)), _fmt(acc)))
                out.append("%s_sum%s %s" % (self.name, _fmt_labels(key),
                                            _fmt(total)))
                out.append("%s_count%s %s" % (self.name, _fmt_labels(key),
                                              _fmt(n)))
        return out

    def _json(self):
        out = []
        with self._lock:
            for key, (counts, total, n) in sorted(self._values.items()):
                acc, cum = 0, {}
                for bound, c in zip(self.buckets, counts):
                    acc += c
                    le = "+Inf" if bound == math.inf else _fmt(bound)
                    cum[le] = acc
                out.append({"labels": dict(key), "buckets": cum,
                            "sum": total, "count": n})
        return out


class _BoundHistogram:
    __slots__ = ("_metric", "_key")

    def __init__(self, metric: Histogram, key: _LabelKey) -> None:
        self._metric = metric
        self._key = key

    def observe(self, value: float) -> None:
        self._metric._observe(self._key, value)


class MetricsRegistry:
    """Get-or-create registry of named metrics.

    ``counter``/``gauge``/``histogram`` return the existing metric when
    the name is already registered (kind/labelnames must match), so
    instrumentation sites never need to coordinate creation order.
    """

    def __init__(self, clock=time.monotonic) -> None:
        self.clock = clock
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, labels: Iterable[str],
             **kw) -> _Metric:
        labelnames = tuple(labels)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError("metric %r already registered as %s"
                                     % (name, m.kind))
                if m.labelnames != labelnames and labelnames:
                    raise ValueError(
                        "metric %r labelnames mismatch: %r vs %r"
                        % (name, m.labelnames, labelnames))
                return m
            m = cls(name, help, labelnames, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def render_prometheus(self) -> str:
        """Prometheus text exposition. Deterministic: sorted by metric
        name, children by label tuple, no timestamps."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    lines.append("# HELP %s %s" % (name, m.help))
                lines.append("# TYPE %s %s" % (name, m.kind))
                lines.extend(m._samples())
        return "\n".join(lines) + "\n" if lines else ""

    def render_json(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                out[name] = {"type": m.kind, "help": m.help,
                             "values": m._json()}
        return out
