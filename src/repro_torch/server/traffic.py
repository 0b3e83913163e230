"""Seeded traffic-trace workload generator for the serving frontend.

Datacenter serving workloads are bursty and heavy-tailed, not the uniform
request lists the engine tests use.  This module generates *replayable*
traces with the three canonical properties:

- **Poisson arrivals** — exponential inter-arrival gaps at ``rate_rps``,
  optionally modulated by a **diurnal burst envelope**
  (``rate(t) = rate_rps * (1 + amplitude * sin(2*pi*t / period))``,
  realized by Lewis thinning so the process stays an exact
  inhomogeneous Poisson process under one seed).
- **Heavy-tailed lengths** — prompt and generation lengths drawn from
  clipped lognormals, so a few large requests dominate token demand.
- **QoS mix** — each request lands in a ``Priority`` tier with a
  per-tier TTFT SLO (``deadline_s``), the knobs the priority scheduler
  and load shedder act on.

Everything is deterministic under ``TrafficConfig.seed``; traces round-trip
through NDJSON files (``save_trace``/``load_trace``) so a measured envelope
can be replayed bit-for-bit across backends, scheduler policies and
devices.

CLI (writes a trace file for ``repro_torch.launch.serve --trace``):

    PYTHONPATH=src python -m repro_torch.server --out trace.ndjson \
        --rate 8 --duration 5 --seed 0

Counterpart of ``repro.server.traffic``: the same draws from the same
``numpy`` generator, so one seed gives the same trace bytes in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import IO, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..serve import Priority, Request


@dataclasses.dataclass
class TrafficConfig:
    """Knobs for one synthetic traffic trace (all draws seeded)."""
    rate_rps: float = 4.0            # mean arrival rate (requests/second)
    duration_s: float = 10.0         # trace horizon
    seed: int = 0
    # clipped-lognormal length distributions (ln-space mean / sigma)
    prompt_len_log_mean: float = 1.1
    prompt_len_log_sigma: float = 0.6
    gen_len_log_mean: float = 1.4
    gen_len_log_sigma: float = 0.6
    max_prompt_len: int = 24
    max_gen_len: int = 24
    # diurnal burst envelope: 0 disables; 0.8 swings the rate +-80%
    diurnal_amplitude: float = 0.0
    diurnal_period_s: float = 60.0
    # QoS mix: P(LOW), P(NORMAL), P(HIGH) and per-tier TTFT SLO seconds
    # (None = no deadline for that tier), indexed by int(Priority)
    priority_weights: Tuple[float, float, float] = (0.25, 0.5, 0.25)
    deadline_s: Tuple[Optional[float], Optional[float], Optional[float]] = \
        (None, 2.0, 0.75)
    vocab_size: int = 256            # prompt tokens drawn from [3, vocab)

    def __post_init__(self):
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {self.duration_s}")
        if not 0 <= self.diurnal_amplitude <= 1:
            raise ValueError("diurnal_amplitude must be in [0, 1], got "
                             f"{self.diurnal_amplitude}")
        if len(self.priority_weights) != 3 or \
                not math.isclose(sum(self.priority_weights), 1.0,
                                 rel_tol=1e-6):
            raise ValueError("priority_weights must be 3 probabilities "
                             f"summing to 1, got {self.priority_weights}")

    def mean_tokens_per_request(self) -> float:
        """Expected generated tokens per request (un-clipped lognormal mean;
        close enough for capacity planning)."""
        return math.exp(self.gen_len_log_mean
                        + 0.5 * self.gen_len_log_sigma ** 2)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TraceEvent:
    """One request arrival in a traffic trace."""
    t_s: float                       # arrival time from trace start
    uid: int
    prompt: List[int]
    max_new_tokens: int
    priority: Priority = Priority.NORMAL
    deadline_s: Optional[float] = None

    def to_request(self) -> Request:
        return Request(uid=self.uid, prompt=list(self.prompt),
                       max_new_tokens=self.max_new_tokens,
                       priority=self.priority, deadline_s=self.deadline_s)

    def to_dict(self) -> dict:
        return {"t_s": self.t_s, "uid": self.uid, "prompt": self.prompt,
                "max_new_tokens": self.max_new_tokens,
                "priority": self.priority.name, "deadline_s": self.deadline_s}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEvent":
        return cls(t_s=float(d["t_s"]), uid=int(d["uid"]),
                   prompt=[int(t) for t in d["prompt"]],
                   max_new_tokens=int(d["max_new_tokens"]),
                   priority=Priority[d.get("priority", "NORMAL")],
                   deadline_s=(None if d.get("deadline_s") is None
                               else float(d["deadline_s"])))


class TrafficGenerator:
    """Deterministic trace generation from a ``TrafficConfig``."""

    def __init__(self, cfg: TrafficConfig):
        self.cfg = cfg

    def _length(self, rng: np.random.Generator, log_mean: float,
                log_sigma: float, max_len: int) -> int:
        raw = rng.lognormal(mean=log_mean, sigma=log_sigma)
        return int(np.clip(round(raw), 1, max_len))

    def rate_at(self, t_s: float) -> float:
        """Instantaneous arrival rate under the diurnal envelope."""
        c = self.cfg
        return c.rate_rps * (1.0 + c.diurnal_amplitude
                             * math.sin(2.0 * math.pi * t_s
                                        / c.diurnal_period_s))

    def events(self) -> List[TraceEvent]:
        c = self.cfg
        rng = np.random.default_rng(c.seed)
        # Lewis thinning: draw a homogeneous process at the envelope's peak
        # rate, keep each arrival with probability rate(t) / rate_max
        rate_max = c.rate_rps * (1.0 + c.diurnal_amplitude)
        out: List[TraceEvent] = []
        t, uid = 0.0, 0
        while True:
            t += float(rng.exponential(1.0 / rate_max))
            if t >= c.duration_s:
                break
            if float(rng.random()) * rate_max > self.rate_at(t):
                continue
            plen = self._length(rng, c.prompt_len_log_mean,
                                c.prompt_len_log_sigma, c.max_prompt_len)
            glen = self._length(rng, c.gen_len_log_mean,
                                c.gen_len_log_sigma, c.max_gen_len)
            prio = Priority(int(rng.choice(3, p=c.priority_weights)))
            prompt = rng.integers(3, c.vocab_size, plen).tolist()
            out.append(TraceEvent(t_s=t, uid=uid, prompt=prompt,
                                  max_new_tokens=glen, priority=prio,
                                  deadline_s=c.deadline_s[int(prio)]))
            uid += 1
        return out


# ---- trace files (NDJSON: one event per line) -------------------------------

def save_trace(events: Sequence[TraceEvent],
               path_or_file: Union[str, IO[str]]) -> None:
    def _write(f: IO[str]) -> None:
        for ev in events:
            f.write(json.dumps(ev.to_dict()) + "\n")

    if isinstance(path_or_file, str):
        with open(path_or_file, "w") as f:
            _write(f)
    else:
        _write(path_or_file)


def load_trace(path_or_file: Union[str, IO[str]]) -> List[TraceEvent]:
    def _read(f: IO[str]) -> List[TraceEvent]:
        return [TraceEvent.from_dict(json.loads(line))
                for line in f if line.strip()]

    if isinstance(path_or_file, str):
        with open(path_or_file) as f:
            return _read(f)
    return _read(path_or_file)


def _main() -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="Generate a replayable serving traffic trace (NDJSON).")
    ap.add_argument("--out", required=True, help="trace file to write")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="mean arrival rate, requests/s")
    ap.add_argument("--duration", type=float, default=10.0,
                    help="trace horizon, seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--burst", type=float, default=0.0,
                    help="diurnal envelope amplitude in [0, 1]")
    ap.add_argument("--burst-period", type=float, default=60.0)
    ap.add_argument("--max-prompt-len", type=int, default=24)
    ap.add_argument("--max-gen-len", type=int, default=24)
    ap.add_argument("--vocab-size", type=int, default=256)
    args = ap.parse_args()
    cfg = TrafficConfig(rate_rps=args.rate, duration_s=args.duration,
                        seed=args.seed, diurnal_amplitude=args.burst,
                        diurnal_period_s=args.burst_period,
                        max_prompt_len=args.max_prompt_len,
                        max_gen_len=args.max_gen_len,
                        vocab_size=args.vocab_size)
    events = TrafficGenerator(cfg).events()
    save_trace(events, args.out)
    by_prio = {p.name: sum(1 for e in events if e.priority is p)
               for p in Priority}
    # lint: allow=RP008 CLI entry point owns stdout; one-shot summary line
    print(f"wrote {len(events)} events over {args.duration}s to {args.out} "
          f"(priorities {by_prio})")


if __name__ == "__main__":
    _main()
