"""Behavioural Razor flip-flop model (paper Sec. II-E, Fig. 6; Ernst et al. [5]).

A main register R samples at the rising edge of CLK (period T); a shadow
register S samples the same data on DCLK, lagging by T_del.  Data arriving

  * before T              -> both agree: no error;
  * in (T, T + T_del]     -> R caught stale data, S the fresh value: the error
                             flag F fires and S's value *corrects* R (one-cycle
                             replay penalty);
  * after T + T_del       -> both stale: a *silent* failure (the crash region
                             of Fig. 7 — undetectable, accuracy collapses).

The paper notes input-bit fluctuation raises NTC failure probability; we model
the effective arrival time as the nominal path delay scaled by a
switching-activity term computed from the data actually flowing through the
MAC.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

OK = 0
DETECTED = 1       # Razor flag fires; value is corrected, one replay cycle
SILENT = 2         # arrival beyond the shadow window: undetected corruption


@dataclasses.dataclass(frozen=True)
class RazorConfig:
    clock_ns: float = 10.0
    t_del_ns: float = 2.5          # shadow-clock lag (detection window)
    beta: float = 0.25             # delay sensitivity to switching activity


def classify_arrival(arrival_ns: np.ndarray, cfg: RazorConfig) -> np.ndarray:
    """Elementwise OK / DETECTED / SILENT for arrival times."""
    a = np.asarray(arrival_ns, dtype=np.float64)
    out = np.zeros(a.shape, dtype=np.int64)
    out[a > cfg.clock_ns] = DETECTED
    out[a > cfg.clock_ns + cfg.t_del_ns] = SILENT
    return out


def switching_activity(prev_bits: np.ndarray, cur_bits: np.ndarray,
                       n_bits: int = 16) -> np.ndarray:
    """Fraction of input bits that toggled between consecutive operands.

    Operates on integer operands; the paper's observation is that high
    fluctuation of input bits raises timing-failure probability at NTC.
    """
    prev = np.asarray(prev_bits).astype(np.int64)
    cur = np.asarray(cur_bits).astype(np.int64)
    mask = (1 << n_bits) - 1
    x = (prev ^ cur) & mask
    # popcount via per-byte lookup
    cnt = np.zeros(x.shape, dtype=np.int64)
    for shift in range(0, n_bits, 8):
        cnt += POPCOUNT8[(x >> shift) & 0xFF]
    return cnt / float(n_bits)


POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def streamed_activity(a: np.ndarray, n_bits: int = 16) -> np.ndarray:
    """(M, K) per-cycle toggle fraction of streamed real-valued activations.

    Full-scale quantization to ``n_bits`` signed ints, then consecutive-row
    :func:`switching_activity`.  The single definition shared by
    ``SystolicSim`` and the hwloop emulator — their data-dependent delay
    terms must stay bit-identical.
    """
    a = np.asarray(a)
    scale = np.max(np.abs(a)) or 1.0
    q = np.clip((a / scale) * (2 ** (n_bits - 1) - 1),
                -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1).astype(np.int64)
    prev = np.vstack([q[:1], q[:-1]])
    return switching_activity(prev, q, n_bits)


def effective_arrival(nominal_delay_ns: np.ndarray, activity: np.ndarray,
                      cfg: RazorConfig) -> np.ndarray:
    """Arrival time after data-dependent slowdown: d * (1 + beta * activity)."""
    return np.asarray(nominal_delay_ns) * (1.0 + cfg.beta * np.asarray(activity))


@dataclasses.dataclass
class RazorMac:
    """A MAC wrapped with a Razor FF: produces (value, status) per cycle.

    ``delay_ns`` is the MAC's worst-path delay at its partition voltage (from
    ``TimingModel.delays_at``).  On DETECTED the corrected (true) value is
    returned and the replay counter increments; on SILENT the *stale* previous
    register value leaks through — exactly the paper's failure semantics.
    """

    delay_ns: float
    cfg: RazorConfig = dataclasses.field(default_factory=RazorConfig)
    _reg: float = 0.0
    replays: int = 0
    silent_failures: int = 0

    def cycle(self, a: float, b: float, acc: float, activity: float) -> Tuple[float, int]:
        true_val = acc + a * b
        arrival = float(effective_arrival(np.float64(self.delay_ns), activity, self.cfg))
        status = int(classify_arrival(np.float64(arrival), self.cfg))
        if status == OK:
            self._reg = true_val
        elif status == DETECTED:
            self.replays += 1            # shadow FF corrects R next cycle
            self._reg = true_val
        else:
            self.silent_failures += 1    # R keeps stale data; corruption propagates
        return self._reg, status
