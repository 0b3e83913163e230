"""Synthetic-but-calibrated timing model of an N x N systolic MAC array.

Reproduces the *statistics* of the paper's synthesis timing reports (Sec. II,
Table I): per-path slack for every MAC output bit, with bottom rows (deeper
partial-sum accumulation) having the smallest minimum slack, and a per-bit
carry-chain gradient.  The Vivado/VTR timing engines are replaced by this
model (see DESIGN.md Sec. 2 "what did not transfer").

Calibration targets (16x16 array, 100 MHz clock, Artix-7-class logic):
  * worst paths: total delay 4.05-4.40 ns, logic 2.49-2.89 ns, net 1.47-1.57 ns
    => slack of worst paths ~ 5.3-5.8 ns   (paper Table I)
  * the row-band structure yields the multi-modal min-slack distribution that
    the paper's clustering figures (Figs. 11-14) show: ~4 natural groups.

Voltage -> delay uses the alpha-power law (near/sub-threshold behaviour):
    d(V) = d(Vnom) * ((Vnom - Vth) / (V - Vth)) ** alpha
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Technology nodes (paper Sec. V: Vivado Artix-7 28nm + VTR 22/45/130nm)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TechNode:
    """Electrical constants for one FPGA technology node."""

    name: str
    v_nom: float          # nominal core voltage (V)
    v_th: float           # threshold voltage (V) (paper Sec. V: 22nm 0.45, 45nm 0.5, 130nm 0.7)
    v_min: float          # top of the scaling range used by the paper
    v_crash: float        # voltage below which timing collapses (paper Fig. 7)
    alpha: float          # alpha-power-law exponent for delay(V)
    # power-law exponent P ~ (V/Vref)^k, least-squares fit to Table II (see power.py)
    power_k: float
    # baseline dynamic power (mW) of a 16x16 array at v_nom, 100MHz (Table II)
    p16_mw: float


#: Cross-instance cache of synthesized timing structure (see
#: ``TimingModel.__post_init__``); bounded, cleared wholesale when full.
_SYNTH_CACHE: Dict[tuple, tuple] = {}

TECH_NODES: Dict[str, TechNode] = {
    # Guard-band experiments use [0.95, 1.00] V exactly as the paper's Artix-7 run.
    "vivado-28nm": TechNode("vivado-28nm", v_nom=1.00, v_th=0.40, v_min=1.00,
                            v_crash=0.95, alpha=1.3, power_k=2.546, p16_mw=408.0),
    "vtr-22nm": TechNode("vtr-22nm", v_nom=1.00, v_th=0.45, v_min=1.20,
                         v_crash=0.50, alpha=1.3, power_k=0.713, p16_mw=269.0),
    "vtr-45nm": TechNode("vtr-45nm", v_nom=1.00, v_th=0.50, v_min=1.20,
                         v_crash=0.50, alpha=1.3, power_k=0.687, p16_mw=387.0),
    "vtr-130nm": TechNode("vtr-130nm", v_nom=1.30, v_th=0.70, v_min=1.30,
                          v_crash=0.70, alpha=1.3, power_k=0.280, p16_mw=1543.0),
}


def delay_scale(tech: TechNode, v: np.ndarray | float) -> np.ndarray | float:
    """Alpha-power-law delay multiplier relative to the nominal voltage.

    >= 1 for v < v_nom; diverges as v -> v_th (the crash region of Fig. 7).
    """
    v = np.asarray(v, dtype=np.float64)
    v_eff = np.maximum(v - tech.v_th, 1e-3)
    return ((tech.v_nom - tech.v_th) / v_eff) ** tech.alpha


# ---------------------------------------------------------------------------
# Timing report synthesis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TimingPath:
    """One row of the synthesis timing report (paper Table I)."""

    name: str
    slack_ns: float
    levels: int
    high_fanout: int
    path_from: str
    path_to: str
    total_delay_ns: float
    logic_delay_ns: float
    net_delay_ns: float
    requirement_ns: float
    src_clock: str = "clk"
    dst_clock: str = "clk"


@dataclasses.dataclass
class TimingModel:
    """Deterministic per-path delay model for an ``n x n`` systolic array.

    Structure (physical rationale, calibrated to Table I):
      * per-bit carry gradient: higher accumulator bits close later;
      * row bands: partial sums ripple down rows, and every ``n//4`` rows the
        accumulation word grows / the P&R engine inserts longer nets, giving a
        step increase in delay -> the multi-modal min-slack structure that the
        paper clusters into ~4 groups;
      * per-MAC jitter: placement/LUT-mapping noise.
    """

    n: int = 16
    clock_ns: float = 10.0          # 100 MHz, as in the paper
    n_bits: int = 17                # accumulator output register bits (Table I shows bits 11..16)
    tech: TechNode = TECH_NODES["vivado-28nm"]
    seed: int = 2021

    # Calibrated against Table I (16x16 @ 100 MHz): worst total 4.41 vs paper
    # 4.40 ns, worst slack 5.34 vs 5.34, worst logic 2.93 vs 2.89, worst net
    # 1.51 vs 1.57; DBSCAN/mean-shift recover the 4 row bands of Figs. 11-14.
    base_logic_ns: float = 1.30
    carry_ns: float = 0.60          # full-swing per-bit carry contribution
    row_band_ns: float = 0.30       # step per row band (the cluster separation)
    row_slope_ns: float = 0.004     # small within-band gradient
    base_net_ns: float = 1.35
    net_spread_ns: float = 0.10
    jitter_ns: float = 0.03
    uncertainty_ns: float = 0.25    # clock uncertainty subtracted from slack

    def __post_init__(self) -> None:
        # The synthesized structure depends only on geometry, seed and the
        # calibration constants — NOT on the tech node or clock (those only
        # scale delays later).  Cache it so a sweep's 4 tech nodes share one
        # synthesis, and repeated models (tests, benchmarks) are free.
        key = (self.n, self.n_bits, self.seed, self.base_logic_ns,
               self.carry_ns, self.row_band_ns, self.row_slope_ns,
               self.base_net_ns, self.net_spread_ns, self.jitter_ns)
        hit = _SYNTH_CACHE.get(key)
        if hit is None:
            hit = self._synthesize()
            if len(_SYNTH_CACHE) >= 32:
                _SYNTH_CACHE.clear()
            _SYNTH_CACHE[key] = hit
        self._logic, self._net, self._fanout, self._levels, self._mac_delay \
            = hit

    def _synthesize(self):
        rng = np.random.default_rng(self.seed)
        n, b = self.n, self.n_bits
        bits = np.arange(b, dtype=np.float64)
        rows = np.arange(n, dtype=np.float64)

        n_bands = 4
        band = np.minimum(rows * n_bands // max(n, 1), n_bands - 1)  # (n,)

        logic = (
            self.base_logic_ns
            + self.carry_ns * (bits[None, None, :] / max(b - 1, 1))
            + self.row_band_ns * band[:, None, None]
            + self.row_slope_ns * rows[:, None, None]
            + rng.normal(0.0, self.jitter_ns, size=(n, n, b))
        )
        net = (
            self.base_net_ns
            + self.net_spread_ns * rng.random(size=(n, n, b))
            + 0.02 * band[:, None, None]
        )
        logic = np.maximum(logic, 0.1)            # (n, n, bits)
        net = np.maximum(net, 0.05)
        fanout = rng.integers(4, 12, size=(n, n))
        levels = 7 + (bits[None, None, :] // 6).astype(np.int64) \
            + np.zeros((n, n, b), np.int64)
        mac_delay = (logic + net).max(axis=-1)
        for arr in (logic, net, fanout, levels, mac_delay):
            arr.flags.writeable = False           # cached arrays are shared
        return logic, net, fanout, levels, mac_delay

    # -- nominal-voltage quantities ------------------------------------------------

    @property
    def path_delays_ns(self) -> np.ndarray:
        """(n, n, bits) total path delay at nominal voltage."""
        return self._logic + self._net

    @property
    def mac_delay_ns(self) -> np.ndarray:
        """(n, n) worst-path delay per MAC (precomputed — it is the base of
        every per-trial voltage scaling)."""
        return self._mac_delay

    @property
    def min_slack_ns(self) -> np.ndarray:
        """(n, n) minimum slack per MAC — the clustering feature (Sec. II-D)."""
        return self.clock_ns - self.uncertainty_ns - self.mac_delay_ns

    def min_slack_flat(self) -> np.ndarray:
        """(n*n,) min slack in row-major MAC order."""
        return self.min_slack_ns.reshape(-1)

    # -- voltage-dependent quantities ----------------------------------------------

    def delays_at(self, v: float | np.ndarray) -> np.ndarray:
        """(n, n) worst-path delay per MAC at per-MAC voltage ``v``.

        ``v`` may be a scalar or an (n, n) per-MAC voltage map (built from the
        partition voltages).
        """
        scale = delay_scale(self.tech, v)
        return self.mac_delay_ns * np.asarray(scale)

    def fails_at(self, v: float | np.ndarray, margin_ns: float = 0.0) -> np.ndarray:
        """(n, n) bool: worst path misses the clock at voltage ``v``."""
        return self.delays_at(v) > (self.clock_ns - margin_ns)

    def min_safe_voltage(self, lo: float | None = None, hi: float | None = None,
                         tol: float = 1e-4) -> np.ndarray:
        """(n, n) smallest voltage at which each MAC still meets timing (bisect)."""
        lo_v = self.tech.v_th + 1e-2 if lo is None else lo
        hi_v = max(self.tech.v_nom, self.tech.v_min) if hi is None else hi
        lo_a = np.full((self.n, self.n), lo_v)
        hi_a = np.full((self.n, self.n), hi_v)
        for _ in range(64):
            mid = 0.5 * (lo_a + hi_a)
            bad = self.fails_at(mid)
            lo_a = np.where(bad, mid, lo_a)
            hi_a = np.where(bad, hi_a, mid)
            if float(np.max(hi_a - lo_a)) < tol:
                break
        return hi_a

    # -- report rendering ------------------------------------------------------------

    def report(self, worst: int = 100) -> List[TimingPath]:
        """The ``worst`` setup paths, formatted like the paper's Table I.

        All numeric columns (indices, slacks, rounded delays) are produced as
        whole arrays; only the final dataclass packing walks the rows.
        """
        d = self.path_delays_ns
        flat = d.reshape(-1)
        order = np.argsort(-flat)[:worst]
        n, b = self.n, self.n_bits
        i_s, j_s, bits = np.unravel_index(order, (n, n, b))
        totals = flat[order]
        slacks = self.clock_ns - self.uncertainty_ns - totals
        levels = self._levels[i_s, j_s, bits]
        fanout = self._fanout[i_s, j_s]
        logic = self._logic[i_s, j_s, bits]
        net = self._net[i_s, j_s, bits]
        return [TimingPath(
            name=f"Path {rank + 1}",
            slack_ns=round(float(slacks[rank]), 2),
            levels=int(levels[rank]),
            high_fanout=int(fanout[rank]),
            path_from=f"GEN_REG_I[{max(i - 1, 0)}].GEN_REG_J[{j}].uut/prev_activ_reg[1]/C",
            path_to=f"GEN_REG_I[{i}].GEN_REG_J[{j}].uut/sig_mac_out_reg[{bit}]/D",
            total_delay_ns=round(float(totals[rank]), 2),
            logic_delay_ns=round(float(logic[rank]), 2),
            net_delay_ns=round(float(net[rank]), 2),
            requirement_ns=self.clock_ns,
        ) for rank, (i, j, bit) in enumerate(zip(i_s.tolist(), j_s.tolist(),
                                                 bits.tolist()))]

    def implementation_report(self, worst: int = 100, *, partitioned: bool = True,
                              seed: int = 7) -> np.ndarray:
        """Post-P&R delays for the ``worst`` synthesis paths (paper Figs. 4/5).

        Per Sec. II-D, clustering whole MACs keeps implementation delays close
        to synthesis delays; we model the residual P&R perturbation as a small
        multiplicative noise (larger if ``partitioned`` is False, mimicking the
        abandoned per-path flow whose critical path blew up ~2x).
        """
        d = np.sort(self.path_delays_ns.reshape(-1))[::-1][:worst]
        rng = np.random.default_rng(seed)
        if partitioned:
            return d * rng.normal(1.0, 0.015, size=d.shape)
        return d * rng.normal(1.9, 0.12, size=d.shape)


def render_report_table(paths: List[TimingPath]) -> str:
    """Text rendering mirroring Table I's columns."""
    hdr = ("Name, Slack, Levels, HighFanout, From, To, TotalDelay, LogicDelay, "
           "NetDelay, Requirement, SrcClk, DstClk")
    rows = [hdr]
    for p in paths:
        rows.append(
            f"{p.name}, {p.slack_ns:.2f}, {p.levels}, {p.high_fanout}, {p.path_from}, "
            f"{p.path_to}, {p.total_delay_ns:.2f}, {p.logic_delay_ns:.2f}, "
            f"{p.net_delay_ns:.2f}, {p.requirement_ns:.2f}, {p.src_clock}, {p.dst_clock}")
    return "\n".join(rows)
