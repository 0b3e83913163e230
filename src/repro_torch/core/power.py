"""Dynamic-power model calibrated to the paper's Table II / Figs. 15-16.

Physics: P_dyn = a * C * V^2 * f.  The paper's *reported* reductions do not
track a pure V^2 law (tool power models mix voltage-scalable logic power with
rail-independent interconnect/clock components, plus leakage that shrinks
super-quadratically at 28 nm), so per technology node we fit a single exponent

    P(V) = P_ref * (V / V_ref) ** k

by least squares over the paper's own reduction rows, then *hold it fixed*
for every prediction (array sizes, Fig. 15/16 variants).  See DESIGN.md Sec. 9.

All paper numbers live in PAPER_TABLE2 so benchmarks/tests print model vs
paper side by side and flag |delta|.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .timing import TECH_NODES, TechNode

# ---------------------------------------------------------------------------
# Paper data (Table II).  Garbled OCR cells are reconstructed from the
# self-consistent columns: scaled = baseline * (1 - reduction); see DESIGN.md.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Table2Row:
    tech: str
    array: int                      # systolic array dimension (16/32/64)
    baseline_v: float               # unpartitioned V_ccint
    baseline_mw: float
    partition_v: Tuple[float, ...]  # the 4 partition voltages
    reduction_pct: float            # paper's reported % reduction


PAPER_TABLE2: List[Table2Row] = [
    # --- guard-band experiments: baseline 1.00 V, partitions {0.96,0.97,0.98,0.99}
    Table2Row("vivado-28nm", 16, 1.00, 408.0, (0.96, 0.97, 0.98, 0.99), 6.37),
    Table2Row("vivado-28nm", 32, 1.00, 1538.0, (0.96, 0.97, 0.98, 0.99), 6.76),
    Table2Row("vivado-28nm", 64, 1.00, 5920.0, (0.96, 0.97, 0.98, 0.99), 6.52),
    Table2Row("vtr-22nm", 16, 1.00, 269.0, (0.96, 0.97, 0.98, 0.99), 1.86),
    Table2Row("vtr-22nm", 32, 1.00, 1072.0, (0.96, 0.97, 0.98, 0.99), 1.95),
    Table2Row("vtr-22nm", 64, 1.00, 4284.0, (0.96, 0.97, 0.98, 0.99), 1.84),
    Table2Row("vtr-45nm", 16, 1.00, 387.0, (0.96, 0.97, 0.98, 0.99), 1.80),
    Table2Row("vtr-45nm", 32, 1.00, 1549.0, (0.96, 0.97, 0.98, 0.99), 1.87),
    Table2Row("vtr-45nm", 64, 1.00, 6200.0, (0.96, 0.97, 0.98, 0.99), 1.77),
    Table2Row("vtr-130nm", 16, 1.00, 1543.0, (0.96, 0.97, 0.98, 0.99), 0.70),
    Table2Row("vtr-130nm", 32, 1.00, 6172.0, (0.96, 0.97, 0.98, 0.99), 0.76),
    Table2Row("vtr-130nm", 64, 1.00, 24693.0, (0.96, 0.97, 0.98, 0.99), 0.77),
    # --- critical-region experiment (4th instant): baseline 0.9 V
    Table2Row("vtr-22nm", 64, 0.90, 3965.0, (0.70, 0.80, 0.90, 1.00), 3.70),
    Table2Row("vtr-45nm", 64, 0.90, 5798.0, (0.70, 0.80, 0.90, 1.00), 2.40),
    Table2Row("vtr-130nm", 64, 0.90, 23961.0, (0.70, 0.80, 0.90, 1.00), 1.37),
]


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def fit_power_exponent(tech: str) -> float:
    """Least-squares fit of k in P ~ V^k over the tech's Table II rows.

    Each row with equal-size partitions at voltages v_i and baseline V_ref
    predicts reduction r(k) = 1 - mean_i (v_i / V_ref)^k ; we minimise
    sum (r(k) - r_paper)^2 by golden-section search on k in [0.05, 4].

    The fit is cached per tech — ``PAPER_TABLE2`` is a constant, so the
    exponent is too.  Previously this re-ran ~2.5k interpreted ``loss``
    evaluations on every ``PowerStage`` execution of a sweep.  The loss body
    is kept operation-for-operation identical to
    :func:`fit_power_exponent_ref` so both produce the same bits (Python
    ``**`` and NumPy power round differently in the last ulp, which the
    golden-section bracketing would amplify into a different exponent).
    """
    rows = [r for r in PAPER_TABLE2 if r.tech == tech]
    if not rows:
        raise ValueError(f"no Table II rows for {tech}")

    def loss(k: float) -> float:
        tot = 0.0
        for r in rows:
            pred = 1.0 - np.mean([(v / r.baseline_v) ** k for v in r.partition_v])
            tot += (pred - r.reduction_pct / 100.0) ** 2
        return tot

    lo, hi = 0.05, 4.0
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c, d = b - phi * (b - a), a + phi * (b - a)
    for _ in range(80):
        if loss(c) < loss(d):
            b = d
        else:
            a = c
        c, d = b - phi * (b - a), a + phi * (b - a)
    return 0.5 * (a + b)


def fit_power_exponent_ref(tech: str) -> float:
    """The original per-row interpreted fit, uncached — bit-identical result
    to :func:`fit_power_exponent`; kept as the ``impl="reference"`` perf
    baseline (the seed paid ~2.5k Python ``loss`` evaluations per sweep)."""
    rows = [r for r in PAPER_TABLE2 if r.tech == tech]
    if not rows:
        raise ValueError(f"no Table II rows for {tech}")

    def loss(k: float) -> float:
        tot = 0.0
        for r in rows:
            pred = 1.0 - np.mean([(v / r.baseline_v) ** k for v in r.partition_v])
            tot += (pred - r.reduction_pct / 100.0) ** 2
        return tot

    lo, hi = 0.05, 4.0
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c, d = b - phi * (b - a), a + phi * (b - a)
    for _ in range(80):
        if loss(c) < loss(d):
            b = d
        else:
            a = c
        c, d = b - phi * (b - a), a + phi * (b - a)
    return 0.5 * (a + b)


@dataclasses.dataclass
class PowerModel:
    """Per-technology dynamic power with partitioned voltage scaling."""

    tech: TechNode
    k: Optional[float] = None                # power-law exponent; fit if None
    freq_mhz: float = 100.0
    activity: float = 0.5                    # toggle rate alpha

    def __post_init__(self) -> None:
        if self.k is None:
            self.k = fit_power_exponent(self.tech.name)

    # -- baselines -----------------------------------------------------------------

    def baseline_mw(self, array: int, v: Optional[float] = None) -> float:
        """Unpartitioned array power, anchored to the tech's 16x16 Table II cell
        and scaled by MAC count, frequency and activity."""
        v = self.tech.v_nom if v is None else v
        p16 = self.tech.p16_mw
        scale = (array / 16.0) ** 2
        f = self.freq_mhz / 100.0
        a = self.activity / 0.5
        return p16 * scale * f * a * (v / self.tech.v_nom) ** self.k

    # -- partitioned ----------------------------------------------------------------

    def partitioned_mw(self, array: int, partition_v: Sequence[float],
                       partition_frac: Optional[Sequence[float]] = None,
                       v_ref: Optional[float] = None) -> float:
        """Power with per-partition voltages.

        ``partition_frac[i]`` — fraction of MACs in partition i (defaults to
        equal, matching the paper's 'same partition size' simplification).
        ``v_ref`` — the unpartitioned baseline voltage this config is compared
        against (paper uses 1.0 in guard-band rows, 0.9 in the critical row).
        """
        v = np.asarray(partition_v, dtype=np.float64)
        frac = (np.full(len(v), 1.0 / len(v)) if partition_frac is None
                else np.asarray(partition_frac, dtype=np.float64))
        frac = frac / frac.sum()
        v_ref = self.tech.v_nom if v_ref is None else v_ref
        base = self.baseline_mw(array, v_ref)
        return float(base * np.sum(frac * (v / v_ref) ** self.k))

    def reduction_pct(self, array: int, partition_v: Sequence[float],
                      v_ref: Optional[float] = None,
                      partition_frac: Optional[Sequence[float]] = None) -> float:
        v_ref = self.tech.v_nom if v_ref is None else v_ref
        base = self.baseline_mw(array, v_ref)
        part = self.partitioned_mw(array, partition_v, partition_frac, v_ref)
        return 100.0 * (1.0 - part / base)

    # -- energy for the accelerator integration (DESIGN.md Sec. 2c) ------------------

    def energy_per_mac_pj(self, v: float) -> float:
        """Energy of one MAC op at voltage v, derived from the 16x16 anchor:
        P = N_mac * E_mac * f  =>  E_mac(V_nom) = P16 / (256 * f)."""
        e_nom_pj = (self.tech.p16_mw * 1e-3) / (256 * self.freq_mhz * 1e6) * 1e12
        return e_nom_pj * (v / self.tech.v_nom) ** self.k

    def macs_energy_j(self, n_macs: float, partition_v: Sequence[float],
                      partition_frac: Optional[Sequence[float]] = None) -> float:
        """Total energy for ``n_macs`` MAC ops spread over voltage partitions."""
        v = np.asarray(partition_v, dtype=np.float64)
        frac = (np.full(len(v), 1.0 / len(v)) if partition_frac is None
                else np.asarray(partition_frac, dtype=np.float64))
        frac = frac / frac.sum()
        e = np.array([self.energy_per_mac_pj(float(x)) for x in v]) * 1e-12
        return float(n_macs * np.sum(frac * e))


def model_for(tech_name: str, **kw) -> PowerModel:
    return PowerModel(tech=TECH_NODES[tech_name], **kw)


def validate_against_table2(max_rows: Optional[int] = None) -> List[Dict]:
    """Model-vs-paper comparison over every Table II row (used by tests and the
    table2 benchmark)."""
    out = []
    models = {t: model_for(t) for t in TECH_NODES}
    rows = PAPER_TABLE2[:max_rows] if max_rows else PAPER_TABLE2
    for r in rows:
        m = models[r.tech]
        pred = m.reduction_pct(r.array, r.partition_v, v_ref=r.baseline_v)
        scaled_paper = r.baseline_mw * (1 - r.reduction_pct / 100.0)
        scaled_model = r.baseline_mw * (1 - pred / 100.0)
        out.append({
            "tech": r.tech, "array": r.array, "v_ref": r.baseline_v,
            "paper_reduction_pct": r.reduction_pct,
            "model_reduction_pct": round(pred, 3),
            "delta_pp": round(pred - r.reduction_pct, 3),
            "paper_scaled_mw": round(scaled_paper, 1),
            "model_scaled_mw": round(scaled_model, 1),
        })
    return out
