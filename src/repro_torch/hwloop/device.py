"""Emulated voltage-scaled systolic accelerator for real inference traffic.

:class:`EmulatedAccelerator` closes the loop between the CAD flow and the
DNN stack: it is built *from* a :class:`repro_torch.flow.FlowReport`
(per-partition calibrated rails, MAC→partition floorplan, Razor window) and
then *executes* matmuls the way the paper's hardware would — per-MAC arrival
times scale
with the data-dependent switching activity of the streamed activations
(Sec. II-E), the Razor model classifies each MAC-cycle as OK / DETECTED /
SILENT, DETECTED flags cost a replay cycle (energy + latency, value
corrected), and SILENT failures corrupt the product through a pluggable
model from :mod:`repro_torch.hwloop.inject`.

Arbitrary ``(M, K) @ (K, N)`` shapes are tiled onto the ``n x n`` array
weight-stationary: K splits into row tiles (resident weight rows), N into
column tiles.  Within a K-tile the Razor status tensor depends only on the
streamed activations and the rail map — never on the weights — so it is
classified once and shared by every column tile, exactly like
:class:`repro_torch.core.systolic.SystolicSim`'s flags-only trial path.

Clean tiles (no SILENT entry) take the *ideal* kernel (``a_blk @ w_blk``),
which makes the emulator bit-identical to the ideal tiled product whenever
no fault is injected — the parity property the backend parity matrix
(``tests/test_torch_hwloop.py``) pins down.
Every call feeds the :class:`repro_torch.hwloop.energy.EnergyLedger`
regardless.

The port's counterpart of ``repro.hwloop.device``.  The accelerator lives
on ``device`` (``None`` means the GPU; without one it raises) and
:meth:`EmulatedAccelerator.matmul` takes tensors, or host arrays that it
puts on its device, and returns the product as a float64 tensor where the
operands lie.  On CPU operands it runs the reference's tile loop, carried
over in numpy (the plain version, bit for bit the reference's); on CUDA
operands the tiled form of :mod:`repro_torch.hwloop.tiled`, which gives the
same flags, counts and ledger records and the same product up to summation
order.  The rails, the timing model, the floorplan and the ledger stay on
the host.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core.partition import Floorplan
from ..core.power import PowerModel, model_for
from ..core.razor import (DETECTED, SILENT, RazorConfig, classify_arrival,
                          effective_arrival, streamed_activity)
from ..core.timing import TimingModel
from .energy import EnergyLedger
from .inject import get_corruption, get_tile_corruption
from .tiled import (DelayCache, emulated_cycles, emulated_macs,
                    partition_sums, route, tiled_matmul)

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids a flow import cycle
    from ..flow.config import FlowConfig
    from ..flow.report import FlowReport


@dataclasses.dataclass
class MatmulTelemetry:
    """Per-call Razor/energy observables of one emulated matmul."""

    detected_p: np.ndarray          # (P,) DETECTED counts per partition
    silent_p: np.ndarray            # (P,) SILENT counts per partition
    macs_p: np.ndarray              # (P,) executed MAC ops per partition
    partition_flags: np.ndarray     # (P,) bool: Razor flag fired (DETECTED only)
    replay_cycles: int
    cycles: int
    rel_error: float                # ||C_emu - C_ideal|| / ||C_ideal||

    @property
    def detected_rate(self) -> np.ndarray:
        """(P,) DETECTED fraction of that partition's MAC ops."""
        return self.detected_p / np.maximum(self.macs_p, 1)


#: The paper's input-bit-fluctuation term, shared with ``SystolicSim`` (one
#: definition in :mod:`repro_torch.core.razor` keeps the two bit-identical).
quantized_activity = streamed_activity


class EmulatedAccelerator:
    """A voltage-island systolic array emulated under real matmul traffic.

    ``rails`` is the live per-partition V_ccint vector — mutable, because the
    online loop (:class:`repro_torch.hwloop.session.HwLoopSession`) lowers
    and raises rails mid-serve.  The floorplan fixes the MAC→partition map;
    the timing model fixes per-MAC nominal delays; the power model prices
    MACs.  ``device`` is where host operands are put (``None``: the GPU).
    """

    def __init__(self, timing: TimingModel, floorplan: Floorplan,
                 razor: Optional[RazorConfig] = None,
                 power: Optional[PowerModel] = None,
                 rails: Optional[np.ndarray] = None,
                 corruption: str = "stale",
                 quant_bits: int = 16,
                 leak_frac: float = 0.05,
                 seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.timing = timing
        self.floorplan = floorplan
        self.razor = razor or RazorConfig(clock_ns=timing.clock_ns)
        self.power = power or model_for(timing.tech.name)
        self.quant_bits = quant_bits
        self.corruption = corruption
        self._corrupt = get_corruption(corruption)
        self._part = floorplan.partition_of_mac()               # (n*n,)
        self.n_partitions = int(self._part.max()) + 1
        n = timing.n
        self._part_grid = self._part.reshape(n, n)
        if rails is None:
            rails = np.array([p.v_ccint for p in
                              sorted(floorplan.partitions,
                                     key=lambda p: p.index)])
        self.rails = np.asarray(rails, dtype=np.float64).copy()
        if self.rails.shape != (self.n_partitions,):
            raise ValueError(f"expected {self.n_partitions} rail voltages, "
                             f"got {self.rails.shape}")
        if np.isnan(self.rails).any():
            raise ValueError("rail voltages unset (NaN); pass rails= or use "
                             "a floorplan with voltages assigned")
        self._rng = np.random.default_rng(seed)
        self._delays = DelayCache(timing)
        self.ledger = EnergyLedger(power=self.power, clock_ns=timing.clock_ns,
                                   array_n=n, n_partitions=self.n_partitions,
                                   leak_frac=leak_frac)

    # -- construction from the CAD flow --------------------------------------

    @classmethod
    def from_flow(cls, report: "FlowReport", cfg: "FlowConfig", *,
                  rails: Optional[np.ndarray] = None,
                  **kw) -> "EmulatedAccelerator":
        """Build the device a :class:`FlowReport` describes: the config's
        timing model (deterministic in ``(array_n, tech, clock_ns, seed)``),
        the report's floorplan, and its calibrated runtime rails.
        ``device=`` is among ``kw``."""
        tm = TimingModel(n=cfg.array_n, clock_ns=cfg.clock_ns, tech=cfg.node,
                         seed=cfg.seed)
        kw.setdefault("power", model_for(cfg.tech, freq_mhz=cfg.freq_mhz,
                                         activity=cfg.activity))
        kw.setdefault("razor", RazorConfig(clock_ns=cfg.clock_ns))
        return cls(tm, report.floorplan,
                   rails=np.asarray(report.runtime_v) if rails is None
                   else rails, **kw)

    # -- rail control (the online loop's knobs) -------------------------------

    def set_rails(self, v: np.ndarray) -> None:
        v = np.asarray(v, dtype=np.float64)
        if v.shape != self.rails.shape:
            raise ValueError(f"expected {self.rails.shape[0]} rails, got {v.shape}")
        self.rails = v.copy()

    def set_partition_voltage(self, partition: int, v: float) -> None:
        self.rails[partition] = float(v)

    @property
    def v_map(self) -> np.ndarray:
        """(n, n) per-MAC voltage from the live rails."""
        return self.rails[self._part_grid]

    # -- emulated execution ---------------------------------------------------

    def _operand(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x), device=self.device)

    def delays(self, device: Optional[torch.device] = None):
        """(n, n) per-MAC delays at the live rails: a host array, or a
        float64 tensor on ``device``."""
        return self._delays(self.v_map, device)

    def matmul(self, a, w) -> Tuple[torch.Tensor, MatmulTelemetry]:
        """Emulate ``C = a @ w`` on the voltage-scaled array.

        ``a``: (M, K) activations, ``w``: (K, N) weights, tensors (used
        where they lie) or host arrays (put on the accelerator's device); K
        and N are tiled onto the ``n x n`` grid.  Returns the (possibly
        corrupted) float64 product and the call's telemetry; the energy
        ledger is updated in place.
        """
        a, w = self._operand(a), self._operand(w)
        if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
            raise ValueError(f"incompatible shapes {tuple(a.shape)} @ "
                             f"{tuple(w.shape)}")
        if a.device != w.device:
            raise ValueError(f"operands on different devices: {a.device} "
                             f"and {w.device}")
        return route(a, w, self._matmul_loop, self._matmul_tiled, "emulation")

    def _matmul_tiled(self, a: torch.Tensor, w: torch.Tensor
                      ) -> Tuple[torch.Tensor, MatmulTelemetry]:
        """The tiled form (:mod:`repro_torch.hwloop.tiled`): every tile of
        :meth:`_matmul_loop` at once, on the operands' device; the same
        counts, flags and ledger record, one read of the counts."""
        m_rows, k_dim = a.shape
        n_dim = w.shape[1]
        n = self.timing.n
        p = self.n_partitions
        c, scan, rel = tiled_matmul(
            a, w, delays=self.delays(a.device), razor=self.razor,
            quant_bits=self.quant_bits,
            corrupt=get_tile_corruption(self.corruption), rule="emulated")
        cols = scan.column_weights(n_dim)[None, :]
        detected_p = partition_sums(scan.detected * cols, self._part_grid, p)
        silent_p = partition_sums(scan.silent * cols, self._part_grid, p)
        macs_p = emulated_macs(m_rows, k_dim, n_dim, self._part_grid, p)
        cycles = emulated_cycles(m_rows, k_dim, n_dim, n)
        return c, self._account(detected_p, silent_p, macs_p, cycles,
                                0.0 if silent_p.sum() == 0 else rel)

    def _account(self, detected_p, silent_p, macs_p, cycles, rel_error
                 ) -> MatmulTelemetry:
        replay_cycles = int(detected_p.sum())
        self.ledger.record(macs_p, self.rails, detected_p,
                           cycles + replay_cycles)
        return MatmulTelemetry(
            detected_p=detected_p, silent_p=silent_p, macs_p=macs_p,
            partition_flags=detected_p > 0,
            replay_cycles=replay_cycles,
            cycles=cycles + replay_cycles,
            rel_error=rel_error,
        )

    def _matmul_loop(self, a: np.ndarray, w: np.ndarray
                     ) -> Tuple[np.ndarray, MatmulTelemetry]:
        """The reference's tile loop on host arrays (the plain version)."""
        a = np.asarray(a, dtype=np.float64)
        w = np.asarray(w, dtype=np.float64)
        n = self.timing.n
        m_rows, k_dim = a.shape
        n_dim = w.shape[1]
        c = np.zeros((m_rows, n_dim), dtype=np.float64)

        p = self.n_partitions
        detected_p = np.zeros(p, dtype=np.int64)
        silent_p = np.zeros(p, dtype=np.int64)
        macs_p = np.zeros(p, dtype=np.int64)
        cycles = 0
        delays = self.delays()                                  # (n, n)

        for ki in range(0, k_dim, n):
            a_blk = a[:, ki:ki + n]                             # (M, kb)
            kb = a_blk.shape[1]
            act = quantized_activity(a_blk, self.quant_bits)    # (M, kb)
            arrival = effective_arrival(delays[None, :kb, :],
                                        act[:, :, None], self.razor)
            status = classify_arrival(arrival, self.razor)      # (M, kb, n)
            for nj in range(0, n_dim, n):
                w_blk = w[ki:ki + n, nj:nj + n]                 # (kb, nb)
                nb = w_blk.shape[1]
                st = status[:, :, :nb]
                part = self._part_grid[:kb, :nb].reshape(-1)
                det = (st == DETECTED).sum(axis=0).reshape(-1)
                sil = st == SILENT
                sil_counts = sil.sum(axis=0).reshape(-1)
                detected_p += np.bincount(part, weights=det,
                                          minlength=p).astype(np.int64)
                silent_p += np.bincount(part, weights=sil_counts,
                                        minlength=p).astype(np.int64)
                macs_p += m_rows * np.bincount(part, minlength=p)
                if sil.any():
                    terms = a_blk[:, :, None] * w_blk[None, :, :]
                    c_blk = self._corrupt(terms, sil, self._rng)
                else:
                    # fault-free tile: the ideal kernel, bit for bit
                    c_blk = a_blk @ w_blk
                c[:, nj:nj + nb] += c_blk
                # weight-stationary pass: pipeline fill + M streamed rows + drain
                cycles += m_rows + kb + nb - 1

        if silent_p.sum() == 0:
            # no corruption was injected, so c IS the ideal tiled product —
            # don't pay a second full matmul just to measure a zero
            rel_error = 0.0
        else:
            c_true = a @ w
            denom = float(np.linalg.norm(c_true)) or 1.0
            rel_error = float(np.linalg.norm(c - c_true)) / denom
        return c, self._account(detected_p, silent_p, macs_p, cycles,
                                rel_error)
