"""The four first-class execution backends.

| name        | machinery                      | fidelity                 |
|-------------|--------------------------------|--------------------------|
| `ideal`     | ``torch.matmul``               | exact, fastest           |
| `reference` | ``systolic_mac`` at nominal    | exact, kernel-semantics  |
| `simulated` | ``core.SystolicSim``           | cycle-level Razor faults |
| `emulated`  | ``hwloop.EmulatedAccelerator`` | faults + replay + energy |

`simulated`/`emulated` tile arbitrary ``(M, K) @ (K, N)`` problems onto
their ``n x n`` array exactly like the accelerator would (K into resident
row tiles, N into column tiles); at nominal rails both degenerate to the
exact tiled product, which is what makes the backend parity matrix
(``tests/test_torch_hwloop.py``) bit-identical to the JAX package's.  On CPU
operands both walk the reference's tile loop in numpy (the plain version);
on a GPU both run the tiled form of :mod:`repro_torch.hwloop.tiled`, which
gives the same flags and counts and the same product up to summation order.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike
from ..core.partition import quadrant_floorplan
from ..core.razor import RazorConfig
from ..core.systolic import SystolicSim
from ..core.timing import TECH_NODES, TimingModel
from ..hwloop.inject import stale_psum_tiles
from ..hwloop.tiled import DelayCache, partition_sums, route, tiled_matmul
from ..kernels.systolic_mac import systolic_mac
from .base import (BackendTelemetry, MatmulBackend, largest_common_block,
                   register_backend)


class IdealBackend(MatmulBackend):
    """The production library path: a plain ``torch.matmul`` (the JAX
    package leaves this product to XLA, outside any kernel).  The router
    never enters the backend for it — ``matmul()`` stays ``a @ b``."""

    name = "ideal"
    is_ideal = True

    def _execute(self, a, b, count_flags, counter):
        res = torch.promote_types(a.dtype, b.dtype)
        if not res.is_floating_point:
            res = torch.float32
        out = torch.matmul(a.to(res), b.to(res))
        m, k = a.shape
        tel = BackendTelemetry(calls=1, macs=m * k * b.shape[1])
        return out, tel


class ReferenceBackend(MatmulBackend):
    """The ``systolic_mac`` kernel with a uniformly nominal voltage map, so
    no cell ever trips the corruption model and the product is the exact
    f32-accumulated matmul.  On a GPU every model GEMM is one launch of the
    hand-written kernel, on the operands where and as they lie (bf16 weights
    are read as bf16, a transposed view through its strides); on the CPU it
    is the kernel's plain version, which is what ``repro``'s reference
    backend computes."""

    name = "reference"

    def __init__(self, device=None) -> None:
        super().__init__(device)
        # nominal rails per flag grid, made once: a decode step would
        # otherwise fill two maps per GEMM
        self._rails: Dict[Tuple[int, int, torch.device],
                          Tuple[torch.Tensor, torch.Tensor]] = {}

    def _nominal(self, grid: Tuple[int, int], device: torch.device):
        key = (*grid, device)
        if key not in self._rails:
            self._rails[key] = (
                torch.ones(grid, dtype=torch.float32, device=device),
                torch.zeros(grid, dtype=torch.float32, device=device))
        return self._rails[key]

    def _execute(self, a, b, count_flags, counter):
        m, k = a.shape
        n = b.shape[1]
        if a.dtype != b.dtype or a.dtype not in (torch.float32,
                                                 torch.bfloat16):
            # exact up-cast of the narrower operand (never on the model's
            # path, where activations and weights are both bf16)
            a, b = a.to(torch.float32), b.to(torch.float32)
        block = largest_common_block(m, n)
        v_map, v_safe = self._nominal((m // block, n // block), a.device)
        # the kernel adds its fired cells into the caller's count
        c, _ = systolic_mac(a, b, v_map, v_safe, block_m=block, block_n=block,
                            counter=counter if count_flags else None)
        return c, BackendTelemetry(calls=1, macs=m * k * n)


class SimulatedBackend(MatmulBackend):
    """``core.SystolicSim`` under real traffic: cycle-level Razor
    classification with stale-register silent failures, tiled onto the
    simulator's ``n x n`` array.

    Partial tiles are zero-padded to the array edge; padded MACs still get
    classified (they exist on the die), but their rank-1 terms are zero so
    the product is unaffected and only real MACs are counted in ``macs``.

    On a GPU the tiled form reports ``rel_error`` as the largest of the
    silent tiles' (0.0 where no tile is silent: the loop's clean tiles
    report the rounding gap between two summation orders of one exact
    product, which the tiled form does not reproduce).
    """

    name = "simulated"

    def __init__(self, sim: SystolicSim, device: DeviceLike = None):
        super().__init__(device)
        self.sim = sim
        self._delays = DelayCache(sim.timing)

    @classmethod
    def nominal(cls, array_n: int = 8, tech: str = "vtr-22nm",
                clock_ns: float = 10.0, seed: int = 2021,
                device: DeviceLike = None,
                **sim_kw: Any) -> "SimulatedBackend":
        """A fault-free operating point: quadrant floorplan with every rail
        at the tech node's nominal voltage."""
        node = TECH_NODES[tech]
        tm = TimingModel(n=array_n, clock_ns=clock_ns, tech=node, seed=seed)
        fp = quadrant_floorplan(array_n).with_voltages([node.v_nom] * 4)
        return cls(SystolicSim(tm, fp, RazorConfig(clock_ns=clock_ns),
                               **sim_kw), device=device)

    def _execute(self, a, b, count_flags, counter):
        return route(a, b, self._execute_loop, self._execute_tiled,
                     "simulation")

    def _execute_tiled(self, a: torch.Tensor, b: torch.Tensor):
        """The tiled form: every tile of :meth:`_execute_loop` at once."""
        sim = self.sim
        n = sim.timing.n
        m, k = a.shape
        n_dim = b.shape[1]
        out, scan, rel = tiled_matmul(
            a, b, delays=self._delays(sim.floorplan.voltage_map(), a.device),
            razor=sim.razor,
            quant_bits=sim.quant_bits, corrupt=stale_psum_tiles,
            rule="simulated")
        col_tiles = -(-n_dim // n)
        part_flags = partition_sums(scan.detected, sim._part.reshape(n, n),
                                    sim._n_part) > 0
        tel = BackendTelemetry(
            calls=1, macs=m * k * n_dim, flags=int(part_flags.sum()),
            replays=col_tiles * int(scan.detected.sum()),
            silent=col_tiles * int(scan.silent.sum()),
            rel_error=0.0 if rel is None else rel,
            partition_flags=[bool(f) for f in part_flags])
        return out, tel

    def _execute_loop(self, a: np.ndarray, b: np.ndarray):
        """The reference's tile loop on host arrays (the plain version)."""
        n = self.sim.timing.n
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        m, k = a.shape
        n_dim = b.shape[1]
        out = np.zeros((m, n_dim), dtype=np.float64)
        n_part = self.sim._n_part
        part_flags = np.zeros(n_part, dtype=bool)
        replays = silent = macs = 0
        rel_error = 0.0
        for ki in range(0, k, n):
            a_blk = a[:, ki:ki + n]
            kb = a_blk.shape[1]
            if kb < n:
                a_blk = np.pad(a_blk, ((0, 0), (0, n - kb)))
            for nj in range(0, n_dim, n):
                w_blk = b[ki:ki + kb, nj:nj + n]
                nb = w_blk.shape[1]
                w_pad = np.zeros((n, n), dtype=np.float64)
                w_pad[:kb, :nb] = w_blk
                c_blk, stats = self.sim.matmul(a_blk, w_pad)
                out[:, nj:nj + nb] += c_blk[:, :nb]
                part_flags |= stats.partition_fail
                replays += stats.replay_cycles
                silent += int(stats.silent.sum())
                macs += m * kb * nb
                rel_error = max(rel_error, stats.rel_error)
        tel = BackendTelemetry(
            calls=1, macs=macs, flags=int(part_flags.sum()), replays=replays,
            silent=silent, rel_error=rel_error,
            partition_flags=[bool(f) for f in part_flags])
        return out, tel


class EmulatedBackend(MatmulBackend):
    """``hwloop.EmulatedAccelerator`` as a production execution target:
    every GEMM runs on the voltage-scaled array with data-dependent Razor
    fault injection, DETECTED replay costs, pluggable SILENT corruption, and
    the :class:`~repro_torch.hwloop.energy.EnergyLedger` pricing every MAC.

    ``backend.accel.rails`` stays live — the hwloop watchdog adapter (or an
    undervolting experiment) can move rails between serve steps.  The
    backend's device is the accelerator's.
    """

    name = "emulated"

    def __init__(self, accel):
        super().__init__(accel.device)
        self.accel = accel

    @classmethod
    def nominal(cls, array_n: int = 8, tech: str = "vtr-22nm",
                clock_ns: float = 10.0, seed: int = 2021,
                **accel_kw: Any) -> "EmulatedBackend":
        """Fault-free operating point (quadrant floorplan, nominal rails) —
        the zero-flag end of the parity matrix, ledger still live.
        ``device=`` is among ``accel_kw``."""
        from ..hwloop.device import EmulatedAccelerator
        node = TECH_NODES[tech]
        tm = TimingModel(n=array_n, clock_ns=clock_ns, tech=node, seed=seed)
        fp = quadrant_floorplan(array_n).with_voltages([node.v_nom] * 4)
        return cls(EmulatedAccelerator(tm, fp,
                                       razor=RazorConfig(clock_ns=clock_ns),
                                       **accel_kw))

    @classmethod
    def from_flow(cls, report, cfg, *, rails: Optional[np.ndarray] = None,
                  **accel_kw: Any) -> "EmulatedBackend":
        """The CAD flow's calibrated operating point: the `FlowReport`'s
        floorplan and runtime rails (the actual voltage-scaled serving
        target)."""
        from ..hwloop.device import EmulatedAccelerator
        return cls(EmulatedAccelerator.from_flow(report, cfg, rails=rails,
                                                 **accel_kw))

    @property
    def ledger(self):
        return self.accel.ledger

    def add_tokens(self, n: int) -> None:
        self.accel.ledger.add_tokens(n)

    def _execute(self, a, b, count_flags, counter):
        j_before = self.accel.ledger.total_j
        c, mtel = self.accel.matmul(a, b)
        tel = BackendTelemetry(
            calls=1, macs=int(mtel.macs_p.sum()),
            flags=int(mtel.partition_flags.sum()),
            replays=int(mtel.replay_cycles),
            silent=int(mtel.silent_p.sum()),
            energy_j=float(self.accel.ledger.total_j - j_before),
            rel_error=float(mtel.rel_error),
            partition_flags=[bool(f) for f in mtel.partition_flags])
        return c, tel

    def summary(self):
        out = super().summary()
        out["rails_v"] = [float(v) for v in self.accel.rails]
        out["corruption"] = self.accel.corruption
        led = self.accel.ledger.summary()
        # the ledger counts the DEVICE's lifetime (a shared accel also sees
        # hwloop probe traffic); keep the backend-routed "macs" authoritative
        led["device_macs"] = led.pop("macs")
        out.update(led)
        return out


register_backend("ideal", IdealBackend)
register_backend("reference", ReferenceBackend)
register_backend("simulated", SimulatedBackend.nominal)
register_backend("emulated", EmulatedBackend.nominal)
