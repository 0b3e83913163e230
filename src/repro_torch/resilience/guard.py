"""ABFT-guarded GEMM execution: :class:`GuardedBackend`.

The emulated accelerator's SILENT corruption modes (stale / TE-Drop /
bitflip, :mod:`repro_torch.hwloop.inject`) are by definition invisible to
the Razor replay path — at near-threshold rails a corrupted product flows
straight into model outputs with no flag.  ``GuardedBackend`` wraps ANY
:class:`~repro_torch.backend.base.MatmulBackend` and closes that hole with
algorithm-based fault tolerance (Huang & Abraham, 1984):

* ``mode="abft"``     — row/column checksum verification: the product's row
  and column sums are checked against two float64 GEMVs of the operands.  A
  single corrupted element shows up as exactly one bad row i and one bad
  column j with matching residuals — it is located and corrected in place
  without re-execution.
* ``mode="freivalds"``— Freivalds' probabilistic probe: seeded ±1 vectors,
  ``C @ x`` vs ``A @ (B @ x)``.  Detection only; ``probes=k`` drives the miss
  rate to 2^-k.
* ``mode="off"``      — transparent pass-through (measurement baseline).

On an uncorrectable mismatch the guard walks the escalation ladder: bounded
re-execution (``max_retries``), a rail heal (the attached
:class:`~repro_torch.hwloop.session.HwLoopSession` watchdog fed
all-partitions flags until its patience recalibrates, or the device's
nominal rails without a session), then the policy (``fail_open`` returns the
best product with ``guard_uncorrected`` telemetry, ``fail_closed`` raises
:class:`GuardError`).  All guard activity lands in the ``guard_*`` counters
of :class:`~repro_torch.backend.base.BackendTelemetry`.

The port's counterpart of ``repro.resilience.guard``, with the same ladder,
counters, events and probe sequence.  The checks are computed where the
operands lie, by :mod:`repro_torch.kernels.abft` (the kernels on a GPU,
their plain versions on the CPU): in the abft mode
:func:`~repro_torch.kernels.abft.abft_checksums` forms a GEMM's references
and tolerances from one read of ``b`` (one launch), and
:func:`~repro_torch.kernels.abft.abft_verdict` each verification's verdict
(one launch): the bad-row and bad-column counts, the first of each with its
residual, and the largest residual-to-tolerance ratio, seven float64 numbers
read by the host once a verification.  Freivalds' probes go through
``abft_checksums``' general form and PyTorch ops.  Neither the product nor
an operand goes to the host.  The ``b``-side checks of one guarded GEMM are
computed once and serve its retries.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..backend.base import (BackendTelemetry, MatmulBackend, get_backend,
                            register_backend)
from ..kernels.abft import abft_checksums, abft_verdict

MODES = ("off", "freivalds", "abft")
POLICIES = ("fail_open", "fail_closed")


class GuardError(RuntimeError):
    """Raised under ``policy="fail_closed"`` when the escalation ladder
    cannot produce a verified product.

    When an ``ObsBus`` is attached, :attr:`flight` carries the flight
    recorder's ring (the last N step/guard/heal events, oldest first)."""

    flight: list = []


@dataclasses.dataclass
class _Verdict:
    """One verification pass over a candidate product, as the host reads
    it: the counts of failing rows and columns and, for locate-and-correct,
    the first of each with its residual."""

    ok: bool
    bad_rows: int
    bad_cols: int
    row: int = 0
    col: int = 0
    row_err: float = 0.0
    col_err: float = 0.0


@dataclasses.dataclass
class _Checks:
    """What one guarded GEMM's operands give every verification of it (on
    the operands' device).  abft: ``ref``, the (2, M + N) pack of the
    reference row sums then column sums over their tolerances; freivalds:
    ``a`` in float64 and, after the first probe pass, the row tolerances
    (M,)."""

    a64: Optional[torch.Tensor] = None
    tol: Optional[torch.Tensor] = None
    ref: Optional[torch.Tensor] = None


class GuardedBackend(MatmulBackend):
    """ABFT wrapper conforming to the ``MatmulBackend`` protocol.

    ``inner`` is any backend name (made on ``device``) or instance; the guard
    composes at the ``_execute`` level, so the shared precision pipeline runs
    ONCE at the guard and the inner backend sees the operands it would see
    unguarded.  The guard's device is the inner backend's.

    ``max_clean_ratio`` is the largest residual-to-tolerance ratio of any
    verification that passed: how close a clean product came to a false
    detection.
    """

    is_guarded = True

    def __init__(self, inner: Any = "emulated", *, mode: str = "abft",
                 policy: str = "fail_closed", max_retries: int = 2,
                 probes: int = 2, tol: float = 1e-6, seed: int = 0,
                 heal: bool = True, session=None, device=None):
        if mode not in MODES:
            raise ValueError(f"unknown guard mode {mode!r}; known: {MODES}")
        if policy not in POLICIES:
            raise ValueError(f"unknown guard policy {policy!r}; "
                             f"known: {POLICIES}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        if probes < 1:
            raise ValueError(f"probes must be >= 1, got {probes}")
        self.inner = (get_backend(inner) if isinstance(inner, MatmulBackend)
                      else get_backend(inner, device=device))
        super().__init__(self.inner.device)
        self.mode = mode
        self.policy = policy
        self.max_retries = int(max_retries)
        self.probes = int(probes)
        self.tol = float(tol)
        self.heal = bool(heal)
        self.session = session
        self.name = f"guarded[{self.inner.name}]"
        self._rng = np.random.default_rng(seed)
        self._pinned: Dict[int, torch.Tensor] = {}
        self.max_clean_ratio = 0.0

    # -- wiring ---------------------------------------------------------------

    @property
    def accel(self):
        """Delegate to the inner backend's live device (when it has one), so
        the serve engine's hwloop adapter sees through the guard."""
        return self.inner.accel

    def attach_session(self, session) -> None:
        """Bind the hwloop session whose watchdog the heal path drives (the
        serve engine calls this when both guard and session are present)."""
        self.session = session

    def _obs_event(self, name: str, **attrs) -> None:
        """Guard escalation trace (no-op without an attached ObsBus)."""
        if self._obs is not None:
            self._obs.event(name, backend=self.inner.name, mode=self.mode,
                            **attrs)

    def add_tokens(self, n: int) -> None:
        self.inner.add_tokens(n)

    # -- verification ---------------------------------------------------------

    def _checks(self, a: torch.Tensor, b: torch.Tensor) -> _Checks:
        """The operand-side checks of one guarded GEMM.  abft: one
        ``abft_checksums`` call (``b`` read once; a's column sums, the
        products with ``a`` and the tolerances formed with it).  Freivalds'
        tolerance comes with its first probe pass (the same read of
        ``b``)."""
        if self.mode == "freivalds":
            return _Checks(a64=a.to(torch.float64))
        return _Checks(ref=abft_checksums(b, a=a, tol=self.tol))

    def _read(self, pack: torch.Tensor) -> List[float]:
        """The verdict's one read by the host (on a GPU a copy into pinned
        memory, then the stream's end)."""
        if not pack.is_cuda:
            return pack.tolist()
        host = self._pinned.get(pack.numel())
        if host is None:
            host = self._pinned[pack.numel()] = torch.empty(
                pack.shape, dtype=pack.dtype, pin_memory=True)
        host.copy_(pack, non_blocking=True)
        torch.cuda.current_stream(pack.device).synchronize()
        return host.tolist()

    def _abft_verify(self, ck: _Checks, out: torch.Tensor) -> _Verdict:
        nbr, nbc, fi, fj, er, ec, worst = self._read(abft_verdict(out,
                                                                  ck.ref))
        ok = nbr == 0 and nbc == 0
        if ok:
            self.max_clean_ratio = max(self.max_clean_ratio, worst)
        return _Verdict(ok=ok, bad_rows=int(nbr), bad_cols=int(nbc),
                        row=int(fi), col=int(fj), row_err=er, col_err=ec)

    def _freivalds_verify(self, ck: _Checks, b: torch.Tensor,
                          out: torch.Tensor) -> bool:
        """The reference's probe loop: probe ``p`` is drawn only when probes
        0..p-1 passed.  All probes are drawn and checked at once; the
        generator is then set back to where the reference's loop leaves
        it."""
        n = b.shape[1]
        states, xs = [], []
        for _ in range(self.probes):
            xs.append(self._rng.integers(0, 2, size=n).astype(np.float64)
                      * 2 - 1)
            states.append(self._rng.bit_generator.state)
        x = torch.as_tensor(np.stack(xs, axis=1)).to(b.device)   # (N, k)
        bw, _ = abft_checksums(b, x, ck.a64[:0])
        if ck.tol is None:
            ck.tol = (ck.a64.abs() @ bw[:, -1] + 1.0) * self.tol
        resid = (out.to(torch.float64) @ x - ck.a64 @ bw[:, :-1]).abs()
        tol = ck.tol[:, None]                                     # (M, k)
        bad = (resid > tol).any(dim=0)
        first = bad.to(torch.int32).argmax()
        any_bad, fp, worst = self._read(torch.stack([
            bad.any().to(torch.float64), first.to(torch.float64),
            (resid / tol).max()]))
        if any_bad:
            self._rng.bit_generator.state = states[int(fp)]
            return False
        self.max_clean_ratio = max(self.max_clean_ratio, worst)
        return True

    def _verify(self, ck: _Checks, b: torch.Tensor,
                out: torch.Tensor) -> _Verdict:
        if self.mode == "freivalds":
            ok = self._freivalds_verify(ck, b, out)
            return _Verdict(ok=ok, bad_rows=0, bad_cols=0)
        return self._abft_verify(ck, out)

    # -- escalation ladder ----------------------------------------------------

    def _try_correct(self, out: torch.Tensor, v: _Verdict
                     ) -> Optional[torch.Tensor]:
        """Single-element locate-and-correct: one bad row x one bad column
        with matching residuals pins the corruption to C[i, j].  Returns the
        product, in float64, with that element corrected, or None."""
        if self.mode != "abft" or v.bad_rows != 1 or v.bad_cols != 1:
            return None
        delta_r, delta_c = v.row_err, v.col_err
        scale = max(abs(delta_r), abs(delta_c), 1.0)
        if abs(delta_r - delta_c) > self.tol * scale:
            return None                   # residuals disagree: >1 element hit
        out64 = out.to(torch.float64, copy=True)
        out64[v.row, v.col] -= delta_r
        return out64

    def _heal_rails(self) -> bool:
        """Re-rail the inner device: watchdog recalibration when a session is
        attached (detected corruption counts as an all-partitions event),
        else straight to the tech node's nominal voltage."""
        accel = getattr(self.inner, "accel", None)
        if self.session is not None:
            flags = np.ones(self.session.n_partitions, dtype=bool)
            for _ in range(int(self.session.watchdog.patience) + 1):
                if self.session.observe_flags(flags):
                    return True
            return False
        if accel is None:
            return False
        accel.set_rails(np.full(accel.n_partitions,
                                float(accel.timing.tech.v_nom)))
        return True

    def _corrected(self, ck: _Checks, b: torch.Tensor, out: torch.Tensor,
                   v: _Verdict, tel: BackendTelemetry
                   ) -> Tuple[torch.Tensor, bool]:
        """The locate-and-correct rung after a failed verification: the
        product from here on (corrected where a single element was located,
        as the reference corrects its copy in place) and whether it
        verified."""
        out64 = self._try_correct(out, v)
        if out64 is None:
            return out, False
        tel.guard_checks += 1
        if self._verify(ck, b, out64).ok:
            tel.guard_corrected += 1
            self._obs_event("guard_correct")
            return out64, True
        return out64, False

    # -- execution ------------------------------------------------------------

    def _reexecute(self, a, b, count_flags, counter, tel: BackendTelemetry
                   ) -> torch.Tensor:
        out, tel_r = self.inner._execute(a, b, count_flags, counter)
        tel.merge(tel_r)
        tel.calls -= 1                  # one protocol call, several executions
        return out

    def _execute(self, a: torch.Tensor, b: torch.Tensor, count_flags: bool,
                 counter: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, BackendTelemetry]:
        out, tel = self.inner._execute(a, b, count_flags, counter)
        if self.mode == "off":
            return out, tel
        ck = self._checks(a, b)
        tel.guard_checks += 1
        v = self._verify(ck, b, out)
        if v.ok:
            return out, tel
        tel.guard_detected += 1
        self._obs_event("guard_detect", bad_rows=v.bad_rows,
                        bad_cols=v.bad_cols)
        out, ok = self._corrected(ck, b, out, v, tel)
        if ok:
            return out, tel

        # rung 1: bounded re-execution (clears transient faults; a
        # deterministic undervolt fault reproduces and falls through)
        for retry in range(self.max_retries):
            out = self._reexecute(a, b, count_flags, counter, tel)
            tel.guard_retries += 1
            self._obs_event("guard_retry", attempt=retry + 1)
            tel.guard_checks += 1
            v = self._verify(ck, b, out)
            if v.ok:
                return out, tel
            out, ok = self._corrected(ck, b, out, v, tel)
            if ok:
                return out, tel

        # rung 2: heal the rails, then one more execution at health
        if self.heal and self._heal_rails():
            tel.guard_heals += 1
            self._obs_event("guard_heal",
                            via="watchdog" if self.session is not None
                            else "nominal")
            out = self._reexecute(a, b, count_flags, counter, tel)
            tel.guard_checks += 1
            if self._verify(ck, b, out).ok:
                return out, tel

        # rung 3: policy
        tel.guard_uncorrected += 1
        self._obs_event("guard_uncorrected", policy=self.policy)
        if self.policy == "fail_closed":
            err = GuardError(
                f"unverified product after {self.max_retries} retries "
                f"(mode={self.mode}, heal={self.heal}, "
                f"inner={self.inner.name})")
            if self._obs is not None:
                # hand the black box to the catcher: the flight recorder
                # ring (ending in this escalation) rides on the exception
                err.flight = self._obs.recorder.to_list()
            raise err
        return out, tel

    # -- telemetry ------------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        out = super().summary()
        out["mode"] = self.mode
        out["policy"] = self.policy
        inner = self.inner.summary()
        out["inner"] = inner
        # surface the inner energy accounting at the top level so guarded
        # serving keeps the J/token telemetry consumers expect
        for key in ("energy_per_token_j", "tokens"):
            if key in inner:
                out[key] = inner[key]
        return out


def _make_guarded(inner: Any = "emulated", **kw: Any) -> GuardedBackend:
    return GuardedBackend(inner, **kw)


register_backend("guarded", _make_guarded)
