"""The `repro_torch.backend` execution protocol: one matmul contract over
every fidelity level of the voltage-scaled array.

    out, telemetry = backend.matmul(a, b, precision="f32", count_flags=True)

with a string-keyed registry (``get_backend("reference")``) and a
context-manager / ``set_default`` scoping API, so the *same* model code runs
its GEMMs on the ideal library path or through the ``systolic_mac`` kernel —
selectable per serve engine or per ``with use_backend(...)`` block.
Counterpart of ``repro.backend.base``; the ``simulated`` and ``emulated``
targets are not ported yet.

Contract highlights (``tests/test_torch_backend.py`` pins these against the
JAX package):

* ``precision=None`` (native) keeps the inputs' promoted dtype;
  ``precision="f32"`` computes/returns float32; ``precision="int8"``
  quantizes both operands through the **shared** quantizer below, runs the
  exact integer product on the backend, and dequantizes in shared float32
  code — so the int8 path is bit-identical across backends by construction.
* At nominal rails every backend computes the exact product: ``ideal`` and
  ``reference`` are bit-identical on reduction-order-independent inputs, and
  telemetry shows zero flags.
* :func:`matmul` (the model-facing router) runs eagerly where the tensors
  lie: the ideal backend is a plain ``torch.matmul``; every other backend
  gets the flattened (M, K) problem.  Nothing crosses to the host: flag
  counts stay on the device and are read once per ``pop_telemetry()`` /
  ``summary()``, not once per GEMM.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..obs.serialize import to_plain


def ensure_host_callback_capacity() -> bool:
    """Kept so launch code reads like the JAX package's: there it guards a
    host-callback deadlock on single-core hosts.  PyTorch runs eagerly and
    has no host callback, so this does nothing and returns ``False``."""
    return False


#: Precision tiers of the protocol.  ``None`` means "native" (keep the
#: inputs' promoted dtype).
PRECISIONS: Tuple[Optional[str], ...] = (None, "f32", "int8")


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BackendTelemetry:
    """Observables of one (or an accumulation of) backend matmul call(s).

    ``flags`` counts partitions whose Razor flag fired (summed over calls);
    ``partition_flags`` is the per-partition OR across the accumulated calls
    (``None`` for backends without a partition notion).  ``energy_j`` is the
    emulated accelerator's ledger delta (0.0 elsewhere).
    """

    calls: int = 0
    macs: int = 0
    flags: int = 0
    replays: int = 0
    silent: int = 0
    energy_j: float = 0.0
    rel_error: float = 0.0          # max over the accumulated calls
    partition_flags: Optional[List[bool]] = None
    # ABFT guard counters (a guarded backend's; zero elsewhere)
    guard_checks: int = 0           # verifications run
    guard_detected: int = 0         # calls whose first verification failed
    guard_corrected: int = 0        # single-element locate-and-correct wins
    guard_retries: int = 0          # bounded re-executions
    guard_heals: int = 0            # rail heals (watchdog / nominal fallback)
    guard_uncorrected: int = 0      # mismatches surviving the ladder (fail_open)

    def merge(self, other: "BackendTelemetry") -> None:
        self.calls += other.calls
        self.macs += other.macs
        self.flags += other.flags
        self.replays += other.replays
        self.silent += other.silent
        self.energy_j += other.energy_j
        self.guard_checks += other.guard_checks
        self.guard_detected += other.guard_detected
        self.guard_corrected += other.guard_corrected
        self.guard_retries += other.guard_retries
        self.guard_heals += other.guard_heals
        self.guard_uncorrected += other.guard_uncorrected
        self.rel_error = max(self.rel_error, other.rel_error)
        if other.partition_flags is not None:
            if self.partition_flags is None:
                self.partition_flags = [bool(f) for f in other.partition_flags]
            else:
                self.partition_flags = [
                    bool(a or b) for a, b in
                    zip(self.partition_flags, other.partition_flags)]

    def to_dict(self) -> Dict[str, Any]:
        """Plain-JSON snapshot via the one shared telemetry serializer
        (``repro_torch.obs.to_plain``) — field order pinned by the dataclass
        declaration."""
        return to_plain(self)


# ---------------------------------------------------------------------------
# Shared int8 path (one definition for every backend)
# ---------------------------------------------------------------------------


def quantize_sym_i8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization, float32 throughout,
    round-half-even (``torch.round`` rounds as ``numpy.round`` does).

    One quantizer for every backend, in torch ops on the tensor's own
    device: the int8 parity guarantee."""
    xf = torch.as_tensor(x).to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _out_dtype(a_dtype: torch.dtype, b_dtype: torch.dtype,
               precision: Optional[str]) -> torch.dtype:
    if precision == "f32":
        return torch.float32
    res = torch.promote_types(a_dtype, b_dtype)
    if not res.is_floating_point or res == torch.float64:
        return torch.float32             # exact accumulation of int inputs
    return res


# ---------------------------------------------------------------------------
# Protocol
# ---------------------------------------------------------------------------


class _Routed(torch.autograd.Function):
    """Forward through a backend, backward through exact products: the
    straight-through treatment for training through injected faults."""

    @staticmethod
    def forward(ctx, a, b, backend):
        ctx.save_for_backward(a, b)
        return backend._route(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return ((g @ b.T).to(a.dtype), (a.T @ g).to(b.dtype), None)


class MatmulBackend:
    """Base class of the execution-backend protocol.

    Subclasses implement :meth:`_execute` — the exact-semantics matmul (plus
    whatever fault injection their fidelity level models) on the tensors
    where they lie — and the base class supplies the precision pipeline,
    telemetry accumulation and the model-routing entry point.

    ``device`` is where host data handed to :meth:`matmul` is put; ``None``
    means the GPU and raises where there is none.
    """

    name: str = "backend"
    #: The ideal backend routes as a plain ``torch.matmul``.
    is_ideal: bool = False
    #: True only for a guarded (ABFT) backend — the serve engine uses it to
    #: surface per-step guard telemetry.
    is_guarded: bool = False

    def __init__(self, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.total = BackendTelemetry()
        self._pending = BackendTelemetry()
        self._deferred_flags: Optional[torch.Tensor] = None
        self._obs = None            # ObsBus, when a serve engine attaches
        self._obs_cb_hist = None    # per-GEMM host-side histogram

    def attach_obs(self, bus) -> None:
        """Attach a ``repro_torch.obs.ObsBus``: every :meth:`matmul` and
        every routed model GEMM is timed into a
        ``backend_callback_seconds{backend=...}`` histogram.  The name is the
        JAX package's, where it timed a host callback's round trip; here it
        times the *host side* of one GEMM — argument checks, allocation and
        the kernel launch, not the kernel's completion on the device."""
        self._obs = bus
        self._obs_cb_hist = bus.registry.histogram(
            "backend_callback_seconds",
            "host-side service time of one backend GEMM callback (s)",
            labels=("backend",)).labels(backend=self.name)

    # -- subclass hook --------------------------------------------------------

    def _execute(self, a: torch.Tensor, b: torch.Tensor, count_flags: bool
                 ) -> Tuple[torch.Tensor, BackendTelemetry,
                            Optional[torch.Tensor]]:
        """Exact-product (M, K) @ (K, N) on this backend's machinery.

        Returns the (possibly fault-injected) product in the backend's
        working precision, single-call telemetry, and — when the flag count
        of this call still lies on the device — that count as a 0-d integer
        tensor (``None`` when ``telemetry.flags`` is already final)."""
        raise NotImplementedError

    # -- the protocol ---------------------------------------------------------

    def _run(self, a: torch.Tensor, b: torch.Tensor,
             precision: Optional[str], count_flags: bool):
        if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(
                f"matmul expects (M, K) @ (K, N); got {tuple(a.shape)} @ "
                f"{tuple(b.shape)}")
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}; "
                             f"known: {PRECISIONS}")
        if a.device != b.device:
            raise ValueError(f"matmul operands lie on different devices: "
                             f"{a.device} and {b.device}")
        out_dtype = _out_dtype(a.dtype, b.dtype, precision)
        t0 = self._obs.clock() if self._obs is not None else None
        if precision == "int8":
            qa, sa = quantize_sym_i8(a)
            qb, sb = quantize_sym_i8(b.T)             # per-column scales of b
            prod, tel, dev_flags = self._execute(
                qa.to(torch.float32), qb.T.to(torch.float32), count_flags)
            # shared float32 dequant: bit-identical across backends given the
            # exact integer product each backend guarantees
            out = prod.to(torch.float32) * sa * sb.T
        else:
            raw, tel, dev_flags = self._execute(a, b, count_flags)
            out = raw.to(out_dtype)
        if not count_flags:
            tel = dataclasses.replace(tel, flags=0, partition_flags=None)
            dev_flags = None
        if t0 is not None:
            self._obs_cb_hist.observe(self._obs.clock() - t0)
        return out, tel, dev_flags

    def _as_operand(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(x, device=self.device)

    def matmul(self, a, b, *, precision: Optional[str] = None,
               count_flags: bool = True
               ) -> Tuple[torch.Tensor, BackendTelemetry]:
        """Execute ``a @ b`` at the given precision tier.

        Takes tensors (used where they lie) or host arrays (put on the
        backend's device).  The caller asked for this call's telemetry, so
        its flag count is read back here (one synchronisation on a GPU);
        model GEMMs go through :func:`matmul` instead, which defers it.
        Telemetry is returned AND accumulated on the backend
        (``pop_telemetry`` drains it)."""
        out, tel, dev_flags = self._run(self._as_operand(a),
                                        self._as_operand(b), precision,
                                        count_flags)
        if dev_flags is not None:
            tel = dataclasses.replace(tel, flags=int(dev_flags))
        self._record(tel)
        return out, tel

    # -- model routing --------------------------------------------------------

    def _route(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out, tel, dev_flags = self._run(a, b, None, True)
        if dev_flags is not None:
            self._deferred_flags = (dev_flags.to(torch.int64)
                                    if self._deferred_flags is None else
                                    self._deferred_flags + dev_flags)
        self._record(tel)
        return out

    def traced_matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` routed through this backend from model code.

        Differentiable with **ideal-path gradients**: the forward product
        carries this backend's fault injection while the backward pass uses
        exact products — the standard straight-through treatment for
        training through injected hardware faults.  (The name is the JAX
        package's, where the call crossed to the host from traced code.)"""
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _Routed.apply(a, b, self)
        return self._route(a, b)

    # -- telemetry ------------------------------------------------------------

    def _record(self, tel: BackendTelemetry) -> None:
        self.total.merge(tel)
        self._pending.merge(tel)

    def _settle_flags(self) -> None:
        """Read the flag counts still on the device (one synchronisation)
        and fold them into the host telemetry."""
        if self._deferred_flags is None:
            return
        n = int(self._deferred_flags)
        self._deferred_flags = None
        self.total.flags += n
        self._pending.flags += n

    def pop_telemetry(self) -> BackendTelemetry:
        """Drain the telemetry accumulated since the last pop (the serve
        engine's per-decode-step payload); totals keep everything."""
        self._settle_flags()
        out, self._pending = self._pending, BackendTelemetry()
        return out

    def add_tokens(self, n: int) -> None:
        """Attribute ``n`` served tokens to this backend's energy accounting
        (a no-op unless the backend owns an energy ledger)."""

    def summary(self) -> Dict[str, Any]:
        """Plain-JSON lifetime telemetry (EngineStats' backend payload)."""
        self._settle_flags()
        return {"backend": self.name, **self.total.to_dict()}

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r} on {self.device}>"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., MatmulBackend]] = {}


def register_backend(name: str, factory: Callable[..., MatmulBackend]
                     ) -> Callable[..., MatmulBackend]:
    """Make a backend constructible by name via :func:`get_backend`."""
    _REGISTRY[name] = factory
    return factory


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


def get_backend(spec: Any, **kw: Any) -> MatmulBackend:
    """Resolve a backend: an instance passes through; a registered name is
    constructed fresh with ``**kw`` (``device=`` among them) forwarded to its
    factory."""
    if isinstance(spec, MatmulBackend):
        if kw:
            raise ValueError("keyword options only apply when constructing "
                             "a backend by name")
        return spec
    try:
        factory = _REGISTRY[spec]
    except (KeyError, TypeError):
        raise KeyError(f"unknown backend {spec!r}; known: "
                       f"{available_backends()}") from None
    return factory(**kw)


# ---------------------------------------------------------------------------
# Scoping: default + context manager
# ---------------------------------------------------------------------------

_DEFAULT: Optional[MatmulBackend] = None      # unset routes as "ideal"
_STACK: List[MatmulBackend] = []


def current_backend() -> MatmulBackend:
    """The backend model GEMMs route through right now (the innermost
    ``use_backend`` scope, else the installed default, else a fresh
    ``ideal`` on the GPU)."""
    if _STACK:
        return _STACK[-1]
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = get_backend("ideal")
    return _DEFAULT


def set_default(spec: Any, **kw: Any) -> MatmulBackend:
    """Install the process-wide default backend (outside any
    ``use_backend`` scope).  Returns the resolved instance."""
    global _DEFAULT
    _DEFAULT = get_backend(spec, **kw)
    return _DEFAULT


@contextlib.contextmanager
def use_backend(spec: Any, **kw: Any):
    """Scope the active backend: every :func:`matmul` (and hence every model
    GEMM) inside the block routes through it.  PyTorch runs eagerly, so the
    binding takes effect at once and ends with the block."""
    be = get_backend(spec, **kw)
    _STACK.append(be)
    try:
        yield be
    finally:
        _STACK.pop()


# ---------------------------------------------------------------------------
# Model-facing router
# ---------------------------------------------------------------------------


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense GEMM through the active backend.  ``a``: (..., K); ``b``: (K, N).

    With no backend scoped or installed, and on the ideal backend, this IS
    ``torch.matmul(a, b)``; any other backend receives the flattened (M, K)
    problem.
    """
    be = _STACK[-1] if _STACK else _DEFAULT
    if be is None or be.is_ideal:
        return torch.matmul(a, b)
    lead = a.shape[:-1]
    out = be.traced_matmul(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*lead, b.shape[-1])


def largest_common_block(m: int, n: int,
                         prefs: Tuple[int, ...] = (128, 64, 32, 16, 8, 4, 2, 1)
                         ) -> int:
    """Largest preferred tile edge dividing both axes (reference backend's
    flag-grid block)."""
    g = math.gcd(m, n)
    for b in prefs:
        if g % b == 0:
            return b
    return 1
