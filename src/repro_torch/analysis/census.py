"""Dispatch census: inventory every matrix product and every host
synchronisation of a model call on the serving hot path.

Counterpart of ``repro.analysis.jaxpr``, which walks the closed jaxpr of
each config's prefill / decode step.  PyTorch runs eagerly, so this census
runs each config's ``ModelAPI.prefill`` and ``decode_step`` once, the way
``ServeEngine`` runs them (the same batch shapes, the same backend scope,
int64 token ids on the device), under a ``TorchDispatchMode`` that sees
every aten op, and reports per model call:

* ``backend_gemms`` — GEMMs routed through ``backend.matmul`` to a
  non-ideal backend, counted from the backend's own telemetry (``calls``):
  the counterpart of the reference's ``pure_callbacks``, one a routed GEMM;
* ``kernel_calls`` — calls of each hand-written kernel, by name: its
  wrapper's launch counter on the card, its plain version's calls on the
  CPU (the wrapper's CPU route);
* ``dots`` / ``flops`` / ``dot_dtypes`` — the aten matrix products (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, ``dot``, ...) that run neither inside the
  router nor inside a kernel's plain version: attention, the ideal
  backend's GEMMs, the recurrent decode steps' einsums.  A plain version's
  einsums belong to its kernel (the card's kernel runs none), so the CPU
  and the card give the same structure.  ``flops`` is ``2 * out.numel() *
  K`` per product, the reference's ``dot_general`` estimate;
* ``host_syncs`` — reads from the device that block the host, as the
  dispatcher sees them: ``aten._local_scalar_dense`` (``.item()``,
  ``int(t)``, ``bool(t)``), a copy from a device tensor to the CPU
  (``.tolist()``, ``.cpu()`` and ``.numpy()`` come to this), ops whose
  output size depends on the data (``nonzero``, ``masked_select``, boolean
  indexing, ...), and ``torch.cuda.synchronize`` / ``Event.synchronize`` /
  ``Stream.synchronize``, which the census wraps while it runs.  On the CPU
  the copies and the explicit synchronisations are invisible (the data is
  already on the host), so the CPU's count is a lower bound and
  ``host_syncs`` is a number from the card.  ``host_sync_sites`` names the
  sites by op and the innermost frame of the port's code.

These counts are the worklist of a CUDA-graph capture of the served step:
every host synchronisation blocks it, every routed GEMM is a kernel launch
it would replay.  The pinned CPU counts live in ``census_baseline_torch.json``
(never in ``census_baseline.json``, the JAX package's); :func:`check_census`
fails when a config's ``host_syncs`` rise or its ``backend_gemms``, ``dots``
or ``kernel_calls`` change.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import sys
from collections import Counter
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .._device import DeviceLike, resolve_device

# Small smoke config per family: the census is about *structure* (GEMM, dot
# and sync counts per model call), which smoke shapes share with full ones.
CENSUS_ARCHS: Tuple[str, ...] = (
    "starcoder2-3b",          # dense
    "llama4-scout-17b-a16e",  # moe (shared expert + top-k router)
    "llava-next-mistral-7b",  # vlm
    "rwkv6-1.6b",             # ssm (decode-only prompt absorption)
    "zamba2-2.7b",            # hybrid
    "seamless-m4t-medium",    # encdec
)
#: the backends a census takes by default: the routed one, and the plain
#: ``torch.matmul`` path
CENSUS_BACKENDS: Tuple[str, ...] = ("reference", "ideal")

PROMPT_LEN = 8
SLOTS = 2
MAX_LEN = 32
#: the sync sites a report keeps (the most frequent first)
SYNC_SITES = 8

#: the port's hand-written kernels: (module under ``kernels``, wrapper);
#: each module's plain version is ``<wrapper>_plain``
KERNELS: Tuple[Tuple[str, str], ...] = (
    ("systolic_mac", "systolic_mac"),
    ("razor_matmul", "razor_matmul"),
    ("precision_island", "precision_island"),
    ("wkv6", "wkv6"),
    ("ssd_chunk", "ssd_chunk"),
    ("abft", "abft_checksums"),
)

#: aten matrix products -> the argument index of their left operand, whose
#: last extent is the contraction (``matmul``, ``einsum`` and ``linear`` are
#: composite: they reach the census as these)
_DOTS: Dict[str, int] = {
    "mm": 0, "bmm": 0, "dot": 0, "vdot": 0, "mv": 0,
    "addmm": 1, "baddbmm": 1, "addbmm": 1, "addmv": 1, "addr": 1,
}
#: aten ops whose output size depends on the data (a device read each)
_DATA_SIZED = {"nonzero", "masked_select", "_unique", "_unique2",
               "unique_dim", "unique_consecutive", "unique_dim_consecutive",
               "bincount", "equal", "is_nonzero"}

_MISSING = object()
_PKG = Path(__file__).resolve().parents[1]      # src/repro_torch
_HERE = Path(__file__).resolve().parent         # src/repro_torch/analysis
_TORCH = Path(torch.__file__).resolve().parent


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _site() -> str:
    """The innermost frame of the port's code (outside this package) that
    led to the current op: ``serve/engine.py:522 step``; else the innermost
    frame outside torch and this package."""
    frame = sys._getframe(2)
    fallback = None
    while frame is not None:
        path = Path(frame.f_code.co_filename)
        if not (_is_under(path, _HERE) or _is_under(path, _TORCH)):
            where = f"{frame.f_lineno} {frame.f_code.co_name}"
            if _is_under(path, _PKG):
                return f"{path.relative_to(_PKG).as_posix()}:{where}"
            if fallback is None:
                fallback = f"{path.name}:{where}"
        frame = frame.f_back
    return fallback or "?"


def _is_under(path: Path, root: Path) -> bool:
    try:
        path.relative_to(root)
    except ValueError:
        return False
    return True


class _Tally(TorchDispatchMode):
    """Counts one model call's matrix products (outside the router and the
    kernels' plain versions) and host synchronisations."""

    def __init__(self) -> None:
        super().__init__()
        self.depth = 0              # > 0 inside the router or a plain version
        self.dots = 0
        self.flops = 0
        self.dot_dtypes: Counter = Counter()
        self.syncs: Counter = Counter()     # (op, site) -> count

    def sync(self, op: str) -> None:
        self.syncs[op, _site()] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # a composite op (einsum, matmul, linear, to: what inference mode
        # hands this mode whole) is counted as the ops it runs, the ones
        # that reach the kernels with autograd on or off
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        kind = _sync_kind(name, args, kwargs, out)
        if kind is not None:
            self.sync(kind)
        if self.depth == 0 and name in _DOTS:
            lhs = args[_DOTS[name]]
            res = out if isinstance(out, torch.Tensor) else _tensors(out)[0]
            self.dots += 1
            self.flops += 2 * res.numel() * int(lhs.shape[-1])
            self.dot_dtypes[str(res.dtype).replace("torch.", "")] += 1
        return out


def _sync_kind(name: str, args, kwargs, out) -> Optional[str]:
    """The kind of host synchronisation one aten op makes, else None."""
    if name == "_local_scalar_dense":
        return "aten._local_scalar_dense"
    if name in _DATA_SIZED:
        return f"aten.{name}"
    if name == "index" and any(
            t.dtype == torch.bool for t in _tensors(args[1:])):
        return "aten.index (boolean mask)"
    if name == "repeat_interleave" and isinstance(args[0], torch.Tensor) \
            and kwargs.get("output_size") is None:
        return "aten.repeat_interleave"
    if name in ("_to_copy", "copy_"):
        ins = _tensors(args[1:] if name == "copy_" else args)
        dst = _tensors(args[0] if name == "copy_" else out)
        if any(t.device.type != "cpu" for t in ins) and dst \
                and dst[0].device.type == "cpu":
            return "copy to the host"
    return None


@contextlib.contextmanager
def _watching(tally: _Tally, backend):
    """Inside the block: the router's body (non-ideal backends) and every
    kernel's plain version run at ``tally.depth > 0``; the plain versions'
    calls are counted; the explicit CUDA synchronisations are tallied."""
    plain_calls: Counter = Counter()
    undo: List[Tuple[Any, str, Any]] = []

    def wrap(owner, attr, make):
        inner = getattr(owner, attr)
        undo.append((owner, attr, owner.__dict__.get(attr, _MISSING)))
        setattr(owner, attr, make(inner))

    def nested(inner, count=None):
        def call(*args, **kwargs):
            if count is not None:
                plain_calls[count] += 1
            tally.depth += 1
            try:
                return inner(*args, **kwargs)
            finally:
                tally.depth -= 1
        return call

    def syncing(inner, op):
        def call(*args, **kwargs):
            tally.sync(op)
            return inner(*args, **kwargs)
        return call

    try:
        for mod_name, fn_name in KERNELS:
            mod = importlib.import_module(f"{_PKG.name}.kernels.{mod_name}")
            plain = f"{fn_name}_plain"
            wrap(mod, plain, lambda f, n=fn_name: nested(f, n))
        if backend is not None and not backend.is_ideal:
            wrap(backend, "_run", nested)
        wrap(torch.cuda, "synchronize",
             lambda f: syncing(f, "torch.cuda.synchronize"))
        for cls in (torch.cuda.Event, torch.cuda.Stream):
            wrap(cls, "synchronize",
                 lambda f, c=cls: syncing(f, f"{c.__name__}.synchronize"))
        yield plain_calls
    finally:
        for owner, attr, saved in reversed(undo):
            if saved is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, saved)


def _launches() -> Dict[str, int]:
    """Each kernel's launch counter; a kernel with variants by dtype (the
    bf16 wkv6's ``bf16_launches``) counts them under its one name, as its
    plain version's calls are counted on the CPU."""
    out = {}
    for mod_name, fn_name in KERNELS:
        mod = importlib.import_module(f"{_PKG.name}.kernels.{mod_name}")
        fn = getattr(mod, fn_name)
        out[fn_name] = fn.launches + getattr(fn, "bf16_launches", 0)
    return out


def count_call(fn, backend=None) -> Dict[str, Any]:
    """Run ``fn()`` once under the census and return its counts.
    ``backend`` is the ``MatmulBackend`` the call routes through (its
    telemetry gives ``backend_gemms``; ``None`` for the ideal path)."""
    tally = _Tally()
    calls0 = backend.total.calls if backend is not None else 0
    launches0 = _launches()
    with _watching(tally, backend) as plain_calls, tally:
        fn()
    launched = {k: v - launches0[k] for k, v in _launches().items()}
    kernel_calls = {k: plain_calls[k] + launched[k] for k in launched
                    if plain_calls[k] + launched[k]}
    sites = Counter()
    for (op, site), n in tally.syncs.items():
        sites[f"{op} @ {site}"] += n
    return {
        "backend_gemms": (backend.total.calls - calls0
                          if backend is not None else 0),
        "kernel_calls": dict(sorted(kernel_calls.items())),
        "dots": tally.dots, "flops": tally.flops,
        "dot_dtypes": dict(sorted(tally.dot_dtypes.items())),
        "host_syncs": sum(tally.syncs.values()),
        "host_sync_sites": [{"site": s, "count": n}
                            for s, n in sites.most_common(SYNC_SITES)],
    }


# ---- per-config runs --------------------------------------------------------


def census_config(arch: str, backend: str = "reference", *,
                  device: DeviceLike = None) -> Dict[str, Any]:
    """One smoke config's prefill and decode step, run the way
    ``ServeEngine`` runs them, each under the census.  Weights are random,
    from seed 0."""
    from ..configs import get_config
    from ..configs.base import ShapeConfig
    from ..models.api import model_api

    dev = resolve_device(device)
    cfg = get_config(arch, smoke=True)
    api = model_api(cfg, backend=backend, device=dev)
    be = None if api.backend.is_ideal else api.backend
    params = api.init_params(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def tokens(b: int, s: int) -> torch.Tensor:
        return torch.randint(3, cfg.vocab_size, (b, s), generator=gen,
                             device=dev, dtype=torch.int64)

    state = api.make_decode_state(ShapeConfig("census", MAX_LEN, SLOTS,
                                              "decode"))
    step_tokens = tokens(SLOTS, 1)
    report: Dict[str, Any] = {
        "arch": arch, "family": cfg.family, "backend": backend,
        "decode": count_call(
            lambda: api.decode_step(params, state, step_tokens), be),
    }
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        batch = {"tokens": tokens(1, PROMPT_LEN)}
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (1, MAX_LEN // cfg.enc_frames_ratio, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        report["prefill"] = count_call(
            lambda: api.prefill(params, batch, max_len=MAX_LEN), be)
    else:
        report["prefill"] = None  # SSM/hybrid absorb prompts via decode_step
    return report


def census(archs: Iterable[str] = CENSUS_ARCHS,
           backends: Sequence[str] = CENSUS_BACKENDS, *,
           device: DeviceLike = None) -> Dict[str, Any]:
    """Every config of ``archs`` on every backend of ``backends``."""
    dev = resolve_device(device)
    archs = list(archs)
    return {
        "version": 1,
        "device": dev.type,
        "slots": SLOTS,
        "max_len": MAX_LEN,
        "prompt_len": PROMPT_LEN,
        "backends": {
            be: {"configs": {a: census_config(a, be, device=dev)
                             for a in archs}}
            for be in backends},
    }


# ---- CI gate ----------------------------------------------------------------

#: fields pinned exactly
PINNED = ("backend_gemms", "dots", "kernel_calls")


def check_census(current: Dict[str, Any],
                 baseline: Dict[str, Any]) -> List[str]:
    """Violations (empty list = gate passes).

    ``host_syncs`` may only *fall* relative to the baseline (the CUDA-graph
    work drives them to zero); a drop is reported by :func:`census_advice`,
    not here.  ``backend_gemms``, ``dots`` and ``kernel_calls`` are pinned
    exactly — a change means the model graph or its routing changed and the
    baseline must be regenerated deliberately.  A backend or config missing
    from ``current``, or a model call that appears or disappears, fails."""
    problems: List[str] = []
    for be, base_run in baseline.get("backends", {}).items():
        cur_run = current.get("backends", {}).get(be)
        if cur_run is None:
            problems.append(f"{be}: backend missing from current census")
            continue
        for arch, base_cfg in base_run.get("configs", {}).items():
            cur_cfg = cur_run.get("configs", {}).get(arch)
            if cur_cfg is None:
                problems.append(f"{be}/{arch}: missing from current census")
                continue
            for phase in ("prefill", "decode"):
                base, cur = base_cfg.get(phase), cur_cfg.get(phase)
                where = f"{be}/{arch}.{phase}"
                if base is None and cur is None:
                    continue
                if (base is None) != (cur is None):
                    problems.append(f"{where}: presence changed "
                                    f"(baseline={base is not None}, "
                                    f"current={cur is not None})")
                    continue
                if cur["host_syncs"] > base["host_syncs"]:
                    problems.append(
                        f"{where}: host_syncs rose {base['host_syncs']} -> "
                        f"{cur['host_syncs']} — a new device read landed on "
                        f"the hot path")
                for key in PINNED:
                    if cur[key] != base[key]:
                        problems.append(
                            f"{where}: {key} changed {base[key]} -> "
                            f"{cur[key]} — regenerate the baseline if the "
                            f"model graph change is intentional")
    return problems


def census_advice(current: Dict[str, Any],
                  baseline: Dict[str, Any]) -> List[str]:
    """The calls whose ``host_syncs`` fell below their pin (a stale pin:
    repin with ``census --write-baseline``)."""
    out = []
    for be, base_run in baseline.get("backends", {}).items():
        cur_run = current.get("backends", {}).get(be, {})
        for arch, base_cfg in base_run.get("configs", {}).items():
            cur_cfg = cur_run.get("configs", {}).get(arch, {})
            for phase in ("prefill", "decode"):
                base, cur = base_cfg.get(phase), cur_cfg.get(phase)
                if base and cur and cur["host_syncs"] < base["host_syncs"]:
                    out.append(f"{be}/{arch}.{phase}: host_syncs fell "
                               f"{base['host_syncs']} -> {cur['host_syncs']}")
    return out


def load_census(path: Path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())


def write_census(report: Dict[str, Any], path: Path) -> None:
    Path(path).write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
