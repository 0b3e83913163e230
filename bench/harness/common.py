"""What a driver is handed and what it hands back, and the device checks
every run makes."""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

#: top-level module names that may not be loaded when a run ends (the JAX
#: package of this repo and JAX itself): compared whole, so ``repro_torch``
#: is not ``repro``
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Check:
    """One number of the correctness comparison beside its limit; the run
    is correct when every value is at or below its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Context:
    cell: str
    seed: int
    seconds: float
    trace: bool
    conf: Dict[str, Any]          # the configuration file
    traffic: Dict[str, Any]       # the traffic file (at the run's size)
    limits: Dict[str, float]      # the cell's correctness limits
    sample: int                   # outputs the check compares
    cfg: Any                      # repro_torch ModelConfig
    device: Any                   # torch.device
    t_start: float                # the process's start (perf_counter)
    trace_seconds: float = 3.0    # length of the traced slice
    backend: str = "reference"


@dataclasses.dataclass
class Record:
    """What one run measured.  ``e2e`` holds the end-to-end candidates by
    name; ``calls_in_slice`` lists the model calls of the traced slice
    (``("decode", rows)``, ``("prefill", n)``, ``("loss", b, s)``,
    ``("train", b, s)``) for the yardstick."""
    kind: str
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    e2e: Dict[str, float]
    flops_in_window: float
    memory_peak_bytes: int
    checks: List[Check]
    spans: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Any = None
    calls_in_slice: List[Tuple] = dataclasses.field(default_factory=list)
    yard: Any = None


def build_context(cell: str, seed: int, seconds: float, trace: bool = False,
                  smoke: bool = False, device: Any = None,
                  t_start: Optional[float] = None) -> Context:
    """The context of one run of ``cell``: its files read by name, at the
    cell's size, or with ``smoke`` at the CPU tests' size (the
    configuration's smoke preset and the traffic's ``smoke`` entries)."""
    import torch
    from . import manifest as mf
    entry = mf.workload_entry(mf.load_manifest(), cell)
    conf = mf.load_config(entry["config"])
    traffic = mf.load_traffic(entry["traffic"])
    if smoke:
        traffic = mf.smoke_traffic(traffic)
    spec = mf.load_cell(cell)
    return Context(
        cell=cell, seed=int(seed), seconds=float(seconds), trace=trace,
        conf=conf, traffic=traffic, limits=mf.limits_of(spec),
        sample=int(spec["sample"]), cfg=mf.model_config(conf, smoke=smoke),
        device=torch.device("cuda", 0) if device is None else device,
        t_start=time.perf_counter() if t_start is None else t_start,
        trace_seconds=float(traffic.get("trace_seconds", 3.0)),
        backend=conf.get("backend", "reference"))


def driver(ctx: Context):
    """The traffic's driver module (``bench/drivers/<driver>.py``)."""
    from .manifest import load_module
    return load_module("drivers", ctx.traffic["driver"])


def setup_environment(root) -> None:
    """Caches at fixed paths inside the checkout, no JAX behind any
    library, and the checkout's ``src`` and root importable."""
    import os
    from pathlib import Path
    root = Path(root)
    cache = root / "build" / "bench-cache"
    for key, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[key] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the scripts' own folder is no package root: bench's modules are
    # imported as bench.<...> from the checkout's root
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != root / "bench"]
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def require_cuda(chips: int) -> None:
    """Exit (code 2, no result) unless ``chips`` CUDA devices are there."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the benchmark measures the port on an "
                 "NVIDIA GPU and has no other route")
    if torch.cuda.device_count() < chips:
        sys.exit(f"the cell asks for {chips} CUDA devices and "
                 f"{torch.cuda.device_count()} are there")


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: the
    process's loaded modules)."""
    names = list(sys.modules if modules is None else modules)
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def free_device() -> None:
    """Give the allocator's cached blocks back after the program's state
    is dropped."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def reset_peak(device) -> None:
    """Start the peak of device memory afresh: ``memory_peak_bytes`` is
    the peak from the window's start on (set-up's own reads, such as the
    train cell's copy of the first weights, are left out)."""
    import torch
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    import torch
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def reference_precision() -> None:
    """Plain float32 for the reference: no TF32 in any product."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
