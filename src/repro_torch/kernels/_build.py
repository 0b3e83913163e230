"""Build and load the port's CUDA kernels.

``csrc/*.cu`` are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with ``ctypes``.  The library is
built at first use into ``build/repro_torch/`` at the root of the checkout,
named by a hash of the sources and the compile flags, from the sources in
the package and nothing else.  Every source is compiled by its own ``nvcc``
process, all started together, and the objects are linked in one step.

There is no second way to get a kernel: where ``nvcc`` is missing or a
compile fails, :func:`load_library` raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelCompileError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_seconds: Optional[float] = None
_build_log: str = ""


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's standard place."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelCompileError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of repro_torch cannot be "
        "built, and there is no other implementation for CUDA tensors")


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, srcs: List[Path], lib_path: Path) -> str:
    """Compile every source in parallel, link, and move the library into
    place atomically.  Returns the compiler's output."""
    tag = f"{lib_path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    log, failed = [], []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        log.append(f"--- nvcc {s.name} (exit {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(s.name)
    tmp = BUILD_DIR / f"{tag}.so"
    try:
        if failed:
            raise KernelCompileError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"--- link (exit {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise KernelCompileError("linking the kernel library failed:\n"
                                   + "\n".join(log))
        os.replace(tmp, lib_path)
    finally:
        for f in objs + [tmp]:
            if f.exists():
                f.unlink()
    return "\n".join(log)


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use.  Raises
    :class:`KernelCompileError` when it cannot be built."""
    global _lib, _build_seconds, _build_log
    if _lib is not None:            # every launch asks: no lock once loaded
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        if not srcs:
            raise KernelCompileError(f"no CUDA sources under {CSRC_DIR}")
        lib_path = BUILD_DIR / f"libkernels_{_digest(srcs)}.so"
        t0 = time.monotonic()
        if not lib_path.exists():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _build_log = _compile(nvcc, srcs, lib_path)
        _build_seconds = time.monotonic() - t0
        lib = ctypes.CDLL(str(lib_path))
        _declare(lib)
        _lib = lib
        return lib


def build_seconds() -> Optional[float]:
    """Seconds the first :func:`load_library` of this process spent finding
    or building the library (``None`` before it)."""
    return _build_seconds


def build_log() -> str:
    """``nvcc``'s output of this process's build (``-Xptxas -v`` register
    and shared-memory use per kernel); empty when the library was cached."""
    return _build_log


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes/restype of every exported launcher (pointers and the stream
    as ``c_void_p``: a bare Python int would be cut to 32 bits)."""
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.systolic_mac_launch.argtypes = [
        p, p, p, p, p, p, p,        # a, b, v_map, v_safe, c, flags, count
        i, i, i,                    # zero_count, splits, rows
        i, i, i,                    # M, N, K
        ll, ll, ll, ll,             # strides of a (m, k) and b (k, n)
        i, i, i, i,                 # block_m, block_n, keep_bits, dtype
        p]                          # stream
    lib.systolic_mac_launch.restype = ctypes.c_int
    lib.quant_rows_launch.argtypes = [
        p, i, i, i,                 # x, R, K, Kp
        ll, ll, f, i,               # strides of x (r, k), levels, dtype
        p, p, p,                    # amax scratch, q, scale
        p]                          # stream
    lib.quant_rows_launch.restype = ctypes.c_int
    lib.razor_matmul_launch.argtypes = [
        p, p, p, ll,                # a, b, workspace, its bytes
        p, p, p, p,                 # c, flags, rel, count
        i, i, i,                    # M, N, K
        ll, ll, ll, ll,             # strides of a (m, k) and b (k, n)
        i, i, i, f, i,              # block_m, block_n, slices, tol, dtype
        p]                          # stream
    lib.razor_matmul_launch.restype = ctypes.c_int
    lib.precision_island_int_maps.argtypes = [
        p, ll,                      # workspace, its bytes
        i, i, i,                    # M, N, K
        p]                          # the maps (host memory)
    lib.precision_island_int_maps.restype = ctypes.c_int
    lib.precision_island_launch.argtypes = [
        p, p, p, p, ll,             # a, b, tiers, workspace, its bytes
        p, p,                       # the workspace's int8 maps, c
        i, i, i,                    # M, N, K
        ll, ll, ll, ll,             # strides of a (m, k) and b (k, n)
        i, i, i,                    # block_m, block_n, dtype
        p]                          # stream
    lib.precision_island_launch.restype = ctypes.c_int
    lib.wkv6_launch.argtypes = [
        p, p, p, p,                 # r, k, v, w_log
        *[ll] * 12,                 # strides (b, s, h) of r, k, v, w_log
        p, p, p, p,                 # u, state, y, state_out
        p, ll,                      # workspace, its floats
        i, i, i, i, i,              # B, S, H, P, chunk
        p]                          # stream
    lib.wkv6_launch.restype = ctypes.c_int
    lib.wkv6_bf16_launch.argtypes = lib.wkv6_launch.argtypes
    lib.wkv6_bf16_launch.restype = ctypes.c_int
    lib.wkv6_passes_launch.argtypes = lib.wkv6_launch.argtypes
    lib.wkv6_passes_launch.restype = ctypes.c_int
    lib.wkv6_bf16_passes_launch.argtypes = lib.wkv6_launch.argtypes
    lib.wkv6_bf16_passes_launch.restype = ctypes.c_int
    lib.wkv6_bwd_launch.argtypes = [
        p, p, p,                    # r, k, v
        *[ll] * 9,                  # strides (b, s, h) of r, k, v
        p, p, p,                    # u, dy, dS_final (or null)
        p, p, ll,                   # forward's workspace, scratch, its floats
        p, p, p, p, p, p,           # dr, dk, dv, dw, du, dstate
        i, i, i, i, i,              # B, S, H, P, chunk
        p]                          # stream
    lib.wkv6_bwd_launch.restype = ctypes.c_int
    lib.wkv6_bwd_bf16_launch.argtypes = lib.wkv6_bwd_launch.argtypes
    lib.wkv6_bwd_bf16_launch.restype = ctypes.c_int
    lib.ssd_chunk_launch.argtypes = [
        p, p, p, p, p, p,           # x, dt, A_log, B, C, D
        p, p, p,                    # state, y, state_out
        p, p,                       # states and cum scratch
        ll, ll, ll, ll, ll, ll,     # strides (b, s, h) of x and dt
        ll, ll, ll, ll,             # strides (b, s) of B and C
        i, i, i, i, i, i,           # B, S, H, P, N, chunk
        i,                          # heads_per_block
        p]                          # stream
    lib.ssd_chunk_launch.restype = ctypes.c_int
    lib.ssd_chunk_bwd_launch.argtypes = [
        p, p, p, p, p, p,           # x, dt, A_log, B, C, D
        p, p,                       # dy, dS_final (or null)
        p, p,                       # the forward's states and cum
        p, ll,                      # scratch, its floats
        p, p, p, p, p, p, p,        # dx, ddt, dA_log, dB, dC, dD, dstate
        i, i, i, i, i, i,           # B, S, H, P, N, chunk
        i,                          # heads_per_block
        p]                          # stream
    lib.ssd_chunk_bwd_launch.restype = ctypes.c_int
    lib.abft_checksums_launch.argtypes = [
        p,                          # the call's fixed Args (by address)
        p, p, p, p,                 # x, P, Q, a
        p, p, p, p,                 # Yr's, Yc's and a's outputs, a's partials
        p]                          # stream
    lib.abft_checksums_launch.restype = ctypes.c_int
    lib.abft_verdict_launch.argtypes = [
        p, i, i, ll, ll, i,         # out, M, N, its strides, dtype
        p, ll,                      # checks (2, M + N), its row stride
        p, p, p,                    # partials, ticket, the verdict
        p]                          # stream
    lib.abft_verdict_launch.restype = ctypes.c_int
