"""precision_island on Hopper: a matmul in which each output cell computes
at its assigned tier (0 = int4, 1 = int8, 2 = f32), the numerics analogue of
per-partition V_ccint rails.

Replaces the Pallas kernel ``src/repro/kernels/precision_island.py::_kernel``
(wrappers ``_precision_island_call`` / ``precision_island``).  The CUDA
sources are ``csrc/quant_rows.cu`` (the per-row quantization of both
operands, both levels in one pass), ``csrc/precision_island.cu`` (the tier
word, the product pass and the launcher that runs them on one stream) and
``csrc/tc_ring.cuh`` (the tensor-core products and the TMA ring, shared
with ``razor_matmul``).  The tier map plays the role of the voltage map
produced by the static scheme; the runtime ``PrecisionController`` re-tiers
from razor_matmul flags.

What bounds it on an H100: the bytes of ``b``.  The Pallas body computes
all three products for every tile; here a block runs only the products its
cells need, each as its own walk over K on the tensor cores (int8 into
int32 for both integer tiers, bf16 or a 3xTF32 split for the f32 tier), so
on the precision-island path's aligned 128 x 128 cells a block makes one
walk and an integer block streams b's 1-byte copy.  A level the map lacks
is not quantized.  Integer cells are exact int32 products and equal
:func:`precision_island_plain` bit for bit.  The workspace of a shape is
kept across calls on a stream, so the int8 copies' tensor maps are encoded
once a workspace; :func:`release_workspaces` drops the kept ones.

:func:`precision_island` launches the kernels for CUDA tensors (or raises)
and computes :func:`precision_island_plain` for CPU tensors; there is no
other route between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .quant_rows import _DTYPE_CODE, padded_k
from .razor_matmul import _MAX_K
from .ref import precision_island_tiles

#: the product pass's block tile and k-tile, its ring of k-tiles and its
#: threads: four MMA warps and one producer warp (csrc/tc_ring.cuh BM, BN,
#: BK, STAGES, BLOCK); the walks a block can run (csrc/precision_island.cu
#: WALKS): walk w computes tier w, and any tier other than 0 and 1 is f32
TILE_M = TILE_N = TILE_K = 64
STAGES = 4
BLOCK_THREADS = 160
WALKS = ("int4", "int8", "f32")
#: bytes of a float tile row (csrc/tc_ring.cuh ROW): a stage holds a's and
#: b's float tiles, (TILE_M + TILE_N) rows of TILE_K elements, and an int8
#: stage fits inside it
_ROW_BYTES = 128
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}
#: column tiles lie on grid.y, which CUDA limits to 65535
_MAX_GRID_Y = 65535
#: alignment of the pieces of the workspace (csrc/tc_ring.cuh WS_ALIGN)
WS_ALIGN = 256
#: bytes of the int8 copies' four tensor maps a workspace holds (qa4, qb4,
#: qa8, qb8; csrc/precision_island.cu INT_MAPS of 128-byte CUtensorMaps)
_MAPS_BYTES = 4 * 128
#: workspaces kept (one a shape and device stream): the precision-island
#: loop's four weight shapes
_WORKSPACES = 4


class LaunchPlan(NamedTuple):
    """How one call is launched: a one-block pass for the tier word, the
    quantizations of a and b^T, and the product pass's grid of TILE_M x
    TILE_N blocks (row tiles fastest), each walking ``k_tiles`` k-tiles of
    TILE_K in order once for every tier its tile covers, through a ring of
    STAGES stages of ``stage_bytes``; and the one workspace that holds the
    word, the row maxima and both levels' int8 copies and scales."""
    m: int
    n: int
    k: int
    block_m: int
    block_n: int
    kp: int
    k_tiles: int
    row_tiles: int
    col_tiles: int
    stage_bytes: int
    smem_bytes: int

    def workspace_pieces(self) -> Tuple[Tuple[str, int], ...]:
        """(name, bytes) in the order the launcher carves them."""
        m, n, kp = self.m, self.n, self.kp
        return (("word", 4), ("amax_a", 4 * m), ("amax_b", 4 * n),
                ("qa8", m * kp), ("qb8", n * kp), ("qa4", m * kp),
                ("qb4", n * kp), ("scale_a8", 4 * m), ("scale_b8", 4 * n),
                ("scale_a4", 4 * m), ("scale_b4", 4 * n))

    def workspace_bytes(self) -> int:
        return sum(-(-b // WS_ALIGN) * WS_ALIGN
                   for _, b in self.workspace_pieces())


@functools.lru_cache(maxsize=256)
def launch_plan(m: int, n: int, k: int, block_m: int, block_n: int,
                dtype: torch.dtype) -> LaunchPlan:
    """The launch of one (M, K) @ (K, N) call with (block_m x block_n)
    cells and operands of ``dtype`` (cached: the precision-island loop asks
    at the same shapes).  K is walked whole by every walk in ascending
    k-tiles (no split of K), so each tier's summation order depends on K
    and the operands' type alone."""
    if dtype not in _ELEMENT_BYTES:
        raise TypeError(f"precision_island takes float32 or bfloat16; got "
                        f"{dtype}")
    boxes = TILE_K * _ELEMENT_BYTES[dtype] // _ROW_BYTES
    stage = boxes * (TILE_M + TILE_N) * _ROW_BYTES
    return LaunchPlan(m, n, k, block_m, block_n, padded_k(k),
                      -(-k // TILE_K), -(-m // TILE_M), -(-n // TILE_N),
                      stage, STAGES * stage + 1024)


@functools.lru_cache(maxsize=256)
def _workspace_bytes(plan: LaunchPlan) -> int:
    return plan.workspace_bytes()


class _Workspace(NamedTuple):
    """A call's scratch, kept across calls: the workspace tensor, and its
    int8 copies' tensor maps (host memory) and their address."""
    ws: torch.Tensor
    maps: ctypes.Array
    maps_ptr: int


@functools.lru_cache(maxsize=_WORKSPACES)
def _workspace(m: int, n: int, k: int, ws_bytes: int, device: int,
               stream: int) -> _Workspace:
    """The workspace of (M, K) @ (K, N) calls on one device stream: its
    calls run in stream order, so one workspace serves them all, and the
    maps of its int8 copies are encoded once.  Both operand types share it
    (its pieces depend on M, N and K alone).  A workspace dropped from the
    cache goes back to PyTorch's allocator, which hands it out again only in
    that stream's order."""
    lib = _build.load_library()
    ws = torch.empty((ws_bytes,), dtype=torch.uint8,
                     device=torch.device("cuda", device))
    maps = ctypes.create_string_buffer(_MAPS_BYTES)
    err = lib.precision_island_int_maps(ws.data_ptr(), ws_bytes, m, n, k,
                                        maps)
    if err != 0:
        raise RuntimeError(f"precision_island: the int8 copies' tensor maps "
                           f"of a ({m}, {k}) @ ({k}, {n}) workspace failed: "
                           f"CUDA error {err}")
    return _Workspace(ws, maps, ctypes.addressof(maps))


def release_workspaces() -> None:
    """Drop the workspaces kept across calls (the next call allocates its
    own again)."""
    _workspace.cache_clear()


def precision_island_plain(a: torch.Tensor, b: torch.Tensor,
                           tiers: torch.Tensor, *, block_m: int,
                           block_n: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: C f32 (M, N).  Same as
    ``kernels.ref.precision_island`` with independent cell edges; the
    integer products are exact on any device."""
    return precision_island_tiles(a, b, tiers, block_m, block_n)


def _check(a, b, tiers):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"precision_island expects (M, K) @ (K, N); got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"precision_island takes a and b both float32 or both "
                        f"bfloat16; got {a.dtype} and {b.dtype}")
    if tiers.dim() != 2 or tiers.dtype.is_floating_point:
        raise TypeError(f"tiers must be a 2-D integer grid; got {tiers.dtype} "
                        f"{tuple(tiers.shape)}")
    for t in (b, tiers):
        if t.device != a.device:
            raise ValueError(f"precision_island operands lie on different "
                             f"devices: {a.device} and {t.device}")
    if min(*a.shape, b.shape[1], *tiers.shape) == 0:
        raise ValueError(f"precision_island needs non-empty operands; got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}, tiers "
                         f"{tuple(tiers.shape)}")


def precision_island(a: torch.Tensor, b: torch.Tensor, tiers: torch.Tensor,
                     *, block_m: Optional[int] = None,
                     block_n: Optional[int] = None) -> torch.Tensor:
    """Tiered matmul: C f32 (M, N).  Block sizes default to the island shape
    ``tiers`` (gm, gn) implies.

    a: (M, K); b: (K, N), both float32 or both bfloat16, any strides; tiers
    an integer grid on the same device.  CUDA tensors go to the kernel, CPU
    tensors to :func:`precision_island_plain`.
    """
    _check(a, b, tiers)
    (m, k), n = a.shape, b.shape[1]
    gm, gn = tiers.shape
    block_m = m // gm if block_m is None else block_m
    block_n = n // gn if block_n is None else block_n
    if block_m <= 0 or block_n <= 0 or block_m * gm != m or block_n * gn != n:
        raise ValueError(f"tiers ({gm}, {gn}) with cells {block_m}x{block_n} "
                         f"do not tile a ({m}, {n}) output")
    if a.device.type == "cpu":
        return precision_island_plain(a, b, tiers, block_m=block_m,
                                      block_n=block_n)
    if a.device.type != "cuda":
        raise ValueError(f"precision_island has no kernel for device "
                         f"{a.device}")

    plan = launch_plan(m, n, k, block_m, block_n, a.dtype)
    if k > _MAX_K or m * n > 2 ** 62 or plan.col_tiles > _MAX_GRID_Y:
        raise ValueError(f"precision_island: problem ({m}, {k}, {n}) exceeds "
                         f"the kernel's extents")
    lib = _build.load_library()
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):
            return precision_island(a, b, tiers, block_m=block_m,
                                    block_n=block_n)
    dev = a.device
    if tiers.dtype != torch.int32 or not tiers.is_contiguous():
        tiers = tiers.to(torch.int32).contiguous()
    ws_bytes = _workspace_bytes(plan)
    # the raw handle of PyTorch's current stream (as razor_matmul)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    w = _workspace(m, n, k, ws_bytes, dev.index, stream)
    c = torch.empty((m, n), dtype=torch.float32, device=dev)
    err = lib.precision_island_launch(
        a.data_ptr(), b.data_ptr(), tiers.data_ptr(), w.ws.data_ptr(),
        ws_bytes, w.maps_ptr, c.data_ptr(), m, n, k, a.stride(0),
        a.stride(1), b.stride(0), b.stride(1), block_m, block_n,
        _DTYPE_CODE[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"precision_island launch failed: CUDA error {err} "
                           f"for ({m}, {k}) @ ({k}, {n}), cells "
                           f"{block_m}x{block_n}")
    precision_island.launches += 1
    return c


#: kernel launches made by :func:`precision_island` in this process (one per
#: call: the tier word, the quantization prologue and the product together)
precision_island.launches = 0
