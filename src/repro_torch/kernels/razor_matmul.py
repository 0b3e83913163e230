"""razor_matmul on Hopper: the Razor double-sampled matmul (the paper's
runtime timing sensor as one GEMM).

Replaces the Pallas kernel ``src/repro/kernels/razor_matmul.py::_kernel``
(wrappers ``_razor_matmul_call`` / ``razor_matmul``).  The CUDA sources are
``csrc/quant_rows.cu`` (the per-row int8 quantization of A's rows and B's
columns, once per operand) and ``csrc/razor_matmul.cu`` (the product and
cell passes, and the launcher that runs all of them on one stream).

Main path = int8 x int8 -> int32 (the cheap near-threshold path); shadow
path = f32 (the delayed shadow register).  Per partition cell the kernel
emits a mismatch flag (relative Frobenius error > tol) and — like Razor's
replay — *corrects* flagged cells to the shadow value.  The flags feed
``core.precision.PrecisionController`` (Algorithm 2 on precision tiers).

What bounds it on an H100: the tensor cores (2MNK in bf16 or 3xTF32, 2MNK
in int8) and the bytes of ``b``.  Both products run on the tensor cores:
the integer one in int8 into int32 (exact, as the oracle's int32 product,
so a main-path cell equals :func:`razor_matmul_plain` bit for bit; the
Pallas body multiplies the integer values in f32, which stops being exact
once partial sums pass 2^24), the shadow in bf16 for bf16 operands (both by
warpgroup MMAs, ``wgmma``) and by a 3xTF32 split for f32 ones (both by
``mma.sync``).  One producer warp streams the operands and their int8
copies into a ring of k-tiles by tensor-map TMA while four warps multiply
(:func:`launch_plan` holds the tile sizes, the grid, the cell slices and
the one workspace a call allocates).

:func:`razor_matmul` launches the kernels for CUDA tensors (or raises) and
computes :func:`razor_matmul_plain` for CPU tensors; there is no other route
between the two.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .quant_rows import _DTYPE_CODE, padded_k
from .ref import razor_matmul_tiles
from .tuning import select_blocks

_INT_MAX = 2 ** 31 - 1
#: the int32 accumulator holds K * 127^2 while K stays below this
_MAX_K = _INT_MAX // 127 ** 2

#: the product pass's block tile and k-tile (csrc/razor_matmul.cu BM, BN,
#: BK), its ring of k-tiles (STAGES), and its threads: four MMA warps and
#: one producer warp (BLOCK)
TILE_M = TILE_N = TILE_K = 64
STAGES = 4
BLOCK_THREADS = 160
#: column tiles lie on grid.y, which CUDA limits to 65535
_MAX_GRID_Y = 65535
#: the cell passes: a cell is cut into slices of about CELL_SLICE elements,
#: at most MAX_SLICES (csrc/razor_matmul.cu MAX_SLICES)
CELL_SLICE = 2048
MAX_SLICES = 64
#: alignment of the pieces of the workspace (csrc/razor_matmul.cu WS_ALIGN)
WS_ALIGN = 256


class LaunchPlan(NamedTuple):
    """How one call is launched: the product pass's grid of TILE_M x TILE_N
    blocks (row tiles fastest) walking ``k_tiles`` k-tiles of TILE_K in
    order, the (cell, slice) grids of the two cell passes, and the one
    workspace that holds the int8 copies, scales, row maxima, the main and
    shadow planes and the cell partial sums."""
    m: int
    n: int
    k: int
    block_m: int
    block_n: int
    kp: int
    k_tiles: int
    row_tiles: int
    col_tiles: int
    cells: int
    slices: int

    def workspace_pieces(self) -> Tuple[Tuple[str, int], ...]:
        """(name, bytes) in the order the launcher carves them."""
        m, n, kp = self.m, self.n, self.kp
        return (("qa", m * kp), ("qb", n * kp), ("scale_a", 4 * m),
                ("scale_b", 4 * n), ("amax_a", 4 * m), ("amax_b", 4 * n),
                ("main", 4 * m * n), ("shadow", 4 * m * n),
                ("partial", 8 * self.cells * self.slices))

    def workspace_bytes(self) -> int:
        return sum(-(-b // WS_ALIGN) * WS_ALIGN
                   for _, b in self.workspace_pieces())

    def slice_ranges(self):
        """[lo, hi) of each slice, in runs of the cell's elements taken in
        row-major order (runs of 4 where the cell pass loads 16 bytes)."""
        units = self.block_m * self.block_n // self.run()
        return [(units * s // self.slices, units * (s + 1) // self.slices)
                for s in range(self.slices)]

    def run(self) -> int:
        return 4 if self.block_n % 4 == 0 and self.n % 4 == 0 else 1


def launch_plan(m: int, n: int, k: int, block_m: int,
                block_n: int) -> LaunchPlan:
    """The launch of one (M, K) @ (K, N) call with (block_m x block_n)
    cells.  K is walked whole by every block in ascending k-tiles (no split
    of K), so the plan's summation order depends on K alone."""
    cell = block_m * block_n
    slices = max(1, min(MAX_SLICES, cell // CELL_SLICE))
    return LaunchPlan(m, n, k, block_m, block_n, padded_k(k),
                      -(-k // TILE_K), -(-m // TILE_M), -(-n // TILE_N),
                      (m // block_m) * (n // block_n), slices)


def razor_matmul_plain(a: torch.Tensor, b: torch.Tensor, *,
                       tol: float = 0.05, block_m: int, block_n: int):
    """The kernel's function in plain PyTorch: (C f32 (M, N), flags int32
    (gm, gn), rel f32 (gm, gn)).  Same as ``kernels.ref.razor_matmul`` with
    independent cell edges; the integer product is exact on any device."""
    return razor_matmul_tiles(a, b, tol, block_m, block_n)


def _check(a, b, block_m, block_n):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"razor_matmul expects (M, K) @ (K, N); got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"razor_matmul takes a and b both float32 or both "
                        f"bfloat16; got {a.dtype} and {b.dtype}")
    if b.device != a.device:
        raise ValueError(f"razor_matmul operands lie on different devices: "
                         f"{a.device} and {b.device}")
    m, k = a.shape
    n = b.shape[1]
    if min(m, n, k) == 0:
        raise ValueError(f"razor_matmul needs non-empty operands; got "
                         f"({m}, {k}) @ ({k}, {n})")
    if block_m <= 0 or block_n <= 0 or m % block_m or n % block_n:
        raise ValueError(f"cells {block_m}x{block_n} do not tile a "
                         f"({m}, {n}) output")


def razor_matmul(a: torch.Tensor, b: torch.Tensor, *, tol: float = 0.05,
                 block_m: Optional[int] = None, block_n: Optional[int] = None,
                 count_flags: bool = False):
    """Returns (C f32 (M, N) corrected, flags int32 (gm, gn), rel f32
    (gm, gn)); with ``count_flags=True`` additionally the fused int32
    fired-cell total as a 0-d tensor on the inputs' device.  Cells default
    to :func:`~repro_torch.kernels.tuning.select_blocks`.

    a: (M, K); b: (K, N), both float32 or both bfloat16, any strides.
    CUDA tensors go to the kernel, CPU tensors to :func:`razor_matmul_plain`.
    """
    bm, bn = select_blocks(a.shape[0], b.shape[-1])
    block_m = bm if block_m is None else block_m
    block_n = bn if block_n is None else block_n
    _check(a, b, block_m, block_n)
    (m, k), n = a.shape, b.shape[1]
    if a.device.type == "cpu":
        c, flags, rel = razor_matmul_plain(a, b, tol=tol, block_m=block_m,
                                           block_n=block_n)
        if not count_flags:
            return c, flags, rel
        return c, flags, rel, flags.sum().to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"razor_matmul has no kernel for device {a.device}")

    plan = launch_plan(m, n, k, block_m, block_n)
    if k > _MAX_K or m * n > 2 ** 62 or plan.col_tiles > _MAX_GRID_Y:
        raise ValueError(f"razor_matmul: problem ({m}, {k}, {n}) exceeds the "
                         f"kernel's extents")
    lib = _build.load_library()
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):
            return razor_matmul(a, b, tol=tol, block_m=block_m,
                                block_n=block_n, count_flags=count_flags)
    dev = a.device
    ws_bytes = plan.workspace_bytes()
    ws = torch.empty((ws_bytes,), dtype=torch.uint8, device=dev)
    c = torch.empty((m, n), dtype=torch.float32, device=dev)
    flags = torch.empty((m // block_m, n // block_n), dtype=torch.int32,
                        device=dev)
    rel = torch.empty(flags.shape, dtype=torch.float32, device=dev)
    # the launcher zeroes a fresh count on the stream: no separate fill
    count = (torch.empty((), dtype=torch.int32, device=dev)
             if count_flags else None)
    err = lib.razor_matmul_launch(
        a.data_ptr(), b.data_ptr(), ws.data_ptr(), ws_bytes, c.data_ptr(),
        flags.data_ptr(), rel.data_ptr(),
        count.data_ptr() if count is not None else None, m, n, k,
        a.stride(0), a.stride(1), b.stride(0), b.stride(1), block_m, block_n,
        plan.slices, float(tol), _DTYPE_CODE[a.dtype],
        # the raw handle of PyTorch's current stream (the Stream object
        # that torch.cuda.current_stream() builds costs more than a launch)
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"razor_matmul launch failed: CUDA error {err} "
                           f"for ({m}, {k}) @ ({k}, {n}), cells "
                           f"{block_m}x{block_n}")
    razor_matmul.launches += 1
    if not count_flags:
        return c, flags, rel
    return c, flags, rel, count


#: kernel launches made by :func:`razor_matmul` in this process (one per
#: call: the quantization prologue, the product pass and the cell passes
#: together)
razor_matmul.launches = 0
