"""systolic_mac on Hopper: voltage-island partitioned matmul with
timing-fault injection and Razor flags (the paper's partitioned MAC array as
one GEMM).

Replaces the Pallas kernel ``src/repro/kernels/systolic_mac.py::_kernel``
(wrappers ``_systolic_mac_call`` / ``systolic_mac``).  The CUDA source is
``csrc/systolic_mac.cu``.

Each (i, j) cell of the ``v_map`` grid is one partition with a rail voltage
``v_map[i, j]`` and a minimum safe voltage ``v_safe[i, j]``.  Under-volted
cells have the low mantissa bits of their f32 results masked off (the model
shared with :func:`repro_torch.kernels.ref.corrupt_low_bits`) and raise a
flag — the per-partition Razor flag the runtime scheme consumes.  With
``count_flags=True`` the kernel also counts the fired cells (an integer
``atomicAdd``), so callers that only need "how many partitions failed" read
one integer instead of the flag map; with ``counter=`` it adds that count
into a caller's running device counter instead.

What bounds it on an H100: at the serving shapes (M = 1..16 rows against a
(K, N) weight) the bytes of ``b``, and how many SMs stream them: one block
moves only a fraction of the card's memory rate.  At large M the tensor cores
(bf16) or the f32 FMA rate (f32).  The kernel has two forms, one kernel name
(``systolic_mac_kernel``), chosen before the launch by :func:`launch_rows`:

* the 16-row form, every f32 call and bf16 below ``WIDE_FROM_M`` rows (the
  decode step); what follows is its design;
* the wide form, bf16 from ``WIDE_FROM_M`` rows on (prefill, the train
  step): 128 x 128 tiles, eight MMA warps and a copy warp on the same ring,
  each block walking every split of the plan in turn (no cluster), so each
  weight tile is streamed M / 128 times instead of M / 16.  It sums every
  element in the same order, so the two forms give the same bits.

The 16-row form:

* K is split over the blocks of a thread-block cluster
  (:func:`launch_plan`: from K, N and the type alone, a power of two up to 16,
  about one block per SM at N <= 8192, no split for the logits).
* Each block streams its k-tiles through a 4-stage shared-memory ring filled
  by 2-D tensor-map TMA copies along whichever axis of ``b`` is contiguous (a
  transposed view of the embedding is read in place, never copied); ragged
  edges arrive as zeros.  One warp issues the copies and four run the MMAs,
  handing stages back and forth on mbarriers, so neither waits on a block
  barrier inside the loop.
* bf16 multiplies on the tensor cores (``mma.sync`` m16n8k16, rows padded to
  16), f32 with ``fmaf`` on the CUDA cores.
* The splits' partial tiles are summed through the cluster's distributed
  shared memory, so the split-K workspace is on chip (one padded f32 tile per
  block, :meth:`LaunchPlan.workspace_bytes`); no device memory, fence or
  semaphore.
* An operand whose base pointer or row stride is not 16-byte aligned is
  loaded by the threads instead, from clamped addresses, in the same kernel.

The partition cell (``block_m x block_n``, as small as 1x1 on the serving
path) is independent of the launch tile.

Numerical contracts (stated in the CUDA source too):

1. One summation order per (K, N, dtype), never a function of M: a row's
   result does not depend on how many rows share the call, nor on the form
   that runs it.  Split ``s`` sums its k-tiles in ascending order (bf16:
   each 64-deep tile's four ``mma.sync`` into a fresh fragment, added to an
   f32 register sum; f32: one ``fmaf`` chain), and the splits are added in
   split order (``v = part[0]; v += part[1]; ...``).
2. Deterministic: no float atomics; mask, flags and count are applied after
   the whole sum, by one writer per element.
3. Within 1e-5 x max|C| of the plain f32 product at every model shape
   (``chip_smoke.py``, K = 10240 included).

The launch path is kept short for the decode step's hundreds of GEMMs: the
launcher zeroes a fresh count on the stream (no separate fill), the reference
backend's routed GEMMs add into its running count (``counter=``), and the
device guard is entered only when the operands lie off the current device.

:func:`systolic_mac` launches the kernel for CUDA tensors (or raises) and
computes :func:`systolic_mac_plain` for CPU tensors; there is no other
route between the two.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch

from . import _build
from .ref import keep_mask, systolic_mac_tiles

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1

# ---- the launch plan (mirrors csrc/systolic_mac.cu) -------------------------

#: rows and columns of a block's output tile
TILE_M, TILE_N = 16, 128
#: depth of a k-tile by dtype code (0 f32, 1 bf16)
TILE_K = {0: 32, 1: 64}
#: blocks the split aims at: one on each of the H100's 132 SMs (a block
#: streams its k-tiles faster than its SM's share of the memory rate)
TARGET_BLOCKS = 132
#: fewest k-tiles a split walks; most splits (the blocks of one cluster)
MIN_TILES_PER_SPLIT, MAX_SPLITS = 2, 16
#: a split's partial tile in shared memory (f32, rows padded by 4 floats):
#: the whole split-K workspace, on chip
PARTIAL_BYTES = TILE_M * (TILE_N + 4) * 4

#: the wide form (bf16 at large M): a block's rows, its MMA threads (eight
#: warps of 32 rows x 64 columns) beside one copy warp, the stages of its
#: ring (a 128 x 64 a tile and b's 64 x 128 tile each), the padded row of
#: the finished f32 tile it stages over the ring for the epilogue
WIDE_TILE_M, WIDE_THREADS, WIDE_STAGES = 128, 256, 5
WIDE_STAGE_BYTES = (WIDE_TILE_M + TILE_N) * 128
WIDE_RED_LD = TILE_N + 8
#: fewest rows at which bf16 takes the wide form: on an H100 the 16-row
#: form is the faster over a phi4-mini layer's GEMMs at M = 64 and the wide
#: form from M = 128 on (``scripts/b1_ab.py --crossover``)
WIDE_FROM_M = 128
#: most column tiles of a wide launch (CUDA's grid.y)
WIDE_MAX_COL_TILES = 65535


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the kernel cuts a (K, N) product: ``splits`` blocks of one
    cluster along K for every ``TILE_M x TILE_N`` output tile, split ``s``
    summing k-tiles ``[s * k_tiles // splits, (s + 1) * k_tiles // splits)``.
    """

    k: int
    n: int
    dtype_code: int
    block_k: int
    k_tiles: int
    n_tiles: int
    splits: int

    def k_ranges(self) -> List[Tuple[int, int]]:
        """The K range each split sums, in split order (ascending)."""
        t = self.k_tiles
        return [(min(self.k, s * t // self.splits * self.block_k),
                 min(self.k, (s + 1) * t // self.splits * self.block_k))
                for s in range(self.splits)]

    def workspace_bytes(self) -> int:
        """Bytes of split partials one output tile holds: one partial tile
        in the shared memory of each block of its cluster, none in device
        memory, whatever M is."""
        return self.splits * PARTIAL_BYTES if self.splits > 1 else 0


@functools.lru_cache(maxsize=4096)
def launch_plan(k: int, n: int, dtype_code: int) -> LaunchPlan:
    """The split of K for a (K, N) weight of the given type: the largest
    power of two up to ``TARGET_BLOCKS / n_tiles``, ``MAX_SPLITS`` and
    ``k_tiles / MIN_TILES_PER_SPLIT``.  M is not an argument: the plan, and
    with it every element's order of summation, is the same at every M."""
    bk = TILE_K[dtype_code]
    k_tiles = -(-k // bk)
    n_tiles = -(-n // TILE_N)
    cap = min(TARGET_BLOCKS // n_tiles, k_tiles // MIN_TILES_PER_SPLIT,
              MAX_SPLITS)
    splits = 1 << (max(1, cap).bit_length() - 1)
    return LaunchPlan(k, n, dtype_code, bk, k_tiles, n_tiles, splits)


def row_tile(m: int, dtype_code: int) -> int:
    """The row tile of a block at M rows: the wide form's ``WIDE_TILE_M``
    for bf16 from ``WIDE_FROM_M`` rows on, else ``TILE_M``; f32 always
    ``TILE_M``.  The bits do not depend on it: both forms sum every element
    in :func:`launch_plan`'s order."""
    if dtype_code == 1 and m >= WIDE_FROM_M:
        return WIDE_TILE_M
    return TILE_M


def _tma_operand(ptr: int, inner: int, outer: int, stride: int,
                 elem: int) -> bool:
    """Whether the launcher's tensor map takes a matrix whose ``inner``
    axis is contiguous (``csrc/systolic_mac.cu::encode``): a 16-byte
    aligned base and row stride, rows that do not overlap."""
    if outer == 1:
        stride = -(-inner // (16 // elem)) * (16 // elem)
    return ptr % 16 == 0 and stride * elem % 16 == 0 and stride >= inner


def launch_rows(a: torch.Tensor, b: torch.Tensor) -> int:
    """The row tile a call launches, decided before the launch:
    :func:`row_tile`'s, except that operands the wide form cannot take (it
    loads through the TMA only: a K of 0, a base or row stride off 16
    bytes, more than ``WIDE_MAX_COL_TILES`` column tiles) go to the 16-row
    form, which also loads by hand."""
    m, k = a.shape
    n = b.shape[1]
    rows = row_tile(m, _DTYPE_CODE[a.dtype])
    if rows == TILE_M:
        return rows
    elem = a.element_size()
    sa_m, sa_k = a.stride()
    sb_k, sb_n = b.stride()
    a_ok = (sa_k == 1 or k == 1) and _tma_operand(a.data_ptr(), k, m, sa_m,
                                                  elem)
    if sb_k == 1 and sb_n != 1:             # the transposed view: K inner
        b_ok = _tma_operand(b.data_ptr(), k, n, sb_n, elem)
    else:
        b_ok = (sb_n == 1 or n == 1) and _tma_operand(b.data_ptr(), n, k,
                                                      sb_k, elem)
    if (k == 0 or not (a_ok and b_ok)
            or -(-n // TILE_N) > WIDE_MAX_COL_TILES):
        return TILE_M
    return rows


def systolic_mac_plain(a: torch.Tensor, b: torch.Tensor, v_map: torch.Tensor,
                       v_safe: torch.Tensor, *, block_m: int, block_n: int,
                       keep_bits: int = 8):
    """The kernel's function in plain PyTorch: (C f32 (M, N), flags int32
    (M/block_m, N/block_n)).  Same as ``kernels.ref.systolic_mac`` with
    independent cell edges."""
    return systolic_mac_tiles(a, b, v_map, v_safe, block_m, block_n,
                              keep_bits)


def _check(a, b, v_map, v_safe, block_m, block_n, keep_bits):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"systolic_mac expects (M, K) @ (K, N); got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"systolic_mac takes a and b both float32 or both "
                        f"bfloat16; got {a.dtype} and {b.dtype}")
    if v_map.dim() != 2 or v_map.shape != v_safe.shape:
        raise ValueError(f"v_map and v_safe must be equal-shaped 2-D grids; "
                         f"got {tuple(v_map.shape)} / {tuple(v_safe.shape)}")
    m, n = a.shape[0], b.shape[1]
    gm, gn = v_map.shape
    if m == 0 or n == 0 or gm == 0 or gn == 0:
        raise ValueError(f"systolic_mac needs non-empty M, N and grid; got "
                         f"M={m}, N={n}, grid=({gm}, {gn})")
    block_m = m // gm if block_m is None else block_m
    block_n = n // gn if block_n is None else block_n
    if block_m <= 0 or block_n <= 0 or block_m * gm != m or block_n * gn != n:
        raise ValueError(f"grid ({gm}, {gn}) with cells {block_m}x{block_n} "
                         f"does not tile a ({m}, {n}) output")
    keep_mask(keep_bits)                        # range check
    dev = a.device
    if b.device != dev or v_map.device != dev or v_safe.device != dev:
        raise ValueError(f"systolic_mac operands lie on different devices: "
                         f"{a.device}, {b.device}, {v_map.device}, "
                         f"{v_safe.device}")
    return block_m, block_n


def _launch(a, b, v_map, v_safe, block_m, block_n, keep_bits, counter,
            fresh_count):
    """One call of the CUDA kernel; returns (C, flags, count): ``count`` is
    a fresh one (zeroed by the launcher) with ``fresh_count``, else
    ``counter`` (added into; None for no count)."""
    lib = _build.load_library()
    if a.device.index != torch.cuda.current_device():
        with torch.cuda.device(a.device):
            return _launch(a, b, v_map, v_safe, block_m, block_n, keep_bits,
                           counter, fresh_count)
    m, k = a.shape
    n = b.shape[1]
    if m > _INT_MAX or n > _INT_MAX or k > _INT_MAX:
        raise ValueError(f"systolic_mac: problem ({m}, {k}, {n}) exceeds the "
                         f"kernel's 32-bit extents")
    code = _DTYPE_CODE[a.dtype]
    plan = launch_plan(k, n, code)
    if v_map.dtype != torch.float32 or not v_map.is_contiguous():
        v_map = v_map.to(torch.float32).contiguous()
    if v_safe.dtype != torch.float32 or not v_safe.is_contiguous():
        v_safe = v_safe.to(torch.float32).contiguous()
    dev = a.device
    c = torch.empty((m, n), dtype=torch.float32, device=dev)
    flags = torch.empty(v_map.shape, dtype=torch.int32, device=dev)
    count = (torch.empty((), dtype=torch.int32, device=dev)
             if fresh_count else counter)
    sa_m, sa_k = a.stride()
    sb_k, sb_n = b.stride()
    err = lib.systolic_mac_launch(
        a.data_ptr(), b.data_ptr(), v_map.data_ptr(), v_safe.data_ptr(),
        c.data_ptr(), flags.data_ptr(),
        count.data_ptr() if count is not None else None, int(fresh_count),
        plan.splits, launch_rows(a, b), m, n, k, sa_m, sa_k, sb_k, sb_n,
        block_m, block_n, keep_bits, code,
        # the raw handle of PyTorch's current stream (the Stream object
        # that torch.cuda.current_stream() builds costs more than a launch)
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"systolic_mac launch failed: CUDA error {err} "
                           f"for ({m}, {k}) @ ({k}, {n}), cells "
                           f"{block_m}x{block_n}")
    systolic_mac.launches += 1
    return c, flags, count


def systolic_mac(a: torch.Tensor, b: torch.Tensor, v_map: torch.Tensor,
                 v_safe: torch.Tensor, *, block_m: Optional[int] = None,
                 block_n: Optional[int] = None, keep_bits: int = 8,
                 count_flags: bool = False,
                 counter: Optional[torch.Tensor] = None):
    """C = a @ b with per-cell voltage-island fault semantics.

    a: (M, K); b: (K, N), both float32 or both bfloat16, any strides;
    v_map/v_safe: (M/block_m, N/block_n).  Returns (C f32 (M, N), flags
    int32 (gm, gn)); with ``count_flags=True`` additionally the fused int32
    total of fired cells as a 0-d tensor on the inputs' device (reading it is
    the caller's synchronisation, not this function's).  ``counter``, a 0-d
    int32 tensor on the inputs' device, is the other way to count: the call
    adds its fired cells into it, so a caller that keeps a running total
    (the reference backend, over a decode step's GEMMs) reads it once and no
    per-call fill or sum runs on the device.  ``block_m`` / ``block_n``
    default to the cell shape ``v_map`` implies.

    CUDA tensors go to the kernel, CPU tensors to :func:`systolic_mac_plain`.
    """
    block_m, block_n = _check(a, b, v_map, v_safe, block_m, block_n,
                              keep_bits)
    if counter is not None:
        if count_flags:
            raise ValueError("systolic_mac counts into a fresh count "
                             "(count_flags=True) or into counter=, not both")
        if (counter.dtype != torch.int32 or counter.dim() != 0
                or counter.device != a.device):
            raise ValueError(f"systolic_mac: counter must be a 0-d int32 "
                             f"tensor on {a.device}; got {counter.dtype} "
                             f"{tuple(counter.shape)} on {counter.device}")
    if a.device.type == "cpu":
        c, flags = systolic_mac_plain(a, b, v_map, v_safe, block_m=block_m,
                                      block_n=block_n, keep_bits=keep_bits)
        if counter is not None:
            counter += flags.sum().to(torch.int32)
        if not count_flags:
            return c, flags
        return c, flags, flags.sum().to(torch.int32)
    if a.device.type != "cuda":
        raise ValueError(f"systolic_mac has no kernel for device {a.device}")
    # the launcher zeroes a fresh count on the stream: no separate fill
    c, flags, count = _launch(a, b, v_map, v_safe, block_m, block_n,
                              keep_bits, counter, count_flags)
    if not count_flags:
        return c, flags
    return c, flags, count


#: kernel launches made by :func:`systolic_mac` in this process
systolic_mac.launches = 0
