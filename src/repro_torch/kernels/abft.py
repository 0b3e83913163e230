"""abft_checksums on Hopper: the ABFT guard's float64 checksums of one GEMM
operand in one read of it (CUDA source ``csrc/abft_checksums.cu``).

Not a TPU kernel: ``repro.resilience.guard.GuardedBackend`` computes these in
numpy (``guard.py:146-154`` and ``:164-167``) from float64 copies of both
operands.  On a GPU such a copy of a weight costs 8 bytes a parameter to
write and read again; the kernel reads the weight ``b`` (K, N) once, in its
own type (float32, bfloat16 or float64, any strides: a transposed view is
read through its strides), and forms every product the guard needs from that
read, in float64:

* ``b @ v``    (K, r): ``v`` (N, r) holds the ones vector (the checksums'
  row sums) or Freivalds' probes;
* ``|b| @ 1``  (K,):   the row sums of ``|b|``, which scale the tolerance;
* ``u @ b``    (r', N): ``u`` holds ``a``'s column sums and, in its last
  ``abs_rows`` rows multiplying ``|b|``, ``|a|``'s.

The products with ``a`` that remain (``a64 @ (b @ v)``, the product's row
and column sums) are small and stay PyTorch ops on the device.

Sums across the kernel's blocks go through a second, ordered pass over
per-strip partial sums (no float atomics), so a repeated call gives the same
bits.  :func:`launch_plan` fixes the blocks from the operand's shape alone.

:func:`abft_checksums` launches the kernel for CUDA tensors (or raises) and
computes :func:`abft_checksums_plain` for CPU tensors; there is no other
route between the two.  ``abft_checksums.launches`` counts the launches.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_INT_MAX = 2 ** 31 - 1

# ---- the launch plan (mirrors csrc/abft_checksums.cu) ----------------------

#: warps of a block, columns of a sub-tile (32 lanes x 4)
WARPS, TILE_C = 8, 128
#: most sub-tiles and rows a block covers
MAX_SUB, MAX_ROWS = 4, 512
#: float64 vectors a pass takes on each side (P along the contiguous axis, Q
#: along the other)
MAXV = 4
#: blocks the plan aims at: two on each of the H100's 132 SMs
TARGET_BLOCKS = 264


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the kernel cuts an (R, C) operand (C its contiguous axis): blocks
    of ``sub x 128`` columns and ``rows`` rows, ``n_cb x n_rb`` of them, each
    writing one partial sum per output it touches."""

    rows_total: int
    cols_total: int
    sub: int
    rows: int

    @property
    def n_cb(self) -> int:
        return -(-self.cols_total // (self.sub * TILE_C))

    @property
    def n_rb(self) -> int:
        return -(-self.rows_total // self.rows)

    def partial_doubles(self, n_p: int, n_q: int) -> Tuple[int, int]:
        """float64s of the partial sums: along C (n_cb x R x n_p) and along R
        (n_rb x n_q x C)."""
        return (self.n_cb * self.rows_total * n_p,
                self.n_rb * n_q * self.cols_total)


@functools.lru_cache(maxsize=4096)
def launch_plan(rows_total: int, cols_total: int) -> LaunchPlan:
    """The widest blocks (``MAX_SUB`` sub-tiles, ``MAX_ROWS`` rows) that
    still give ``TARGET_BLOCKS`` blocks: sub-tiles are halved first, then
    rows, down to one sub-tile of ``WARPS`` rows."""
    sub, rows = MAX_SUB, MAX_ROWS
    while True:
        plan = LaunchPlan(rows_total, cols_total, sub, rows)
        if plan.n_cb * plan.n_rb >= TARGET_BLOCKS or (sub == 1
                                                      and rows == WARPS):
            return plan
        if sub > 1:
            sub //= 2
        else:
            rows //= 2


# ---- the function ----------------------------------------------------------


def abft_checksums_plain(b: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                         abs_rows: int = 0):
    """The kernel's function in plain PyTorch (float64 ops): ``([b @ v,
    |b| @ 1], [u_s @ b; u_a @ |b|])``, ``u_a`` the last ``abs_rows`` rows of
    ``u`` and ``u_s`` the others."""
    b64 = b.to(torch.float64)
    babs = b64.abs()
    bw = torch.cat([b64 @ v, babs.sum(dim=1, keepdim=True)], dim=1)
    ns = u.shape[0] - abs_rows
    return bw, torch.cat([u[:ns] @ b64, u[ns:] @ babs])


def _check(b, v, u, abs_rows):
    if b.dim() != 2 or v.dim() != 2 or u.dim() != 2:
        raise ValueError(f"abft_checksums takes 2-D b, v and u; got "
                         f"{tuple(b.shape)}, {tuple(v.shape)}, "
                         f"{tuple(u.shape)}")
    k, n = b.shape
    if v.shape[0] != n or u.shape[1] != k:
        raise ValueError(f"abft_checksums: v must be ({n}, r) and u (r', "
                         f"{k}) for b {tuple(b.shape)}; got "
                         f"{tuple(v.shape)} and {tuple(u.shape)}")
    if v.dtype != torch.float64 or u.dtype != torch.float64:
        raise ValueError(f"abft_checksums: v and u must be float64; got "
                         f"{v.dtype} and {u.dtype}")
    if v.device != b.device or u.device != b.device:
        raise ValueError(f"abft_checksums: v on {v.device} and u on "
                         f"{u.device}, the operand on {b.device}")
    if not 0 <= abs_rows <= u.shape[0] or u.shape[0] > MAXV:
        raise ValueError(f"abft_checksums takes at most {MAXV} rows of u and "
                         f"0 <= abs_rows <= rows; got {u.shape[0]} rows, "
                         f"abs_rows {abs_rows}")


def _launch(x, p, pabs, q, qabs):
    """One launch on X (R, C) with C the axis of the smaller stride: returns
    ``(X' @ P (R, np), Q @ X' (nq, C))``, X' the element or its absolute
    value where the vector's bit in ``pabs`` / ``qabs`` is set."""
    lib = _build.load_library()
    dev = x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(x, p, pabs, q, qabs)
    r_tot, c_tot = x.shape
    if r_tot > _INT_MAX or c_tot > _INT_MAX:
        raise ValueError(f"abft_checksums: operand {tuple(x.shape)} exceeds "
                         f"the kernel's 32-bit extents")
    plan = launch_plan(r_tot, c_tot)
    n_p, n_q = p.shape[1], q.shape[0]
    p, q = p.contiguous(), q.contiguous()
    pr_n, pc_n = plan.partial_doubles(n_p, n_q)
    # outputs and partial sums in one allocation
    buf = torch.empty((r_tot * n_p + n_q * c_tot + pr_n + pc_n,),
                      dtype=torch.float64, device=dev)
    yr = buf[:r_tot * n_p].view(r_tot, n_p)
    yc = buf[r_tot * n_p:r_tot * n_p + n_q * c_tot].view(n_q, c_tot)
    base = buf.data_ptr() + 8 * (r_tot * n_p + n_q * c_tot)
    err = lib.abft_checksums_launch(
        x.data_ptr(), r_tot, c_tot, x.stride(0), x.stride(1),
        _DTYPE_CODE[x.dtype], p.data_ptr(), n_p, pabs, q.data_ptr(), n_q,
        qabs, plan.sub, plan.rows, base, base + 8 * pr_n,
        yr.data_ptr(), yc.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"abft_checksums launch failed: CUDA error {err} "
                           f"for an operand {tuple(x.shape)} with {n_p} + "
                           f"{n_q} vectors")
    abft_checksums.launches += 1
    return yr, yc


def _kernel_route(b, v, u, abs_rows):
    k, n = b.shape
    ones = torch.ones((n, 1), dtype=torch.float64, device=b.device)
    u_bits = ((1 << abs_rows) - 1) << (u.shape[0] - abs_rows)
    bw_parts, ub = [], None
    row_major = b.stride(1) <= b.stride(0)
    # v's columns in groups that leave room for the |b| row sums; u rides
    # with the first group
    groups = [v[:, c:c + MAXV - 1] for c in range(0, v.shape[1], MAXV - 1)]
    for gi, vg in enumerate(groups or [v]):
        r = vg.shape[1]
        uq = u if gi == 0 else u[:0]
        row_vecs = torch.cat([vg, ones], dim=1)          # (N, r + 1)
        if row_major:
            # contiguous along N: X = b, the N-sums are X's row products
            yr, yc = _launch(b, row_vecs, 1 << r, uq, u_bits)
            bw = yr
            if gi == 0 and u.shape[0]:
                ub = yc
        else:
            # contiguous along K: X = b^T, the K-sums are X's row products
            yr, yc = _launch(b.T, uq.T, u_bits, row_vecs.T, 1 << r)
            bw = yc.T
            if gi == 0 and u.shape[0]:
                ub = yr.T
        bw_parts.append(bw if gi == len(groups) - 1 or not groups
                        else bw[:, :r])
    bw = bw_parts[0] if len(bw_parts) == 1 else torch.cat(bw_parts, dim=1)
    return bw, (ub if ub is not None else u.new_zeros((0, n)))


def abft_checksums(b: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                   abs_rows: int = 0):
    """``(bw (K, r + 1), ub (r', N))``, all float64: ``bw`` is ``b @ v``
    with the row sums of ``|b|`` as its last column, ``ub`` is ``u @ b``
    with the last ``abs_rows`` rows of ``u`` multiplying ``|b|``.  ``b`` is
    (K, N) float32 / bfloat16 / float64 of any strides; ``v`` (N, r) and
    ``u`` (r', K) are float64 on ``b``'s device (r and r' may be 0, r' <=
    4).

    CUDA tensors go to the kernel (one launch for up to three columns of
    ``v``, each launch one read of ``b``), CPU tensors to
    :func:`abft_checksums_plain`."""
    _check(b, v, u, abs_rows)
    if b.device.type == "cpu":
        return abft_checksums_plain(b, v, u, abs_rows)
    if b.device.type != "cuda":
        raise ValueError(f"abft_checksums has no kernel for device "
                         f"{b.device}")
    if b.dtype not in _DTYPE_CODE:
        raise TypeError(f"abft_checksums takes float32, bfloat16 or float64 "
                        f"operands; got {b.dtype}")
    _build.load_library()               # raises before anything is made
    k, n = b.shape
    if k == 0 or n == 0:                   # empty sums: nothing to read
        return (u.new_zeros((k, v.shape[1] + 1)), u.new_zeros((u.shape[0], n)))
    return _kernel_route(b, v, u, abs_rows)


#: kernel launches made by :func:`abft_checksums` in this process
abft_checksums.launches = 0
