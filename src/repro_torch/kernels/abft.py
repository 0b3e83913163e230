"""The ABFT guard's two kernels on Hopper (CUDA source
``csrc/abft_checksums.cu``): ``abft_checksums``, the float64 checksums of one
GEMM's operands in one read of its weight, and ``abft_verdict``, the
verification of a product against them.

Not TPU kernels: ``repro.resilience.guard.GuardedBackend`` computes both in
numpy (``guard.py:144-159``) from float64 copies of the operands and the
product.  On a GPU such a copy of a weight costs 8 bytes a parameter to
write and read again, and the verification some twenty PyTorch ops.

``abft_checksums`` reads the weight ``b`` (K, N) once, in its own type
(float32, bfloat16 or float64, any strides: a transposed view is read
through its strides), and has two forms:

* the abft mode, ``abft_checksums(b, a=a, tol=tol)``: from ``a`` (M, K) and
  that read, the guard's references and tolerances in one (2, M + N) float64
  pack, ``[a @ b 1; (sum_m a) @ b]`` and ``([|a| @ |b| 1; (sum_m |a|) @
  |b|] + 1) * tol``.  The column sums of ``a`` and ``|a|`` are formed in the
  kernel, and the products with ``a`` by its last blocks;
* the general form, ``abft_checksums(b, v, u, abs_rows)``: ``[b @ v, |b| @
  1]`` (K, r + 1) and ``u @ b`` (r', N), the last ``abs_rows`` rows of ``u``
  multiplying ``|b|`` (Freivalds' probes are ``v``).

``abft_verdict(out, checks)`` reads the product (M, N) in its own type and
returns the seven float64 numbers the guard reads: the counts of bad rows and
columns, the first of each, their residuals and the largest residual over
its tolerance.

Sums across blocks go through partial sums that the last block of a group
adds in block order (an integer ticket a group; no float atomics), so a
repeated call gives the same bits; the order is fixed by the operand's shape
and type (:func:`launch_plan`, :func:`verdict_plan`), never by M.  Scratch
(partials, tickets) is kept per shape, type and stream.

Each wrapper launches its kernel for CUDA tensors (or raises) and computes
its plain version (:func:`abft_checksums_plain`, :func:`abft_verdict_plain`)
for CPU tensors; there is no other route between the two.
``abft_checksums.launches`` and ``abft_verdict.launches`` count the
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float64: 8}
_INT_MAX = 2 ** 31 - 1
#: which side of X the a-side vectors are on (csrc SIDE_*)
SIDE_NONE, SIDE_Q, SIDE_P = 0, 1, 2

# ---- the launch plans (mirror csrc/abft_checksums.cu) ----------------------

#: warps of a block (256 threads) and lanes of a warp
WARPS, LANES = 8, 32
#: bytes a lane loads from a row at once: 8 bf16, 4 f32 or 2 f64
LANE_BYTES = 16
#: rows between the block's syncs in the general form (Q staged for them);
#: a block's rows are a multiple
CHUNK_ROWS = 32
#: least and most rows a block
MIN_ROWS, MAX_ROWS = 64, 1024
#: float64 vectors a launch takes on each side (P along the contiguous axis,
#: Q along the other)
MAXV = 4
#: blocks the plan aims at: two on each of the H100's 132 SMs
TARGET_BLOCKS = 264
#: the verdict kernel: threads of a block, columns a thread; a cluster's
#: most blocks and rows (past them the blocks meet through global memory)
VERDICT_THREADS, VERDICT_COLS = 512, 8
VERDICT_CLUSTER, VERDICT_CLUSTER_ROWS = 8, 32
#: float64s a verdict block leaves besides its row sums: its tally (count,
#: first, residual, largest ratio) and column 0's residual
VERDICT_PART = 5


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How ``abft_checksums`` cuts an (R, C) operand X (C its contiguous
    axis): blocks of one strip of ``strip`` columns (a lane's 16 bytes a
    row, 32 lanes) and ``rows`` rows, ``n_cb x n_rb`` of them; warp w of a
    block walks its rows w, w + 8, ..."""

    rows_total: int
    cols_total: int
    elem: int
    rows: int

    @property
    def vec(self) -> int:
        return LANE_BYTES // self.elem

    @property
    def strip(self) -> int:
        return LANES * self.vec

    @property
    def n_cb(self) -> int:
        return -(-self.cols_total // self.strip)

    @property
    def n_rb(self) -> int:
        return -(-self.rows_total // self.rows)

    @property
    def blocks(self) -> int:
        return self.n_cb * self.n_rb

    @property
    def tickets(self) -> int:
        """Integer tickets: one a row group, one a column group, one for
        the call."""
        return self.n_rb + self.n_cb + 1

    def partial_doubles(self, n_p: int, n_q: int) -> Tuple[int, int]:
        """float64s of the partial sums: along C (n_cb x n_p x R, none when
        one block spans C) and along R (n_rb x n_q x C, none when one block
        spans R)."""
        return (self.n_cb * n_p * self.rows_total if self.n_cb > 1 else 0,
                self.n_rb * n_q * self.cols_total if self.n_rb > 1 else 0)


@functools.lru_cache(maxsize=4096)
def launch_plan(rows_total: int, cols_total: int,
                dtype: torch.dtype) -> LaunchPlan:
    """The blocks of an (R, C) operand of ``dtype``: one strip wide, their
    rows split so that about ``TARGET_BLOCKS`` blocks cover the operand (one
    wave), a multiple of ``CHUNK_ROWS`` from ``MIN_ROWS`` to ``MAX_ROWS``."""
    if dtype not in _ELEMENT_BYTES:
        raise TypeError(f"abft_checksums takes float32, bfloat16 or float64 "
                        f"operands; got {dtype}")
    elem = _ELEMENT_BYTES[dtype]
    n_cb = -(-cols_total // (LANES * LANE_BYTES // elem))
    n_rs = max(1, TARGET_BLOCKS // n_cb)
    rows = -(-rows_total // n_rs)
    rows = -(-rows // CHUNK_ROWS) * CHUNK_ROWS
    return LaunchPlan(rows_total, cols_total, elem,
                      min(MAX_ROWS, max(MIN_ROWS, rows)))


def verdict_plan(cols: int) -> int:
    """Blocks of ``abft_verdict`` for an N-wide product: each
    ``VERDICT_THREADS x VERDICT_COLS`` columns, all rows."""
    return -(-cols // (VERDICT_THREADS * VERDICT_COLS))


# ---- the plain versions ----------------------------------------------------


def abft_checksums_plain(b: torch.Tensor, v: Optional[torch.Tensor] = None,
                         u: Optional[torch.Tensor] = None,
                         abs_rows: int = 0, *, a: Optional[torch.Tensor] = None,
                         tol: Optional[float] = None):
    """The kernel's function in plain PyTorch (float64 ops).  With ``a``:
    the (2, M + N) pack ``[ref; tol]`` of the guard's abft mode.  Else
    ``([b @ v, |b| @ 1], [u_s @ b; u_a @ |b|])``, ``u_a`` the last
    ``abs_rows`` rows of ``u`` and ``u_s`` the others."""
    b64 = b.to(torch.float64)
    babs = b64.abs()
    if a is not None:
        m, k = a.shape
        a64 = a.to(torch.float64)
        acat = torch.cat([a64, a64.abs()])                  # (2M, K)
        ones = torch.ones((b.shape[1], 1), dtype=torch.float64,
                          device=b.device)
        bw = torch.cat([b64 @ ones, babs.sum(dim=1, keepdim=True)], dim=1)
        ua = acat.view(2, m, k).sum(dim=1)
        ub = torch.cat([ua[:1] @ b64, ua[1:] @ babs])
        ab = acat @ bw                       # [a; |a|] @ [b 1, |b| 1]
        return torch.stack([torch.cat([ab[:m, 0], ub[0]]),
                            (torch.cat([ab[m:, 1], ub[1]]) + 1.0) * tol])
    bw = torch.cat([b64 @ v, babs.sum(dim=1, keepdim=True)], dim=1)
    ns = u.shape[0] - abs_rows
    return bw, torch.cat([u[:ns] @ b64, u[ns:] @ babs])


def abft_verdict_plain(out: torch.Tensor, checks: torch.Tensor
                       ) -> torch.Tensor:
    """The verdict kernel's function in plain PyTorch: the residuals of the
    product's row and column sums against ``checks[0]``, over
    ``checks[1]``; returns (7,) float64 ``[bad rows, bad columns, first bad
    row, first bad column (0 where none), the residual at each, the largest
    ratio]``."""
    m = out.shape[0]
    err = torch.cat([out.sum(dim=1, dtype=torch.float64),
                     out.sum(dim=0, dtype=torch.float64)]) - checks[0]
    # |err| / tol > 1 exactly where |err| > tol (tol is a positive normal
    # float64, the division correctly rounded)
    ratio = err.abs() / checks[1]
    bad = ratio > 1.0
    first = bad.to(torch.int32)
    i, j = first[:m].argmax(), first[m:].argmax()         # first maxima
    return torch.stack([bad[:m].sum(dtype=torch.float64),
                        bad[m:].sum(dtype=torch.float64), i.to(torch.float64),
                        j.to(torch.float64), err[i], err[m + j], ratio.max()])


# ---- abft_checksums --------------------------------------------------------


def _check(b, v, u, abs_rows, a, tol):
    if b.dim() != 2:
        raise ValueError(f"abft_checksums takes a 2-D b; got "
                         f"{tuple(b.shape)}")
    k, n = b.shape
    if a is not None:
        if v is not None or u is not None or tol is None:
            raise ValueError("abft_checksums takes a and tol, or v and u")
        if a.dim() != 2 or a.shape[1] != k or a.device != b.device:
            raise ValueError(f"abft_checksums: a must be (M, {k}) on "
                             f"{b.device}; got {tuple(a.shape)} on "
                             f"{a.device}")
        if a.dtype not in _DTYPE_CODE:
            raise TypeError(f"abft_checksums takes float32, bfloat16 or "
                            f"float64 a; got {a.dtype}")
        return
    if v is None or u is None or v.dim() != 2 or u.dim() != 2:
        raise ValueError("abft_checksums takes 2-D v and u (or a and tol)")
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


class _Workspace(NamedTuple):
    """One shape's scratch on one stream: the partial sums (and the
    addresses of those along C and along R), and the tickets."""
    buf: torch.Tensor
    part_r: int
    part_c: int
    tickets: torch.Tensor


@functools.lru_cache(maxsize=32)
def _workspace(plan: LaunchPlan, n_p: int, n_q: int, device: int,
               stream: int) -> _Workspace:
    """Kept across calls: calls on one stream run in its order, so one
    workspace serves them all; each ticket is back at 0 when a call ends
    (``atomicInc`` wraps)."""
    dev = torch.device("cuda", device)
    pr, pc = plan.partial_doubles(n_p, n_q)
    buf = torch.empty((max(1, pr + pc),), dtype=torch.float64, device=dev)
    tickets = torch.zeros((plan.tickets,), dtype=torch.int32, device=dev)
    return _Workspace(buf, buf.data_ptr(), buf.data_ptr() + 8 * pr, tickets)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _strides(t: Optional[torch.Tensor]) -> Tuple[int, int]:
    return (0, 0) if t is None else (t.stride(0), t.stride(1))


class _Args(ctypes.Structure):
    """csrc/abft_checksums.cu's ``Args``: what stays fixed across the calls
    of one configuration, passed by address."""
    _fields_ = ([(f, ctypes.c_longlong) for f in (
        "ld", "sc", "a_ld", "a_sc", "or_r", "or_j", "oc_i", "oc_c", "om_j",
        "om_m")]
        + [("tol", ctypes.c_double), ("part_r", ctypes.c_void_p),
           ("part_c", ctypes.c_void_p), ("tickets", ctypes.c_void_p)]
        + [(f, ctypes.c_int) for f in (
            "R", "C", "dtype", "np", "nq", "M", "a_dtype", "a_side", "rows")]
        + [(f, ctypes.c_uint) for f in ("pabs", "qabs", "aff_r", "aff_c")])


class _Config(NamedTuple):
    """One configuration's launch, built once: its Args (what stays fixed
    across its calls, passed by address), the workspace they point into
    (kept alive here), and in the abft mode the blocks' products with a (M
    x 2 float64s a block)."""
    args: _Args
    ws: _Workspace
    part_m: Optional[torch.Tensor]


@functools.lru_cache(maxsize=64)
def _config(plan: LaunchPlan, n_p: int, n_q: int, m: int, a_side: int,
            device: int, stream: int, strides: Tuple[int, ...], tol: float,
            dtype: int, a_dtype: int, pabs: int, qabs: int, aff_r: int,
            aff_c: int) -> _Config:
    """Kept per stream as the workspace is: calls on one stream run in its
    order, so one configuration's scratch serves them all."""
    # partial sums only of the side whose sums are written
    ws = _workspace(plan, 0 if a_side == SIDE_Q else n_p,
                    0 if a_side == SIDE_P else n_q, device, stream)
    part_m = None if a_side == SIDE_NONE else torch.empty(
        (plan.blocks * m * 2,), dtype=torch.float64,
        device=torch.device("cuda", device))
    args = _Args(*strides, tol, ws.part_r, ws.part_c, ws.tickets.data_ptr(),
                 plan.rows_total, plan.cols_total, dtype, n_p, n_q, m,
                 a_dtype, a_side, plan.rows, pabs, qabs, aff_r, aff_c)
    return _Config(args, ws, part_m)


def _launch(x, p, pabs, q, qabs, out_r, aff_r, out_c, aff_c, a=None,
            a_side=SIDE_NONE, tol=0.0, out_m=None):
    """One launch on X (R, C), C the axis of the smaller stride, on the
    current device: writes ``X' @ P`` (R, np) into ``out_r`` and ``Q @ X'``
    (nq, C) into ``out_c`` (views of any strides; the vectors in ``aff_r`` /
    ``aff_c`` as ``(y + 1) * tol``), X' the element or its absolute value
    where the vector's bit in ``pabs`` / ``qabs`` is set.  ``p`` / ``q`` are
    float64 (C, np) / (nq, R).  The abft mode (``a_side``): that side's two
    vectors are a's column sums and |a|'s (``p`` / ``q`` None there), the
    other side's ones; the ones' sums are not written, but ``out_m`` (2, M)
    gets ``[a @ y_0; (|a| @ y_1 + 1) * tol]`` of them."""
    r_tot, c_tot = x.shape
    if r_tot > _INT_MAX or c_tot > _INT_MAX:
        raise ValueError(f"abft_checksums: operand {tuple(x.shape)} exceeds "
                         f"the kernel's 32-bit extents")
    n_p = 2 if a_side != SIDE_NONE else p.shape[1]
    n_q = 2 if a_side != SIDE_NONE else q.shape[0]
    dev = x.device.index
    stream = torch._C._cuda_getCurrentRawStream(dev)
    cfg = _config(launch_plan(r_tot, c_tot, x.dtype), n_p, n_q,
                  0 if a is None else a.shape[0], a_side, dev, stream,
                  (*x.stride(), *_strides(a), *_strides(out_r),
                   *_strides(out_c), *_strides(out_m)), tol,
                  _DTYPE_CODE[x.dtype],
                  0 if a is None else _DTYPE_CODE[a.dtype], pabs, qabs, aff_r,
                  aff_c)
    err = _build.load_library().abft_checksums_launch(
        ctypes.addressof(cfg.args), x.data_ptr(), _ptr(p), _ptr(q), _ptr(a),
        _ptr(out_r), _ptr(out_c), _ptr(out_m), _ptr(cfg.part_m), stream)
    if err != 0:
        raise RuntimeError(f"abft_checksums launch failed: CUDA error {err} "
                           f"for an operand {tuple(x.shape)} with {n_p} + "
                           f"{n_q} vectors")
    abft_checksums.launches += 1


def _abft_route(b, a, tol):
    """The abft mode: one launch into one allocation, the (2, M + N)
    pack."""
    m = a.shape[0]
    pack = torch.empty((2, m + b.shape[1]), dtype=torch.float64,
                       device=b.device)
    if b.stride(1) <= b.stride(0):
        # contiguous along N: X = b; a's sums along R (= K) on Q
        _launch(b, None, 0b10, None, 0b10, None, 0, pack[:, m:], 0b10, a=a,
                a_side=SIDE_Q, tol=tol, out_m=pack[:, :m])
    else:
        # contiguous along K: X = b^T; a's sums along C (= K) on P
        _launch(b.T, None, 0b10, None, 0b10, pack[:, m:].T, 0b10, None, 0,
                a=a, a_side=SIDE_P, tol=tol, out_m=pack[:, :m])
    return pack


def _general_route(b, v, u, abs_rows):
    """``(b @ v | |b| 1, u @ b)``: one launch for up to three columns of
    ``v`` (with the ones that give ``|b|``'s row sums), ``u`` with the
    first."""
    k, n = b.shape
    r, nu = v.shape[1], u.shape[0]
    buf = torch.empty((k * (r + 1) + nu * n,), dtype=torch.float64,
                      device=b.device)
    bw = buf[:k * (r + 1)].view(k, r + 1)
    ub = buf[k * (r + 1):].view(nu, n)
    u_bits = ((1 << abs_rows) - 1) << (nu - abs_rows)
    row_major = b.stride(1) <= b.stride(0)
    groups = list(range(0, r, MAXV - 1)) or [0]
    for g0 in groups:
        rg = min(MAXV - 1, r - g0)
        vecs = torch.cat([v[:, g0:g0 + rg],
                          torch.ones((n, 1), dtype=torch.float64,
                                     device=b.device)], dim=1)   # (N, rg + 1)
        # this group's columns of bw; its |b| column is the next group's
        # first, which the next launch (later on the stream) writes over
        cols = bw[:, g0:g0 + rg + 1]
        uq = u if g0 == 0 else u[:0]
        if row_major:
            # contiguous along N: X = b, the N-sums are X's row products
            _launch(b, vecs, 1 << rg, uq, u_bits, cols, 0,
                    ub if uq.shape[0] else None, 0)
        else:
            # contiguous along K: X = b^T, the K-sums are X's column products
            _launch(b.T, uq.T.contiguous(), u_bits, vecs.T.contiguous(),
                    1 << rg, ub.T if uq.shape[0] else None, 0, cols.T, 0)
    return bw, ub


def abft_checksums(b: torch.Tensor, v: Optional[torch.Tensor] = None,
                   u: Optional[torch.Tensor] = None, abs_rows: int = 0, *,
                   a: Optional[torch.Tensor] = None,
                   tol: Optional[float] = None):
    """The guard's float64 checksums of ``b`` (K, N; float32 / bfloat16 /
    float64 of any strides), in one read of it.

    ``abft_checksums(b, a=a, tol=tol)``, ``a`` (M, K): the (2, M + N) pack
    ``[[a @ b 1, (sum_m a) @ b]; ([|a| @ |b| 1, (sum_m |a|) @ |b|] + 1) *
    tol]``, one launch.

    ``abft_checksums(b, v, u, abs_rows)``: ``(bw (K, r + 1), ub (r', N))``;
    ``bw`` is ``b @ v`` with the row sums of ``|b|`` as its last column,
    ``ub`` is ``u @ b`` with the last ``abs_rows`` rows of ``u`` multiplying
    ``|b|``; ``v`` (N, r) and ``u`` (r', K) are float64 on ``b``'s device (r
    and r' may be 0, r' <= 4); one launch for up to three columns of ``v``.

    CUDA tensors go to the kernel, CPU tensors to
    :func:`abft_checksums_plain`."""
    _check(b, v, u, abs_rows, a, tol)
    if b.device.type == "cpu":
        return abft_checksums_plain(b, v, u, abs_rows, a=a, tol=tol)
    if b.device.type != "cuda":
        raise ValueError(f"abft_checksums has no kernel for device "
                         f"{b.device}")
    if b.dtype not in _DTYPE_CODE:
        raise TypeError(f"abft_checksums takes float32, bfloat16 or float64 "
                        f"operands; got {b.dtype}")
    _build.load_library()               # raises before anything is made
    if b.device.index != torch.cuda.current_device():
        # the scratch, the outputs and the launch on b's device
        with torch.cuda.device(b.device):
            return abft_checksums(b, v, u, abs_rows, a=a, tol=tol)
    k, n = b.shape
    if a is not None and (k == 0 or n == 0 or a.shape[0] == 0):
        # empty sums: every reference 0, every tolerance (0 + 1) * tol
        pack = b.new_zeros((2, a.shape[0] + n), dtype=torch.float64)
        return pack.index_fill_(0, pack.new_ones((1,), dtype=torch.long),
                                float(tol))
    if k == 0 or n == 0:
        return (b.new_zeros((k, v.shape[1] + 1), dtype=torch.float64),
                b.new_zeros((u.shape[0], n), dtype=torch.float64))
    if a is not None:
        return _abft_route(b, a, float(tol))
    return _general_route(b, v, u, abs_rows)


#: kernel launches made by :func:`abft_checksums` in this process
abft_checksums.launches = 0


# ---- abft_verdict ----------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _verdict_ticket(device: int, stream: int) -> torch.Tensor:
    """A stream's integer ticket (back at 0 when a call ends)."""
    return torch.zeros((1,), dtype=torch.int32,
                       device=torch.device("cuda", device))


def abft_verdict(out: torch.Tensor, checks: torch.Tensor) -> torch.Tensor:
    """The verification of a product ``out`` (M, N; float32 / bfloat16 /
    float64, any strides) against the abft mode's ``checks`` (2, M + N)
    float64: (7,) float64 ``[bad rows, bad columns, first bad row, first bad
    column, residual at each, largest residual over tolerance]``, as
    :func:`abft_verdict_plain` computes it.

    CPU tensors take the plain version, CUDA tensors one launch."""
    if out.dim() != 2 or checks.dim() != 2 or checks.shape != (
            2, out.shape[0] + out.shape[1]):
        raise ValueError(f"abft_verdict takes out (M, N) and checks (2, M + "
                         f"N); got {tuple(out.shape)} and "
                         f"{tuple(checks.shape)}")
    if checks.dtype != torch.float64 or checks.device != out.device:
        raise ValueError(f"abft_verdict: checks must be float64 on "
                         f"{out.device}; got {checks.dtype} on "
                         f"{checks.device}")
    if out.device.type == "cpu":
        return abft_verdict_plain(out, checks)
    if out.device.type != "cuda":
        raise ValueError(f"abft_verdict has no kernel for device "
                         f"{out.device}")
    if out.dtype not in _DTYPE_CODE:
        raise TypeError(f"abft_verdict takes float32, bfloat16 or float64 "
                        f"products; got {out.dtype}")
    lib = _build.load_library()
    m, n = out.shape
    if m == 0 or n == 0 or m > _INT_MAX or n > _INT_MAX:
        raise ValueError(f"abft_verdict: a product {tuple(out.shape)} has no "
                         f"verdict kernel")
    dev = out.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return abft_verdict(out, checks)
    if checks.stride(1) != 1:
        checks = checks.contiguous()
    n_vb = verdict_plan(n)
    part = None
    if n_vb > VERDICT_CLUSTER or (n_vb > 1 and m > VERDICT_CLUSTER_ROWS):
        # the blocks meet through global memory (no cluster)
        part = torch.empty((n_vb * (m + VERDICT_PART),), dtype=torch.float64,
                           device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    verdict = torch.empty((7,), dtype=torch.float64, device=dev)
    err = lib.abft_verdict_launch(
        out.data_ptr(), m, n, out.stride(0), out.stride(1),
        _DTYPE_CODE[out.dtype], checks.data_ptr(), checks.stride(0),
        _ptr(part), _verdict_ticket(dev.index, stream).data_ptr(),
        verdict.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"abft_verdict launch failed: CUDA error {err} "
                           f"for a product {tuple(out.shape)}")
    abft_verdict.launches += 1
    return verdict


#: kernel launches made by :func:`abft_verdict` in this process
abft_verdict.launches = 0
