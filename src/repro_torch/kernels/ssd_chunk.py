"""ssd_chunk on Hopper: the chunked Mamba2 SSD recurrence.

    S_t = S_{t-1} exp(dt_t a) + dt_t B_t (x) x_t,   y_t = C_t . S_t + D x_t,
    a = -exp(A_log)

Replaces the Pallas kernel ``src/repro/kernels/ssd_chunk.py::_kernel``
(wrappers ``ssd_chunk`` / ``_ssd_chunk_call``).  The CUDA source is
``csrc/ssd_chunk.cu``.  Within a chunk the rows meet in (chunk x chunk)
weight tiles ``(C B^T) * exp(cum_t - cum_s)`` under an inclusive mask; the
(n, p) state carries from chunk to chunk; exponents are clamped at +-30 and
the carried state's factor at [-30, 0], as in the Pallas kernel.

One call is three CUDA kernels (:func:`pass_plan` sizes them): a state pass
over (b, chunk, group of heads) that takes each head's cumsum and the chunk's
local state term, a carry pass over (b, h, slice of the state) that walks the
chunks in order and leaves each chunk's incoming state, and a scan pass over
(b, chunk, group of heads, 64-row tile) that forms the scores ``C B^T`` once
for all the block's heads (B and C are shared by every head, read per batch
row through their strides) and then each head's output.  The four products
run on the TF32 tensor cores with a 3xTF32 split (``hi + lo``, three
products), close to f32.  No float atomics: a repeated call gives the same
bits.

What bounds it on an H100: at zamba2's loss shape (b 2, s 2048, h 80, p 64,
n 64, chunk 64) the bytes: x, dt, B, C, A_log and D read once, y written
once, the state read and written once, 176.4 MB over 3.35 TB/s = 0.0527 ms
(the products at TF32's rate, times three, take 0.049 ms).  The passes also
write and read a (b, h, chunks, n, p) scratch of states (84 MB there).

:func:`ssd_chunk` launches the kernels for CUDA tensors (or raises) and
computes :func:`ssd_chunk_plain` for CPU tensors; there is no other route
between the two.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build
from .tuning import assert_divides, select_chunk

EXP_CLAMP = 30.0
#: largest head size p and state size n the kernel takes
_MAX_DIM = 64
#: rows of a chunk tile (csrc/ssd_chunk.cu: TILE)
TILE = 64
#: most heads one block of the state and scan passes takes (MAX_HEADS)
MAX_HEADS = 8
#: state elements of one carry block (CARRY_ELEMS)
CARRY_ELEMS = 1024
#: blocks the state and scan passes aim at: two per SM on 132 SMs
TARGET_BLOCKS = 264


@dataclass(frozen=True)
class PassPlan:
    """The launch of one :func:`ssd_chunk` call: the three passes' grids,
    the heads a block of the state and scan passes takes, and the scratch
    the wrapper allocates (the kernels allocate nothing)."""
    b: int
    s: int
    h: int
    p: int
    n: int
    chunk: int
    heads_per_block: int

    @property
    def n_chunks(self) -> int:
        return self.s // self.chunk

    @property
    def head_groups(self) -> int:
        return -(-self.h // self.heads_per_block)

    @property
    def row_tiles(self) -> int:
        return -(-self.chunk // TILE)

    @property
    def state_grid(self) -> Tuple[int, int, int]:
        return (self.b * self.n_chunks, self.head_groups, 1)

    @property
    def carry_grid(self) -> Tuple[int, int, int]:
        return (self.b * self.h, -(-self.n * self.p // CARRY_ELEMS), 1)

    @property
    def scan_grid(self) -> Tuple[int, int, int]:
        return (self.b * self.n_chunks, self.head_groups, self.row_tiles)

    @property
    def states_shape(self) -> Tuple[int, ...]:
        """Each chunk's local state term, then (after the carry pass) the
        state entering it."""
        return (self.b, self.h, self.n_chunks, self.n, self.p)

    @property
    def cum_shape(self) -> Tuple[int, ...]:
        """Each head's cumsum of dt * a from its chunk's start."""
        return (self.b, self.s, self.h)


def pass_plan(b: int, s: int, h: int, p: int, n: int, chunk: int) -> PassPlan:
    """The launch of ssd_chunk at these extents.  A block of the state and
    scan passes takes up to MAX_HEADS heads (sharing B, C and the scores);
    fewer where that would leave fewer than TARGET_BLOCKS blocks, down to
    one head a block.  The grouping does not change any result: every head's
    sums run in the same order in any group."""
    assert_divides(chunk, s, "ssd_chunk sequence chunk")
    units = b * (s // chunk) * h             # (batch row, chunk, head)
    g = max(1, min(MAX_HEADS, h, units // TARGET_BLOCKS))
    return PassPlan(b, s, h, p, n, chunk, g)


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                    state: torch.Tensor, *, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, chunk by chunk as the Pallas
    body computes it: (y (b, s, h, p) f32, final state (b, h, n, p) f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    assert_divides(chunk, s, "ssd_chunk sequence chunk")
    nc = s // chunk
    f32 = torch.float32
    xf = x.to(f32).reshape(b, nc, chunk, h, p)
    dtf = dt.to(f32).reshape(b, nc, chunk, h)
    Bf = B.to(f32).reshape(b, nc, chunk, n)
    Cf = C.to(f32).reshape(b, nc, chunk, n)
    a = -torch.exp(A_log.to(f32))                            # (h,)
    cum = torch.cumsum(dtf * a, dim=2)                       # (b,nc,ch,h)
    scores = torch.einsum("bctn,bcsn->bcts", Cf, Bf)
    decay = torch.exp(torch.clamp(cum[:, :, :, None] - cum[:, :, None],
                                  -EXP_CLAMP, EXP_CLAMP))    # (b,nc,t,s,h)
    incl = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    W = torch.where(incl[:, :, None], scores[..., None] * decay,
                    torch.zeros((), device=x.device))
    xdt = xf * dtf[..., None]
    y = torch.einsum("bctsh,bcshp->bcthp", W, xdt)

    tail = torch.exp(torch.clamp(cum[:, :, -1:] - cum, -EXP_CLAMP,
                                 EXP_CLAMP))                 # (b,nc,ch,h)
    B_tail = Bf[..., None] * tail[:, :, :, None, :]          # (b,nc,s,n,h)
    S_c = torch.einsum("bcsnh,bcshp->bchnp", B_tail, xdt)
    dec = torch.exp(torch.clamp(cum[:, :, -1], -EXP_CLAMP, 0.0))  # (b,nc,h)
    ec = torch.exp(torch.clamp(cum, -EXP_CLAMP, 0.0))        # (b,nc,ch,h)
    S = state.to(f32)
    y_in = []
    for c in range(nc):
        y_in.append(torch.einsum("btn,bhnp->bthp", Cf[:, c], S)
                    * ec[:, c, :, :, None])
        S = S * dec[:, c, :, None, None] + S_c[:, c]
    y = y + torch.stack(y_in, dim=1)
    y = y + D.to(f32)[:, None] * xf
    return y.reshape(b, s, h, p), S


def _check(x, dt, A_log, B, C, D, state, state_out):
    if x.dim() != 4:
        raise ValueError(f"ssd_chunk expects x of shape (b, s, h, p); got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1] if B.dim() == 3 else -1
    ok = (tuple(dt.shape) == (b, s, h) and tuple(A_log.shape) == (h,)
          and tuple(D.shape) == (h,) and tuple(B.shape) == (b, s, n)
          and tuple(C.shape) == (b, s, n)
          and tuple(state.shape) == (b, h, n, p))
    if not ok:
        raise ValueError(
            f"ssd_chunk: dt {tuple(dt.shape)}, A_log {tuple(A_log.shape)}, B "
            f"{tuple(B.shape)}, C {tuple(C.shape)}, D {tuple(D.shape)}, state "
            f"{tuple(state.shape)} do not fit x {tuple(x.shape)}")
    if min(b, s, h, p, n) <= 0:
        raise ValueError(f"ssd_chunk needs non-empty inputs; got x "
                         f"{tuple(x.shape)}, n {n}")
    for t in (dt, A_log, B, C, D, state):
        if t.device != x.device:
            raise ValueError(f"ssd_chunk inputs lie on different devices: "
                             f"{x.device} and {t.device}")
    if state_out is not None and (
            tuple(state_out.shape) != (b, h, n, p)
            or state_out.dtype != torch.float32
            or not state_out.is_contiguous()
            or state_out.device != x.device):
        raise ValueError("ssd_chunk: state_out must be a contiguous float32 "
                         f"({b}, {h}, {n}, {p}) tensor on {x.device}")


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
              state: torch.Tensor, *, chunk: Optional[int] = None,
              state_out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, h, p); dt: (b, s, h), already through softplus; A_log, D:
    (h,); B, C: (b, s, n), shared across heads; state: (b, h, n, p).

    Returns (y (b, s, h, p) f32, final state (b, h, n, p) f32).  ``chunk=None``
    picks the largest preferred chunk dividing the sequence; a chunk that does
    not divide it raises.  ``state_out``, when given, receives the final state
    and is returned; it may be ``state`` itself (an update in place).

    CUDA tensors go to the kernel, CPU tensors to :func:`ssd_chunk_plain`.
    """
    _check(x, dt, A_log, B, C, D, state, state_out)
    b, s, h, p = x.shape
    n = B.shape[-1]
    chunk = select_chunk(s) if chunk is None else chunk
    assert_divides(chunk, s, "ssd_chunk sequence chunk")
    if x.device.type == "cpu":
        y, S = ssd_chunk_plain(x, dt, A_log, B, C, D, state, chunk=chunk)
        if state_out is None:
            return y, S
        return y, state_out.copy_(S)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk has no kernel for device {x.device}")
    if p > _MAX_DIM or n > _MAX_DIM or b * h > 2 ** 31 - 1:
        raise ValueError(f"ssd_chunk: x {tuple(x.shape)} with n = {n} exceeds "
                         f"the kernel's extents (p, n <= {_MAX_DIM})")
    plan = pass_plan(b, s, h, p, n, chunk)
    if (plan.head_groups > 65535 or plan.row_tiles > 65535
            or b * plan.n_chunks > 2 ** 31 - 1):
        raise ValueError(f"ssd_chunk: grid {plan.scan_grid} exceeds the "
                         f"card's limits")
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        x = x.to(torch.float32)
        x = x if x.stride(-1) == 1 else x.contiguous()
        dt = dt.to(torch.float32)
        B, C = (t.to(torch.float32) for t in (B, C))
        B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (B, C))
        A_log, D = (t.to(torch.float32).contiguous() for t in (A_log, D))
        state = state.to(torch.float32).contiguous()
        if state_out is None:
            state_out = torch.empty_like(state)
        y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
        states = torch.empty(plan.states_shape, dtype=torch.float32,
                             device=x.device)
        cum = torch.empty(plan.cum_shape, dtype=torch.float32,
                          device=x.device)
        err = lib.ssd_chunk_launch(
            x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), state.data_ptr(), y.data_ptr(),
            state_out.data_ptr(), states.data_ptr(), cum.data_ptr(),
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2), B.stride(0),
            B.stride(1), C.stride(0), C.stride(1), b, s, h, p, n, chunk,
            plan.heads_per_block, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk launch failed: CUDA error {err} for x "
                           f"{(b, s, h, p)}, n {n}, chunk {chunk}")
    ssd_chunk.launches += 1
    return y, state_out


#: calls of :func:`ssd_chunk` that launched its kernels (one a call, for
#: all three passes) in this process
ssd_chunk.launches = 0
