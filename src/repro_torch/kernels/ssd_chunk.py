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

Its gradient (where autograd records) is the port's own kernel,
``csrc/ssd_chunk_bwd.cu`` (:func:`ssd_chunk_backward`; the JAX package takes
it by ``jax.grad`` of the SSD core of its jnp ``mamba2_forward``), on the
CPU :func:`ssd_chunk_backward_plain`.  The forward's scratch (each chunk's
incoming state, the cumsum) is kept for the backward pass: a state pass
over (b, chunk, group of heads), a reverse carry, and where a chunk is one
tile (every shipped config) one fused pass over (b, chunk, group of heads)
that stages B and C and forms the scores once for the group, then takes
each head's row and column sides, dx, ddt and the reverse cumsum of d/dcum
in the block; the group's dB and dC terms go to one partial a group.  A
chunk of several tiles takes the first form's row, column and cumsum
passes, one head a block.  One reduce pass (dB and dC over the partials,
dA_log and dD over the batch and the chunks) in a fixed order: no float
atomics.  Four launches a call (six where a chunk spans tiles), sized by
:func:`pass_plan`; ``ssd_chunk.backward_launches`` counts the calls.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build
from .tuning import assert_divides, select_chunk
from .wkv6 import _backward_workspace, _clamped_exp, _f32_dense

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
#: threads of a block of the backward's passes (csrc/ssd_chunk_bwd.cu)
THREADS = 256
#: chunks whose loads a carry pass (forward or backward) issues at once
CARRY_UNROLL = 8
#: padded 64-row f32 tiles in shared memory of the backward's fused pass
BWD_FUSED_TILES = 11
#: rows of a dB / dC block of the backward's reduce pass (BC_ROWS)
BC_ROWS = THREADS // _MAX_DIM


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

    @property
    def fused_backward(self) -> bool:
        """A chunk of one tile: the backward's tile work is one fused pass
        over (b, chunk, group of heads); else the first form's row, column
        and cumsum passes, one head a block."""
        return self.chunk <= TILE

    @property
    def backward_launches(self) -> int:
        """Kernels one backward call launches: state, carry, the fused
        pass, reduce (the row, column and cumsum passes in place of the
        fused one where a chunk spans tiles)."""
        return 4 if self.fused_backward else 6

    @property
    def bwd_grid(self) -> Tuple[int, int, int]:
        """The backward's tile pass: the fused pass over (b * chunks, head
        groups), as the state pass; where a chunk spans tiles the row and
        column passes over (b * h, chunks, row tiles)."""
        if self.fused_backward:
            return self.state_grid
        return (self.b * self.h, self.n_chunks, self.row_tiles)

    @property
    def bc_slots(self) -> int:
        """Partials of dB and dC a row: one a head group (the fused pass
        adds its heads' terms in head order), or one a head."""
        return self.head_groups if self.fused_backward else self.h

    @property
    def partials_shape(self) -> Tuple[int, ...]:
        """dB's (and dC's) partials, added in slot order by the reduce
        pass."""
        return (self.b, self.s, self.bc_slots, self.n)

    @property
    def tile_partials_shape(self) -> Tuple[int, ...]:
        """A head's sums over a row tile (of d/dcum at the chunk's last
        row, of dy x for dD)."""
        return (self.b * self.h, self.n_chunks, self.row_tiles)

    @property
    def reduce_grid(self) -> Tuple[int, int, int]:
        """The reduce pass: BC_ROWS rows of dB and dC a block, then a
        thread a head for dA_log and dD."""
        return (-(-self.b * self.s // BC_ROWS) + -(-self.h // THREADS), 1, 1)

    @property
    def backward_workspace_floats(self) -> int:
        """The backward pass's scratch, in this order, each rounded up to 4
        floats (16 bytes): each chunk's local state gradient, then (after
        the reverse carry) the gradient of the state leaving it; the row
        and the column pass's parts of d/dcum (b, s, h each; the multi-tile
        passes'); dB's and dC's partials (:attr:`partials_shape` each); a
        head's per-tile sums of d/dcum at the chunk's last row and of dD;
        each chunk's sum of d(dt a) dt."""
        chunks = (self.b * self.h, self.n_chunks)
        return sum(-(-math.prod(shape) // 4) * 4 for shape in (
            self.states_shape, self.cum_shape, self.cum_shape,
            self.partials_shape, self.partials_shape,
            self.tile_partials_shape, self.tile_partials_shape, chunks))


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


def ssd_chunk_backward_plain(x: torch.Tensor, dt: torch.Tensor,
                             A_log: torch.Tensor, B: torch.Tensor,
                             C: torch.Tensor, D: torch.Tensor,
                             state: torch.Tensor, y_grad: torch.Tensor,
                             state_grad: Optional[torch.Tensor] = None, *,
                             chunk: int) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssd_chunk_plain` in plain PyTorch, chunk by
    chunk as ``csrc/ssd_chunk_bwd.cu`` computes it: (dx, ddt, dA_log, dB,
    dC, dD, dstate), all f32, from the gradients of y and of the final
    state (``None``: zero).

    Pass by pass: the forward's cumsum and each chunk's incoming state
    S_in; each chunk's local state gradient ``(ec C)^T dy`` and the reverse
    carry ``dS_in(c) = dec_c dS_out(c) + (ec_c C_c)^T dy_c``; per chunk and
    head the row side (the carried state's ``dy S_in^T``, ``dW = dy
    (x dt)^T`` under the inclusive mask, the scores' gradient ``dW decay``
    into dC) and the column side (``W^T dy`` and the state term ``tail B
    dS_out`` into d(x dt), the scores' gradient into dB); each clamped
    exponential's gradient (zero where the clamp binds); a reverse cumsum of
    d/dcum over the chunk's rows that gives d(dt a).  dB and dC sum over the
    heads, dA_log and dD over the batch and the sequence."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    assert_divides(chunk, s, "ssd_chunk sequence chunk")
    nc = s // chunk
    f32 = torch.float32
    E = EXP_CLAMP
    xf = x.to(f32).reshape(b, nc, chunk, h, p)
    dtf = dt.to(f32).reshape(b, nc, chunk, h)
    Bf = B.to(f32).reshape(b, nc, chunk, n)
    Cf = C.to(f32).reshape(b, nc, chunk, n)
    dyc = y_grad.to(f32).reshape(b, nc, chunk, h, p)
    a = -torch.exp(A_log.to(f32))                            # (h,)
    zero = torch.zeros((), device=x.device)
    # the forward's cumsum, factors and carry
    cum = torch.cumsum(dtf * a, dim=2)                       # (b,nc,ch,h)
    incl = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))[:, :, None]
    decay, in_w = _clamped_exp(cum[:, :, :, None] - cum[:, :, None], -E, E)
    scores = torch.einsum("bctn,bcsn->bcts", Cf, Bf)[..., None]
    W = torch.where(incl, scores * decay, zero)              # (b,nc,t,s,h)
    xdt = xf * dtf[..., None]
    tail, in_t = _clamped_exp(cum[:, :, -1:] - cum, -E, E)   # (b,nc,ch,h)
    dec, in_d = _clamped_exp(cum[:, :, -1], -E, 0.0)         # (b,nc,h)
    ec, in_e = _clamped_exp(cum, -E, 0.0)                    # (b,nc,ch,h)
    S_c = torch.einsum("bcsn,bcsh,bcshp->bchnp", Bf, tail, xdt)
    S = state.to(f32)
    S_in = []
    for c in range(nc):
        S_in.append(S)
        S = S * dec[:, c, :, None, None] + S_c[:, c]
    S_in = torch.stack(S_in, dim=1)                          # (b,nc,h,n,p)
    # the state pass and the reverse carry
    G = torch.einsum("bctn,bcth,bcthp->bchnp", Cf, ec, dyc)
    dS = (torch.zeros_like(S) if state_grad is None
          else state_grad.to(f32))
    dS_out = [None] * nc
    for c in range(nc - 1, -1, -1):
        dS_out[c] = dS
        dS = dS * dec[:, c, :, None, None] + G[:, c]
    dstate = dS
    dS_out = torch.stack(dS_out, dim=1)
    # the row side
    Q = torch.einsum("bcthp,bchnp->bcthn", dyc, S_in)
    dz_e = torch.where(in_e, torch.einsum("bctn,bcthn->bcth", Cf, Q) * ec,
                       zero)
    dW = torch.where(incl, torch.einsum("bcthp,bcshp->bctsh", dyc, xdt),
                     zero)
    dscores = dW * decay                                     # (b,nc,t,s,h)
    dC = (torch.einsum("bcth,bcthn->bctn", ec, Q)
          + torch.einsum("bctsh,bcsn->bctn", dscores, Bf))
    # d/d(cum_t - cum_s); the diagonal's is zero (its two ends cancel)
    off = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=x.device), diagonal=-1)[:, :, None]
    dz_w = torch.where(off & in_w, dscores * scores, zero)
    # the column side
    dB = torch.einsum("bctsh,bctn->bcsn", dscores, Cf)
    U = torch.einsum("bcshp,bchnp->bcshn", xdt, dS_out)
    dB = dB + torch.einsum("bcsh,bcshn->bcsn", tail, U)
    dz_t = torch.where(in_t, torch.einsum("bcsn,bcshn->bcsh", Bf, U) * tail,
                       zero)
    dxdt = (torch.einsum("bcsn,bchnp->bcshp", Bf, dS_out) * tail[..., None]
            + torch.einsum("bctsh,bcthp->bcshp", W, dyc))
    dx = dxdt * dtf[..., None] + D.to(f32)[:, None] * dyc
    ddt = (xf * dxdt).sum(-1)
    # d/dcum and its reverse cumsum
    ddec = (dS_out * S_in).sum((-1, -2))                     # (b,nc,h)
    dL = torch.where(in_d, ddec * dec, zero) + dz_t.sum(2)
    dcum = dz_e + dz_w.sum(3) - dz_w.sum(2) - dz_t
    dcum = dcum + torch.cat([torch.zeros_like(dcum[:, :, :-1]),
                             dL[:, :, None]], dim=2)
    dda = torch.flip(torch.cumsum(torch.flip(dcum, (2,)), dim=2), (2,))
    ddt = ddt + dda * a
    dA_log = (dda * dtf).sum((0, 1, 2)) * a
    dD = (dyc * xf).sum((0, 1, 2, 4))
    return (dx.reshape(b, s, h, p), ddt.reshape(b, s, h), dA_log,
            dB.reshape(b, s, n), dC.reshape(b, s, n), dD, dstate)


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
    Where autograd records and an input requires a gradient, the call is
    differentiable (:class:`_SSDChunkFn`: the backward pass launches
    ``csrc/ssd_chunk_bwd.cu`` for CUDA tensors and computes
    :func:`ssd_chunk_backward_plain` for CPU ones); ``state_out`` (an
    in-place write) raises there.
    """
    _check(x, dt, A_log, B, C, D, state, state_out)
    s = x.shape[1]
    chunk = select_chunk(s) if chunk is None else chunk
    assert_divides(chunk, s, "ssd_chunk sequence chunk")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A_log, B, C, D, state)):
        if state_out is not None:
            raise ValueError("ssd_chunk: state_out= writes the final state "
                             "in place, which autograd cannot record")
        return _SSDChunkFn.apply(x, dt, A_log, B, C, D, state, chunk)
    if x.device.type == "cpu":
        y, S = ssd_chunk_plain(x, dt, A_log, B, C, D, state, chunk=chunk)
        if state_out is None:
            return y, S
        return y, state_out.copy_(S)
    return _launch(x, dt, A_log, B, C, D, state, chunk, state_out)[:2]


def _plan_for(x: torch.Tensor, n: int, chunk: int) -> PassPlan:
    """:func:`pass_plan` of a call on CUDA tensors, its extents checked."""
    b, s, h, p = x.shape
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
    return plan


def _launch(x, dt, A_log, B, C, D, state, chunk, state_out):
    """The forward kernels on CUDA tensors: (y, final state, each chunk's
    incoming state, the cumsum), the last two the passes' scratch, which
    the backward pass reads."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    plan = _plan_for(x, n, chunk)
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
    return y, state_out, states, cum


def ssd_chunk_backward(x: torch.Tensor, dt: torch.Tensor,
                       A_log: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                       D: torch.Tensor, states: torch.Tensor,
                       cum: torch.Tensor, y_grad: torch.Tensor,
                       state_grad: Optional[torch.Tensor], *, chunk: int
                       ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels (``csrc/ssd_chunk_bwd.cu``) on CUDA tensors:
    (dx, ddt, dA_log, dB, dC, dD, dstate), f32, as
    :func:`ssd_chunk_backward_plain`.  ``states`` and ``cum`` are the
    forward's scratch (:func:`_launch`): each chunk's incoming state and
    the cumsum.  ``state_grad`` may be ``None`` (zero)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    plan = _plan_for(x, n, chunk)
    if plan.n_chunks > 65535:
        raise ValueError(f"ssd_chunk backward: grid {plan.bwd_grid} exceeds "
                         f"the card's limits")
    lib = _build.load_library()
    dev = x.device
    with torch.cuda.device(dev):
        x, dt, B, C, dy = (_f32_dense(t) for t in (x, dt, B, C, y_grad))
        A_log, D = _f32_dense(A_log), _f32_dense(D)
        dS = None if state_grad is None else _f32_dense(state_grad)
        f32 = dict(dtype=torch.float32, device=dev)
        dx = torch.empty((b, s, h, p), **f32)
        ddt = torch.empty((b, s, h), **f32)
        dB = torch.empty((b, s, n), **f32)
        dC = torch.empty((b, s, n), **f32)
        dA_log = torch.empty((h,), **f32)
        dD = torch.empty((h,), **f32)
        dstate = torch.empty((b, h, n, p), **f32)
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        bws = _backward_workspace(plan, dev.index, stream)
        err = lib.ssd_chunk_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(), dy.data_ptr(),
            None if dS is None else dS.data_ptr(), states.data_ptr(),
            cum.data_ptr(), bws.data_ptr(), bws.numel(), dx.data_ptr(),
            ddt.data_ptr(), dA_log.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dD.data_ptr(), dstate.data_ptr(), b, s, h, p, n, chunk,
            plan.heads_per_block, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk backward launch failed: CUDA error "
                           f"{err} for x {(b, s, h, p)}, n {n}, chunk {chunk}")
    ssd_chunk.backward_launches += 1
    return dx, ddt, dA_log, dB, dC, dD, dstate


class _SSDChunkFn(torch.autograd.Function):
    """:func:`ssd_chunk` under autograd.  The forward is the kernels' (their
    scratch kept for the backward pass) on CUDA, :func:`ssd_chunk_plain` on
    the CPU; the backward pass is :func:`ssd_chunk_backward` on CUDA and
    :func:`ssd_chunk_backward_plain` on the CPU.  Each gradient is computed
    for every input (one launch gives them all) and handed back where
    ``ctx.needs_input_grad`` asks for it."""

    @staticmethod
    def forward(ctx, x, dt, A_log, B, C, D, state, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.dtypes = [t.dtype for t in (x, dt, A_log, B, C, D, state)]
        if x.device.type == "cpu":
            y, S = ssd_chunk_plain(x, dt, A_log, B, C, D, state, chunk=chunk)
            ctx.save_for_backward(x, dt, A_log, B, C, D, state)
        else:
            y, S, states, cum = _launch(x, dt, A_log, B, C, D, state, chunk,
                                        None)
            ctx.save_for_backward(x, dt, A_log, B, C, D, states, cum)
        return y, S

    @staticmethod
    def backward(ctx, y_grad, state_grad):
        saved = ctx.saved_tensors
        x = saved[0]
        if y_grad is None:
            y_grad = torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device)
        if x.device.type == "cpu":
            grads = ssd_chunk_backward_plain(*saved, y_grad, state_grad,
                                             chunk=ctx.chunk)
        else:
            grads = ssd_chunk_backward(*saved, y_grad, state_grad,
                                       chunk=ctx.chunk)
        return (*(g.to(dt) if need else None for g, dt, need in zip(
            grads, ctx.dtypes, ctx.needs_input_grad)), None)


#: calls of :func:`ssd_chunk` that launched its kernels (one a call, for
#: all three passes) in this process
ssd_chunk.launches = 0
#: backward passes of :func:`ssd_chunk` that launched
#: ``csrc/ssd_chunk_bwd.cu`` (one a call, for all of its passes)
ssd_chunk.backward_launches = 0
