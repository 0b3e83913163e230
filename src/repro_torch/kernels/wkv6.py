"""wkv6 on Hopper: the chunked RWKV6 ("Finch") WKV recurrence.

    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T

Replaces the Pallas kernel ``src/repro/kernels/wkv6.py::_kernel`` (wrappers
``wkv6`` / ``_wkv6_call``).  The CUDA source is ``csrc/wkv6.cu``.  The
chunked form puts a chunk's rows against each other in (chunk x chunk)
score tiles and carries the (p, p) state from chunk to chunk; exponents are
centred at half the chunk's total decay and clamped at +-60 (the Pallas
kernel's ``EXP_CLAMP``), the carried state's factor at [-60, 0].

A call with chunks of more than one row is three CUDA kernels
(:func:`pass_plan` sizes them): a state pass over (b * h, chunk) that takes
the chunk's cumsum of the decays (written to a scratch every later use reads)
and its local state term, a carry pass over (b * h, slice of the state) that
walks the chunks in order and leaves each chunk's incoming state, and a scan
pass over (b * h, chunk, 64-row tile) that forms each tile's output.  The
four products run on the TF32 tensor cores with a 3xTF32 split (``hi +
lo``, three products), close to f32.  A call with chunk 1 (decode) is one
kernel over (b * h, slice of 16 state columns) that reads its slice of the
state once and writes it once.  No float atomics: a repeated call gives the
same bits.

What bounds it on an H100: at rwkv6's loss shape (b 2, s 2048, h 32, p 64,
chunk 64) the bytes: r, k, v, w read once, y written once, the state read
and written once, 169.9 MB over 3.35 TB/s = 0.0507 ms (the products at
TF32's rate, times three, take 0.026 ms); at decode (s = 1) the state's
bytes, 16 KB each way a head.

bf16 r, k and v (the JAX package's ``cfg.ssm_bf16=True``: its
``wkv6_chunked(..., compute_dtype=bfloat16)``) take the bf16 recurrence: the
same passes for bf16 operands (``wkv6_bf16_launch``), which keep r, k and v
in shared memory as bf16 (16-byte ``cp.async`` copies where :func:`rows16`
holds, else lane loads), round ``rr``, ``kk``, the scores and the
intra-chunk output to bf16 where the reference does, and take the two
intra-chunk products on the bf16 tensor cores with bf16x2 operands read
straight from bf16 tiles (each pass's shared memory by type:
:data:`STATE_SMEM_BYTES`, :data:`SCAN_SMEM_BYTES`); the state, the decays,
the carry and the output stay f32 (:func:`wkv6_plain` with
``compute_dtype`` says where each rounding falls).
``wkv6.bf16_launches`` counts its calls.

:func:`wkv6` launches the kernels for CUDA tensors (or raises) and computes
:func:`wkv6_plain` for CPU tensors; there is no other route between the two.

Its gradient (where autograd records) is the port's own kernel,
``csrc/wkv6_bwd.cu`` (:func:`wkv6_backward`; the JAX package takes it by
``jax.grad`` of its jnp chunked form), on the CPU
:func:`wkv6_backward_plain`.  The forward under autograd keeps its three
passes' workspace (each chunk's incoming state, lw, the decays) for the
backward pass, which runs a state pass (rs^T dy a chunk), a reverse carry,
and where a chunk is one tile (rwkv6's chunk, and chunk 1) one fused pass
over (b * h, chunk) that forms dr, dk, dv and dw (the reverse cumsum of
d/dlw over the chunk's rows in the block), then a u pass: four launches.
A chunk of several tiles takes the first form's row pass (dr), column pass
(dk, dv) over 64-row tiles and lw pass (dw) in place of the fused one: six.
Per-block partials are summed in a fixed order: no float atomics.
``wkv6.backward_launches`` counts its calls.  The bound of one backward call at rwkv6's loss shape is
the bytes of r, k, v, w, dy and S_in read and dr, dk, dv, dw written once:
335.5 MB over 3.35 TB/s = 0.100 ms.

bf16 r, k and v under autograd take the bf16 forward with its passes kept
(``wkv6_bf16_passes_launch``) and the bf16 backward
(``wkv6_bwd_bf16_launch``, counted by ``wkv6.bf16_backward_launches``):
the same passes, rounding where ``jax.grad`` of the reference's bf16 form
rounds (:func:`wkv6_backward_plain` with ``compute_dtype`` says where), dr,
dk and dv written in bf16.  r, k, v, dr, dk and dv move at 2 bytes an
element: the bound at the loss shape is 234.9 MB, 0.070 ms.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build
from .tuning import assert_divides, select_chunk

EXP_CLAMP = 60.0
#: largest head size the kernels take (their shared tiles are 64 wide)
_MAX_P = 64
#: rows of a chunk tile (csrc/wkv6.cu: TILE)
TILE = 64
#: state elements of one carry block (CARRY_ELEMS)
CARRY_ELEMS = 1024
#: chunks whose loads a carry pass (forward or backward) issues at once
CARRY_UNROLL = 8
#: padded 64-row f32 tiles in shared memory of the backward's fused pass
#: (r, k and v beside them in their own type)
BWD_FUSED_TILES = 9
#: state columns of one block of the one-token kernel (ONE_COLS)
ONE_COLS = 16
#: dynamic shared memory of a state-pass and a scan-pass block, by the type
#: of r, k and v (csrc/wkv6.cu: STATE_SMEM_BYTES<T>, SCAN_SMEM_BYTES<T>):
#: bf16 keeps r, k, v, rr, kk and the scores in bf16 tiles
STATE_SMEM_BYTES = {torch.float32: 55_296, torch.bfloat16: 36_864}
SCAN_SMEM_BYTES = {torch.float32: 106_496, torch.bfloat16: 90_112}
#: blocks an SM each pass's ``__launch_bounds__`` is built for, by type
STATE_BLOCKS_PER_SM = {torch.float32: 3, torch.bfloat16: 3}
SCAN_BLOCKS_PER_SM = {torch.float32: 2, torch.bfloat16: 2}
#: the card's largest grid extent along y and z
_MAX_GRID_YZ = 65535


@dataclass(frozen=True)
class PassPlan:
    """The launch of one :func:`wkv6` call: the passes' grids and the
    workspace the wrapper allocates (the kernels allocate nothing).  A
    chunk of one row takes the one-token kernel and no workspace."""
    b: int
    s: int
    h: int
    p: int
    chunk: int

    @property
    def one_token(self) -> bool:
        return self.chunk == 1

    @property
    def n_chunks(self) -> int:
        return self.s // self.chunk

    @property
    def row_tiles(self) -> int:
        return -(-self.chunk // TILE)

    @property
    def state_grid(self) -> Tuple[int, int, int]:
        return (self.b * self.h, self.n_chunks, 1)

    @property
    def carry_grid(self) -> Tuple[int, int, int]:
        return (self.b * self.h, -(-self.p * self.p // CARRY_ELEMS), 1)

    @property
    def scan_grid(self) -> Tuple[int, int, int]:
        return (self.b * self.h, self.n_chunks, self.row_tiles)

    @property
    def token_grid(self) -> Tuple[int, int, int]:
        return (self.b * self.h, -(-self.p // ONE_COLS), 1)

    @property
    def states_shape(self) -> Tuple[int, ...]:
        """Each chunk's local state term, then (after the carry pass) the
        state entering it."""
        return (self.b, self.h, self.n_chunks, self.p, self.p)

    @property
    def lw_shape(self) -> Tuple[int, ...]:
        """Each channel's cumsum of w_log from its chunk's start."""
        return (self.b, self.s, self.h, self.p)

    @property
    def dec_shape(self) -> Tuple[int, ...]:
        """Each chunk's decay of the carried state, per key channel."""
        return (self.b, self.h, self.n_chunks, self.p)

    @property
    def workspace_floats(self) -> int:
        """The three scratch tensors, in this order, each rounded up to 4
        floats (16 bytes); none for the one-token kernel."""
        if self.one_token:
            return 0
        return self.passes_workspace_floats

    @property
    def passes_workspace_floats(self) -> int:
        """:attr:`workspace_floats` of the three passes at any chunk (a
        forward under autograd takes them at chunk 1 too, and keeps the
        scratch for the backward pass)."""
        return _floats(self.states_shape, self.lw_shape, self.dec_shape)

    @property
    def fused_backward(self) -> bool:
        """A chunk of one tile: the backward's tile work is one fused pass
        over (b * h, chunk); else the first form's row, column and lw
        passes."""
        return self.chunk <= TILE

    @property
    def backward_launches(self) -> int:
        """Kernels one backward call launches: state, carry, the fused
        pass, u (the row, column and lw passes in place of the fused one
        where a chunk spans tiles)."""
        return 4 if self.fused_backward else 6

    @property
    def bwd_grid(self) -> Tuple[int, int, int]:
        """The backward's tile pass: the fused pass over (b * h, chunks);
        where a chunk spans tiles the row and column passes over (b * h,
        chunks, row tiles)."""
        return (self.b * self.h, self.n_chunks,
                1 if self.fused_backward else self.row_tiles)

    @property
    def partials_shape(self) -> Tuple[int, ...]:
        """One row tile's sums over its rows, per key channel (the backward
        pass's per-block partials)."""
        return (self.b * self.h, self.n_chunks, self.row_tiles, self.p)

    @property
    def backward_workspace_floats(self) -> int:
        """The backward pass's scratch, in this order, each rounded up to 4
        floats: each chunk's local state gradient, then (after the reverse
        carry) the gradient of the state leaving it; where a chunk is one
        tile the fused pass's partials of du; else the gradient of lw
        reaching each row through lw_prev and four per-block partials (the
        row pass's sums of d/dm and of the u term, the column pass's of
        d/dm and d/dL)."""
        if self.fused_backward:
            return _floats(self.states_shape, self.partials_shape)
        return _floats(self.states_shape, self.lw_shape,
                       *[self.partials_shape] * 4)


def rows16(t: torch.Tensor) -> bool:
    """Whether the forward kernels stage ``t`` (r, k, v or w_log, a (b, s,
    h, p) tensor as the launcher receives it: its last axis contiguous) by
    16-byte ``cp.async`` copies, as ``csrc/wkv6.cu``'s ``rows16`` decides:
    every row starts 16-byte aligned, i.e. the base is, and the strides
    of b, s and h and p are multiples of the elements in 16 bytes (4 f32, 8
    bf16).  Else they stage it by 4-byte copies (f32) or clamped lane loads
    (bf16), zero past the edge; the result is the same."""
    per = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[-1] % per == 0
            and all(st % per == 0 for st in t.stride()[:3]))


def _floats(*shapes: Tuple[int, ...]) -> int:
    """Floats of scratch tensors laid one after another, each rounded up
    to 4 (16 bytes)."""
    return sum(-(-math.prod(shape) // 4) * 4 for shape in shapes)


@functools.lru_cache(maxsize=256)
def pass_plan(b: int, s: int, h: int, p: int, chunk: int) -> PassPlan:
    """The launch of wkv6 at these extents (cached: a decode step asks at
    every layer)."""
    assert_divides(chunk, s, "wkv6 sequence chunk")
    return PassPlan(b, s, h, p, chunk)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w_log: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
               chunk: int, compute_dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, chunk by chunk as the Pallas
    body computes it: (y (b, s, h, p) f32, final state (b, h, p, p) f32).

    ``compute_dtype=torch.bfloat16`` is the reference's bf16 recurrence
    (``wkv6_chunked(..., compute_dtype=bfloat16)``): r, k and v are taken in
    bf16, and ``rr``, ``kk`` (each with its exponential factor first), the
    scores ``A`` and the intra-chunk ``y`` are rounded to bf16, each from an
    f32 product or sum; the u term, the carried state's terms, the decays
    and the state stay f32.  ``None`` takes the operands' precision
    (:func:`compute_dtype_of`), as :func:`wkv6` does."""
    if compute_dtype is None:
        compute_dtype = compute_dtype_of(r, k, v)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"wkv6 computes in float32 or bfloat16; got "
                         f"{compute_dtype}")
    b, s, h, p = r.shape
    assert_divides(chunk, s, "wkv6 sequence chunk")
    nc = s // chunk
    f32 = torch.float32

    def rnd(x):
        return x.to(compute_dtype).to(f32)

    rc, kc, vc = (rnd(x).reshape(b, nc, chunk, h, p) for x in (r, k, v))
    wc = w_log.to(f32).reshape(b, nc, chunk, h, p)
    lw = torch.cumsum(wc, dim=2)                            # inclusive
    lw_prev = torch.cat([torch.zeros_like(lw[:, :, :1]), lw[:, :, :-1]],
                        dim=2)
    m = 0.5 * lw[:, :, -1:]
    rr = rnd(rc * rnd(torch.exp(torch.clamp(lw_prev - m, -EXP_CLAMP,
                                            EXP_CLAMP))))
    kk = rnd(kc * rnd(torch.exp(torch.clamp(m - lw, -EXP_CLAMP, EXP_CLAMP))))
    A = rnd(torch.einsum("bcthp,bcshp->bchts", rr, kk))
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    A = torch.where(lower, A, torch.zeros((), device=r.device))
    diag = (rc * u.to(f32) * kc).sum(-1)                    # (b,nc,ch,h)
    y = rnd(torch.einsum("bchts,bcshp->bcthp", A, vc)) + diag[..., None] * vc

    rs = rc * torch.exp(torch.clamp(lw_prev, -EXP_CLAMP, 0.0))
    tail = torch.exp(torch.clamp(lw[:, :, -1:] - lw, -EXP_CLAMP, EXP_CLAMP))
    S_c = torch.einsum("bcshp,bcshq->bchpq", kc * tail, vc)
    dec = torch.exp(torch.clamp(lw[:, :, -1], -EXP_CLAMP, 0.0))   # (b,nc,h,p)
    S = state.to(torch.float32)
    y_in = []
    for c in range(nc):
        y_in.append(torch.einsum("bthp,bhpq->bthq", rs[:, c], S))
        S = S * dec[:, c, :, :, None] + S_c[:, c]
    y = y + torch.stack(y_in, dim=1)
    return y.reshape(b, s, h, p), S


def _clamped_exp(z: torch.Tensor, lo: float, hi: float):
    """(exp(clamp(z, lo, hi)), where the clamp passes a gradient): the
    factor and its mask, as ``torch.clamp``'s gradient has it (the bounds
    themselves pass)."""
    return torch.exp(torch.clamp(z, lo, hi)), (z >= lo) & (z <= hi)


def wkv6_backward_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w_log: torch.Tensor, u: torch.Tensor,
                        state: torch.Tensor, y_grad: torch.Tensor,
                        state_grad: Optional[torch.Tensor] = None, *,
                        chunk: int, compute_dtype: Optional[torch.dtype] = None
                        ) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`wkv6_plain` in plain PyTorch, chunk by chunk as
    ``csrc/wkv6_bwd.cu`` computes it: (dr, dk, dv, dw_log, du, dstate) from
    the gradients of y and of the final state (``None``: zero).  dw_log, du
    and dstate are f32; dr, dk and dv are f32, or bf16 for the bf16
    recurrence.

    Pass by pass: the forward's lw and each chunk's incoming state S_in;
    each chunk's local state gradient rs^T dy and the reverse carry
    ``dS_in(c) = diag(dec_c) dS_out(c) + rs_c^T dy_c`` (``dS_out`` of the
    last chunk is ``state_grad``, ``dS_in`` of the first is ``dstate``);
    per chunk the row side (``dA = tril_-1(dy v^T)``, ``drr = dA kk``, the
    carried state's ``drs = dy S_in^T``, the u term) and the column side
    (``A^T dy``, ``dkk = dA^T rr``, the chunk's state term through
    ``dS_out``); then each clamped exponential's gradient (zero where the
    clamp binds), the centring ``m = lw[last] / 2``, and a reverse cumsum
    of d/dlw over the chunk's rows that gives dw_log.

    ``compute_dtype=torch.bfloat16`` (``None`` takes the operands'
    precision, :func:`compute_dtype_of`) is ``jax.grad`` of the reference's
    ``wkv6_chunked(..., compute_dtype=bfloat16)`` rounding for rounding:
    the intra-chunk output's gradient ``dy1 = bf16(dy)``; ``dA =
    bf16(tril_-1(dy1 v^T))``, ``drr = bf16(dA kk)``, ``dkk = bf16(dA^T rr)``
    and ``A^T dy1`` rounded once each, with ``rr``, ``kk`` and ``A`` as
    :func:`wkv6_plain` rounds them; each f32 term of dr, dk and dv (the
    carried state's, the u term, the chunk's state term) rounded to bf16
    and the terms added in bf16 in the reference's order, ``(state + u) +
    intra-chunk`` (the ``add_any`` order of ``jax.make_jaxpr`` of its VJP);
    the exponential factors' gradients ``bf16(drr r)`` and ``bf16(dkk k)``,
    widened before the clamp's mask.  dw_log's cumsum, du and dstate stay
    f32."""
    if compute_dtype is None:
        compute_dtype = compute_dtype_of(r, k, v)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"wkv6 computes in float32 or bfloat16; got "
                         f"{compute_dtype}")
    bf = compute_dtype == torch.bfloat16
    b, s, h, p = r.shape
    assert_divides(chunk, s, "wkv6 sequence chunk")
    nc = s // chunk
    f32 = torch.float32
    C = EXP_CLAMP

    def rnd(x):
        return x.to(compute_dtype).to(f32)

    rc, kc, vc = (rnd(x).reshape(b, nc, chunk, h, p) for x in (r, k, v))
    wc, dyc = (x.to(f32).reshape(b, nc, chunk, h, p) for x in (w_log, y_grad))
    uf = u.to(f32)
    # the forward's state and carry passes: lw, the factors, S_in
    lw = torch.cumsum(wc, dim=2)
    lw_prev = torch.cat([torch.zeros_like(lw[:, :, :1]), lw[:, :, :-1]],
                        dim=2)
    L = lw[:, :, -1]                                        # (b,nc,h,p)
    m = 0.5 * L[:, :, None]
    er, in_r = _clamped_exp(lw_prev - m, -C, C)
    ek, in_k = _clamped_exp(m - lw, -C, C)
    ers, in_s = _clamped_exp(lw_prev, -C, 0.0)
    tail, in_t = _clamped_exp(L[:, :, None] - lw, -C, C)
    dec, in_d = _clamped_exp(L, -C, 0.0)
    er_c, ek_c = rnd(er), rnd(ek)           # the factors as rr, kk take them
    rr, kk = rnd(rc * er_c), rnd(kc * ek_c)
    rs, kt = rc * ers, kc * tail
    S_c = torch.einsum("bcshp,bcshq->bchpq", kt, vc)
    S = state.to(f32)
    S_in = []
    for c in range(nc):
        S_in.append(S)
        S = S * dec[:, c, :, :, None] + S_c[:, c]
    S_in = torch.stack(S_in, dim=1)                         # (b,nc,h,p,p)
    # the state pass and the reverse carry
    G = torch.einsum("bcthp,bcthq->bchpq", rs, dyc)
    dS = (torch.zeros_like(S) if state_grad is None
          else state_grad.to(f32))
    dS_out = [None] * nc
    for c in range(nc - 1, -1, -1):
        dS_out[c] = dS
        dS = dS * dec[:, c, :, :, None] + G[:, c]
    dstate = dS
    dS_out = torch.stack(dS_out, dim=1)
    # the row side
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    zero = torch.zeros((), device=r.device)
    dy1 = rnd(dyc)                  # the intra-chunk output's gradient
    dA = torch.where(lower, rnd(torch.einsum("bcthq,bcshq->bchts", dy1, vc)),
                     zero)
    drr = rnd(torch.einsum("bchts,bcshp->bcthp", dA, kk))
    drs = torch.einsum("bcthq,bchpq->bcthp", dyc, S_in)
    ddiag = (dyc * vc).sum(-1)[..., None]                   # (b,nc,t,h,1)
    if bf:
        dr = rnd(rnd(rnd(drs * ers) + rnd(ddiag * kc * uf)) + rnd(drr * er_c))
    else:
        dr = er * drr + ers * drs + ddiag * uf * kc
    dz_r = torch.where(in_r, rnd(rc * drr) * er, zero)
    dz_s = torch.where(in_s, rc * drs * ers, zero)
    du = (ddiag * rc * kc).sum((0, 1, 2))
    # the column side
    A = torch.where(lower, rnd(torch.einsum("bcthp,bcshp->bchts", rr, kk)),
                    zero)
    ru = rc * uf
    diag = (ru * kc).sum(-1)[..., None]
    dv_a = rnd(torch.einsum("bchts,bcthq->bcshq", A, dy1))
    dv_s = torch.einsum("bcshp,bchpq->bcshq", kt, dS_out)
    dkk = rnd(torch.einsum("bchts,bcthp->bcshp", dA, rr))
    dkt = torch.einsum("bcshq,bchpq->bcshp", vc, dS_out)
    if bf:
        dv = rnd(rnd(rnd(dv_s) + rnd(diag * dyc)) + dv_a)
        dk = rnd(rnd(rnd(dkt * tail) + rnd(ddiag * ru)) + rnd(dkk * ek_c))
    else:
        dv = dv_a + diag * dyc + dv_s
        dk = ek * dkk + tail * dkt + ddiag * uf * rc
    dz_k = torch.where(in_k, rnd(kc * dkk) * ek, zero)
    dz_t = torch.where(in_t, kc * dkt * tail, zero)
    # d/dlw and its reverse cumsum
    ddec = (dS_out * S_in).sum(-1)                          # (b,nc,h,p)
    dL = (torch.where(in_d, ddec * dec, zero)
          + 0.5 * (dz_k - dz_r).sum(2) + dz_t.sum(2))
    dlw = -dz_k - dz_t
    dlw = dlw + torch.cat([(dz_r + dz_s)[:, :, 1:],
                           dL[:, :, None]], dim=2)
    dw = torch.flip(torch.cumsum(torch.flip(dlw, (2,)), dim=2), (2,))
    return (*(x.reshape(b, s, h, p).to(compute_dtype) for x in (dr, dk, dv)),
            dw.reshape(b, s, h, p), du, dstate)


def _rows(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as ``dtype`` with its last axis contiguous (itself when it
    is)."""
    if x.dtype != dtype:
        x = x.to(dtype)
    return x if x.stride(-1) == 1 else x.contiguous()


def compute_dtype_of(r: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.dtype:
    """The recurrence's precision: bf16 where r, k and v are all bf16,
    f32 where none is (other dtypes are widened); a mix raises."""
    bf = [t.dtype == torch.bfloat16 for t in (r, k, v)]
    if any(bf) and not all(bf):
        raise ValueError(f"wkv6: r, k and v must all be bfloat16 for the "
                         f"bf16 recurrence, or none; got "
                         f"{[str(t.dtype) for t in (r, k, v)]}")
    return torch.bfloat16 if all(bf) else torch.float32


def _f32_dense(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous float32 tensor (itself when it is)."""
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    return x if x.is_contiguous() else x.contiguous()


def _check(r, k, v, w_log, u, state, state_out):
    if r.dim() != 4:
        raise ValueError(f"wkv6 expects r of shape (b, s, h, p); got "
                         f"{tuple(r.shape)}")
    b, s, h, p = shape = r.shape
    if k.shape != shape or v.shape != shape or w_log.shape != shape:
        raise ValueError(f"wkv6: k {tuple(k.shape)}, v {tuple(v.shape)} and "
                         f"w_log {tuple(w_log.shape)} must equal r "
                         f"{tuple(shape)}")
    if u.shape != (h, p) or state.shape != (b, h, p, p):
        raise ValueError(f"wkv6: u {tuple(u.shape)} / state "
                         f"{tuple(state.shape)} do not fit r {tuple(shape)}")
    if min(shape) == 0:
        raise ValueError(f"wkv6 needs non-empty inputs; got {tuple(shape)}")
    dev = r.device
    if not (k.device == v.device == w_log.device == u.device == state.device
            == dev):
        raise ValueError(f"wkv6 inputs lie on different devices: "
                         f"{[t.device for t in (r, k, v, w_log, u, state)]}")
    if state_out is not None and (
            state_out.shape != (b, h, p, p)
            or state_out.dtype != torch.float32
            or not state_out.is_contiguous()
            or state_out.device != dev):
        raise ValueError("wkv6: state_out must be a contiguous float32 "
                         f"({b}, {h}, {p}, {p}) tensor on {dev}")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w_log: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
         chunk: Optional[int] = None,
         state_out: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w_log: (b, s, h, p); u: (h, p); state: (b, h, p, p).

    Returns (y (b, s, h, p) f32, final state (b, h, p, p) f32).  ``chunk=None``
    picks the largest preferred chunk dividing the sequence; a chunk that does
    not divide it raises.  ``state_out``, when given, receives the final state
    and is returned; it may be ``state`` itself (an update in place).

    bf16 r, k and v take the bf16 recurrence (:func:`compute_dtype_of`).
    CUDA tensors go to the kernels, CPU tensors to :func:`wkv6_plain`.

    Where autograd records and an input requires a gradient, the call is
    differentiable (:class:`_WKV6Fn`: the backward pass launches
    ``csrc/wkv6_bwd.cu`` for CUDA tensors and computes
    :func:`wkv6_backward_plain` for CPU ones, both in the operands'
    precision).  ``state_out`` (an in-place write) raises there.
    """
    _check(r, k, v, w_log, u, state, state_out)
    cdt = compute_dtype_of(r, k, v)
    b, s, h, p = r.shape
    chunk = select_chunk(s) if chunk is None else chunk
    assert_divides(chunk, s, "wkv6 sequence chunk")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w_log, u, state)):
        if state_out is not None:
            raise ValueError("wkv6: state_out= writes the final state in "
                             "place, which autograd cannot record")
        return _WKV6Fn.apply(r, k, v, w_log, u, state, chunk, cdt)
    dev = r.device
    if dev.type == "cpu":
        y, S = wkv6_plain(r, k, v, w_log, u, state, chunk=chunk,
                          compute_dtype=cdt)
        if state_out is None:
            return y, S
        return y, state_out.copy_(S)
    y, S, _ = _launch(r, k, v, w_log, u, state, chunk, state_out, cdt,
                      keep=False)
    return y, S


def _plan_for(r: torch.Tensor, chunk: int) -> PassPlan:
    """:func:`pass_plan` of a call on CUDA tensors, its extents checked."""
    b, s, h, p = r.shape
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 has no kernel for device {r.device}")
    plan = pass_plan(b, s, h, p, chunk)
    if (p > _MAX_P or b * h > 2 ** 31 - 1 or (
            not plan.one_token
            and max(plan.n_chunks, plan.row_tiles) > _MAX_GRID_YZ)):
        raise ValueError(f"wkv6: (b, s, h, p) = {tuple(r.shape)}, chunk "
                         f"{chunk} exceeds the kernels' extents (p <= "
                         f"{_MAX_P}, at most {_MAX_GRID_YZ} chunks)")
    return plan


def _launch(r, k, v, w_log, u, state, chunk, state_out, cdt, *, keep):
    """The forward kernels on CUDA tensors: (y, final state, workspace).
    ``keep`` takes the three passes at any chunk (chunk 1 too) and returns
    their workspace (each chunk's incoming state, lw, the chunks' decays),
    which the backward pass reads; else the workspace is ``None``."""
    b, s, h, p = r.shape
    dev = r.device
    plan = _plan_for(r, chunk)
    lib = _build.load_library()
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(r, k, v, w_log, u, state, chunk, state_out, cdt,
                           keep=keep)
    r, k, v = (_rows(t, cdt) for t in (r, k, v))
    w_log = _rows(w_log, torch.float32)
    u, state = _f32_dense(u), _f32_dense(state)
    if state_out is None:
        state_out = torch.empty_like(state)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    n_ws = plan.passes_workspace_floats if keep else plan.workspace_floats
    ws = torch.empty((n_ws,), dtype=torch.float32, device=dev) if n_ws else None
    bf16 = cdt == torch.bfloat16
    launcher = ((lib.wkv6_bf16_passes_launch if keep else lib.wkv6_bf16_launch)
                if bf16 else
                lib.wkv6_passes_launch if keep else lib.wkv6_launch)
    err = launcher(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w_log.stride()[:3],
        u.data_ptr(), state.data_ptr(), y.data_ptr(), state_out.data_ptr(),
        None if ws is None else ws.data_ptr(), n_ws, b, s, h, p, chunk,
        # the raw handle of PyTorch's current stream (the Stream object
        # that torch.cuda.current_stream() builds costs more than a launch)
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {err} for "
                           f"(b, s, h, p) = {(b, s, h, p)}, chunk {chunk}"
                           f"{', bf16' if bf16 else ''}")
    if bf16:
        wkv6.bf16_launches += 1
    else:
        wkv6.launches += 1
    return y, state_out, ws


@functools.lru_cache(maxsize=8)
def _backward_workspace(plan, device: int, stream: int) -> torch.Tensor:
    """A backward pass's scratch (``plan.backward_workspace_floats``: this
    module's :class:`PassPlan` or ssd_chunk's), kept per shape, device and
    stream: a call's kernels and the next call's run on the one stream in
    order, so the next call's first write lands after the last read of
    this one.  A call allocates only the gradients it returns."""
    return torch.empty((plan.backward_workspace_floats,), dtype=torch.float32,
                       device=torch.device("cuda", device))


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  u: torch.Tensor, ws: torch.Tensor, y_grad: torch.Tensor,
                  state_grad: Optional[torch.Tensor], *, chunk: int
                  ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels (``csrc/wkv6_bwd.cu``) on CUDA tensors: (dr,
    dk, dv, dw_log, du, dstate) as :func:`wkv6_backward_plain`, dr, dk and
    dv in r, k and v's precision.  ``ws`` is the forward's kept workspace
    (:func:`_launch` with ``keep``): each chunk's incoming state, lw and the
    chunks' decays.  r, k and v are the forward's operands, all f32 or all
    bf16 (the bf16 recurrence: ``wkv6_bwd_bf16_launch``), the last axis
    contiguous, any other strides; ``state_grad`` may be ``None``
    (zero)."""
    b, s, h, p = r.shape
    dev = r.device
    plan = _plan_for(r, chunk)
    if max(plan.n_chunks, plan.row_tiles) > _MAX_GRID_YZ:
        raise ValueError(f"wkv6 backward: {plan.n_chunks} chunks of "
                         f"{plan.row_tiles} row tiles exceed the grid")
    lib = _build.load_library()
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return wkv6_backward(r, k, v, u, ws, y_grad, state_grad,
                                 chunk=chunk)
    cdt = compute_dtype_of(r, k, v)
    r, k, v = (_rows(t, cdt) for t in (r, k, v))
    u, dy = _f32_dense(u), _f32_dense(y_grad)
    dS = None if state_grad is None else _f32_dense(state_grad)
    if ws is None or ws.numel() < plan.passes_workspace_floats:
        raise ValueError("wkv6 backward: the forward's workspace is missing")
    grads = [torch.empty((b, s, h, p), dtype=dt, device=dev)
             for dt in (cdt, cdt, cdt, torch.float32)]
    du = torch.empty((h, p), dtype=torch.float32, device=dev)
    dstate = torch.empty((b, h, p, p), dtype=torch.float32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    bws = _backward_workspace(plan, dev.index, stream)
    bf16 = cdt == torch.bfloat16
    launcher = lib.wkv6_bwd_bf16_launch if bf16 else lib.wkv6_bwd_launch
    err = launcher(
        r.data_ptr(), k.data_ptr(), v.data_ptr(),
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        u.data_ptr(), dy.data_ptr(), None if dS is None else dS.data_ptr(),
        ws.data_ptr(), bws.data_ptr(), bws.numel(),
        *(g.data_ptr() for g in grads), du.data_ptr(), dstate.data_ptr(),
        b, s, h, p, chunk, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 backward launch failed: CUDA error {err} "
                           f"for (b, s, h, p) = {(b, s, h, p)}, chunk "
                           f"{chunk}{', bf16' if bf16 else ''}")
    if bf16:
        wkv6.bf16_backward_launches += 1
    else:
        wkv6.backward_launches += 1
    return (*grads, du, dstate)


class _WKV6Fn(torch.autograd.Function):
    """:func:`wkv6` under autograd, in the recurrence's precision ``cdt``
    (f32, or bf16 for bf16 r, k and v).  The forward is the kernels' (the
    three passes, their workspace kept for the backward pass) on CUDA,
    :func:`wkv6_plain` on the CPU; the backward pass is
    :func:`wkv6_backward` on CUDA and :func:`wkv6_backward_plain` on the
    CPU.  Each gradient is computed for every input (one launch gives them
    all) and handed back where ``ctx.needs_input_grad`` asks for it."""

    @staticmethod
    def forward(ctx, r, k, v, w_log, u, state, chunk, cdt):
        ctx.set_materialize_grads(False)
        ctx.chunk, ctx.cdt = chunk, cdt
        ctx.dtypes = [t.dtype for t in (r, k, v, w_log, u, state)]
        if r.device.type == "cpu":
            y, S = wkv6_plain(r, k, v, w_log, u, state, chunk=chunk,
                              compute_dtype=cdt)
            ctx.save_for_backward(r, k, v, w_log, u, state)
        else:
            y, S, ws = _launch(r, k, v, w_log, u, state, chunk, None, cdt,
                               keep=True)
            ctx.save_for_backward(r, k, v, u, ws)
        return y, S

    @staticmethod
    def backward(ctx, y_grad, state_grad):
        saved = ctx.saved_tensors
        r = saved[0]
        if y_grad is None:
            y_grad = torch.zeros(r.shape, dtype=torch.float32,
                                 device=r.device)
        if r.device.type == "cpu":
            grads = wkv6_backward_plain(*saved, y_grad, state_grad,
                                        chunk=ctx.chunk,
                                        compute_dtype=ctx.cdt)
        else:
            grads = wkv6_backward(*saved, y_grad, state_grad,
                                  chunk=ctx.chunk)
        return (*(g.to(dt) if need else None for g, dt, need in zip(
            grads, ctx.dtypes, ctx.needs_input_grad)), None, None)


#: calls of :func:`wkv6` that launched its f32 kernels (one a call, for all
#: three passes or the one-token kernel) in this process
wkv6.launches = 0
#: calls of :func:`wkv6` that launched its bf16 kernels (r, k, v in bf16)
wkv6.bf16_launches = 0
#: backward passes of :func:`wkv6` that launched ``csrc/wkv6_bwd.cu`` (one
#: a call, for all of its passes)
wkv6.backward_launches = 0
#: backward passes of :func:`wkv6` that launched its bf16 variant
#: (``wkv6_bwd_bf16_launch``: r, k, v in bf16)
wkv6.bf16_backward_launches = 0
