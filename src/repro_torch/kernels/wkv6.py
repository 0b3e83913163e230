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

:func:`wkv6` launches the kernels for CUDA tensors (or raises) and computes
:func:`wkv6_plain` for CPU tensors; there is no other route between the two.
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
#: state columns of one block of the one-token kernel (ONE_COLS)
ONE_COLS = 16
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
        return sum(-(-math.prod(shape) // 4) * 4 for shape in (
            self.states_shape, self.lw_shape, self.dec_shape))


@functools.lru_cache(maxsize=256)
def pass_plan(b: int, s: int, h: int, p: int, chunk: int) -> PassPlan:
    """The launch of wkv6 at these extents (cached: a decode step asks at
    every layer)."""
    assert_divides(chunk, s, "wkv6 sequence chunk")
    return PassPlan(b, s, h, p, chunk)


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w_log: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
               chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, chunk by chunk as the Pallas
    body computes it: (y (b, s, h, p) f32, final state (b, h, p, p) f32)."""
    b, s, h, p = r.shape
    assert_divides(chunk, s, "wkv6 sequence chunk")
    nc = s // chunk
    rc, kc, vc, wc = (x.to(torch.float32).reshape(b, nc, chunk, h, p)
                      for x in (r, k, v, w_log))
    lw = torch.cumsum(wc, dim=2)                            # inclusive
    lw_prev = torch.cat([torch.zeros_like(lw[:, :, :1]), lw[:, :, :-1]],
                        dim=2)
    m = 0.5 * lw[:, :, -1:]
    rr = rc * torch.exp(torch.clamp(lw_prev - m, -EXP_CLAMP, EXP_CLAMP))
    kk = kc * torch.exp(torch.clamp(m - lw, -EXP_CLAMP, EXP_CLAMP))
    A = torch.einsum("bcthp,bcshp->bchts", rr, kk)
    lower = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    A = torch.where(lower, A, torch.zeros((), device=r.device))
    diag = (rc * u.to(torch.float32) * kc).sum(-1)          # (b,nc,ch,h)
    y = torch.einsum("bchts,bcshp->bcthp", A, vc) + diag[..., None] * vc

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


def _f32_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 with its last axis contiguous (itself when it is)."""
    if x.dtype != torch.float32:
        x = x.to(torch.float32)
    return x if x.stride(-1) == 1 else x.contiguous()


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

    CUDA tensors go to the kernels, CPU tensors to :func:`wkv6_plain`.
    """
    _check(r, k, v, w_log, u, state, state_out)
    b, s, h, p = r.shape
    chunk = select_chunk(s) if chunk is None else chunk
    assert_divides(chunk, s, "wkv6 sequence chunk")
    dev = r.device
    if dev.type == "cpu":
        y, S = wkv6_plain(r, k, v, w_log, u, state, chunk=chunk)
        if state_out is None:
            return y, S
        return y, state_out.copy_(S)
    if dev.type != "cuda":
        raise ValueError(f"wkv6 has no kernel for device {dev}")
    plan = pass_plan(b, s, h, p, chunk)
    if (p > _MAX_P or b * h > 2 ** 31 - 1 or (
            not plan.one_token
            and max(plan.n_chunks, plan.row_tiles) > _MAX_GRID_YZ)):
        raise ValueError(f"wkv6: (b, s, h, p) = {tuple(r.shape)}, chunk "
                         f"{chunk} exceeds the kernels' extents (p <= "
                         f"{_MAX_P}, at most {_MAX_GRID_YZ} chunks)")
    lib = _build.load_library()
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return wkv6(r, k, v, w_log, u, state, chunk=chunk,
                        state_out=state_out)
    r, k, v, w_log = (_f32_rows(t) for t in (r, k, v, w_log))
    u, state = _f32_dense(u), _f32_dense(state)
    if state_out is None:
        state_out = torch.empty_like(state)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    n_ws = plan.workspace_floats
    ws = torch.empty((n_ws,), dtype=torch.float32, device=dev) if n_ws else None
    err = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w_log.stride()[:3],
        u.data_ptr(), state.data_ptr(), y.data_ptr(), state_out.data_ptr(),
        None if ws is None else ws.data_ptr(), n_ws, b, s, h, p, chunk,
        # the raw handle of PyTorch's current stream (the Stream object
        # that torch.cuda.current_stream() builds costs more than a launch)
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {err} for "
                           f"(b, s, h, p) = {(b, s, h, p)}, chunk {chunk}")
    wkv6.launches += 1
    return y, state_out


#: calls of :func:`wkv6` that launched its kernels (one a call, for all
#: three passes or the one-token kernel) in this process
wkv6.launches = 0
