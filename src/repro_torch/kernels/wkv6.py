"""wkv6 on Hopper: the chunked RWKV6 ("Finch") WKV recurrence.

    y_t = r_t . (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T

Replaces the Pallas kernel ``src/repro/kernels/wkv6.py::_kernel`` (wrappers
``wkv6`` / ``_wkv6_call``).  The CUDA source is ``csrc/wkv6.cu``.  The
chunked form puts a chunk's rows against each other in (chunk x chunk)
score tiles and carries the (p, p) state from chunk to chunk; exponents are
centred at half the chunk's total decay and clamped at +-60 (the Pallas
kernel's ``EXP_CLAMP``), the carried state's factor at [-60, 0].

What bounds it on an H100: in the loss path (chunk 64, p 64) the f32
operations of the four products; at decode (s = 1) the state's bytes, far
under the cost of one launch.  One block per (b, h) walks the chunks in
order with the state in shared memory and reads the (b, s, h, p) inputs
through their strides, so no input is moved or copied first.

:func:`wkv6` launches the kernel for CUDA tensors (or raises) and computes
:func:`wkv6_plain` for CPU tensors; there is no other route between the two.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .tuning import assert_divides, select_chunk

EXP_CLAMP = 60.0
#: largest head size the kernel takes (its shared tiles are 64 wide)
_MAX_P = 64


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
    x = x.to(torch.float32)
    return x if x.stride(-1) == 1 else x.contiguous()


def _check(r, k, v, w_log, u, state, state_out):
    if r.dim() != 4:
        raise ValueError(f"wkv6 expects r of shape (b, s, h, p); got "
                         f"{tuple(r.shape)}")
    b, s, h, p = r.shape
    for name, t in (("k", k), ("v", v), ("w_log", w_log)):
        if t.shape != r.shape:
            raise ValueError(f"wkv6: {name} has shape {tuple(t.shape)}, r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (h, p) or tuple(state.shape) != (b, h, p, p):
        raise ValueError(f"wkv6: u {tuple(u.shape)} / state "
                         f"{tuple(state.shape)} do not fit r "
                         f"{tuple(r.shape)}")
    if min(b, s, h, p) == 0:
        raise ValueError(f"wkv6 needs non-empty inputs; got {tuple(r.shape)}")
    for t in (k, v, w_log, u, state):
        if t.device != r.device:
            raise ValueError(f"wkv6 inputs lie on different devices: "
                             f"{r.device} and {t.device}")
    if state_out is not None and (
            tuple(state_out.shape) != (b, h, p, p)
            or state_out.dtype != torch.float32
            or not state_out.is_contiguous()
            or state_out.device != r.device):
        raise ValueError("wkv6: state_out must be a contiguous float32 "
                         f"({b}, {h}, {p}, {p}) tensor on {r.device}")


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

    CUDA tensors go to the kernel, CPU tensors to :func:`wkv6_plain`.
    """
    _check(r, k, v, w_log, u, state, state_out)
    b, s, h, p = r.shape
    chunk = select_chunk(s) if chunk is None else chunk
    assert_divides(chunk, s, "wkv6 sequence chunk")
    if r.device.type == "cpu":
        y, S = wkv6_plain(r, k, v, w_log, u, state, chunk=chunk)
        if state_out is None:
            return y, S
        return y, state_out.copy_(S)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 has no kernel for device {r.device}")
    if p > _MAX_P or b * h > 2 ** 31 - 1:
        raise ValueError(f"wkv6: (b, s, h, p) = {tuple(r.shape)} exceeds the "
                         f"kernel's extents (p <= {_MAX_P})")
    lib = _build.load_library()
    with torch.cuda.device(r.device):
        r, k, v, w_log = (_f32_rows(t) for t in (r, k, v, w_log))
        u = u.to(torch.float32).contiguous()
        state = state.to(torch.float32).contiguous()
        if state_out is None:
            state_out = torch.empty_like(state)
        y = torch.empty((b, s, h, p), dtype=torch.float32, device=r.device)
        strides = [st for t in (r, k, v, w_log)
                   for st in (t.stride(0), t.stride(1), t.stride(2))]
        err = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            *strides, u.data_ptr(), state.data_ptr(), y.data_ptr(),
            state_out.data_ptr(), b, s, h, p, chunk,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {err} for "
                           f"(b, s, h, p) = {(b, s, h, p)}, chunk {chunk}")
    wkv6.launches += 1
    return y, state_out


#: kernel launches made by :func:`wkv6` in this process
wkv6.launches = 0
