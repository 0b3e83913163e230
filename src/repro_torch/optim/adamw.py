"""AdamW with fp32 master weights, optional int8 moment compression,
gradient clipping and LR schedules.  Counterpart of ``repro.optim.adamw``
over dict trees of tensors.

Optimizer state reuses each parameter's *logical axes* (``state_specs``), so
states shard exactly like their parameters: on a device mesh every leaf is a
``DTensor`` and each rank updates its own shards (a gradient is first laid
out as its parameter).

Each element's arithmetic is the reference's, operation by operation, in
float32: bias corrections, clip, the moments, the decoupled weight decay and
the master weight; int8 moments keep one scale per row (the last axis).
Scalars (the step's learning rate, clip and corrections) are 0-d tensors on
the parameters' device, so no step waits on the host and every division is
a true division (PyTorch on a GPU turns a division by a Python number into a
multiplication by its reciprocal).  Two things differ from the reference:

* :func:`apply_updates` writes the new parameters and state **in place** and
  returns the trees it was given (the reference returns new trees);
* it walks each leaf in slices of its leading axis of at most
  ``SLICE_BYTES`` of float32, so that its temporaries stay a slice's size
  (phi4-mini's embedding is 2.5 GB in f32, and the update makes about eight
  temporaries of what it works on).  The per-element arithmetic does not
  change, so no bit does.  A leaf of rank 0 or 1 is updated whole: an int8
  moment's scale spans a vector's whole last axis.

:func:`global_norm` sums each leaf's slices' squares (on a mesh, each
rank's shard, then across the ranks that split the leaf), then the leaves in
the tree's (sorted-key) order: another summation order than XLA's, so the
clip factor may differ from the reference's in its last bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Tuple

import torch

from .._device import is_dtensor
from ..models.shardlib import ParamSpec, tree_leaves, tree_map

Pytree = Any

#: largest float32 slice of a leaf that one update step works on
SLICE_BYTES = 256 * 2 ** 20

_STATE_KEYS = {"mu", "nu", "mu_scale", "nu_scale", "master"}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_fp32: bool = True
    int8_moments: bool = False        # gradient-compression trick: quantized mu/nu
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"          # cosine | constant


def _f32(x: Any, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def lr_at(cfg: AdamWConfig, step: Any) -> torch.Tensor:
    """The learning rate at ``step`` (a Python int or an integer tensor), as
    a 0-d float32 tensor on the step's device."""
    step = torch.as_tensor(step)
    s = step.to(torch.float32)
    warm = torch.clamp((s + 1) / _f32(max(cfg.warmup_steps, 1), s), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((s - cfg.warmup_steps)
                    / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s),
                    0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


# ---------------------------------------------------------------------------
# int8 moment compression
# ---------------------------------------------------------------------------


class Quantized(NamedTuple):
    q: torch.Tensor          # int8 payload
    scale: torch.Tensor      # f32 per-row (last-axis) scale


def quantize_i8(x: torch.Tensor) -> Quantized:
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    clamped = torch.clamp(amax, min=1e-20)
    scale = clamped / torch.full_like(clamped, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return Quantized(q, scale.to(torch.float32))


def dequantize_i8(z: Quantized) -> torch.Tensor:
    return z.q.to(torch.float32) * z.scale


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------


def state_specs(param_specs: Pytree, cfg: AdamWConfig) -> Pytree:
    """ParamSpec tree for the optimizer state (mirrors parameter sharding)."""

    def leaf(s: ParamSpec) -> Dict[str, ParamSpec]:
        moment_dtype = torch.int8 if cfg.int8_moments else torch.float32
        out = {
            "mu": ParamSpec(s.shape, moment_dtype, s.logical, init="zeros"),
            "nu": ParamSpec(s.shape, moment_dtype, s.logical, init="zeros"),
        }
        if cfg.int8_moments:
            sshape = s.shape[:-1] + (1,)
            out["mu_scale"] = ParamSpec(sshape, torch.float32,
                                        s.logical[:-1] + (None,),
                                        init="zeros")
            out["nu_scale"] = ParamSpec(sshape, torch.float32,
                                        s.logical[:-1] + (None,),
                                        init="zeros")
        if cfg.master_fp32:
            out["master"] = ParamSpec(s.shape, torch.float32, s.logical,
                                      init="zeros")
        return out

    return {"per_param": tree_map(leaf, param_specs),
            "step": ParamSpec((), torch.int32, (), init="zeros")}


def init_state(params: Pytree, cfg: AdamWConfig) -> Pytree:
    """Zero moments (and scales), the master a float32 copy of each
    parameter, and step 0; every tensor on its parameter's device."""

    def leaf(p: torch.Tensor) -> Dict[str, torch.Tensor]:
        moment_dtype = torch.int8 if cfg.int8_moments else torch.float32
        out = {"mu": torch.zeros(p.shape, dtype=moment_dtype,
                                 device=p.device),
               "nu": torch.zeros(p.shape, dtype=moment_dtype,
                                 device=p.device)}
        if cfg.int8_moments:
            sshape = tuple(p.shape[:-1]) + (1,)
            out["mu_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                          device=p.device)
            out["nu_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                          device=p.device)
        if cfg.master_fp32:
            out["master"] = p.detach().to(torch.float32, copy=True)
        return out

    device = tree_leaves(params)[0].device
    return {"per_param": tree_map(leaf, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _slices(t: torch.Tensor) -> Iterator[slice]:
    """Runs of ``t``'s leading axis of at most SLICE_BYTES as float32; all
    of a tensor of rank below 2."""
    if t.dim() < 2:
        yield slice(None)
        return
    rows = max(1, SLICE_BYTES // (4 * max(t[0].numel(), 1)))
    for i in range(0, t.shape[0], rows):
        yield slice(i, i + rows)


def _local(t: Any) -> Any:
    """A ``DTensor``'s shard on this rank (a view); anything else as it
    is."""
    return t.to_local() if is_dtensor(t) else t


def _like(grad: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``grad`` laid out as its parameter: a ``DTensor`` gradient (partial
    sums, or another split) is reduced and redistributed to ``p``'s
    placements."""
    if (is_dtensor(grad) and is_dtensor(p)
            and tuple(grad.placements) != tuple(p.placements)):
        return grad.redistribute(p.device_mesh, p.placements)
    return grad


def _sum_over_mesh(part: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A rank's sum over its shard of ``like``, summed over the mesh axes
    that split ``like`` (each shard counted once): a plain 0-d tensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not is_dtensor(like):
        return part
    placements = [Partial() if isinstance(pl, Shard) else Replicate()
                  for pl in like.placements]
    return DTensor.from_local(part, like.device_mesh, placements,
                              run_check=False).full_tensor()


def global_norm(tree: Pytree) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32 (a 0-d tensor
    on the leaves' device); ``None`` leaves count as zeros.  A ``DTensor``
    leaf sums its local shard slice by slice, then across the ranks that
    split it."""
    total = None
    for g in tree_leaves(tree):
        if g is None:
            continue
        local = _local(g)
        leaf = None
        for sl in _slices(local):
            part = torch.sum(torch.square(local[sl].to(torch.float32)))
            leaf = part if leaf is None else leaf + part
        leaf = _sum_over_mesh(leaf, g)
        total = leaf if total is None else total + leaf
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params: Pytree, opt_state: Pytree, grads: Pytree,
                  cfg: AdamWConfig) -> Tuple[Pytree, Pytree]:
    """One AdamW step, written into ``params`` and ``opt_state`` in place.
    Returns ``(params, opt_state)``.  A gradient of ``None`` (a parameter
    the loss did not reach) counts as zeros, as the reference's gradient
    would be.  On ``DTensor`` leaves each gradient is first laid out as its
    parameter, and each rank updates its own shards."""
    if grads is not None:
        grads = _pair_map(params, grads, _like)
    step = _local(opt_state["step"])
    step.add_(1)
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    one = _f32(1.0, step)
    # a Python number over a tensor is a reciprocal times the number in
    # PyTorch: the clip's numerator is a tensor too
    clip = (torch.minimum(one, _f32(cfg.grad_clip, step)
                          / torch.clamp(gnorm, min=1e-9))
            if cfg.grad_clip else one)
    b1, b2 = _f32(cfg.b1, step), _f32(cfg.b2, step)
    corr1 = 1.0 - b1 ** step.to(torch.float32)
    corr2 = 1.0 - b2 ** step.to(torch.float32)

    def leaf(p: torch.Tensor, s: Dict[str, torch.Tensor],
             grad: torch.Tensor) -> None:
        p = _local(p)
        s = {k: _local(v) for k, v in s.items()}
        grad = torch.zeros_like(p) if grad is None else _local(grad)
        for sl in _slices(p):
            g = grad[sl].to(torch.float32) * clip
            if cfg.int8_moments:
                mu = dequantize_i8(Quantized(s["mu"][sl], s["mu_scale"][sl]))
                nu = dequantize_i8(Quantized(s["nu"][sl], s["nu_scale"][sl]))
            else:
                mu, nu = s["mu"][sl], s["nu"][sl]
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            update = (mu / corr1) / (torch.sqrt(nu / corr2) + cfg.eps)
            base = s["master"][sl] if cfg.master_fp32 else \
                p[sl].to(torch.float32)
            new = base - lr * (update + cfg.weight_decay * base)
            if cfg.int8_moments:
                for key, x in (("mu", mu), ("nu", nu)):
                    qx = quantize_i8(x)
                    s[key][sl].copy_(qx.q)
                    s[key + "_scale"][sl].copy_(qx.scale)
            else:
                s["mu"][sl].copy_(mu)
                s["nu"][sl].copy_(nu)
            if cfg.master_fp32:
                s["master"][sl].copy_(new)
            p[sl].copy_(new.to(p.dtype))

    _pair(params, opt_state["per_param"], grads, leaf)
    return params, opt_state


def _pair_map(params: Pytree, grads: Pytree, fn) -> Pytree:
    """``fn(grad, param)`` over the gradient tree, ``None`` kept."""
    if isinstance(params, dict):
        return {k: _pair_map(params[k], grads.get(k), fn) for k in params
                if grads is not None and k in grads}
    return None if grads is None else fn(grads, params)


def _pair(params: Pytree, states: Pytree, grads: Pytree, fn) -> None:
    """``fn(param, state_leaf, grad)`` over the parameter tree (sorted
    keys); a state leaf is the dict of one parameter's moments."""
    if isinstance(params, dict):
        for k in sorted(params):
            _pair(params[k], states[k],
                  None if grads is None else grads.get(k), fn)
        return
    if not set(states) <= _STATE_KEYS:
        raise ValueError(f"optimizer state leaf with keys {sorted(states)} "
                         f"where {sorted(_STATE_KEYS)} are expected")
    fn(params, states, grads)
