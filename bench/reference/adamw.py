"""Plain AdamW for the reference's train steps, in float32.

Decoupled weight decay, bias corrections, the update clipped by the
gradients' global norm, and the learning rate warmed up linearly over
``warmup_steps`` and then on a cosine to ``total_steps``; the defaults are
those the benchmark's train cells run (the port's ``AdamWConfig()``):
learning rate 3e-4, betas 0.9 / 0.95, eps 1e-8, weight decay 0.1, clip 1.0,
warm-up 100 of 10,000 steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch


@dataclasses.dataclass(frozen=True)
class Hyper:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def lr_at(h: Hyper, step: int) -> float:
    """The learning rate of step ``step`` (1 for the first update)."""
    warm = min((step + 1) / max(h.warmup_steps, 1), 1.0)
    t = min(max((step - h.warmup_steps)
                / max(h.total_steps - h.warmup_steps, 1), 0.0), 1.0)
    return h.lr * warm * 0.5 * (1.0 + math.cos(math.pi * t))


def clip_factor(h: Hyper, grads: List[torch.Tensor]) -> torch.Tensor:
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    return torch.clamp(h.grad_clip / torch.clamp(norm, min=1e-9), max=1.0)


@torch.no_grad()
def update(h: Hyper, step: int, params: List[torch.Tensor],
           grads: List[torch.Tensor], mu: List[torch.Tensor],
           nu: List[torch.Tensor], clip: torch.Tensor) -> None:
    """One AdamW step in place; ``step`` counts from 1."""
    lr = lr_at(h, step)
    c1 = 1.0 - h.b1 ** step
    c2 = 1.0 - h.b2 ** step
    for leaf in zip(params, grads, mu, nu):
        for p, g, m, v in _blocks(*leaf):
            g = g.float() * clip
            m.mul_(h.b1).add_(g, alpha=1 - h.b1)
            v.mul_(h.b2).add_(g * g, alpha=1 - h.b2)
            upd = (m / c1) / (torch.sqrt(v / c2) + h.eps)
            p.sub_(lr * (upd + h.weight_decay * p))


def _blocks(*ts: torch.Tensor, rows_bytes: int = 2 ** 28):
    """The tensors cut alike into runs of their leading axis of at most
    ``rows_bytes`` of float32 each (whole where they have one axis), so
    an update's temporaries stay small."""
    t = ts[0]
    if t.dim() < 2:
        yield ts
        return
    rows = max(1, rows_bytes // (4 * t[0].numel()))
    for i in range(0, t.shape[0], rows):
        yield tuple(x[i:i + rows] for x in ts)
