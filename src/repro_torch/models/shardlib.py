"""Parameter specs and initialisation.

Params and activations carry *logical* axes ("fsdp", "tp", "batch", ...) in
their specs, as in ``repro.models.shardlib``; on one GPU nothing is sharded,
so :func:`shard` is the identity.  The mesh rules that resolve logical axes
onto devices arrive with the multi-device slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Shape/dtype + logical axes of one parameter tensor."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    logical: Tuple[Optional[str], ...]
    init: str = "normal"            # "normal" | "zeros" | "ones" | "embed"


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of nested dictionaries that share one
    structure (a leaf is anything that is not a ``dict``); keys are visited
    in sorted order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Sharding hint against the active mesh rules: the identity on one
    device (kept so model code reads like the JAX package's)."""
    return x


def init_param(gen: torch.Generator, s: ParamSpec,
               device: torch.device) -> torch.Tensor:
    """One parameter: zeros, ones, or a normal draw scaled by
    ``1/sqrt(fan_in)`` (0.02 for the embedding), drawn in f32 and cast."""
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
    scale = 0.02 if s.init == "embed" else 1.0 / math.sqrt(fan_in)
    x = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(s.dtype)


def init_param_tree(gen: torch.Generator, tree: Any,
                    device: torch.device) -> Any:
    """Initialise a spec tree leaf by leaf (sorted key order) from one
    generator, which must live on ``device``."""
    return tree_map(lambda s: init_param(gen, s, device), tree)


def param_count(tree: Any) -> int:
    """Number of scalars in a tree of specs or tensors."""
    return sum(math.prod(leaf.shape) for leaf in tree_leaves(tree))
