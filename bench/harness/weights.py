"""Weights from the seed, made on the device in a few large calls.

The tree is the one ``ModelAPI.param_specs()`` names.  All leaves of one
dtype are views of one flat buffer: one ``torch.randn`` over the whole
buffer (a ``torch.Generator`` on the device, in the dtype the weights are
served in), then each normal leaf is scaled in place by ``1/sqrt(fan_in)``
(0.02 for the embedding) and each ``zeros`` / ``ones`` leaf filled.  The
same seed gives the same tensors, so the reference can be handed a second
copy made after the program's state is freed.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def _put(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(specs: Any, seed: int, device: torch.device) -> Dict[str, Any]:
    """A tree of tensors shaped as ``specs`` (``ParamSpec`` leaves: shape,
    dtype, init), drawn from ``seed`` on ``device``."""
    leaves = _leaves(specs)
    by_dtype: Dict[torch.dtype, int] = {}
    for _, s in leaves:
        by_dtype[s.dtype] = by_dtype.get(s.dtype, 0) + math.prod(s.shape)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flats = {}
    for dtype in sorted(by_dtype, key=str):
        flat = torch.empty(by_dtype[dtype], dtype=dtype, device=device)
        if dtype.is_floating_point:
            flat.normal_(generator=gen)
        else:
            flat.zero_()
        flats[dtype] = flat
    out: Dict[str, Any] = {}
    offset = {dtype: 0 for dtype in by_dtype}
    for path, s in leaves:
        n = math.prod(s.shape)
        view = flats[s.dtype][offset[s.dtype]:offset[s.dtype] + n].view(
            s.shape)
        offset[s.dtype] += n
        if s.init == "zeros":
            view.zero_()
        elif s.init == "ones":
            view.fill_(1)
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            view.mul_(0.02 if s.init == "embed" else 1.0 / math.sqrt(fan_in))
        _put(out, path, view)
    return out


def leaves(tree: Any) -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf, in sorted key order."""
    return [(".".join(p), t) for p, t in _leaves(tree)]
