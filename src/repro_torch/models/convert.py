"""Carry weights and decode states across from the JAX package.

The port's parameter tree has the JAX package's keys and its
stacked-layers-first layout, so conversion is a map over the leaves.  numpy
has no bfloat16: a bf16 leaf arrives as float32 numpy (exact) and is cast
back with ``.to(torch.bfloat16)``, which is exact for values that were bf16.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .shardlib import tree_map

Params = Dict[str, Any]


def _leaf(x: Any, spec, device: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":            # an ml_dtypes array
        arr = arr.astype(np.float32)
    t = torch.from_numpy(np.array(arr))         # a copy the port may write to
    if tuple(t.shape) != tuple(spec.shape):
        raise ValueError(f"leaf of shape {tuple(t.shape)} where the spec "
                         f"has {tuple(spec.shape)}")
    return t.to(device=device, dtype=spec.dtype)


def params_from_numpy(tree: Params, specs: Params,
                      device: DeviceLike = None) -> Params:
    """A parameter tree of numpy arrays (nested dictionaries, the JAX
    package's keys) as the port's tree on ``device``; ``specs`` is
    ``ModelAPI.param_specs()`` and gives every leaf its dtype."""
    dev = resolve_device(device)
    return tree_map(lambda s, x: _leaf(x, s, dev), specs, tree)


def decode_state_from_numpy(tree: Params, specs: Params,
                            device: DeviceLike = None) -> Params:
    """The same for a decode state; ``specs`` is
    ``ModelAPI.decode_state_specs(shape)``."""
    return params_from_numpy(tree, specs, device)
