"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import functools
from typing import Any, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU: the port never carries on on the CPU by
    itself.  ``device="cpu"`` is for callers that ask for it (the tests)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on an NVIDIA GPU and none is available; "
                "pass device='cpu' (--device cpu) to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               "not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.cache
def _dtensor_class() -> type:
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor`` (a tensor laid
    out on a device mesh)."""
    return isinstance(x, _dtensor_class())
