"""Production meshes (the reference's shapes), mesh-aware sharding rules, the
process-group starter and the card's constants for the roofline.
Counterpart of ``repro.launch.mesh``.

The reference's meshes live in XLA's compiler over however many (fake)
devices the process has.  The port's are ``torch.distributed`` device
meshes over the active process group: ``nccl`` on the card (one H100 is a
one-rank mesh), ``gloo`` on the CPU for numbers, and ``fake`` (no data, no
communication) for tracing a production mesh of 256 or 512 ranks on one
CPU (:func:`start_mesh`).  Building a mesh is a function call, so importing
this module touches no process group.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

from ..models.shardlib import Rules, multi_pod_rules, single_pod_rules

# NVIDIA H100 SXM5 80 GB (nvidia-smi: "NVIDIA H100 80GB HBM3, 700.00 W"),
# per GPU, dense rates, from NVIDIA's H100 Tensor Core GPU datasheet: the
# same peak and HBM figures as the kernel bounds in PERF.md section 6.
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, bf16 tensor cores, no sparsity
HBM_BW = 3.35e12                  # B/s, HBM3
NVLINK_BW = 900e9                 # B/s, NVLink 4 per GPU, both directions
NVLINK_BW_PER_DIRECTION = NVLINK_BW / 2
# The collective term keeps the reference's one-level ring model: a GPU's
# ring traffic over its NVLink rate in one direction.  An axis of more than
# 8 GPUs crosses the node (InfiniBand, not NVLink), which the model does
# not see.


def start_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
               backend: str = "nccl", rank: int = 0,
               store_path: Optional[str] = None):
    """Start the default process group and return a device mesh over it.

    ``backend``: ``"nccl"`` (the card; the mesh lives on the current CUDA
    device), ``"gloo"`` (the CPU, real numbers) or ``"fake"`` (the CPU, no
    data and no communication: tracing only).  The group has one rank for
    each device of the mesh.  Ranks meet through a ``FileStore`` at
    ``store_path`` (needed for more than one rank), else through a TCP
    store on a port the system picks (one rank).  Stop it with
    :func:`stop_mesh`."""
    import torch.distributed as dist
    world = math.prod(shape)
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    elif store_path is not None:
        store = dist.FileStore(os.fspath(store_path), world)
    elif world == 1:
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
    else:
        raise ValueError(f"{world} ranks need a store_path to meet at")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("an nccl mesh needs a GPU and none is "
                               "available; pass backend='gloo' or 'fake'")
        device_type = "cuda"
    else:
        device_type = "cpu"
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    return _make_mesh(shape, axes, device_type)


def stop_mesh() -> None:
    """Destroy the default process group, if one is active."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
               device_type: Optional[str] = None):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group is active: start one with "
                           "repro_torch.launch.mesh.start_mesh")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    if device_type is None:
        device_type = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes)


def make_test_mesh(shape: Tuple[int, ...] = (2, 2),
                   axes: Tuple[str, ...] = ("data", "model")):
    """A small mesh over the active process group's ranks."""
    return _make_mesh(shape, axes)


def rules_for_mesh(mesh, long_context: bool = False) -> Rules:
    """Sharding rules for a mesh; long_context drops batch sharding (batch=1)
    and spreads cache sequence dims across every axis."""
    multi = "pod" in mesh.mesh_dim_names
    rules = multi_pod_rules(mesh) if multi else single_pod_rules(mesh)
    if long_context:
        table = dict(rules.table)
        table["batch"] = None
        rules = Rules(table, mesh)
    return rules


def tp2d_rules(mesh, long_context: bool = False) -> Rules:
    """Serving weight layout: weights stationary, sharded over EVERY mesh
    axis (256/512-way "2D TP"); activations are small (one token/seq).
    fsdp resolves to None, tp to the full axis tuple."""
    base = rules_for_mesh(mesh, long_context=long_context)
    table = dict(base.table)
    table["fsdp"] = None
    table["tp"] = tuple(mesh.mesh_dim_names)
    return Rules(table, mesh)


def chips(mesh) -> int:
    return int(mesh.size())
